"""The frozen operation and byte counts against hand counts."""
import pytest

from benchmark.counts import kernels as KC
from benchmark.counts import models as MC
from benchmark.counts.peaks import BF16_FLOPS, FP32_FLOPS, bound_ms
from benchmark.run import load_cell

RRDB = {'arch': 'RRDB_net', 'nf': 64, 'nb': 23, 'gc': 32,
        'latent_channels': 3, 'in_nc': 3, 'out_nc': 3, 'scale': 4}


def test_rdb_operations_at_the_main_shape():
    # five convs over [z, x, c0..c3]: inputs 67, 99, 131, 163, 195
    per_px = 2 * 9 * (67 * 32 + 99 * 32 + 131 * 32 + 163 * 32 + 195 * 64)
    assert MC.rdb(64, 32, 3) == per_px == 489_600
    assert MC.rdb(64, 32, 3) * 16 * 128 * 128 == pytest.approx(128.3e9,
                                                             rel=1e-3)


def test_rrdb_operations_per_lr_pixel():
    hand = (2 * 9 * 6 * 64                 # fea_conv on [z, lr]
            + 69 * 489_600                 # 23 RRDBs of 3 RDBs
            + 2 * 9 * 67 * 64              # trunk conv on [z, trunk]
            + 4 * 2 * 9 * 64 * 64          # upconv0 at 2x
            + 16 * 2 * 9 * 64 * 64         # upconv1 at 4x
            + 16 * 2 * 9 * 67 * 64         # hr_conv0 on [z, x]
            + 16 * 2 * 9 * 67 * 3)         # hr_conv1 on [z, x]
    assert MC.rrdbnet_per_lr_pixel(RRDB) == hand == 36_633_888
    # a request of the bf16 cell: batch 16 at 148 x 148 (pre-padded)
    assert MC.forward_flops(RRDB, 16, 148, 148) == pytest.approx(
        12.84e12, rel=1e-3)


def test_msrresnet_operations_per_lr_pixel():
    cfg = dict(RRDB, arch='MSRResNet', nb=16, latent_channels=0)
    hand = (2 * 9 * 3 * 64 + 32 * 2 * 9 * 64 * 64 + 2 * 9 * 64 * 256
            + 4 * 2 * 9 * 64 * 256 + 16 * 2 * 9 * 64 * 64
            + 16 * 2 * 9 * 64 * 3)
    assert MC.msrresnet_per_lr_pixel(cfg) == hand == 5_072_256


def test_stage4_bytes_and_bound():
    nbytes, flops = KC.stage4(16 * 128 * 128, 64, 32, 2)
    assert nbytes / 1e6 == pytest.approx(218.1, abs=0.05)
    assert bound_ms(nbytes, flops, BF16_FLOPS) == (pytest.approx(
        0.0651, abs=1e-4), 'bytes')
    nbytes, flops = KC.stage4(16 * 128 * 128, 64, 32, 4)
    assert bound_ms(nbytes, flops, FP32_FLOPS) == (pytest.approx(
        0.1442, abs=1e-4), 'operations')


def test_cem_bounds_at_the_main_shape():
    # PERF.md's kernel table: LR 1.88, down 16.0, up-combine 31.9 us
    calls = KC.cem_forward(16, 128, 128, 3, 17, 27, 4, (1, 1))
    us = {k: [1e3 * bound_ms(b, f, FP32_FLOPS)[0] for b, f in v]
          for k, v in calls.items()}
    assert us['sepfilter_edge'] == [pytest.approx(1.88, abs=0.01)] * 2
    assert us['sepfilter_down'] == [pytest.approx(16.0, abs=0.05)]
    assert us['sepfilter_up'] == [pytest.approx(31.9, abs=0.05)]


def test_up_entries_match_the_tap_lists():
    # every HR output of the 17-tap x4 upscale meets 4 or 5 data samples
    n = KC.up_entries(128, 4, 1, 17)
    assert 4 * 512 <= n <= 5 * 512


@pytest.mark.parametrize('name', ['rrdb_x4.serve_bf16',
                                  'msrresnet_x4.serve_fp32',
                                  'rrdb_x4.eval_fp32'])
def test_cell_counts_are_positive(name):
    from benchmark.drivers.serve import _counts
    cell, cfg = load_cell(name)
    c = _counts(cell, cfg, 16)
    assert c['model_flops'] > 0
    assert all(b > 0 and f > 0 for v in c['cem'].values() for b, f in v)
