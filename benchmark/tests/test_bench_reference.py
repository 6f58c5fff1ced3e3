"""Each plain reference against the port's plain CPU path at a tiny
size, on the weights the benchmark makes."""
import numpy as np
import pytest
import torch

from benchmark import traffic, weights
from benchmark.drivers.serve import img_rms_errors, reference_outputs
from benchmark.reference import cem as rcem
from benchmark.reference import msrresnet_x4, rrdb_x4
from benchmark.run import load_cell

CPU = torch.device('cpu')


def test_cem_taps_match_the_port():
    from exsr_torch.cem.cem import CEM, CEMConf
    port = CEM.create(CEMConf(scale_factor=4))
    mine = rcem.cem_taps(4)
    np.testing.assert_array_equal(mine.ds_kernel, port.ds_kernel)
    np.testing.assert_array_equal(mine.inv_hth, port.inv_hth)
    assert mine.margins_lr == port.invalidity_margins_lr == 10


def test_plain_cem_matches_the_port():
    from exsr_torch.cem.cem import CEM, CEMConf
    filt = CEM.create(CEMConf(scale_factor=4)).device_filters(3, 'cpu')
    gen = torch.Generator().manual_seed(0)
    lr = torch.rand(2, 20, 24, 3, generator=gen)
    g = torch.rand(2, 80, 96, 3, generator=gen)
    mine = rcem.PlainCem(rcem.cem_taps(4)).enforce(lr, g)
    assert (mine.float() - filt.enforce(lr, g)).abs().max() < 1e-5


@pytest.mark.parametrize('ref_mod,arch', [(rrdb_x4, 'rrdb'),
                                          (msrresnet_x4, 'msrresnet')])
def test_generator_matches_the_port_module(ref_mod, arch):
    cell, cfg = load_cell('rrdb_x4.serve_bf16' if arch == 'rrdb'
                          else 'msrresnet_x4.serve_fp32')
    cfg['nb'] = 2
    state = weights.make(ref_mod.shapes(cfg), cfg['init'], 7, CPU)
    if arch == 'rrdb':
        from exsr_torch.models.rrdb import RRDBNet
        net = RRDBNet(nf=64, nb=2, upscale=4, latent_channels=3)
    else:
        from exsr_torch.models.classifiers import MSRResNet
        net = MSRResNet(nf=64, nb=2, upscale=4)
    net.load_state_dict(state)
    gen = torch.Generator().manual_seed(1)
    lr = torch.rand(2, 10, 12, 3, generator=gen)
    z = torch.rand(2, 40, 48, 3, generator=gen) * 2 - 1
    with torch.no_grad():
        port = net(lr, z) if arch == 'rrdb' else net(lr)
        mine = ref_mod.generator(state, cfg)(lr, z)
    assert mine.shape == port.shape
    assert (mine - port).abs().max() < 1e-5 * port.abs().max()


@pytest.mark.parametrize('name', ['rrdb_x4.eval_fp32',
                                  'msrresnet_x4.serve_fp32'])
def test_served_outputs_match_the_port_fp32(name):
    """The whole served path (pre-pad, generator, CEM, crop, clamp) on the
    CPU, where the port's kernels run their plain versions."""
    from exsr_torch.apps.eval_sr import bucketed_sweep, build_model
    cell, cfg = load_cell(name)
    cfg['nb'] = 1
    cell['traffic'].update(lr_h=12, lr_w=16, pool=1)
    ref_mod = rrdb_x4 if cfg['arch'] == 'RRDB_net' else msrresnet_x4
    state = weights.make(ref_mod.shapes(cfg), cfg['init'], 3, CPU)
    _, fwd = build_model(4, 1, latent_channels=cfg['latent_channels'],
                         nf=64, device='cpu', params=state, arch=cfg['arch'])
    (lr, zs), = traffic.requests(cell['traffic'], cfg['latent_channels'], 4,
                                 3)
    outs = bucketed_sweep(fwd, lr, zs)
    ref = reference_outputs(cell, cfg, ref_mod, state, lr, zs, CPU)
    assert len(outs) == len(zs) == ref.shape[0]
    assert max(img_rms_errors(outs, ref)) < 1e-6


def test_traffic_is_the_same_work_on_every_seed():
    cell, _ = load_cell('rrdb_x4.serve_bf16')
    a = traffic.requests(cell['traffic'], 3, 4, 1)
    b = traffic.requests(cell['traffic'], 3, 4, 2 ** 31 + 9)
    assert [x[0].shape for x in a] == [x[0].shape for x in b]
    assert len(a[0][1]) == len(b[0][1]) == 15
    assert not np.array_equal(a[0][0], b[0][0])
    c = traffic.requests(cell['traffic'], 3, 4, 1)
    np.testing.assert_array_equal(a[3][0], c[3][0])
    assert 0.0 <= a[0][0].min() and a[0][0].max() <= 1.0


def test_rrdb_shapes_count_the_published_parameters():
    cfg = load_cell('rrdb_x4.serve_bf16')[1]
    from exsr_torch.models.rrdb import RRDBNet
    port = RRDBNet(nf=64, nb=23, upscale=4, latent_channels=3).state_dict()
    shapes = rrdb_x4.shapes(cfg)
    assert shapes == {k: tuple(v.shape) for k, v in port.items()}
    assert sum(int(np.prod(s)) for s in shapes.values()) == \
        cfg['parameters'] == 17_060_948


def test_weights_repeat_from_the_seed():
    cfg = load_cell('msrresnet_x4.serve_fp32')[1]
    shapes = msrresnet_x4.shapes(cfg)
    a = weights.make(shapes, cfg['init'], 2 ** 31 + 5, CPU)
    b = weights.make(shapes, cfg['init'], 2 ** 31 + 5, CPU)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert sum(v.numel() for v in a.values()) == cfg['parameters']
    w = a['rb0_conv1.weight']
    assert w.std().item() == pytest.approx(0.4 * (2 / 576) ** 0.5, rel=0.05)
