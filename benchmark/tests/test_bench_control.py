"""The control of each cell, the reference put in the program's place at
the precision below the cell's, comes out not correct: on the CPU at a
size a test run holds, and, marked ``cuda``, on the card at the cell's
own size (``benchmark.calibrate`` prints the same readings)."""
import importlib

import pytest
import torch

from benchmark import traffic, weights
from benchmark.drivers.serve import img_rms_errors, reference_outputs
from benchmark.run import load_cell

CELLS = ['rrdb_x4.serve_bf16', 'msrresnet_x4.serve_fp32',
         'rrdb_x4.eval_fp32']


def reading(name, seed, device, traffic_sizes=None, precision=None):
    """The compared number of the control (or of the reference at
    ``precision``) on the first request of ``seed``."""
    cell, cfg = load_cell(name)
    cell['traffic'].update(traffic_sizes or {})
    ref_mod = importlib.import_module(f'benchmark.reference.{cfg["name"]}')
    state = weights.make(ref_mod.shapes(cfg), cfg['init'], seed, device)
    (lr, zs), = traffic.requests(dict(cell['traffic'], pool=1),
                                 cfg['latent_channels'], cfg['scale'], seed)
    ref = reference_outputs(cell, cfg, ref_mod, state, lr, zs, device)
    ctl = reference_outputs(cell, cfg, ref_mod, state, lr, zs, device,
                            precision=precision or cell['check']['control'])
    return max(img_rms_errors(list(ctl[:, None]), ref)), \
        cell['check']['limits']['img_rms_err']


@pytest.mark.parametrize('name', CELLS)
def test_control_fails_on_the_cpu(name):
    # the published depth, a small image and three Z values
    value, limit = reading(name, 2 ** 31 + 3, torch.device('cpu'),
                           {'lr_h': 12, 'lr_w': 16, 'num_z': 3})
    assert value > limit


@pytest.mark.cuda
@pytest.mark.parametrize('name', CELLS + ['rrdb_x4.train_dual'])
def test_control_fails_at_the_cells_size(name):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    cell, cfg = load_cell(name)
    ref_mod = importlib.import_module(f'benchmark.reference.{cfg["name"]}')
    driver = importlib.import_module(f'benchmark.drivers.{cell["driver"]}')
    limits = cell['check']['limits']
    for seed in (11, 12, 13):
        got = driver.control_reading(cell, cfg, ref_mod, seed,
                                     torch.device('cuda', 0))
        assert any(got[k] > limits[k] for k in limits)
