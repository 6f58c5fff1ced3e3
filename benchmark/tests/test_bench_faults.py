"""A run driven with the timed path broken underneath comes out not
correct; the sound path comes out correct.  The harness's look for a
card is skipped: the runs are on the CPU at the published depth, on a
small image (LR 16 x 24) and a sweep of three Z values, through
``benchmark.run.execute``.  (At one RRDB the sweep's outputs differ by
less than the limit: Z acts through the depth.)"""
import pytest
import torch

from benchmark import run
from benchmark.faults import Serve as Program

SMALL = {'lr_h': 16, 'lr_w': 24, 'pool': 2}


def _run(name, program):
    traffic = dict(SMALL, num_z=3) if name.startswith('rrdb') else SMALL
    return run.execute(name, 2 ** 31 + 77, 0.5, False, torch.device('cpu'),
                       program=program, resize={'traffic': traffic})


@pytest.mark.parametrize('name,fault', [
    ('rrdb_x4.serve_bf16', 'altered'), ('rrdb_x4.serve_bf16', 'half_batch'),
    ('rrdb_x4.eval_fp32', 'altered'), ('rrdb_x4.eval_fp32', 'half_batch'),
    ('msrresnet_x4.serve_fp32', 'altered')])
def test_planted_fault_is_not_correct(name, fault):
    out = _run(name, Program(fault))
    assert out['correct'] is False
    (check,) = out['checks'].values()
    assert check['value'] > check['limit']


@pytest.mark.parametrize('name', ['rrdb_x4.serve_bf16', 'rrdb_x4.eval_fp32',
                                  'msrresnet_x4.serve_fp32'])
def test_sound_path_is_correct(name):
    out = _run(name, Program())
    assert out['correct'] is True and out['failed'] == 0
    assert out['attempted'] >= 1
    assert list(out)[-1] == 'checks'
    fam = run.load_cell(name)[0]['family']
    assert set(out['metrics']) >= {f'{fam}_img_per_s', 'setup_s'}
