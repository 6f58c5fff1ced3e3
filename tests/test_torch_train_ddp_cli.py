"""``train_sr`` and ``train_jpeg`` (Y, then ``--chroma``) under
``python -m torch.distributed.run --nproc_per_node 2`` with ``--device
cpu`` (gloo ranks), at a tiny size, for a few iterations on a few
synthetic PNGs, against the same CLI in one process.

Each rank runs through a small guard script that fails the rank when any
rank but 0 opens a file for writing, replaces one or makes a directory
under the experiment directory: only rank 0 writes.  Both ranks print the
step they finished at, which must agree.  The checkpoints are held to the
one-process run's at every saved step: the Adam moments (linear in the
gradients; the weights themselves move by Adam's near-sign first step)
within 1e-4 of the largest element of the optimizer's; at the first step
the running statistics and the L_struct ring within 1e-5 too (later, the
critic's conv biases in front of batch norm, whose gradients are of
rounding size, have taken Adam steps of either sign, and the running
means carry them).  A ``--batch`` that the world size does not divide
raises.

The ranks join through ``env://``, the launcher's ``--standalone``
rendezvous on a free local port, so that parallel test workers never
collide.  Each launch runs under its own time limit.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from exsr_torch.apps import train_jpeg, train_sr
from exsr_torch.train.checkpoints import CheckpointManager

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_TIMEOUT = 120
MOMENT_TOL, STATS_TOL = 1e-4, 1e-5

SR_TINY = ['--scale', '4', '--patch', '112', '--batch', '2', '--nb', '1',
           '--nf', '8', '--gc', '4', '--d_nb', '4', '--d_nf', '8',
           '--d_strides', '1', '--print_freq', '1', '--ckpt_freq', '2',
           '--niter', '3', '--device', 'cpu']
JPEG_TINY = ['--patch', '64', '--batch', '2', '--nf', '16', '--nb', '3',
             '--print_freq', '1', '--ckpt_freq', '2', '--niter', '3',
             '--device', 'cpu']

GUARD = '''
import builtins, io, os, runpy, sys
exp = os.path.abspath(sys.argv[2])
if os.environ['RANK'] != '0':
    def _inside(path):
        return os.path.abspath(os.fspath(path)).startswith(exp)

    def _guard(real, check):
        def wrapped(*a, **k):
            if check(*a, **k):
                raise AssertionError(f'rank {os.environ["RANK"]} wrote {a[0]}')
            return real(*a, **k)
        return wrapped
    writes = lambda f, mode='r', *a, **k: (
        isinstance(f, (str, bytes, os.PathLike)) and _inside(f)
        and any(c in mode for c in 'wax+'))
    builtins.open = io.open = _guard(io.open, writes)
    os.replace = _guard(os.replace, lambda s, d, *a, **k: _inside(d))
    os.makedirs = _guard(os.makedirs, lambda p, *a, **k: _inside(p))
sys.argv = [sys.argv[1]] + sys.argv[3:]
runpy.run_module(sys.argv[0], run_name='__main__', alter_sys=True)
'''


@pytest.fixture(scope='module')
def images(tmp_path_factory):
    root = tmp_path_factory.mktemp('ddp_cli')
    rng = np.random.default_rng(0)
    for i in range(4):
        Image.fromarray((rng.uniform(size=(128, 128, 3)) * 255)
                        .astype(np.uint8)).save(root / f'im{i}.png')
    return str(root)


def _launch(tmp_path, module: str, exp: str, args: list, world: int = 2):
    """``module``'s ``main`` on ``world`` gloo ranks; the launcher's
    return code and output."""
    guard = tmp_path / 'rank_guard.py'
    guard.write_text(GUARD)
    cmd = [sys.executable, '-m', 'torch.distributed.run', '--standalone',
           '--nproc_per_node', str(world), str(guard), module, exp,
           '--exp_dir', exp, *args]
    # one thread a rank: the ranks share one test worker's CPU share
    env = {**os.environ, 'OMP_NUM_THREADS': '1',
           'PYTHONPATH': os.pathsep.join([ROOT,
                                          os.environ.get('PYTHONPATH', '')])}
    try:
        done = subprocess.run(cmd, env=env, cwd=str(tmp_path),
                              capture_output=True, text=True,
                              timeout=LAUNCH_TIMEOUT)
    except subprocess.TimeoutExpired as e:
        raise AssertionError(f'ranks ran past {LAUNCH_TIMEOUT} s: '
                             f'{(e.stdout or "")[-3000:]}')
    return done.returncode, done.stdout + done.stderr


def _finished_steps(out: str, marker: str) -> list:
    return [int(line.rsplit(' ', 1)[1]) for line in out.splitlines()
            if marker in line]


def _flat(tree, prefix=''):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f'{prefix}{k}/'))
        return out
    if isinstance(tree, (list, tuple)):
        return _flat(dict(enumerate(tree)), prefix)
    return {prefix[:-1]: tree} if isinstance(tree, torch.Tensor) else {}


def _compare_checkpoints(got_dir: str, want_dir: str) -> None:
    got = CheckpointManager(got_dir)
    want = CheckpointManager(want_dir)
    assert got.all_steps() == want.all_steps()
    for step in got.all_steps():
        _compare_step(_flat(got.restore_raw(step)),
                      _flat(want.restore_raw(step)),
                      stats=step == got.all_steps()[0])


def _compare_step(a: dict, b: dict, stats: bool) -> None:
    assert a.keys() == b.keys()
    for kind in ('exp_avg', 'exp_avg_sq'):
        # as the gradients are held: against the largest element of all
        # of an optimizer's moments (a conv bias in front of batch norm
        # has a gradient of rounding size, whatever its sign)
        for opt in ('d_opt/', 'g_opt/'):
            keys = [k for k in b if k.startswith(opt) and k.endswith(kind)]
            if not keys:
                continue
            scale = max(float(b[k].abs().max()) for k in keys)
            err = max(float((a[k] - b[k]).abs().max()) for k in keys)
            assert err <= MOMENT_TOL * scale, (opt, kind, err, scale)
    for k in b if stats else ():
        if 'running' in k or k.startswith('ratio_stats'):
            assert float((a[k].double() - b[k].double()).abs().max()) \
                < STATS_TOL, k


def _one_and_two(images, tmp_path, module, cli, args, marker):
    exp1, exp2 = str(tmp_path / 'one'), str(tmp_path / 'two')
    cli.main(args + ['--exp_dir', exp1])
    rc, out = _launch(tmp_path, module, exp2, args)
    assert rc == 0, out[-5000:]
    steps = _finished_steps(out, marker)
    assert steps == [3, 3], out[-3000:]
    _compare_checkpoints(os.path.join(exp2, 'ckpt'),
                         os.path.join(exp1, 'ckpt'))
    assert sorted(os.listdir(exp2)) == sorted(os.listdir(exp1))
    return exp2


def test_train_sr_on_two_ranks_matches_one_process(images, tmp_path):
    args = ['--hr_dir', images, '--val_hr_dir', images, '--val_freq', '3',
            *SR_TINY]
    _one_and_two(images, tmp_path, 'exsr_torch.apps.train_sr', train_sr,
                 args, 'training done at step')


def test_train_jpeg_y_on_two_ranks_matches_one_process(images, tmp_path):
    args = ['--data_dir', images, '--val_dir', images, '--val_freq', '3',
            *JPEG_TINY]
    _one_and_two(images, tmp_path, 'exsr_torch.apps.train_jpeg',
                 train_jpeg, args, 'JPEG training done at step')


def test_train_jpeg_chroma_on_two_ranks_matches_one_process(images,
                                                            tmp_path):
    args = ['--data_dir', images, '--chroma', *JPEG_TINY]
    _one_and_two(images, tmp_path, 'exsr_torch.apps.train_jpeg',
                 train_jpeg, args, 'chroma training done at step')


def test_batch_the_world_size_does_not_divide_raises(images, tmp_path):
    args = ['--hr_dir', images, *SR_TINY]
    args[args.index('--batch') + 1] = '3'
    rc, out = _launch(tmp_path, 'exsr_torch.apps.train_sr',
                      str(tmp_path / 'exp'), args)
    assert rc != 0
    assert 'cannot be split over 2 ranks' in out
    assert not os.path.exists(tmp_path / 'exp' / 'ckpt')
