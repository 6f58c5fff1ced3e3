"""The port's explorable-JPEG training CLI end to end on the CPU
(``--device cpu``) at a tiny size (nf 16, nb 3, patch 64, batch 2): the Y
phase trains, validates, checkpoints and resumes, its controller's D
verification survives the resume and lets dual G steps through, the
chroma phase conditions on the Y checkpoint (or on exsr's generator
exported as ``.npz``), and ``eval_jpeg --checkpoint`` loads what it wrote.
Its flags are exsr's, with the same defaults, plus ``--device``; without
it the CLI runs on CUDA.

exsr's CLI is not run here: its trainers are held to the port's step by
step in ``tests/test_torch_decomp.py`` and
``tests/test_torch_decomp_chroma.py``.
"""
import ast
import json
import os
import pathlib

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from exsr_torch.apps import eval_jpeg, train_jpeg
from exsr_torch.train.checkpoints import CheckpointManager
from exsr_torch.utils.logging import MetricLog

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = ['--patch', '64', '--batch', '2', '--nf', '16', '--nb', '3',
        '--print_freq', '1', '--ckpt_freq', '1', '--device', 'cpu']


@pytest.fixture(autouse=True, scope='module')
def _two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope='module')
def images(tmp_path_factory):
    root = tmp_path_factory.mktemp('train_jpeg')
    rng = np.random.default_rng(0)
    for i in range(4):
        Image.fromarray((rng.uniform(size=(72, 80, 3)) * 255)
                        .astype(np.uint8)).save(root / f'im{i}.png')
    return str(root)


def _log(exp):
    return MetricLog().load(os.path.join(exp, 'logs.npz'))


@pytest.fixture(scope='module')
def y_run(images, tmp_path_factory):
    """Nine Y steps with validation at the last; then the controller state
    of the last checkpoint marked verified, and a resume to step 12: its
    step 10 runs a dual D step and a dual G step."""
    exp = str(tmp_path_factory.mktemp('y') / 'exp')
    base = ['--data_dir', images, '--val_dir', images, '--exp_dir', exp,
            '--val_freq', '9'] + TINY
    train_jpeg.main(base + ['--niter', '9'])
    first = _log(exp)
    ckpt = CheckpointManager(os.path.join(exp, 'ckpt'))
    steps = ckpt.all_steps()
    path = os.path.join(exp, 'ckpt', '9.pt')
    raw = torch.load(path, weights_only=True)
    ctl = dict(raw['controller'])
    raw['controller'] = {**ctl, 'd_verified': True,
                         'generator_started_learning': True,
                         'verified_d_saved': True}
    torch.save(raw, path)
    train_jpeg.main(base + ['--niter', '12', '--resume'])
    return dict(exp=exp, first=first, steps=steps, controller=ctl,
                log=_log(exp), g_params=raw['g_params'])


def test_y_phase_trains_validates_and_checkpoints(y_run):
    first = y_run['first']
    assert first.last('psnr_val') is not None
    assert np.isfinite(first.last('per_pix_STD_val'))
    assert first.last('l_d_total') is not None     # D stepped
    assert first.last('l_g_total') is None         # the gate held G back
    assert y_run['steps'] == [7, 8, 9]              # the newest three
    assert y_run['controller']['step'] == 9
    assert set(y_run['controller']) == {'step', 'generator_started_learning',
                                        'verified_d_saved', 'd_verified'}


def test_resume_keeps_the_verified_gate_and_runs_dual_g_steps(y_run):
    log = y_run['log']
    # step 10's metrics are read after step 11 is enqueued and logged
    # with it, at 12
    assert [s for s, _ in log.series['l_g_optimalZ']] == [12]
    assert np.isfinite(log.last('l_g_total'))
    raw = CheckpointManager(os.path.join(y_run['exp'], 'ckpt')).restore_raw()
    assert raw['step'] == 12 and raw['controller']['d_verified']
    # the G step moved the generator and its running statistics
    moved = [k for k, v in raw['g_params'].items()
             if not torch.equal(v, y_run['g_params'][k])]
    assert any('running_mean' in k for k in moved)
    assert any(k.endswith('weight') for k in moved)


def test_eval_jpeg_loads_the_y_checkpoint(y_run, images, tmp_path):
    summary = eval_jpeg.main([
        '--data_dir', images, '--nf', '16', '--nb', '3', '--qf', '10',
        '--checkpoint', os.path.join(y_run['exp'], 'ckpt'),
        '--device', 'cpu', '--out_dir', str(tmp_path / 'eval')])
    assert all(np.isfinite(v) for v in summary.values())
    with open(tmp_path / 'eval' / 'summary.json') as f:
        per_image = json.load(f)['per_image']
    assert all(r['bin_consistency_max'] <= 0.5 + 1e-5 for r in per_image)


def test_chroma_phase_on_the_y_checkpoint_and_on_exsr_npz(y_run, images,
                                                          tmp_path, capsys):
    exp = str(tmp_path / 'chroma')
    base = ['--data_dir', images, '--val_dir', images, '--exp_dir', exp,
            '--val_freq', '2', '--chroma'] + TINY
    train_jpeg.main(base + ['--niter', '2', '--y_ckpt',
                            os.path.join(y_run['exp'], 'ckpt')])
    out = capsys.readouterr().out
    assert 'conditioning on Y generator from' in out
    log = _log(exp)
    for key in ('psnr_chroma_val', 'l_d_total', 'l_g_pix', 'l_g_gan'):
        assert np.isfinite(log.last(key)), key
    assert CheckpointManager(os.path.join(exp, 'ckpt')).latest_step() == 2
    train_jpeg.main(base + ['--niter', '3', '--resume'])
    assert 'resumed at step 2' in capsys.readouterr().out
    # exsr's seeded Y generator exported as .npz, as the README shows
    from exsr.models.dncnn import DnCNN as JDnCNN, DnCNNConfig as JConfig
    import jax.numpy as jnp
    g_vars = JDnCNN(JConfig(n_channels=16, depth=3,
                            num_latent_channels=64)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 64)),
        jnp.zeros((1, 8, 8, 64)))
    flat = {'/'.join(str(getattr(k, 'key', k)) for k in path):
            np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(g_vars)[0]}
    npz = str(tmp_path / 'g.npz')
    np.savez(npz, **flat)
    train_jpeg.main(['--data_dir', images, '--exp_dir',
                     str(tmp_path / 'chroma_npz'), '--chroma', '--niter',
                     '1', '--y_ckpt', npz] + TINY)
    assert f'conditioning on Y generator from {npz}' in \
        capsys.readouterr().out


def _exsr_flags() -> dict:
    """exsr's train_jpeg flags and their defaults, read from its source
    (its parser is built inside ``main``)."""
    tree = ast.parse((ROOT / 'exsr/apps/train_jpeg.py').read_text())
    flags = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(
                node.func, 'attr', None) == 'add_argument':
            kw = {k.arg: k.value for k in node.keywords}
            if 'default' in kw:
                default = ast.literal_eval(kw['default'])
            else:
                store_true = ast.literal_eval(kw.get('action', ast.Constant(
                    None))) == 'store_true'
                default = False if store_true else None
            flags[node.args[0].value] = default
    return flags


def test_every_exsr_flag_with_its_default_and_device():
    ref = _exsr_flags()
    parser = train_jpeg._parser()
    mine = {a.option_strings[0]: a.default for a in parser._actions
            if a.option_strings and a.option_strings[0] != '-h'}
    assert set(mine) == set(ref) | {'--device'}
    for flag, default in ref.items():
        assert mine[flag] == default, flag
    assert len(ref) >= 20


def test_runs_on_cuda_by_default(images, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for extra in ([], ['--chroma']):
        with pytest.raises(RuntimeError, match='CUDA'):
            train_jpeg.main(['--data_dir', images, '--exp_dir',
                             str(tmp_path / 'x'), *extra])
