"""The port's training CLI end to end on the CPU (``--device cpu``), at a
tiny size, and the host pieces it runs on: the data loader, the metric
log and its dashboards, the one-transfer metric fetch, the SIGINT stop and
the typed option layer, the last few held to exsr's.

exsr's own CLI is not run here (its trainer is held to the port's step by
step in ``tests/test_torch_train.py``); these tests check what the CLI
adds: the controller's gating, checkpoints and resume, validation, the
architectures an options file selects, and accumulation.
"""
import json
import os
import signal

import numpy as np
import pytest
import torch
from PIL import Image

from exsr_torch.apps import train_sr
from exsr_torch.train.checkpoints import CheckpointManager
from exsr_torch.utils.logging import MetricLog

TINY = ['--scale', '4', '--patch', '112', '--batch', '2', '--nb', '1',
        '--nf', '8', '--gc', '4', '--d_nb', '4', '--d_nf', '8',
        '--d_strides', '1', '--print_freq', '1', '--device', 'cpu']


@pytest.fixture(autouse=True, scope='module')
def _two_threads():
    """Two intra-op threads for this file's tests: under the suite's
    parallel workers, torch's default of one thread per core spins them
    against each other (this file's wall time fell threefold)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope='module')
def images(tmp_path_factory):
    root = tmp_path_factory.mktemp('train_cli')
    rng = np.random.default_rng(0)
    hr = root / 'hr'
    hr.mkdir()
    for i in range(3):
        Image.fromarray((rng.uniform(size=(128, 128, 3)) * 255)
                        .astype(np.uint8)).save(hr / f'im{i}.png')
    return root


def _log(exp):
    return MetricLog().load(os.path.join(exp, 'logs.npz'))


def _steps(log, key):
    return [int(s) for s, _ in log.series.get(key, [])]


def test_cli_trains_validates_checkpoints_and_resumes(images, tmp_path,
                                                      capsys):
    exp = str(tmp_path / 'exp')
    args = ['--hr_dir', str(images / 'hr'), '--val_hr_dir',
            str(images / 'hr'), '--exp_dir', exp, '--val_freq', '2',
            '--ckpt_freq', '2'] + TINY
    train_sr.main(args + ['--niter', '3'])
    log = _log(exp)
    assert log.last('psnr_val') is not None      # validation ran
    assert np.isfinite(log.last('per_pix_STD_val'))
    assert log.last('l_d_total') is not None     # D stepped
    assert log.last('l_g_total') is None         # the gate held G back
    assert any(f.endswith('.pdf') for f in
               os.listdir(os.path.join(exp, 'dashboards')))
    # the first step, every second one, and the final forced save
    assert CheckpointManager(os.path.join(exp, 'ckpt')).all_steps() == \
        [1, 2, 3]
    assert 'collapse_guard armed: True' in capsys.readouterr().out
    train_sr.main(args + ['--niter', '5', '--resume'])
    assert 'resumed at step 3' in capsys.readouterr().out
    log = _log(exp)
    assert max(_steps(log, 'l_d_total')) == 5
    assert _steps(log, 'steps_per_s') == [1, 2, 3, 4, 5]
    ctl = CheckpointManager(os.path.join(exp, 'ckpt')).restore(
        with_controller=True)[1]
    assert ctl['step'] == 5 and ctl['lr_scale'] == 1.0


def test_cli_init_phase_then_gan_resume(images, tmp_path):
    """G-only pixel + range pretraining, then the GAN phase from its
    checkpoint: the generator has started learning, so the D steps are
    dual (their MAP fakes logged as fake 0 and 1)."""
    exp = str(tmp_path / 'exp')
    args = ['--hr_dir', str(images / 'hr'), '--exp_dir', exp,
            '--ckpt_freq', '1'] + TINY
    train_sr.main(args + ['--init_phase', '--niter', '2'])
    log = _log(exp)
    assert log.last('l_g_pix') is not None and log.last('l_d_total') is None
    train_sr.main(args + ['--niter', '4', '--resume'])
    log = _log(exp)
    assert _steps(log, 'l_d_total') == [4]
    assert log.last('l_d_fake_1') is not None     # a dual D step


def test_cli_accumulation_flags(images, tmp_path):
    exp = str(tmp_path / 'exp')
    train_sr.main(['--hr_dir', str(images / 'hr'), '--exp_dir', exp,
                   '--niter', '2', '--accum_g', '2', '--accum_d', '2']
                  + TINY)
    assert _log(exp).last('l_d_total') is not None


def _opt(tmp_path, images, name, g, d, train, patch=64):
    opt = {'name': name, 'model': 'srragan', 'scale': 4,
           'datasets': {'train': {
               'name': 't', 'mode': 'LRHR',
               'dataroot_HR': str(images / 'hr'), 'dataroot_LR': None,
               'batch_size': 2, 'patch_size': patch, 'use_flip': True,
               'use_rot': True, 'n_workers': 0}},
           'path': {'root': str(tmp_path)},
           'network_G': g, 'network_D': d,
           # three steps: G first runs at step 1 and its metrics are
           # logged with the next step's
           'train': {'lr_G': 1e-4, 'lr_D': 1e-4, 'niter': 3,
                     'D_update_ratio': 1, 'lr_steps': [], 'lr_gamma': 0.5,
                     **train}}
    path = tmp_path / f'{name}.json'
    path.write_text(json.dumps(opt))
    return str(path)


VGG_D = {'which_model_D': 'discriminator_vgg_128', 'norm_type': 'batch',
         'nf': 8, 'in_nc': 3, 'n_layers': 4, 'num_2_strides': 1}
GAN_TRAIN = {'gan_type': 'vanilla', 'gan_weight': 0.005,
             'pixel_weight': 0.01, 'pixel_criterion': 'l1'}


@pytest.mark.parametrize('variant', ['esrgan', 'msrresnet', 'decomposed'])
def test_cli_opt_architectures(images, tmp_path, variant, capsys):
    """The architectures an options file selects: the plain ESRGAN (no
    CEM, no Z, the VGG feature loss on random weights), ``MSRResNet``
    (the older ``DTE_arch`` flag) and the decomposed PatchGAN judging the
    CEM's (low, high) pair."""
    if variant == 'esrgan':
        g = {'which_model_G': 'RRDB_net', 'CEM_arch': 0,
             'latent_input': 'None', 'latent_channels': 0, 'nf': 8,
             'nb': 1, 'in_nc': 3, 'out_nc': 3, 'gc': 4}
        d, train = VGG_D, dict(GAN_TRAIN, feature_weight=1.0)
    elif variant == 'msrresnet':
        g = {'which_model_G': 'MSRResNet', 'DTE_arch': 0,
             'latent_input': 'None', 'latent_channels': 0, 'nf': 8,
             'nb': 2, 'in_nc': 3, 'out_nc': 3}
        d, train = VGG_D, GAN_TRAIN
    else:
        g = {'which_model_G': 'RRDB_net', 'CEM_arch': 1,
             'latent_input': 'all_layers',
             'latent_channels': 'SVDinNormedOut_structure_tensor',
             'nf': 8, 'nb': 1, 'gc': 4}
        d = {'which_model_D': 'PatchGAN', 'decomposed_input': 1,
             'pre_clipping': 1, 'nf': 8, 'n_layers': 3}
        train = {'gan_type': 'wgan-gp', 'range_weight': 5000,
                 'latent_weight': 1, 'optimalZ_loss_weight': 100}
    opt = _opt(tmp_path, images, variant, g, d, train,
               patch=112 if variant == 'decomposed' else 64)
    exp = str(tmp_path / 'exp')
    train_sr.main(['--opt', opt, '--hr_dir', str(images / 'hr'),
                   '--exp_dir', exp, '--print_freq', '1', '--device',
                   'cpu'])
    log = _log(exp)
    assert log.last('l_d_total') is not None and log.last('l_g_total') \
        is not None
    out = capsys.readouterr().out
    if variant == 'esrgan':
        assert log.last('l_g_fea') is not None and 'RANDOM VGG' in out
    if variant == 'decomposed':
        assert log.last('l_d_gp_0') is not None
    state = CheckpointManager(os.path.join(exp, 'ckpt')).restore()
    names = ' '.join(state['d_vars'])
    assert ('proj1' in names) == (variant == 'decomposed')
    assert ('rb0_conv1' in ' '.join(state['g_params'])) == \
        (variant == 'msrresnet')


@pytest.mark.parametrize('gamma,stops', [(0.5, False), (1e-5, True)])
def test_cli_rollback_and_lr_stop(images, tmp_path, capsys, gamma, stops):
    """The D-loss-STD trigger armed at any spread (``std_4_lr_drop``
    1e-12, a window of 2): at step 6 the run rolls back to the newest
    checkpoint at or before step 4 with the learning rate scaled by
    ``lr_gamma``; a scale that takes the rate below 1e-8 stops the run
    there instead."""
    g = {'which_model_G': 'RRDB_net', 'CEM_arch': 1,
         'latent_input': 'all_layers',
         'latent_channels': 'SVDinNormedOut_structure_tensor', 'nf': 8,
         'nb': 1, 'gc': 4}
    opt = _opt(tmp_path, images, 'rollback', g, VGG_D,
               {'gan_type': 'wgan-gp', 'range_weight': 5000,
                'latent_weight': 1, 'steps_4_loss_std': 2,
                'std_4_lr_drop': 1e-12, 'lr_gamma': gamma}, patch=112)
    exp = str(tmp_path / 'exp')
    train_sr.main(['--opt', opt, '--hr_dir', str(images / 'hr'),
                   '--exp_dir', exp, '--print_freq', '1', '--device',
                   'cpu', '--ckpt_freq', '1', '--niter', '7',
                   '--no-collapse_guard'])
    out = capsys.readouterr().out
    log = _log(exp)
    if stops:
        # it returns at once, as exsr's does: no final save
        assert 'LR below 1e-8' in out and 'training done' not in out
        assert max(_steps(log, 'steps_per_s')) == 5
        return
    assert _steps(log, 'D_loss_STD') == [6]    # 4 D records by then
    assert 'instability rollback to step 4, lr_scale=0.5' in out
    assert log.series['rollback_lr_scale'] == [(6, 0.5)]
    ctl = CheckpointManager(os.path.join(exp, 'ckpt')).restore(
        with_controller=True)[1]
    assert ctl['lr_scale'] == 0.5


def test_cli_warm_g_from_port_checkpoint_and_exsr_npz(images, tmp_path):
    """--warm_g: a port checkpoint directory or an exsr generator exported
    as .npz; the first GAN-phase step is D-only (the gate is closed), so
    the new run's G equals the warm start exactly; --resume ignores it."""
    import jax
    import jax.numpy as jnp
    from exsr.models.rrdb import RRDBNet as JNet
    from exsr_torch.models.convert import from_exsr_params
    base = ['--hr_dir', str(images / 'hr'), '--ckpt_freq', '1'] + TINY
    exp1 = str(tmp_path / 'exp1')
    train_sr.main(base + ['--exp_dir', exp1, '--init_phase', '--niter',
                          '1'])
    jparams = JNet(nb=1, nf=8, gc=4, latent_channels=3).init(
        jax.random.PRNGKey(3), jnp.zeros((1, 28, 28, 3)),
        jnp.zeros((1, 112, 112, 3)))
    flat = {'/'.join(str(getattr(k, 'key', k)) for k in key): np.asarray(v)
            for key, v in jax.tree_util.tree_flatten_with_path(
                jparams['params'])[0]}
    npz = str(tmp_path / 'g.npz')
    np.savez(npz, **flat)
    for src, want in ((os.path.join(exp1, 'ckpt'),
                       CheckpointManager(os.path.join(exp1, 'ckpt'))
                       .restore()['g_params']),
                      (npz, from_exsr_params(jax.tree.map(np.asarray,
                                                          jparams)))):
        exp2 = str(tmp_path / f'exp2_{os.path.basename(src)}')
        train_sr.main(base + ['--exp_dir', exp2, '--warm_g', src,
                              '--niter', '1'])
        got = CheckpointManager(os.path.join(exp2, 'ckpt')).restore()
        for k, v in want.items():
            assert torch.equal(got['g_params'][k], v), k
    train_sr.main(base + ['--exp_dir', exp2, '--warm_g', npz, '--niter',
                          '2', '--resume'])


def test_cli_runs_on_cuda_by_default(images, tmp_path):
    if torch.cuda.is_available():
        pytest.skip('the default device is present')
    with pytest.raises(RuntimeError, match='CUDA'):
        train_sr.main(['--hr_dir', str(images / 'hr'), '--exp_dir',
                       str(tmp_path / 'exp')])


def test_cli_has_every_flag_of_exsr():
    import exsr.apps.train_sr as J
    src = open(J.__file__).read()
    import re
    flags = set(re.findall(r"add_argument\('(--[a-z_0-9]+)'", src))
    ours = {a for act in train_sr._parser()._actions
            for a in act.option_strings}
    assert flags and flags <= ours
    assert '--device' in ours


# ------------------------------------------------------------ host pieces
class _Items:
    """A dataset whose items record their index and a draw of the rng the
    loader hands them."""

    def __len__(self):
        return 7

    def __getitem__(self, idx, rng=None):
        return {'i': np.int64(idx), 'u': np.float64(rng.uniform()),
                'path': f'p{idx}'}


def test_data_loader_matches_exsr_and_is_deterministic():
    from exsr.data.datasets import DataLoader as JLoader
    from exsr_torch.data.datasets import DataLoader
    for threads in (1, 4):
        ours = [b for e in range(3) for b in DataLoader(
            _Items(), 2, seed=5, num_threads=threads).epoch(e)]
        theirs = [b for e in range(3) for b in JLoader(
            _Items(), 2, seed=5, num_threads=2).epoch(e)]
        assert len(ours) == 9
        for a, b in zip(ours, theirs):
            assert np.array_equal(a['i'], b['i'])
            assert np.array_equal(a['u'], b['u'])
            assert a['path'] == b['path']
    stream = DataLoader(_Items(), 2, seed=5).stream(1)
    for a, b in zip([next(stream) for _ in range(6)], ours[3:]):
        assert np.array_equal(a['i'], b['i'])
    with pytest.raises(ValueError, match='batch_size'):
        DataLoader(_Items(), 8)


def test_metric_log_dashboard_and_writers(tmp_path, capsys, monkeypatch):
    import sys
    from exsr_torch.utils.logging import (JsonlLogger, PrintLogger,
                                          StepTimer, TensorboardWriter,
                                          profile_trace)
    log = MetricLog()
    for s in range(1, 6):
        log.append(s, loss=1.0 / s)
    path = str(tmp_path / 'logs.npz')
    log.save(path)
    assert MetricLog().load(path, max_step=3).window('loss', 0) == \
        [1.0, 0.5, 1.0 / 3]
    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    log.dashboard(str(tmp_path / 'dash'))
    assert 'matplotlib is not installed' in capsys.readouterr().out
    assert not os.path.exists(tmp_path / 'dash')
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    monkeypatch.setitem(sys.modules, 'tensorboardX', None)
    tb = TensorboardWriter(str(tmp_path / 'tb'))
    assert not tb.active
    tb.log(1, loss=1.0)
    tb.close()
    jl = JsonlLogger(str(tmp_path / 'log.jsonl'))
    jl.log(step=1, loss=0.5)
    assert json.loads(open(tmp_path / 'log.jsonl').read()) == \
        {'step': 1, 'loss': 0.5}
    pl = PrintLogger(str(tmp_path / 'pl'))
    print('teed')
    pl.close()
    assert 'teed' in open(tmp_path / 'pl' / 'print_log.txt').read()
    t = StepTimer()
    assert t.tick() > 0
    with profile_trace(str(tmp_path / 'trace')) as prof:
        torch.ones(4).sum()
    assert prof is not None and os.path.exists(
        tmp_path / 'trace' / 'trace.json')


def test_scalar_fetch_sigint_stop_and_varying_weight():
    from exsr.utils.misc import varying_weight as j_weight
    from exsr_torch.utils.misc import (fetch_scalars, install_sigint_stop,
                                       read_scalars, stage_scalars,
                                       varying_weight)
    metrics = {'a': torch.tensor(1.5), 'b': 2, 'c': torch.ones(3)}
    got = fetch_scalars(metrics)
    assert got['a'] == 1.5 and got['b'] == 2.0 and got['c'] is metrics['c']
    got = read_scalars(stage_scalars(metrics))
    assert got['a'] == 1.5 and got['b'] == 2.0 and got['c'] is metrics['c']
    assert read_scalars(stage_scalars({})) == {}
    for step in (0, 5, 12, 30):
        assert varying_weight(step, [0, 10, 20], [1, 0.5, 2], (0.6, 1.5)) \
            == j_weight(step, [0, 10, 20], [1, 0.5, 2], (0.6, 1.5))
    prev = signal.getsignal(signal.SIGINT)
    signal.signal(signal.SIGINT, signal.default_int_handler)
    try:
        stop = install_sigint_stop()
        assert not stop()
        os.kill(os.getpid(), signal.SIGINT)
        assert stop()
        with pytest.raises(KeyboardInterrupt):
            os.kill(os.getpid(), signal.SIGINT)
        install_sigint_stop().restore()
        assert signal.getsignal(signal.SIGINT) is signal.default_int_handler
    finally:
        signal.signal(signal.SIGINT, prev)


def test_experiment_config_matches_exsr(tmp_path):
    """The typed layer over the flagship options and a small variant
    file: every field equal to exsr's."""
    import dataclasses
    from exsr.options import config as JC
    from exsr_torch.options import config as TC
    small = tmp_path / 'small.json'
    small.write_text(json.dumps({
        'name': 's', 'scale': 4, 'path': {'root': str(tmp_path)},
        'datasets': {'train': {'mode': 'LRHR', 'dataroot_HR': 'hr',
                               'batch_size': 4, 'batch_size_4_grads_G': 8,
                               'batch_size_4_grads_D': 8,
                               'patch_size': 128}},
        'network_G': {'which_model_G': 'MSRResNet', 'DTE_arch': 0,
                      'nf': 16, 'nb': 2},
        'network_D': {'which_model_D': 'PatchGAN', 'decomposed_input': 1},
        'train': {'gan_type': 'wgan-gp', 'hinge_threshold': 0.5}}))
    for path in ('artifacts/run_flagship_r5/opt.json', str(small)):
        want = JC.experiment_from_reference_json(JC.parse(path))
        got = TC.experiment_from_reference_json(TC.parse(path))
        for field in dataclasses.fields(want):
            a, b = getattr(got, field.name), getattr(want, field.name)
            if dataclasses.is_dataclass(b):
                assert dataclasses.asdict(a) == dataclasses.asdict(b), \
                    field.name
            else:
                assert a == b, field.name
