"""Two faults that the port once copied from ``exsr``, and their repairs.

* ``DataLoader.epoch`` (and ``stream`` on top of it) re-raises an
  exception raised while collating a batch; it used to leave the consumer
  waiting forever for a batch that a dead worker thread would never
  bring.  Each case runs the consumer on a thread and fails if it has not
  ended within ``TIMEOUT`` seconds, so a regression fails instead of
  hanging the suite.
* The training CLIs put the caller's SIGINT handler back on every way out
  of their loops: ``train_sr``'s early "LR below 1e-8" return and an
  exception in the loop (``train_sr`` and ``train_jpeg``'s Y phase; the
  chroma phase installs no handler, as in ``exsr``).  A handler installed
  outside Python (``signal.getsignal`` gives None) is restored as
  Python's default.
"""
import os
import signal
import threading

import numpy as np
import pytest
from PIL import Image

TIMEOUT = 10.0
SR_TINY = ['--scale', '4', '--patch', '112', '--batch', '2', '--nb', '1',
           '--nf', '8', '--gc', '4', '--d_nb', '4', '--d_nf', '8',
           '--d_strides', '1', '--print_freq', '1', '--device', 'cpu']
JPEG_TINY = ['--patch', '64', '--batch', '2', '--nf', '16', '--nb', '3',
             '--print_freq', '1', '--ckpt_freq', '1', '--device', 'cpu']


def _pngs(root, n, size):
    root.mkdir()
    rng = np.random.default_rng(0)
    for i in range(n):
        Image.fromarray((rng.uniform(size=size + (3,)) * 255)
                        .astype(np.uint8)).save(root / f'im{i}.png')
    return str(root)


def _within_timeout(fn):
    """``fn()``'s exception, raised on a thread that must end within
    ``TIMEOUT`` seconds."""
    out = {}

    def run():
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 - the result under test
            out['error'] = e
    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(TIMEOUT)
    assert not t.is_alive(), f'the consumer still waits after {TIMEOUT} s'
    return out.get('error')


@pytest.mark.parametrize('how', ['epoch', 'stream'])
def test_collate_error_reaches_the_consumer(tmp_path, how):
    """A patch larger than the images: the dataset raises while a worker
    collates, and the consumer sees that error."""
    from exsr_torch.data.datasets import DataLoader, LRHRDataset
    ds = LRHRDataset(_pngs(tmp_path / 'hr', 3, (64, 64)), scale=4,
                     patch_size=128)
    loader = DataLoader(ds, batch_size=2, num_threads=2)
    it = loader.epoch(0) if how == 'epoch' else loader.stream(0)
    err = _within_timeout(lambda: next(it))
    assert isinstance(err, ValueError) and 'smaller than the patch' in \
        str(err)


def test_batches_before_a_failing_one_still_arrive(tmp_path):
    """The batches before the failing one come in order, then the error."""
    from exsr_torch.data.datasets import DataLoader

    class Items:
        def __len__(self):
            return 6

        def __getitem__(self, i, rng=None):
            if i == 4:
                raise RuntimeError('item 4')
            return {'x': np.full((2,), i, np.float32)}
    loader = DataLoader(Items(), batch_size=2, shuffle=False, num_threads=3)
    got = []

    def consume():
        for batch in loader.epoch(0):
            got.append(batch['x'][:, 0].tolist())
    err = _within_timeout(consume)
    assert got == [[0.0, 1.0], [2.0, 3.0]]
    assert isinstance(err, RuntimeError) and str(err) == 'item 4'


@pytest.fixture
def caller_handler():
    """A handler of the caller's own, in force during the test."""
    def mine(signum, frame):
        raise AssertionError('not reached')
    saved = signal.signal(signal.SIGINT, mine)
    yield mine
    signal.signal(signal.SIGINT, saved)


def test_handler_from_outside_python_restores_the_default(monkeypatch):
    """``getsignal`` gives None for a handler installed outside Python:
    restoring (and the first SIGINT, which restores too) puts Python's
    default handler back instead of raising ``TypeError``."""
    from exsr_torch.utils.misc import install_sigint_stop
    saved = signal.getsignal(signal.SIGINT)
    real = signal.getsignal
    try:
        monkeypatch.setattr(signal, 'getsignal', lambda s: None)
        stop = install_sigint_stop()
        monkeypatch.setattr(signal, 'getsignal', real)
        os.kill(os.getpid(), signal.SIGINT)
        assert stop()
        assert signal.getsignal(signal.SIGINT) is signal.default_int_handler
        signal.signal(signal.SIGINT, signal.SIG_IGN)
        stop.restore()
        assert signal.getsignal(signal.SIGINT) is signal.default_int_handler
    finally:
        signal.signal(signal.SIGINT, saved)


def test_train_sr_early_return_restores_the_handler(tmp_path, monkeypatch,
                                                    caller_handler):
    """The "LR below 1e-8" return after the first loss-STD check."""
    from exsr_torch.apps import train_sr
    from exsr_torch.train import controller, srragan
    real = srragan.TrainConfig
    monkeypatch.setattr(srragan, 'TrainConfig', lambda **kw: real(
        **{**kw, 'steps_4_loss_std': 1}))
    monkeypatch.setattr(controller.GANController, 'check_lr_drop',
                        lambda self: (False, True))
    calls = []
    step = srragan.SRRaGANTrainer.g_step
    monkeypatch.setattr(srragan.SRRaGANTrainer, 'g_step',
                        lambda *a, **k: calls.append(1) or step(*a, **k))
    hr = _pngs(tmp_path / 'hr', 2, (128, 128))
    train_sr.main(SR_TINY + ['--hr_dir', hr, '--exp_dir',
                             str(tmp_path / 'exp'), '--niter', '5',
                             '--init_phase'])
    assert len(calls) == 1          # returned after the first step
    assert signal.getsignal(signal.SIGINT) is caller_handler


class _Boom(RuntimeError):
    pass


def _boom(*a, **k):
    raise _Boom('in the loop')


def test_train_sr_exception_restores_the_handler(tmp_path, monkeypatch,
                                                 caller_handler):
    from exsr_torch.apps import train_sr
    from exsr_torch.train import srragan
    monkeypatch.setattr(srragan.SRRaGANTrainer, 'g_step', _boom)
    hr = _pngs(tmp_path / 'hr', 2, (128, 128))
    with pytest.raises(_Boom):
        train_sr.main(SR_TINY + ['--hr_dir', hr, '--exp_dir',
                                 str(tmp_path / 'exp'), '--niter', '3',
                                 '--init_phase'])
    assert signal.getsignal(signal.SIGINT) is caller_handler


@pytest.mark.parametrize('phase', ['y', 'chroma'])
def test_train_jpeg_exception_restores_the_handler(tmp_path, monkeypatch,
                                                   caller_handler, phase):
    from exsr_torch.apps import train_jpeg
    from exsr_torch.train import decomp, decomp_chroma
    if phase == 'y':
        monkeypatch.setattr(decomp.DecompTrainer, 'd_step', _boom)
        monkeypatch.setattr(decomp.DecompTrainer, 'g_step', _boom)
        extra = []
    else:
        monkeypatch.setattr(decomp_chroma.ChromaDecompTrainer, 'step', _boom)
        extra = ['--chroma', '--y_nf', '16', '--y_nb', '3']
    data = _pngs(tmp_path / 'data', 2, (72, 80))
    with pytest.raises(_Boom):
        train_jpeg.main(JPEG_TINY + extra + [
            '--data_dir', data, '--exp_dir', str(tmp_path / 'exp'),
            '--niter', '3'])
    assert signal.getsignal(signal.SIGINT) is caller_handler
