"""The port's eval_jpeg CLI against exsr's, on the CPU, on two tiny PNGs
with exsr's own random init (``PRNGKey(0)``) carried across as ``.npz``:
PSNRs within 1e-3 dB, the diversity sweep, the optimizer latent modes, the
images and GIFs, ``--checkpoint`` (``.npz`` and the port's checkpoints) and
every flag of exsr's."""
import json
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from exsr.apps import eval_jpeg as E
from exsr.models.dncnn import DnCNN as JDnCNN, DnCNNConfig as JConfig
from exsr_torch.apps import eval_jpeg as P
from exsr_torch.models.convert import dncnn_from_exsr_vars
from exsr_torch.models.dncnn import DnCNN, DnCNNConfig
from exsr_torch.train.checkpoints import CheckpointManager, load_exsr_npz

WIDTH = ['--nf', '16', '--nb', '3']


@pytest.fixture(scope='module')
def data(tmp_path_factory):
    """Two PNGs (one not a multiple of 8) and exsr's PRNGKey(0) init of
    the generator as ``.npz``, keyed by its leaves' paths."""
    root = tmp_path_factory.mktemp('eval_jpeg')
    rng = np.random.default_rng(0)
    (root / 'imgs').mkdir()
    for i, (h, w) in enumerate(((40, 48), (37, 45))):
        a = rng.uniform(0, 255, (h, w, 3))
        a = (a + np.roll(a, 1, 0) + np.roll(a, 1, 1)) / 3
        Image.fromarray(a.astype(np.uint8)).save(root / 'imgs' / f'im{i}.png')
    g = JDnCNN(JConfig(n_channels=16, depth=3, num_latent_channels=64))
    v = g.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 64)),
               jnp.zeros((1, 8, 8, 64)))
    np.savez(root / 'w.npz', **{
        '/'.join(str(getattr(k, 'key', k)) for k in path): np.asarray(x)
        for path, x in jax.tree_util.tree_flatten_with_path(v)[0]})
    return root


def _run(main, root, out, *extra):
    summary = main(['--data_dir', str(root / 'imgs'), *WIDTH,
                    '--out_dir', str(root / out), *extra])
    with open(root / out / 'summary.json') as f:
        return summary, json.load(f)['per_image']


def _compare(ref, port, keys, tol, relative=False):
    """|a - b| <= tol, or tol * max(1, |a|) when ``relative``."""
    assert len(ref) == len(port)
    for a, b in zip(ref, port):
        assert (a['name'], a['qf']) == (b['name'], b['qf'])
        for k in keys:
            scale = max(1.0, abs(a[k])) if relative else 1.0
            assert abs(a[k] - b[k]) <= tol * scale, (k, a, b)


def test_sweep_matches_exsr(data):
    """Z = 0 decode, the 3-sample sweep (exsr's numpy draws), plain JPEG,
    bin consistency; images and GIFs written under the same names."""
    extra = ['--qf', '10', '50', '--num_z', '3', '--save_images',
             '--z_sweep_gif', '3']
    se, ref = _run(E.main, data, 'exsr', *extra)
    sp, port = _run(P.main, data, 'port', *extra, '--device', 'cpu',
                    '--checkpoint', str(data / 'w.npz'))
    # PSNR within 1e-3 dB; the STD and bin distance within fp32 noise
    _compare(ref, port, ('psnr_jpeg', 'psnr_decomp'), 1e-3)
    _compare(ref, port, ('per_pixel_std', 'bin_consistency_max'), 1e-4,
             relative=True)
    assert set(sp) == set(se)
    for k in se:
        assert abs(se[k] - sp[k]) <= 1e-3, k
    assert all(r['bin_consistency_max'] <= 0.5 and r['time_s'] > 0
               for r in port)
    written = sorted(p.name for p in (data / 'port').iterdir())
    assert written == sorted(p.name for p in (data / 'exsr').iterdir())
    for name in written:
        if name.endswith('.png'):
            a = np.asarray(Image.open(data / 'port' / name), np.int16)
            b = np.asarray(Image.open(data / 'exsr' / name), np.int16)
            assert a.shape == b.shape and np.abs(a - b).max() <= 1
    gif = Image.open(data / 'port' / 'im0_qf10_Zsweep.gif')
    assert gif.n_frames == 3


@pytest.mark.parametrize('latent', ['desired_im', 'undesired_im',
                                    'max_std', 'min_std'])
def test_optimizer_modes_match_exsr(data, latent):
    extra = ['--qf', '20', '--latent', latent, '--num_z_iters', '4',
             '--max_images', '1']
    _, ref = _run(E.main, data, f'exsr_{latent}', *extra)
    _, port = _run(P.main, data, f'port_{latent}', *extra, '--device', 'cpu',
                   '--checkpoint', str(data / 'w.npz'))
    _compare(ref, port, ('psnr_jpeg', 'psnr_decomp'), 1e-3)
    _compare(ref, port, ('final_loss',), 1e-4, relative=True)


def test_checkpoints_and_seeded_default(data):
    """A directory of the port's checkpoints (the DnCNN's state dict with
    its running statistics under 'g_params', ``--step``) decodes as the
    ``.npz`` it came from; without one the seeded init decodes."""
    sd = dncnn_from_exsr_vars(load_exsr_npz(str(data / 'w.npz')))
    mgr = CheckpointManager(str(data / 'ckpt'), max_to_keep=None)
    mgr.save(5, {'g_params': sd})
    mgr.save(9, {'g_params': DnCNN(DnCNNConfig(
        n_channels=16, depth=3, num_latent_channels=64), seed=4)
        .state_dict()})
    extra = ['--qf', '30', '--num_z', '2', '--device', 'cpu']
    _, npz = _run(P.main, data, 'npz', *extra,
                  '--checkpoint', str(data / 'w.npz'))
    _, step5 = _run(P.main, data, 'step5', *extra,
                    '--checkpoint', str(data / 'ckpt'), '--step', '5')
    _, latest = _run(P.main, data, 'latest', *extra,
                     '--checkpoint', str(data / 'ckpt'))
    _, seeded = _run(P.main, data, 'seeded', *extra)
    drop = lambda rs: [{k: v for k, v in r.items() if k != 'time_s'}
                       for r in rs]
    assert drop(step5) == drop(npz)
    assert drop(latest) != drop(npz) and drop(seeded) != drop(npz)
    with pytest.raises(FileNotFoundError):
        P.main(['--data_dir', str(data / 'imgs'), '--device', 'cpu',
                '--checkpoint', str(data / 'nothing.npz')])


def test_cuda_default_and_every_exsr_flag(data, monkeypatch):
    """Every flag of exsr's CLI, plus --device; CUDA unless asked for the
    CPU."""
    src = pathlib.Path(E.__file__).read_text()
    flags = set(re.findall(r"add_argument\('(--[a-z_]+)'", src))
    ours = {a for action in P._parser()._actions
            for a in action.option_strings}
    assert flags and flags <= ours and '--device' in ours
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        P.main(['--data_dir', str(data / 'imgs'), *WIDTH])
