"""The port's ``scripts`` CLI against exsr's: every subcommand runs on the
same temporary folders in both packages.  File lists must be equal, PNG
and GIF pixels equal, numpy outputs within 1e-6; the checkpoint
subcommands write the port's checkpoints where exsr writes numpy or Orbax
trees, so their tensors are compared with exsr's arrays (equal, or within
1e-6 after an interpolation)."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from exsr.apps import scripts as X
from exsr_torch.apps import scripts as T
from exsr_torch.train.checkpoints import CheckpointManager


def _png(path, arr01):
    Image.fromarray((np.clip(arr01, 0, 1) * 255).astype(np.uint8)).save(path)


def _pixels(path):
    with Image.open(path) as im:
        return np.asarray(im.convert('RGB'))


def _gif_frames(path):
    with Image.open(path) as im:
        frames = []
        for i in range(im.n_frames):
            im.seek(i)
            frames.append(np.asarray(im.convert('RGB')))
        return frames


def _same_tree(a, b, images=True):
    names_a, names_b = sorted(os.listdir(a)), sorted(os.listdir(b))
    assert names_a == names_b and names_a
    if images:
        for n in names_a:
            np.testing.assert_array_equal(_pixels(os.path.join(a, n)),
                                          _pixels(os.path.join(b, n)))


@pytest.fixture(scope='module')
def images(tmp_path_factory):
    """Three seeded RGB PNGs of mixed sizes, smooth plus noise."""
    d = tmp_path_factory.mktemp('imgs')
    rng = np.random.default_rng(0)
    for i, (h, w) in enumerate([(100, 140), (64, 64), (52, 76)]):
        yy, xx = np.mgrid[:h, :w] / 40.0
        base = 0.5 + 0.3 * np.sin(yy * (i + 1) + xx)[..., None]
        _png(str(d / f'im{i}.png'),
             base + 0.1 * rng.standard_normal((h, w, 3)))
    return str(d)


def _both(tmp_path, fn):
    """Run ``fn(package, out_root)`` for exsr and the port."""
    out = {}
    for name, pkg in (('exsr', X), ('port', T)):
        root = tmp_path / name
        root.mkdir()
        fn(pkg, root)
        out[name] = root
    return out['exsr'], out['port']


def test_extract_subimages(images, tmp_path):
    a, b = _both(tmp_path, lambda pkg, root: pkg.extract_subimages(
        images, str(root / 'sub'), crop_size=48, step=24, threshold=8,
        workers=2))
    _same_tree(a / 'sub', b / 'sub')
    assert len(os.listdir(a / 'sub')) > 10


@pytest.mark.parametrize('cmd', ['generate_mod_lr', 'color2gray'])
def test_folder_to_folder(images, tmp_path, cmd):
    argv = {'generate_mod_lr': ['--scale', '4'], 'color2gray': []}[cmd]

    def run(pkg, root):
        pkg.main([cmd, '--input_dir', images, '--output_dir',
                  str(root / 'out')] + argv)
    a, b = _both(tmp_path, run)
    if cmd == 'generate_mod_lr':
        for sub in ('HRx4', 'LRx4'):
            _same_tree(a / 'out' / sub, b / 'out' / sub)
        assert _pixels(str(b / 'out' / 'LRx4' / 'im0.png')).shape == \
            (25, 35, 3)
    else:
        _same_tree(a / 'out', b / 'out')


def test_gaussian_kernel(tmp_path):
    a, b = _both(tmp_path, lambda pkg, root: pkg.main(
        ['gaussian_kernel', '--sigma', '1.3', '--out', str(root / 'k.npy')]))
    ka, kb = np.load(a / 'k.npy'), np.load(b / 'k.npy')
    assert ka.shape == kb.shape and abs(kb.sum() - 1) < 1e-12
    assert np.abs(ka - kb).max() <= 1e-6


def test_make_gif_and_results_2_video(images, tmp_path):
    frames = tmp_path / 'val'
    frames.mkdir()
    rng = np.random.default_rng(1)
    for step in (100, 20, 3):
        _png(str(frames / f'{step}_PSNR21.3.png'),
             rng.uniform(size=(32, 32, 3)))
    _png(str(frames / 'collage.png'), rng.uniform(size=(32, 32, 3)))

    def run(pkg, root):
        pkg.main(['make_gif', '--frames_dir', images, '--out',
                  str(root / 'z.gif')])
        pkg.main(['results_2_video', '--images_dir', str(frames), '--out',
                  str(root / 'v.gif'), '--fps', '2', '--blink_seconds', '2'])
    a, b = _both(tmp_path, run)
    for name in ('z.gif', 'v.gif'):
        fa, fb = _gif_frames(a / name), _gif_frames(b / name)
        assert len(fa) == len(fb) >= 3
        for x, y in zip(fa, fb):
            np.testing.assert_array_equal(x, y)


def test_fft_comparison_single_and_ratio(tmp_path):
    a_dir, b_dir = tmp_path / 'a', tmp_path / 'b'
    a_dir.mkdir(), b_dir.mkdir()
    rng = np.random.default_rng(1)
    for i, size in enumerate((40, 40, 32)):
        img = rng.uniform(size=(size, size, 3))
        _png(str(a_dir / f'im{i}_SR.png'), img)
        blur = (img + np.roll(img, 1, 0) + np.roll(img, 1, 1)
                + np.roll(img, -1, 0)) / 4
        _png(str(b_dir / f'im{i}_other.png'), blur)

    def run(pkg, root):
        pkg.main(['fft_comparison', '--folder_a', str(a_dir), '--out',
                  str(root / 'single.npz')])
        pkg.main(['fft_comparison', '--folder_a', str(a_dir), '--folder_b',
                  str(b_dir), '--out', str(root / 'ratio.npz')])
    a, b = _both(tmp_path, run)
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for name in ('single', 'ratio'):
        da, db = np.load(a / f'{name}.npz'), np.load(b / f'{name}.npz')
        assert int(da['n_images']) == int(db['n_images']) == 3
        assert da['mean_log_spectrum'].shape == (40, 40)
        assert np.abs(da['mean_log_spectrum']
                      - db['mean_log_spectrum']).max() <= 1e-6
        assert abs(float(da['scale']) - float(db['scale'])) <= 1e-6
        np.testing.assert_array_equal(_pixels(a / f'{name}.png'),
                                      _pixels(b / f'{name}.png'))


def test_transfer_files(tmp_path):
    src = tmp_path / 'src'
    src.mkdir()
    for n, data in (('a_s00.png', b'x'), ('b_s00_LR.png', b'y'),
                    ('c_other.png', b'z')):
        (src / n).write_bytes(data)
    a, b = _both(tmp_path, lambda pkg, root: pkg.main(
        ['transfer_files', '--source_dir', str(src), '--target_dir',
         str(root / 'dst')]))
    assert sorted(os.listdir(a / 'dst')) == sorted(os.listdir(b / 'dst')) \
        == ['a_s00.png', 'b_s00_LR.png']
    assert (b / 'dst' / 'b_s00_LR.png').read_bytes() == b'y'
    with pytest.raises(FileExistsError):   # exsr asserts
        T.main(['transfer_files', '--source_dir', str(src),
                '--target_dir', str(b / 'dst')])


def test_pack(images, tmp_path):
    a, b = _both(tmp_path, lambda pkg, root: pkg.main(
        ['pack', '--input_dir', images, '--out', str(root / 'd.pack')]))
    assert (a / 'd.pack').read_bytes() == (b / 'd.pack').read_bytes()
    with open(a / 'd.pack.json') as fa, open(b / 'd.pack.json') as fb:
        assert json.load(fa) == json.load(fb)


def test_psnr_ssim(tmp_path):
    rng = np.random.default_rng(0)
    gt_dir, gen_dir = tmp_path / 'gt', tmp_path / 'gen'
    gt_dir.mkdir()
    gen_dir.mkdir()
    for i in range(2):
        img = (rng.uniform(size=(32, 32, 3)) * 255).astype('uint8')
        noisy = np.clip(img.astype(int) + rng.integers(-8, 8, img.shape),
                        0, 255).astype('uint8')
        Image.fromarray(img).save(gt_dir / f'im{i}.png')
        Image.fromarray(noisy).save(gen_dir / f'im{i}_x4.png')
    for kw in ({'crop': 4, 'y_only': True, 'suffix': '_x4'},
               {'crop': 0, 'suffix': '_x4'}):
        xp, xs = X.psnr_ssim(str(gt_dir), str(gen_dir), **kw)
        tp, ts = T.psnr_ssim(str(gt_dir), str(gen_dir), **kw)
        assert 20 < tp < 50 and 0 < ts <= 1
        assert abs(tp - xp) <= 1e-6 and abs(ts - xs) <= 1e-6
    mp, ms = T.psnr_ssim(str(gt_dir), str(gt_dir), crop=0)
    assert np.isinf(mp) and ms > 0.999


def _g_tree(seed):
    rng = np.random.default_rng(seed)
    return {'conv.weight': rng.normal(size=(3, 4)).astype(np.float32),
            'conv.bias': rng.normal(size=(4,)).astype(np.float32)}


def test_net_interp(tmp_path):
    """exsr interpolates two ``.npz`` files, the port two of its checkpoint
    directories holding the same tensors."""
    ga, gb = _g_tree(1), _g_tree(2)
    np.savez(tmp_path / 'a.npz', **ga)
    np.savez(tmp_path / 'b.npz', **gb)
    X.main(['net_interp', '--ckpt_a', str(tmp_path / 'a.npz'), '--ckpt_b',
            str(tmp_path / 'b.npz'), '--alpha', '0.3', '--out',
            str(tmp_path / 'x.npz')])
    for name, tree in (('a', ga), ('b', gb)):
        CheckpointManager(str(tmp_path / name)).save(
            5, {'g_params': {k: torch.from_numpy(v)
                             for k, v in tree.items()}, 'step': 5})
    T.main(['net_interp', '--ckpt_a', str(tmp_path / 'a'), '--ckpt_b',
            str(tmp_path / 'b'), '--alpha', '0.3', '--out',
            str(tmp_path / 't')])
    ref = np.load(tmp_path / 'x.npz')
    got = CheckpointManager(str(tmp_path / 't')).restore()['g_params']
    assert set(got) == set(ref.files)
    for k in got:
        assert np.abs(got[k].numpy() - ref[k]).max() <= 1e-6


def test_export_g(tmp_path):
    """The generator of a train-state checkpoint, exported at its step:
    exsr's Orbax tree and the port's checkpoint hold the same arrays."""
    from exsr.train.checkpoints import CheckpointManager as JManager
    g = _g_tree(3)
    jm = JManager(str(tmp_path / 'x_train'))
    jm.save(7, {'g_params': jax.tree.map(jnp.asarray, g),
                'd_params': {'w': jnp.ones(3)}, 'step': jnp.int32(7)},
            force=True)
    jm.wait()
    X.main(['export_g', '--train_ckpt', str(tmp_path / 'x_train'), '--out',
            str(tmp_path / 'x_g')])
    ref = JManager(str(tmp_path / 'x_g')).restore_raw()['g_params']
    CheckpointManager(str(tmp_path / 't_train')).save(
        7, {'g_params': {k: torch.from_numpy(v) for k, v in g.items()},
            'd_vars': {'w': torch.ones(3)}, 'step': 7})
    T.main(['export_g', '--train_ckpt', str(tmp_path / 't_train'), '--out',
            str(tmp_path / 't_g')])
    dst = CheckpointManager(str(tmp_path / 't_g'))
    assert dst.all_steps() == [7] == JManager(str(tmp_path / 'x_g')) \
        .all_steps()
    got = dst.restore()
    assert set(got) == {'g_params'}
    for k in g:
        np.testing.assert_array_equal(got['g_params'][k].numpy(),
                                      np.asarray(ref[k]))
    T.main(['export_g', '--train_ckpt', str(tmp_path / 't_train'), '--out',
            str(tmp_path / 't_g')])      # again: unchanged
    assert dst.all_steps() == [7]


def test_help_says_the_port_checkpoints(capsys):
    for cmd in ('net_interp', 'export_g'):
        with pytest.raises(SystemExit):
            T.main([cmd, '--help'])
        assert "port's" in capsys.readouterr().out


# ------------------------------------------------- checkpoint conversion
NB, NF, GC = 1, 16, 32


def _explorable_pth(path, seed=0, nz_in=3):
    from test_torch_convert import _rrdb_state
    torch.save({'state_dict': {f'module.{k}': v for k, v in _rrdb_state(
        seed, NF, NB, GC, nz_in, std=0.08).items()}}, path)
    return path


def _exsr_g_params(ckpt, nz):
    from exsr.models.rrdb import RRDBNet
    from exsr.train.checkpoints import CheckpointManager as JManager
    g = RRDBNet(nb=NB, nf=NF, gc=GC, latent_channels=nz)
    template = g.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)),
                      jnp.zeros((1, 64, 64, nz)) if nz else None)
    return jax.tree.map(np.asarray, JManager(ckpt).restore(
        {'g_params': template})['g_params'])


@pytest.mark.parametrize('nz_in,nz', [(0, 3), (3, 3), (0, 0)])
def test_convert_torch_g_rrdb(tmp_path, nz_in, nz):
    from exsr_torch.models.convert import from_exsr_params
    pth = _explorable_pth(str(tmp_path / 'g.pth'), 1, nz_in)
    argv = ['convert_torch_g', '--pth', pth, '--nb', str(NB), '--nf',
            str(NF), '--gc', str(GC), '--latent_channels', str(nz)]
    X.main(argv + ['--out', str(tmp_path / 'x')])
    T.main(argv + ['--out', str(tmp_path / 't')])
    got = CheckpointManager(str(tmp_path / 't')).restore()['g_params']
    ref = from_exsr_params(_exsr_g_params(str(tmp_path / 'x'), nz))
    assert set(got) == set(ref)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), ref[k].numpy())


def test_convert_torch_g_msrresnet(tmp_path):
    from exsr.models.classifiers import MSRResNet as XMSRResNet
    from exsr.train.checkpoints import CheckpointManager as JManager
    from exsr_torch.models.convert import from_exsr_flat_params
    from test_torch_convert import _msrresnet_state
    torch.save(_msrresnet_state(2, 8, 2, 4), str(tmp_path / 'm.pth'))
    argv = ['convert_torch_g', '--pth', str(tmp_path / 'm.pth'), '--arch',
            'msrresnet', '--nb', '2', '--nf', '8', '--latent_channels', '0']
    X.main(argv + ['--out', str(tmp_path / 'x')])
    T.main(argv + ['--out', str(tmp_path / 't')])
    template = XMSRResNet(nf=8, nb=2).init(jax.random.PRNGKey(0),
                                          jnp.zeros((1, 8, 8, 3)))
    ref = from_exsr_flat_params(jax.tree.map(np.asarray, JManager(
        str(tmp_path / 'x')).restore({'g_params': template})['g_params']))
    got = CheckpointManager(str(tmp_path / 't')).restore()['g_params']
    assert set(got) == set(ref)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), ref[k].numpy())
    with pytest.raises(ValueError, match='latent'):
        T.main(argv[:-1] + ['3', '--out', str(tmp_path / 't3')])


def _assert_summaries_match(js, ts):
    """As ``tests/test_torch_eval.py`` holds eval_sr's summaries: PSNR
    within 1e-3 dB, SSIM 1e-4, the consistency error 1e-5 relative or
    1e-6, the standard deviations 1e-5 relative."""
    assert set(js) == set(ts) and ts['num_images'] == js['num_images']
    assert abs(ts['avg_psnr'] - js['avg_psnr']) <= 1e-3
    assert abs(ts['avg_ssim'] - js['avg_ssim']) <= 1e-4
    np.testing.assert_allclose(ts['avg_consistency_mae'],
                               js['avg_consistency_mae'], rtol=1e-5,
                               atol=1e-6)
    for key in ('avg_per_pixel_std', 'avg_hr_std', 'avg_sr_high_freq_std'):
        if key in js:
            assert abs(ts[key] - js[key]) <= 1e-5 * abs(js[key]), key


@pytest.fixture(scope='module')
def hr_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp('hr')
    rng = np.random.default_rng(5)
    for i in range(2):
        _png(str(d / f'im{i}.png'), rng.uniform(size=(64, 64, 3)))
    return str(d)


def test_official_parity_matches_exsr(tmp_path, hr_dir):
    """``official_parity``: the converted .pth through eval_sr, Z = 0 and
    one random Z (the port draws the same numpy Z as exsr)."""
    pth = _explorable_pth(str(tmp_path / 'g.pth'), 4)
    argv = ['official_parity', '--pth', pth, '--hr_dir', hr_dir, '--nb',
            str(NB), '--nf', str(NF), '--gc', str(GC), '--num_z', '2']
    X.main(argv + ['--out', str(tmp_path / 'x')])
    ts = T.main(argv + ['--out', str(tmp_path / 't'), '--device', 'cpu'])
    with open(tmp_path / 'x' / 'summary.json') as f:
        js = json.load(f)['summary']
    assert js['num_images'] == 2 and js['avg_per_pixel_std'] > 1e-3
    _assert_summaries_match(js, ts)


def test_convert_then_eval_sr_checkpoint_matches_exsr(tmp_path, hr_dir):
    """``convert_torch_g`` then ``eval_sr --checkpoint`` in each package,
    on a plain ESRGAN .pth converted with zero Z inputs."""
    from exsr.apps import eval_sr as JEval
    from exsr_torch.apps import eval_sr as TEval
    pth = _explorable_pth(str(tmp_path / 'g.pth'), 6, nz_in=0)
    conv = ['convert_torch_g', '--pth', pth, '--nb', str(NB), '--nf',
            str(NF), '--gc', str(GC)]
    X.main(conv + ['--out', str(tmp_path / 'xc')])
    T.main(conv + ['--out', str(tmp_path / 'tc')])
    ev = ['--hr_dir', hr_dir, '--nb', str(NB), '--nf', str(NF)]
    js = JEval.main(ev + ['--checkpoint', str(tmp_path / 'xc'),
                          '--out_dir', str(tmp_path / 'xe')])
    ts = TEval.main(ev + ['--checkpoint', str(tmp_path / 'tc'),
                          '--out_dir', str(tmp_path / 'te'),
                          '--device', 'cpu'])
    _assert_summaries_match(js, ts)
