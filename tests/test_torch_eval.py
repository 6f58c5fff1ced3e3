"""The port's batch-evaluation CLI and what it runs, against exsr, on the
CPU: ``eval_sr.main`` in every latent mode, ``build_model`` (the plain SR
architectures, estimated kernels, checkpoints), the latent sweeps, the
``--opt`` path, the checkpoint formats, color, metrics, datasets, the Z-map
helpers and the VGG feature net.

Both packages run on the same images and the same weights: exsr's seeded
weights are carried across (the two initialisations draw different
numbers).  The CLI tests scale exsr's initial weights by 10: at the
initial scale (Kaiming times 0.1) the generator barely reacts to Z, and its
diversity statistics (~3e-7) sit at the level of float32 rounding, where
two correct implementations cannot agree to 1e-5.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from exsr.apps import eval_sr as JApp
from exsr.apps.session import EditSession as JSession
from exsr.models.rrdb import RRDBNet as JNet
from exsr.train.checkpoints import CheckpointManager as JManager
from exsr_torch.apps import eval_sr as TApp
from exsr_torch.apps.session import EditSession as TSession
from exsr_torch.models.convert import from_exsr_flat_params, \
    from_exsr_params
from exsr_torch.train.checkpoints import CheckpointManager, load_exsr_npz

HR, NB, NF = 96, 1, 16
WEIGHT_SCALE = 10.0


def export_npz(ckpt_dir: str, path: str) -> None:
    """The README's export of an exsr checkpoint's generator to ``.npz``."""
    raw = JManager(ckpt_dir).restore_raw()['g_params']
    flat = {'/'.join(str(getattr(k, 'key', k)) for k in key): np.asarray(v)
            for key, v in jax.tree_util.tree_flatten_with_path(raw)[0]}
    np.savez(path, **flat)


@pytest.fixture(scope='module')
def work(tmp_path_factory):
    """Two 96 x 96 PNGs, a Z-map PNG, exsr's seeded weights (scaled) in an
    Orbax checkpoint, and the same weights exported to ``.npz``."""
    root = tmp_path_factory.mktemp('eval')
    rng = np.random.default_rng(0)
    hr_dir = root / 'hr'
    hr_dir.mkdir()
    for i in range(2):
        Image.fromarray((rng.uniform(size=(HR, HR, 3)) * 255)
                        .astype(np.uint8)).save(hr_dir / f'im{i}.png')
    Image.fromarray((rng.uniform(size=(32, 32, 3)) * 255)
                    .astype(np.uint8)).save(root / 'zmap.png')
    g = JNet(nb=NB, nf=NF, upscale=4, latent_channels=3)
    params = g.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)),
                    jnp.zeros((1, 64, 64, 3)))
    params = jax.tree.map(lambda a: a * WEIGHT_SCALE, params)
    mgr = JManager(str(root / 'orbax'))
    mgr.save(0, {'g_params': params})
    mgr.wait()
    export_npz(str(root / 'orbax'), str(root / 'g.npz'))
    return {'root': root, 'hr': str(hr_dir), 'params': params,
            'orbax': str(root / 'orbax'), 'npz': str(root / 'g.npz'),
            'zmap': str(root / 'zmap.png')}


def _run_both(work, args, tag):
    """exsr's and the port's ``main`` on the same arguments and weights;
    the optimizer's loss histories are read through ``optimize``."""
    histories = {}
    summaries = {}
    for name, app, session, ckpt, extra in (
            ('exsr', JApp, JSession, work['orbax'], []),
            ('port', TApp, TSession, work['npz'], ['--device', 'cpu'])):
        optimize = session.optimize

        def recorded(self, *a, _opt=optimize, _name=name, **k):
            res = _opt(self, *a, **k)
            histories.setdefault(_name, []).append(
                [float(v) for v in res['losses']])
            return res
        session.optimize = recorded
        try:
            out = str(work['root'] / f'{tag}_{name}')
            summaries[name] = app.main(args + ['--checkpoint', ckpt,
                                               '--out_dir', out] + extra)
        finally:
            session.optimize = optimize
        with open(os.path.join(out, 'summary.json')) as f:
            assert json.load(f)['summary'] == summaries[name]
    return summaries['exsr'], summaries['port'], histories


def _assert_summaries_match(js, ts):
    """PSNR within 1e-3 dB; SSIM within 1e-4 (a uint8 rounding may flip
    between the two outputs); the standard deviations within 1e-5
    relative.  The consistency error within 1e-5 relative or 1e-6: where
    the output keeps the CEM's guarantee, the error is float32 rounding of
    the CEM chain (~5e-6), and the two frameworks' summation orders differ
    there by ~1 %."""
    assert set(js) == set(ts)
    assert ts['num_images'] == js['num_images']
    assert abs(ts['avg_psnr'] - js['avg_psnr']) <= 1e-3
    assert abs(ts['avg_ssim'] - js['avg_ssim']) <= 1e-4
    np.testing.assert_allclose(ts['avg_consistency_mae'],
                               js['avg_consistency_mae'], rtol=1e-5,
                               atol=1e-6)
    for key in ('avg_per_pixel_std', 'avg_hr_std', 'avg_sr_high_freq_std'):
        if key in js:
            assert abs(ts[key] - js[key]) <= 1e-5 * abs(js[key]), key


SWEEP_MODES = [
    ('rand_uniform', ['--num_z', '3']),
    ('uniform_sweep', ['--num_z', '3', '--latent_channel', '1']),
    ('gaussian_sweep', ['--num_z', '5', '--other_channels_val', '0.3']),
    ('unit_circle', ['--num_z', '3']),
    ('z_image', []),
]


@pytest.mark.parametrize('mode,extra', SWEEP_MODES,
                         ids=[m for m, _ in SWEEP_MODES])
def test_main_matches_exsr_in_the_sweep_modes(work, mode, extra):
    args = ['--hr_dir', work['hr'], '--nb', str(NB), '--nf', str(NF),
            '--latent', mode] + extra
    if mode == 'z_image':
        args += ['--z_image', work['zmap']]
    js, ts, _ = _run_both(work, args, mode)
    assert js['num_images'] == 2
    if mode != 'z_image':
        assert js['avg_per_pixel_std'] > 1e-3   # Z moves the output
        # the clip to [0, 1] spares the scored output: the CEM's guarantee
        # holds (z_image's Z saturates it, in both packages)
        assert ts['avg_consistency_mae'] < 1e-5
    _assert_summaries_match(js, ts)


def test_main_matches_exsr_in_the_optimizer_mode(work):
    """``desired_im``: the loss history of each step within 1e-4 of the
    first loss (not Z: Adam's normalised steps amplify the two
    frameworks' rounding differences in Z), and the summaries as in the
    sweep modes, the final loss within 1e-4 relative."""
    args = ['--hr_dir', work['hr'], '--nb', str(NB), '--nf', str(NF),
            '--latent', 'desired_im', '--num_z_iters', '5',
            '--max_images', '1']
    js, ts, hist = _run_both(work, args, 'desired_im')
    (jl,), (tl,) = hist['exsr'], hist['port']
    assert len(jl) == len(tl) == 5 and tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, atol=1e-4 * jl[0], rtol=0)
    assert abs(ts['avg_final_loss'] - js['avg_final_loss']) <= \
        1e-4 * abs(js['avg_final_loss'])
    _assert_summaries_match(js, ts)


def test_main_reads_reference_options(work):
    """``--opt`` with a reference-style JSON (``//`` comments, a phase
    variant, the test dataset's root, the generator's width and latent
    channels) configures both CLIs alike."""
    path = work['root'] / 'test_sr.json'
    path.write_text('\n'.join([
        '{ "name": "explorable_x4" // the experiment',
        ', "scale": 4',
        ', "path": {"root": "%s"}' % work['root'],
        ', "datasets": {"test_1": {"name": "synthetic", "mode": "LRHR",',
        '    "dataroot_HR": "%s"}}' % work['hr'],
        ', "network_G": {"which_model_G": "RRDB_net", "nb": 1, "nf": 16,',
        '    "latent_input": "all_layers", "latent_channels": "3",',
        '    "CEM_arch": {"PhaseInit": 0, "PhaseGAN": 1}}',
        '}']))
    js, ts, _ = _run_both(work, ['--opt', str(path), '--num_z', '3',
                                 '--latent', 'uniform_sweep'], 'opt')
    assert js['num_images'] == 2
    _assert_summaries_match(js, ts)
    from exsr.options import config as JC
    from exsr_torch.options import config as TC
    assert TC.parse(str(path), is_train=False) == \
        JC.parse(str(path), is_train=False)
    for v in (3, 'STD_1dir', '10', 'z'):
        assert TC.num_latent_channels(v) == \
            __import__('exsr.losses.filter_loss', fromlist=['x']) \
            .num_latent_channels(v)


@pytest.mark.parametrize('arch,use_cem', [('MSRResNet', False),
                                          ('sr_resnet', False),
                                          ('MSRResNet', True)])
def test_build_model_plain_archs_match_exsr(arch, use_cem):
    """The plain generators on exsr's seeded weights (exsr's build_model
    initialises them with PRNGKey(0)), to 1e-5."""
    from exsr.models.classifiers import MSRResNet, SRResNet
    cls = MSRResNet if arch == 'MSRResNet' else SRResNet
    params = cls(nf=NF, nb=2, upscale=4).init(jax.random.PRNGKey(0),
                                              jnp.zeros((1, 16, 16, 3)))
    state = from_exsr_flat_params(jax.tree.map(np.asarray, params))
    _, j_fwd = JApp.build_model(4, nb=2, latent_channels=0, arch=arch,
                                use_cem=use_cem, nf=NF)
    cem, t_fwd = TApp.build_model(4, nb=2, latent_channels=0, nf=NF,
                                  device='cpu', params=state, arch=arch,
                                  use_cem=use_cem)
    assert (cem is None) == (not use_cem)
    rng = np.random.default_rng(1)
    lr = rng.uniform(size=(2, 20, 20, 3)).astype(np.float32)
    z = np.zeros((2, 80, 80, 1), np.float32)
    ref = j_fwd(lr, z)
    out = t_fwd(lr, z)
    assert tuple(out.shape) == ref.shape == (2, 80, 80, 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    with pytest.raises(ValueError, match='latent'):
        TApp.build_model(4, nb=2, latent_channels=3, nf=NF, device='cpu',
                         arch=arch)


@pytest.mark.parametrize('scale,sigma', [(2, 1.0), (4, 2.5)])
def test_build_model_with_an_estimated_kernel_matches_exsr(scale, sigma):
    """``upscale_kernel`` reaches ``CEM.create``: the same CEM (margins
    and filters) and the same output on exsr's seeded weights, to 1e-5."""
    from exsr.ops.resize import gaussian_2d
    kernel = gaussian_2d(sigma, 13)
    params = JNet(nb=NB, nf=NF, upscale=scale, latent_channels=3).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)),
        jnp.zeros((1, 16 * scale, 16 * scale, 3)))
    jc, j_fwd = JApp.build_model(scale, nb=NB, nf=NF, upscale_kernel=kernel)
    tc, t_fwd = TApp.build_model(scale, nb=NB, nf=NF, device='cpu',
                                 upscale_kernel=kernel,
                                 params=from_exsr_params(
                                     jax.tree.map(np.asarray, params)))
    assert tc.invalidity_margins_lr == jc.invalidity_margins_lr
    np.testing.assert_allclose(tc.ds_kernel, jc.ds_kernel, atol=1e-12)
    rng = np.random.default_rng(scale)
    lr = rng.uniform(size=(1, 24, 24, 3)).astype(np.float32)
    z = rng.uniform(-1, 1, size=(1, 24 * scale, 24 * scale, 3)) \
        .astype(np.float32)
    np.testing.assert_allclose(t_fwd(lr, z).numpy(), j_fwd(lr, z),
                               atol=1e-5)


def test_sweep_values_and_build_zs_equal_exsr(work):
    import argparse
    for mode in ('uniform_sweep', 'gaussian_sweep'):
        for num in (1, 2, 3, 5, 8, 11):
            assert TApp.sweep_values(mode, num) == \
                JApp.sweep_values(mode, num)
    assert TApp.OPTIMIZER_MODES == JApp.OPTIMIZER_MODES
    for latent, num, nz in (('rand_uniform', 4, 3), ('uniform_sweep', 5, 3),
                            ('gaussian_sweep', 7, 3), ('unit_circle', 6, 3),
                            ('z_image', 1, 3), ('z_image', 1, 1),
                            ('rand_uniform', 1, 0)):
        args = argparse.Namespace(
            latent=latent, num_z=num, latent_channel=1,
            other_channels_val=0.25, z_image=work['zmap'])
        jz, ji = JApp.build_zs(args, (40, 48), np.random.default_rng(3),
                               nz=nz)
        tz, ti = TApp.build_zs(args, (40, 48), np.random.default_rng(3),
                               nz=nz)
        assert ti == ji and len(tz) == len(jz)
        for a, b in zip(tz, jz):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, atol=1e-6)


def test_main_refuses_what_it_cannot_run(work):
    base = ['--hr_dir', work['hr'], '--nb', '1', '--nf', '16', '--device',
            'cpu', '--out_dir', str(work['root'] / 'refused')]
    with pytest.raises(NotImplementedError, match='KernelGAN'):
        TApp.main(base + ['--kernel', 'estimated'])
    with pytest.raises(ValueError, match='latent'):
        TApp.main(base + ['--latent_channels', '0', '--latent',
                          'uniform_sweep'])


# ------------------------------------------------------------ checkpoints
def test_orbax_checkpoint_exported_to_npz_matches_exsr(work):
    """exsr's Orbax checkpoint, exported by the README's snippet: the
    port's forward on the ``.npz`` equals exsr's on the checkpoint to
    1e-5, and the loaded tree is exsr's, leaf for leaf."""
    tree = load_exsr_npz(work['npz'])
    ref_leaves = jax.tree_util.tree_leaves_with_path(work['params'])
    assert len(jax.tree_util.tree_leaves(tree)) == len(ref_leaves)
    for key, leaf in ref_leaves:
        node = tree
        for k in key:
            node = node[k.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    _, j_fwd = JApp.build_model(4, nb=NB, nf=NF, checkpoint=work['orbax'])
    _, t_fwd = TApp.build_model(4, nb=NB, nf=NF, device='cpu',
                                checkpoint=work['npz'])
    rng = np.random.default_rng(4)
    lr = rng.uniform(size=(2, 20, 20, 3)).astype(np.float32)
    z = rng.uniform(-1, 1, size=(2, 80, 80, 3)).astype(np.float32)
    np.testing.assert_allclose(t_fwd(lr, z).numpy(), j_fwd(lr, z),
                               atol=1e-5)


def test_port_checkpoints_round_trip_and_prune(tmp_path):
    from exsr_torch.models.rrdb import RRDBNet
    mgr = CheckpointManager(str(tmp_path / 'ck'), max_to_keep=2)
    assert mgr.all_steps() == [] and mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore()
    nets = [RRDBNet(nf=NF, nb=NB, latent_channels=3, seed=s)
            for s in range(3)]
    for step, net in zip((10, 20, 30), nets):
        assert mgr.save(step, {'g_params': net.state_dict(), 'step': step})
    assert not mgr.save(30, {'g_params': nets[0].state_dict()})
    assert mgr.all_steps() == [20, 30] and mgr.latest_step() == 30
    assert mgr.restore()['step'] == 30
    restored = mgr.restore(step=20)['g_params']
    for k, v in nets[1].state_dict().items():
        assert torch.equal(restored[k], v)
    rng = np.random.default_rng(5)
    lr = rng.uniform(size=(1, 16, 16, 3)).astype(np.float32)
    z = rng.uniform(-1, 1, size=(1, 64, 64, 3)).astype(np.float32)
    _, f_ckpt = TApp.build_model(4, nb=NB, nf=NF, device='cpu',
                                 checkpoint=str(tmp_path / 'ck'))
    _, f_net = TApp.build_model(4, nb=NB, nf=NF, device='cpu',
                                params=nets[2])
    assert torch.equal(f_ckpt(lr, z), f_net(lr, z))


# ------------------------------------------------ color, metrics, datasets
def test_color_and_metrics_equal_exsr():
    from exsr.utils import color as JColor
    from exsr.utils import metrics as JMetrics
    from exsr_torch.utils import color as TColor
    from exsr_torch.utils import metrics as TMetrics
    rng = np.random.default_rng(6)
    f = rng.uniform(size=(37, 41, 3)).astype(np.float32)
    u = (f * 255).astype(np.uint8)
    for img in (f, u):
        for only_y in (True, False):
            np.testing.assert_array_equal(TColor.rgb2ycbcr(img, only_y),
                                          JColor.rgb2ycbcr(img, only_y))
        np.testing.assert_array_equal(TColor.ycbcr2rgb(img),
                                      JColor.ycbcr2rgb(img))
        np.testing.assert_array_equal(TColor.modcrop(img, 4),
                                      JColor.modcrop(img, 4))
    np.testing.assert_array_equal(TColor.tensor2img(f[None] * 1.2 - 0.1),
                                  JColor.tensor2img(f[None] * 1.2 - 0.1))
    np.testing.assert_array_equal(TColor.tensor2img(torch.from_numpy(f)),
                                  JColor.tensor2img(f))
    g = np.clip(f + rng.normal(0, 0.05, f.shape), 0, 1) * 255
    a, b = f.astype(np.float64) * 255, g
    assert TMetrics.calculate_psnr(a, b) == JMetrics.calculate_psnr(a, b)
    assert TMetrics.calculate_ssim(a, b) == JMetrics.calculate_ssim(a, b)
    assert TMetrics.calculate_ssim(a[..., :1], b[..., :1]) == \
        JMetrics.calculate_ssim(a[..., :1], b[..., :1])
    assert TMetrics.calculate_psnr(a, a) == float('inf')
    np.testing.assert_array_equal(TMetrics.crop_border(a, 3),
                                  JMetrics.crop_border(a, 3))
    hr = rng.uniform(size=(48, 48, 3))
    lr = rng.uniform(size=(12, 12, 3))
    # the two packages' float64 resize kernels differ in the last bits
    np.testing.assert_allclose(TMetrics.lr_consistency_error(hr, lr, 4),
                               JMetrics.lr_consistency_error(hr, lr, 4),
                               rtol=1e-12)


def test_datasets_equal_exsr(work, tmp_path):
    from exsr.data import datasets as JD
    from exsr_torch.data import datasets as TD
    assert TD.list_images(work['hr']) == JD.list_images(work['hr'])
    # an HR size that is not a multiple of the scale, and an LR folder
    rng = np.random.default_rng(7)
    hr_dir, lr_dir = tmp_path / 'hr', tmp_path / 'lr'
    hr_dir.mkdir()
    lr_dir.mkdir()
    Image.fromarray((rng.uniform(size=(50, 45, 3)) * 255).astype(
        np.uint8)).save(hr_dir / 'a.png')
    Image.fromarray((rng.uniform(size=(12, 11, 3)) * 255).astype(
        np.uint8)).save(lr_dir / 'a.png')
    for kw in ({}, {'lr_root': str(lr_dir)}):
        jd = JD.LRHRDataset(hr_root=str(hr_dir), scale=4, train=False, **kw)
        td = TD.LRHRDataset(hr_root=str(hr_dir), scale=4, train=False, **kw)
        assert len(td) == len(jd) == 1
        ji, ti = jd[0], td[0]
        assert ti['path'] == ji['path']
        for key in ('lr', 'hr'):
            assert ti[key].dtype == ji[key].dtype == np.float32
            np.testing.assert_array_equal(ti[key], ji[key])
    # training crops and augmentation draw the same from the same rng
    jd = JD.LRHRDataset(hr_root=work['hr'], scale=4, patch_size=32)
    td = TD.LRHRDataset(hr_root=work['hr'], scale=4, patch_size=32)
    for seed in range(4):
        ji = jd.__getitem__(1, np.random.default_rng(seed))
        ti = td.__getitem__(1, np.random.default_rng(seed))
        np.testing.assert_array_equal(ti['lr'], ji['lr'])
        np.testing.assert_array_equal(ti['hr'], ji['hr'])
    jl, tl = JD.LRDataset(str(lr_dir)), TD.LRDataset(str(lr_dir))
    np.testing.assert_array_equal(tl[0]['lr'], jl[0]['lr'])
    (tmp_path / 'empty').mkdir()
    with pytest.raises(FileNotFoundError):
        TD.list_images(str(tmp_path / 'empty'))


def test_z_map_helpers_equal_exsr():
    from exsr.utils import misc as JMisc
    from exsr_torch.utils import misc as TMisc
    rng = np.random.default_rng(8)
    img = rng.uniform(size=(30, 22, 3))
    for single in (False, True):
        np.testing.assert_array_equal(
            TMisc.im_to_z_input(img, (40, 48), 0.8, single),
            JMisc.im_to_z_input(img, (40, 48), 0.8, single))
    np.testing.assert_array_equal(
        TMisc.im_to_z_input(np.full((8, 8), 0.3), (16, 16)),
        JMisc.im_to_z_input(np.full((8, 8), 0.3), (16, 16)))
    z = rng.uniform(-1.2, 1.2, size=(9, 7, 3)).astype(np.float32)
    png = TMisc.z_map_to_png(z)
    np.testing.assert_array_equal(png, JMisc.z_map_to_png(z))
    np.testing.assert_array_equal(TMisc.png_to_z_map(png),
                                  JMisc.png_to_z_map(png))


# ------------------------------------------------------------ VGG features
@pytest.mark.parametrize('num_convs,trailing', [(16, 'conv'), (4, 'relu'),
                                                (2, 'pool')])
def test_vgg_features_match_exsr(num_convs, trailing):
    """exsr's VGG19Features on its seeded weights through the bridge, to
    1e-5 of the largest feature."""
    from exsr.models.vgg import VGG19Features as JVGG
    from exsr_torch.models.vgg import VGG19Features as TVGG
    jv = JVGG(num_convs=num_convs, trailing=trailing)
    x = np.random.default_rng(9).uniform(size=(2, 32, 32, 3)) \
        .astype(np.float32)
    params = jv.init(jax.random.PRNGKey(1), jnp.asarray(x))
    ref = np.asarray(jv.apply(params, jnp.asarray(x)))
    tv = TVGG(num_convs=num_convs, trailing=trailing)
    tv.load_state_dict(from_exsr_flat_params(
        jax.tree.map(np.asarray, params)))
    assert not any(p.requires_grad for p in tv.parameters())
    out = tv(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-5 * np.abs(ref).max())


def test_torchvision_state_dict_loads_as_exsr_does(tmp_path):
    """A torchvision-layout state dict (``features.<i>``), written with
    ``torch.save``, loads into the port as exsr's loader reads it."""
    from exsr.models.vgg import VGG19Features as JVGG
    from exsr.models.vgg import load_torch_vgg19_features as j_load
    from exsr_torch.models.vgg import VGG19Features as TVGG
    from exsr_torch.models.vgg import load_torch_vgg19_features as t_load
    gen = torch.Generator().manual_seed(3)
    state, idx, cin = {}, 0, 3
    for item in (64, 64, 'M', 128, 128, 'M', 256, 256, 256, 256, 'M',
                 512, 512, 512, 512, 'M', 512, 512, 512, 512, 'M'):
        if item == 'M':
            idx += 1
            continue
        state[f'features.{idx}.weight'] = torch.randn(
            item, cin, 3, 3, generator=gen) * (2.0 / (9 * cin)) ** 0.5
        state[f'features.{idx}.bias'] = torch.randn(item, generator=gen)
        cin, idx = item, idx + 2
    path = str(tmp_path / 'vgg19.pth')
    torch.save(state, path)
    x = np.random.default_rng(10).uniform(size=(1, 32, 32, 3)) \
        .astype(np.float32)
    ref = np.asarray(JVGG().apply(j_load(path), jnp.asarray(x)))
    tv = TVGG()
    tv.load_state_dict(t_load(path))
    np.testing.assert_allclose(tv(torch.from_numpy(x)).numpy(), ref,
                               atol=1e-5 * np.abs(ref).max())
