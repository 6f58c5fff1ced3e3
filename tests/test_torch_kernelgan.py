"""The port's KernelGAN against exsr's, on the CPU: every numpy helper,
the generator's composed kernel and the critic on carried weights, the
crops, a short estimation iteration by iteration (g_chan / d_chan 16,
three critic layers, ten iterations, from exsr's initial weights), the
Learner's schedule on a synthetic bicubic-loss sequence, and both
estimated-kernel entry points (``EditSession.estimate_kernel``,
``eval_sr --kernel estimated``) with one iteration, KernelGAN started
from exsr's initial weights.  (At the default width, Adam's normalised
steps amplify float32 noise in weights whose gradients nearly cancel: the
losses agree to 2e-5 while the kernels part by 1e-4 of their largest entry
after two iterations and 5e-4 after five; after one they agree to 2e-6.)

Tolerances: the helpers within 1e-12 (numpy on both sides); the composed
kernel within 1e-6 of its largest entry; the critic's sigmoid map within
1e-5 (flax's batch norm computes the variance as E[x^2] - E[x]^2);
per-iteration losses within 1e-4 relative (1e-6 absolute, as the
trainers' metrics: the bicubic loss falls towards zero); the final kernel
within 1e-4 of its largest entry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from exsr.kernelgan import kernelgan as J
from exsr_torch.kernelgan import kernelgan as K
from exsr_torch.models.convert import (kernelgan_d_from_exsr_vars,
                                       kernelgan_g_from_exsr_vars)

SMALL = dict(g_chan=16, d_chan=16, d_n_layers=3)
ITERS = 10


@pytest.fixture(autouse=True, scope='module')
def _two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _np(tree):
    return jax.tree.map(np.asarray, dict(tree))


def _image(size=96, seed=1):
    """A smooth image with edges: a seeded noise field blurred, plus a
    bright square."""
    from scipy.ndimage import gaussian_filter
    rng = np.random.default_rng(seed)
    img = gaussian_filter(rng.uniform(size=(size, size, 3)), (2, 2, 0))
    img[size // 4:size // 2, size // 3:2 * size // 3] += 0.3
    return np.clip(img, 0, 1).astype(np.float32)


def _exsr_init(cfg, seed=0):
    """exsr's initial variables for ``KernelGAN(cfg, seed).estimate``."""
    jkg = J.KernelGAN(cfg, seed=seed)
    rng_g, rng_d, _ = jax.random.split(jkg.rng, 3)
    shave = sum(k - 1 for k in J.G_STRUCTURE)
    d_size = (cfg.input_crop_size - shave + cfg.inv_scale - 1) \
        // cfg.inv_scale
    g_vars = jkg.g.init(rng_g, jnp.zeros((3, cfg.input_crop_size,
                                          cfg.input_crop_size, 1)))
    d_vars = jkg.d.init(rng_d, jnp.zeros((3, d_size, d_size, 1)))
    return jkg, _np(g_vars), _np(d_vars)


def _port(cfg, g_vars, d_vars, seed=0):
    kg = K.KernelGAN(K.KernelGANConfig(**cfg.__dict__), seed=seed,
                     device='cpu')
    kg.g.load_state_dict(kernelgan_g_from_exsr_vars(g_vars))
    kg.d.load_state_dict(kernelgan_d_from_exsr_vars(d_vars))
    return kg


def _k(seed=0, size=13):
    k = np.random.default_rng(seed).uniform(size=(size, size))
    return k / k.sum()


HELPERS = {
    'bicubic_k8': lambda m: m.BICUBIC_K8,
    'gradient_prob_map': lambda m: m.gradient_prob_map(_image(), 26),
    'gradient_prob_map_flat': lambda m: m.gradient_prob_map(
        np.ones((40, 40, 3)), 16),
    'penalty_mask_13': lambda m: (
        m.KernelGAN(m.KernelGANConfig())._penalty_mask() if m is J
        else m.penalty_mask(13)),
    'penalty_mask_11': lambda m: (
        m.KernelGAN(m.KernelGANConfig(g_kernel_size=11))._penalty_mask()
        if m is J else m.penalty_mask(11)),
    'zeroize_negligible': lambda m: m.zeroize_negligible(_k(), 40),
    'kernel_shift_sf2': lambda m: m.kernel_shift(
        m.zeroize_negligible(_k(1), 40), 2),
    'kernel_shift_sf3': lambda m: m.kernel_shift(
        m.zeroize_negligible(_k(2, 12), 30), 3),
    'post_process_kernel': lambda m: m.post_process_kernel(
        _k(3).astype(np.float32), 2),
    'aniso_gaussian_kernel': lambda m: m.aniso_gaussian_kernel(
        13, 2.0, 0.8, 0.6, sf=2),
    'aniso_gaussian_kernel_sf3': lambda m: m.aniso_gaussian_kernel(
        12, 1.2, 2.1, -0.3, sf=3),
    'kernel_moments': lambda m: np.concatenate(
        [a.ravel() for a in m.kernel_moments(_k(4))]),
    'analytic_x4_kernel': lambda m: m.analytic_x4_kernel(_k(5)),
}


@pytest.mark.parametrize('name', list(HELPERS))
def test_helper_matches_exsr(name):
    got, want = HELPERS[name](K), HELPERS[name](J)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_generator_kernel_and_forward_on_carried_weights():
    """The composed kernel and G's output equal exsr's, and G is the
    stride-2 correlation with its composed kernel."""
    cfg = J.KernelGANConfig(**SMALL)
    _, g_vars, _ = _exsr_init(cfg)
    kg = _port(cfg, g_vars, _exsr_init(cfg)[2])
    want = np.asarray(J.generator_kernel(g_vars, cfg))
    k = K.generator_kernel(kg.g).detach()
    assert k.shape == (13, 13)
    np.testing.assert_allclose(k.numpy(), want, atol=1e-6 * np.abs(want).max())
    x = np.random.default_rng(0).uniform(size=(3, 64, 64, 1)).astype(
        np.float32)
    out = kg.g(torch.from_numpy(x)).detach()
    np.testing.assert_allclose(
        out.numpy(), np.asarray(J.KGGenerator(cfg).apply(g_vars, x)),
        atol=1e-6)
    direct = torch.nn.functional.conv2d(
        torch.from_numpy(x).permute(0, 3, 1, 2), k[None, None], stride=2)
    np.testing.assert_allclose(out.numpy(), direct.permute(0, 2, 3, 1),
                               atol=2e-5)


def test_discriminator_on_carried_weights():
    """The critic's map, and its ``u`` vectors and running statistics after
    one train-mode call that keeps them."""
    cfg = J.KernelGANConfig(**SMALL)
    _, g_vars, d_vars = _exsr_init(cfg)
    kg = _port(cfg, g_vars, d_vars)
    x = np.random.default_rng(1).uniform(size=(3, 26, 26, 1)).astype(
        np.float32)
    want, new = J.KGDiscriminator(cfg).apply(
        d_vars, x, train=True, mutable=['batch_stats', 'spectral'])
    got = kg.d(torch.from_numpy(x), update_stats=True).detach()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    ref = kernelgan_d_from_exsr_vars({**d_vars, **_np(new)})
    sd = kg.d.state_dict()
    for name, v in ref.items():
        if name.endswith(('.u', 'running_mean', 'running_var')):
            np.testing.assert_allclose(sd[name].numpy(), v.numpy(),
                                       atol=1e-5, err_msg=name)


def test_crops_bit_equal():
    cfg = J.KernelGANConfig(max_iters=50)
    img = _image(100, seed=4)
    g_j, d_j, size_j = J.KernelGAN(cfg, seed=3)._sample_crops(img)
    g_t, d_t, size_t = K.KernelGAN(K.KernelGANConfig(max_iters=50), seed=3,
                                   device='cpu').sample_crops(img)
    assert size_t == size_j
    np.testing.assert_array_equal(g_t, g_j)
    np.testing.assert_array_equal(d_t, d_j)


def test_short_estimation_matches_exsr():
    """Ten iterations from exsr's initial weights on the same crops: the
    G, D and bicubic losses of every iteration, and the kernel."""
    cfg = J.KernelGANConfig(max_iters=ITERS, **SMALL)
    jkg, g_vars, d_vars = _exsr_init(cfg)
    img = _image()
    want = jkg.estimate(img)
    kg = _port(cfg, g_vars, d_vars)
    got = kg.estimate(img)
    for name, a, b in zip(('g', 'd', 'bic'), kg.losses, jkg.losses):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6, err_msg=name)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert abs(got.sum() - 1.0) < 1e-3
    assert np.abs(got - want).max() < 1e-4 * np.abs(want).max()
    # a second call starts from the initial weights again, on new crops
    again = kg.estimate(img)
    np.testing.assert_allclose(again, jkg.estimate(img),
                               atol=1e-4 * np.abs(want).max())


def _exsr_schedule(cfg, it, similar, lam_bic, lam_cent, lam_sparse,
                   bic_cnt, bic_loss):
    """exsr's ``schedule`` (``exsr/kernelgan/kernelgan.py:269-286``, nested
    in ``estimate``), line for line."""
    hit = bic_loss < 0.4
    bic_cnt = jnp.where(similar, bic_cnt, jnp.where(hit, bic_cnt + 1, 0))
    similar = similar | (hit & (bic_cnt >= 2))
    decay_step = (it % 200 == 0) & similar & (lam_bic > 5e-6)
    lam_bic = jnp.where(decay_step, jnp.maximum(lam_bic / 100.0, 5e-6),
                        lam_bic)
    insert = similar & (lam_bic < 5e-3)
    lam_cent = jnp.where(insert, cfg.lambda_centralized_end, lam_cent)
    lam_sparse = jnp.where(insert, cfg.lambda_sparse_end, lam_sparse)
    return similar, lam_bic, lam_cent, lam_sparse, bic_cnt


def test_learner_schedule_matches_exsr_on_a_synthetic_sequence():
    """Misses reset the latch's count, two hits in a row set it, it stays
    set; the bicubic weight falls by 100 at each multiple of 200 down to
    5e-6, and the final weights switch on below 5e-3."""
    cfg = J.KernelGANConfig()
    rng = np.random.default_rng(0)
    bic = np.concatenate([np.full(7, 0.6), [0.3, 0.5, 0.3, 0.6],
                          rng.uniform(0.1, 0.7, 180), [0.2, 0.2],
                          rng.uniform(0.3, 0.9, 1100)]).astype(np.float32)
    j = (jnp.zeros((), bool), jnp.float32(cfg.lambda_bicubic),
         jnp.float32(0.0), jnp.float32(0.0), jnp.zeros((), jnp.int32))
    t = K.learner_init(K.KernelGANConfig(), 'cpu')
    seen = set()
    for it, b in enumerate(bic):
        j = _exsr_schedule(cfg, jnp.int32(it), *j, jnp.float32(b))
        t = K.learner_update(K.KernelGANConfig(), it, t, torch.tensor(b))
        for name, v in zip(('similar', 'lam_bic', 'lam_cent', 'lam_sparse',
                            'bic_cnt'), j):
            assert float(t[name]) == float(v), (it, name)
        seen.add(np.float32(t['lam_bic']))
    assert seen >= set(np.float32([5.0, 0.05, 5e-4, 5e-6]))
    assert float(t['lam_cent']) == 1.0 and float(t['lam_sparse']) == 5.0


@pytest.fixture(scope='module')
def lr_image():
    return _image(80, seed=6)


@pytest.fixture
def exsr_initial_weights(monkeypatch):
    """Every port ``KernelGAN`` starts from the initial weights exsr's
    draws for the same configuration and seed."""
    init = K.KernelGAN.__init__

    def from_exsr(self, cfg=K.KernelGANConfig(), seed=0, device=None):
        init(self, cfg, seed, device)
        _, g_vars, d_vars = _exsr_init(J.KernelGANConfig(**cfg.__dict__),
                                       seed)
        self.g.load_state_dict(kernelgan_g_from_exsr_vars(g_vars))
        self.d.load_state_dict(kernelgan_d_from_exsr_vars(d_vars))
    monkeypatch.setattr(K.KernelGAN, '__init__', from_exsr)


def test_session_estimate_kernel_matches_exsr(lr_image,
                                              exsr_initial_weights):
    """``EditSession.estimate_kernel`` on the same weights and LR image:
    the same x4 kernel, the CEM rebuilt around it, the same SR view, and
    the same LR consistency under the new kernel (measured before the
    display clip)."""
    from exsr.apps.session import EditSession as JSession
    from exsr.cem.cem import consistent_downsample as \
        j_consistent_downsample
    from exsr_torch.apps.session import EditSession
    from exsr_torch.cem.cem import consistent_downsample
    from exsr_torch.models.convert import from_exsr_params
    js = JSession(scale=4, nb=1, nf=16)
    js.init_random_params(0)
    ts = EditSession(scale=4, nb=1, nf=16, device='cpu')
    ts.load_params(from_exsr_params(jax.tree.map(np.asarray, js.params)))
    for s in (js, ts):
        s.open_image(lr_image, is_hr=False)
    want, got = js.estimate_kernel(max_iters=1), ts.estimate_kernel(
        max_iters=1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5 * want.max())
    assert ts.estimated_kernel is not None
    np.testing.assert_allclose(ts.cem.ds_kernel, js.cem.ds_kernel,
                               atol=1e-5 * want.max())
    np.testing.assert_allclose(ts.sr, js.sr, atol=1e-4)
    with torch.no_grad():
        out = ts._wrapped(ts.eff_params, ts._t(ts.lr_image),
                          ts._t(ts.cur_z), ts.cem.invalidity_margins_lr,
                          pre_pad=True)
        down = consistent_downsample(
            out, ts.filters, ts.cem.ds_kernel_invalidity_half_size_lr)
    jout = js._wrapped(js.eff_params, jnp.asarray(js.lr_image),
                       jnp.asarray(js.cur_z), js.cem.invalidity_margins_lr,
                       pre_pad=True)
    jdown = j_consistent_downsample(
        jout, js.filters, js.cem.ds_kernel_invalidity_half_size_lr)
    m = int(np.clip(ts.cem.invalidity_margins_lr, 1,
                    ts.lr_image.shape[1] // 2 - 4))
    err, jerr = (np.abs(np.asarray(d) - ts.lr_image)[:, m:-m, m:-m].max()
                 for d in (down, jdown))
    # a one-iteration kernel leaves exsr's own view 0.16 from consistent
    # (its estimated-kernel CEM chain); the port's is as far, no farther
    assert abs(err - jerr) < 1e-4


def test_eval_sr_estimated_kernel_matches_exsr(lr_image, tmp_path,
                                               monkeypatch,
                                               exsr_initial_weights):
    """``eval_sr --kernel estimated`` estimates each image's kernel as
    exsr's does (x2, composed to x4) and rebuilds the model around it."""
    from exsr_torch.apps import eval_sr
    hr_dir = tmp_path / 'hr'
    hr_dir.mkdir()
    hr = np.kron(lr_image, np.ones((4, 4, 1)))
    Image.fromarray((hr * 255).round().astype(np.uint8)).save(
        hr_dir / 'a.png')
    kernels = []
    build = eval_sr.build_model

    def recording(*a, **kw):
        if kw.get('upscale_kernel') is not None:
            kernels.append(kw['upscale_kernel'])
        return build(*a, **kw)
    monkeypatch.setattr(eval_sr, 'build_model', recording)
    summary = eval_sr.main([
        '--hr_dir', str(hr_dir), '--nb', '1', '--nf', '16', '--num_z', '2',
        '--kernel', 'estimated', '--kernelgan_iters', '1', '--device', 'cpu',
        '--out_dir', str(tmp_path / 'out')])
    assert len(kernels) == 1 and summary['num_images'] == 1
    assert all(np.isfinite(v) for v in summary.values())
    from exsr_torch.data.datasets import LRHRDataset
    lr = LRHRDataset(hr_root=str(hr_dir), scale=4, train=False,
                     patch_size=None)[0]['lr']
    want = J.analytic_x4_kernel(
        J.KernelGAN(J.KernelGANConfig(max_iters=1)).estimate(lr))
    np.testing.assert_allclose(kernels[0], want, atol=1e-5 * want.max())
    with pytest.raises(ValueError, match='bicubic'):
        eval_sr.main(['--hr_dir', str(hr_dir), '--kernel', 'estimated',
                      '--latent', 'desired_im', '--device', 'cpu',
                      '--nb', '1', '--nf', '16',
                      '--out_dir', str(tmp_path / 'opt')])


def test_float32_kernels_can_miss_the_cem_sum_check_the_port_s_do_not():
    """exsr post-processes the kernel in float32, and the CEM rebuild
    (``set_estimated``) wants its sum within float32's epsilon of one: on
    seeded random kernels the float32 result misses it now and then (x2
    uses the kernel directly).  The port returns it in float64."""
    from exsr_torch.ops.resize import KernelRegistry
    misses = 0
    for seed in range(40):
        k = (np.random.default_rng(seed).uniform(size=(13, 13)) ** 8) \
            .astype(np.float32)
        p = J.post_process_kernel(k / k.sum(), 2)
        misses += abs(1.0 - np.sum(p)) >= np.finfo(np.float32).eps
        q = K.post_process_kernel((k / k.sum()).astype(np.float64), 2)
        KernelRegistry().set_estimated(2, q)
    assert misses > 0
    cfg = K.KernelGANConfig(max_iters=2, **SMALL)
    k = K.KernelGAN(cfg, device='cpu').estimate(_image())
    assert k.dtype == np.float64 and abs(1.0 - k.sum()) < 1e-12
