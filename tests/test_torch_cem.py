"""exsr_torch's CEM against exsr's: host setup, the device filter chain,
cem_wrap and the consistency invariant.  CPU, fp32."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exsr.cem import cem as J
from exsr_torch.cem import cem as T


@pytest.fixture(scope='module', params=[2, 3, 4])
def pair(request):
    sf = request.param
    return (J.CEM.create(J.CEMConf(scale_factor=sf)),
            T.CEM.create(T.CEMConf(scale_factor=sf)))


def _np(t):
    return t.detach().numpy()


def test_create_matches(pair):
    jc, tc = pair
    np.testing.assert_allclose(tc.ds_kernel, jc.ds_kernel, atol=1e-12)
    np.testing.assert_allclose(tc.inv_hth, jc.inv_hth, atol=1e-12)
    for f in ('ds_kernel_invalidity_half_size_lr',
              'inv_hth_invalidity_half_size', 'invalidity_margins_lr',
              'invalidity_margins_hr'):
        assert getattr(tc, f) == getattr(jc, f), f


def test_host_projections_match(pair):
    jc, tc = pair
    sf = jc.conf.scale_factor
    rng = np.random.default_rng(0)
    lr = rng.uniform(size=(10, 10, 3))
    np.testing.assert_allclose(tc.dt_satisfying_upscale(lr),
                               jc.dt_satisfying_upscale(lr), atol=1e-12)
    hr = rng.uniform(size=(10 * sf, 10 * sf, 3))
    np.testing.assert_allclose(tc.enforce_dt_on_image_pair(lr, hr),
                               jc.enforce_dt_on_image_pair(lr, hr),
                               atol=1e-12)
    np.testing.assert_array_equal(tc.loss_mask(128), jc.loss_mask(128))


def test_filter_chain_matches(pair):
    """downscale / upscale / enforce (plain and decomposed) to 1e-5."""
    jc, tc = pair
    sf = jc.conf.scale_factor
    jf, tf = jc.device_filters(3), tc.device_filters(3, device='cpu')
    rng = np.random.default_rng(1)
    lr = rng.uniform(size=(2, 12, 12, 3)).astype(np.float32)
    g = rng.uniform(size=(2, 12 * sf, 12 * sf, 3)).astype(np.float32)
    tl, tg = torch.from_numpy(lr), torch.from_numpy(g)
    jl, jg = jnp.asarray(lr), jnp.asarray(g)
    np.testing.assert_allclose(_np(tf.downscale(tg)),
                               np.asarray(jf.downscale(jg)), atol=1e-5)
    np.testing.assert_allclose(_np(tf.upscale(tl)),
                               np.asarray(jf.upscale(jl)), atol=1e-5)
    np.testing.assert_allclose(_np(tf.enforce(tl, tg)),
                               np.asarray(jf.enforce(jl, jg)), atol=1e-5)
    for t, j in zip(tf.enforce(tl, tg, decompose=True),
                    jf.enforce(jl, jg, decompose=True)):
        np.testing.assert_allclose(_np(t), np.asarray(j), atol=1e-5)


def _gen(p, x, z):
    """A generator with a z dependence, the same math in both packages."""
    sf = 4
    up = x.repeat_interleave(sf, 1).repeat_interleave(sf, 2) \
        if isinstance(x, torch.Tensor) else \
        jnp.repeat(jnp.repeat(x, sf, 1), sf, 2)
    return up * p + 0.1 * z


@pytest.mark.parametrize('pre_pad', [True, False])
@pytest.mark.parametrize('decompose', [False, True])
def test_cem_wrap_matches(pre_pad, decompose):
    jc = J.CEM.create(J.CEMConf(scale_factor=4))
    tc = T.CEM.create(T.CEMConf(scale_factor=4))
    rng = np.random.default_rng(2)
    lr = rng.uniform(size=(1, 24, 24, 3)).astype(np.float32)
    z = rng.uniform(-1, 1, size=(1, 96, 96, 3)).astype(np.float32)
    m = jc.invalidity_margins_lr
    ref = J.cem_wrap(_gen, jc.device_filters(3), 4)(
        0.7, jnp.asarray(lr), jnp.asarray(z), m, pre_pad=pre_pad,
        decompose=decompose)
    out = T.cem_wrap(_gen, tc.device_filters(3, device='cpu'), 4)(
        0.7, torch.from_numpy(lr), torch.from_numpy(z), m, pre_pad=pre_pad,
        decompose=decompose)
    if not decompose:
        ref, out = (ref,), (out,)
    for o, r in zip(out, ref):
        assert tuple(o.shape) == r.shape == (1, 96, 96, 3)
        np.testing.assert_allclose(_np(o), np.asarray(r), atol=1e-5)


def test_consistent_downsample_matches(pair):
    jc, tc = pair
    sf = jc.conf.scale_factor
    rng = np.random.default_rng(3)
    hr = rng.uniform(size=(2, 12 * sf, 12 * sf, 3)).astype(np.float32)
    margin = jc.ds_kernel_invalidity_half_size_lr
    ref = J.consistent_downsample(jnp.asarray(hr), jc.device_filters(3),
                                  margin)
    out = T.consistent_downsample(torch.from_numpy(hr),
                                  tc.device_filters(3, device='cpu'), margin)
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=1e-5)


def test_consistency_invariant(pair):
    """downscale(CEM(lr, g)) == lr to < 5e-6 inside the margins."""
    _, tc = pair
    sf = tc.conf.scale_factor
    filt = tc.device_filters(3, device='cpu')
    rng = np.random.default_rng(4)
    n = 3 * tc.invalidity_margins_lr
    lr = torch.from_numpy(rng.uniform(size=(2, n, n, 3)).astype(np.float32))
    g = torch.from_numpy(
        rng.uniform(size=(2, n * sf, n * sf, 3)).astype(np.float32))
    down = filt.downscale(filt.enforce(lr, g))
    m = tc.invalidity_margins_lr
    assert (down - lr)[:, m:-m, m:-m].abs().max().item() < 5e-6


def test_sigmoid_range_limit_matches():
    conf = dict(scale_factor=2, sigmoid_range_limit=True,
                input_range=(-1.0, 1.0))
    jf = J.CEM.create(J.CEMConf(**conf)).device_filters(3)
    tf = T.CEM.create(T.CEMConf(**conf)).device_filters(3, device='cpu')
    rng = np.random.default_rng(5)
    lr = rng.uniform(size=(1, 10, 10, 3)).astype(np.float32)
    g = rng.normal(size=(1, 20, 20, 3)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tf.enforce(torch.from_numpy(lr), torch.from_numpy(g))),
        np.asarray(jf.enforce(jnp.asarray(lr), jnp.asarray(g))), atol=1e-5)


def test_non_separable_estimated_kernel_takes_the_2d_path():
    """An anisotropic, rotated kernel does not factor: both packages run
    the 2-D depthwise path, and agree."""
    n = np.arange(13) - 6.0
    yy, xx = np.meshgrid(n, n, indexing='ij')
    u, v = (xx + yy) / np.sqrt(2), (xx - yy) / np.sqrt(2)
    k = np.exp(-(u ** 2) / 4.0 - (v ** 2) / 1.0)
    k /= k.sum()
    jc = J.CEM.create(J.CEMConf(scale_factor=2), upscale_kernel=k)
    tc = T.CEM.create(T.CEMConf(scale_factor=2), upscale_kernel=k)
    np.testing.assert_allclose(tc.ds_kernel, jc.ds_kernel, atol=1e-12)
    np.testing.assert_allclose(tc.inv_hth, jc.inv_hth, atol=1e-12)
    tf = tc.device_filters(3, device='cpu')
    assert tf.w_down_1d is None
    rng = np.random.default_rng(6)
    lr = rng.uniform(size=(1, 12, 12, 3)).astype(np.float32)
    g = rng.uniform(size=(1, 24, 24, 3)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tf.enforce(torch.from_numpy(lr), torch.from_numpy(g))),
        np.asarray(jc.device_filters(3).enforce(jnp.asarray(lr),
                                                jnp.asarray(g))),
        atol=1e-5)


def test_device_filters_need_cuda_or_cpu(monkeypatch):
    tc = T.CEM.create(T.CEMConf(scale_factor=2))
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tc.device_filters(3)
