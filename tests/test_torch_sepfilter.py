"""The CEM filter's polyphase entry points on the CPU: ``sepfilter_down`` and
``sepfilter_up`` (and ``CEMFilters``, which routes through them) against
exsr's ``CEMFilters``, the host-built tap lists of the up kernel against the
plain version, and the launch counters.  The CUDA kernels themselves are
tested by tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exsr.cem import cem as J
from exsr_torch.cem import cem as T
from exsr_torch.ops.kernels import sepfilter as K

SFS = [2, 3, 4, 8]


@pytest.fixture(scope='module', params=SFS)
def cems(request):
    sf = request.param
    return (J.CEM.create(J.CEMConf(scale_factor=sf)),
            T.CEM.create(T.CEMConf(scale_factor=sf)))


def _np(t):
    return t.detach().numpy()


# LR sizes that leave ragged tiles in both kernels (32 x 64 HR up tiles,
# 8-row down tiles), and one smaller than every tile
@pytest.mark.parametrize('c', [1, 3])
@pytest.mark.parametrize('h,w', [(13, 21), (3, 2)])
def test_polyphase_wrappers_match_exsr_filters(cems, c, h, w):
    """sepfilter_down / sepfilter_up and the CEMFilters methods built on
    them against exsr's downscale, upscale and enforce (decompose off and
    on) to 1e-5."""
    jc, tc = cems
    sf = jc.conf.scale_factor
    jf, tf = jc.device_filters(c), tc.device_filters(c, device='cpu')
    rng = np.random.default_rng(sf * 10 + c)
    lr = rng.uniform(size=(2, h, w, c)).astype(np.float32)
    g = rng.uniform(size=(2, h * sf, w * sf, c)).astype(np.float32)
    tl, tg = torch.from_numpy(lr), torch.from_numpy(g)
    jl, jg = jnp.asarray(lr), jnp.asarray(g)
    down = np.asarray(jf.downscale(jg))
    up = np.asarray(jf.upscale(jl))
    np.testing.assert_allclose(
        _np(K.sepfilter_down(tg, *tf.w_down_1d, sf, tf.pre)), down,
        atol=1e-5)
    np.testing.assert_allclose(
        _np(K.sepfilter_up(tl, *tf.w_up_1d, sf, tf.pre)), up, atol=1e-5)
    np.testing.assert_allclose(_np(tf.downscale(tg)), down, atol=1e-5)
    np.testing.assert_allclose(_np(tf.upscale(tl)), up, atol=1e-5)
    np.testing.assert_allclose(_np(tf.enforce(tl, tg)),
                               np.asarray(jf.enforce(jl, jg)), atol=1e-5)
    for t, j in zip(tf.enforce(tl, tg, decompose=True),
                    jf.enforce(jl, jg, decompose=True)):
        np.testing.assert_allclose(_np(t), np.asarray(j), atol=1e-5)
    # the combine entry point is enforce's own arithmetic
    a = tf.conv_inv_hth(tl).contiguous()
    b = tf.conv_inv_hth(tf.downscale(tg)).contiguous()
    np.testing.assert_allclose(
        _np(K.sepfilter_up(a, *tf.w_up_1d, sf, tf.pre, b=b, g=tg)),
        np.asarray(jf.enforce(jl, jg)), atol=1e-5)


def test_down_on_an_hr_size_that_is_not_a_multiple(cems):
    jc, tc = cems
    sf = jc.conf.scale_factor
    jf, tf = jc.device_filters(3), tc.device_filters(3, device='cpu')
    x = np.random.default_rng(1).uniform(
        size=(1, 5 * sf + 1, 3 * sf + sf - 1, 3)).astype(np.float32)
    out = K.sepfilter_down(torch.from_numpy(x), *tf.w_down_1d, sf, tf.pre)
    ref = np.asarray(jf.downscale(jnp.asarray(x)))
    assert out.shape == ref.shape
    np.testing.assert_allclose(_np(out), ref, atol=1e-5)


@pytest.mark.parametrize('sf', [2, 3])
def test_sigmoid_range_limit_matches_exsr(sf):
    """sigmoid_range_limit composes upscale with exsr's elementwise ops."""
    conf = dict(scale_factor=sf, sigmoid_range_limit=True,
                input_range=(-1.0, 1.0))
    jf = J.CEM.create(J.CEMConf(**conf)).device_filters(3)
    tf = T.CEM.create(T.CEMConf(**conf)).device_filters(3, device='cpu')
    rng = np.random.default_rng(5 + sf)
    lr = rng.uniform(size=(1, 11, 7, 3)).astype(np.float32)
    g = rng.normal(size=(1, 11 * sf, 7 * sf, 3)).astype(np.float32)
    tl, tg = torch.from_numpy(lr), torch.from_numpy(g)
    jl, jg = jnp.asarray(lr), jnp.asarray(g)
    np.testing.assert_allclose(_np(tf.enforce(tl, tg)),
                               np.asarray(jf.enforce(jl, jg)), atol=1e-5)
    for t, j in zip(tf.enforce(tl, tg, decompose=True),
                    jf.enforce(jl, jg, decompose=True)):
        np.testing.assert_allclose(_np(t), np.asarray(j), atol=1e-5)


def apply_polyphase_taps(a, kcol, krow, rtab, ctab):
    """The up filter of NHWC ``a`` from the tap lists, in numpy (float64):
    the arithmetic the up kernel does."""
    a = np.asarray(a, np.float64)
    kcol, krow = np.asarray(kcol, np.float64), np.asarray(krow, np.float64)
    t = np.zeros((a.shape[0], rtab.shape[1]) + a.shape[2:])
    for e in rtab:
        on = e >= 0
        t[:, on] += kcol[e[on] & 255][None, :, None, None] * a[:, e[on] >> 8]
    y = np.zeros(t.shape[:2] + (ctab.shape[1], a.shape[3]))
    for e in ctab:
        on = e >= 0
        y[:, :, on] += krow[e[on] & 255][None, None, :, None] * \
            t[:, :, e[on] >> 8]
    return y


@pytest.mark.parametrize('sf', SFS)
@pytest.mark.parametrize('h,w,c', [(5, 7, 3), (3, 2, 1), (9, 4, 4)])
def test_polyphase_tap_lists_equal_the_plain_up_filter(sf, h, w, c):
    """The up kernel's tap lists, applied in numpy, equal zero stuffing plus
    the same-size filter to 1e-6, clamped edges included."""
    filt = T.CEM.create(T.CEMConf(scale_factor=sf)).device_filters(
        c, device='cpu')
    kcol, krow = filt.w_up_1d
    rtab = K.polyphase_taps(h, sf, filt.pre[0], kcol.numel())
    ctab = K.polyphase_taps(w, sf, filt.pre[1], krow.numel())
    assert rtab.shape[1] == h * sf and ctab.shape[1] == w * sf
    a = np.random.default_rng(sf).uniform(-1, 1, size=(2, h, w, c)) \
        .astype(np.float32)
    out = apply_polyphase_taps(a, kcol.numpy(), krow.numpy(), rtab, ctab)
    ref = K.sepfilter_up_plain(torch.from_numpy(a), kcol, krow, sf,
                               filt.pre)
    np.testing.assert_allclose(out, _np(ref), atol=1e-6)


def test_sf2_edge_repeats_data_and_sf4_edge_is_zero():
    """At sf 2 (pre 0) the clamped top rows read data row 0 once per
    clamped tap plus once in place: kh // 2 + 1 times for row 0.  At sf 4
    (pre 1) every clamped tap reads a stuffed zero and is left out."""
    tab = K.polyphase_taps(16, 2, 0, 9)
    first = tab[:, 0][tab[:, 0] >= 0]
    assert ((first >> 8) == 0).sum() == 9 // 2 + 1
    assert list(first & 255) == sorted(first & 255)
    tab4 = K.polyphase_taps(16, 4, 1, 17)
    first4 = tab4[:, 0][tab4[:, 0] >= 0]
    assert ((first4 >> 8) == 0).sum() == 1  # data row 0 only in place
    last4 = tab4[:, -1][tab4[:, -1] >= 0]
    assert ((last4 >> 8) == 15).sum() == 1


@pytest.mark.parametrize('sf', SFS)
@pytest.mark.parametrize('n_lr', [1, 13, 37, 148])
def test_up_kernel_staging_covers_every_tap(sf, n_lr):
    """The LR rows the up kernel stages for a tile of 32 rows or 64 columns
    (its floordiv bounds, exsr_torch/csrc/sepfilter.cu) hold every entry of
    that tile's tap lists, within the span its shared memory is sized for
    (``lr_span``: (tile - 1 + 2 (k // 2) + sf - 1) // sf + 1)."""
    k = {2: 9, 3: 11, 4: 17, 8: 33}[sf]
    pre = {2: 0, 3: 1, 4: 1, 8: 3}[sf]
    tab = K.polyphase_taps(n_lr, sf, pre, k)
    for tile in (32, 64):
        span = (tile - 1 + 2 * (k // 2) + sf - 1) // sf + 1
        for i0 in range(0, n_lr * sf, tile):
            last = min(i0 + tile, n_lr * sf) - 1
            lo = max(0, (i0 - k // 2 - pre) // sf)
            hi = min(n_lr - 1, (last + k // 2 - pre) // sf)
            e = tab[:, i0:last + 1]
            idx = e[e >= 0] >> 8
            assert lo <= idx.min() and idx.max() <= hi
            assert hi - lo + 1 <= span


def test_cpu_calls_leave_the_polyphase_counters_at_zero():
    filt = T.CEM.create(T.CEMConf(scale_factor=4)).device_filters(
        3, device='cpu')
    K.sepfilter_down.launches = K.sepfilter_up.launches = 0
    K.sepfilter_edge.launches = 0
    rng = np.random.default_rng(2)
    lr = torch.from_numpy(rng.uniform(size=(1, 8, 8, 3)).astype(np.float32))
    g = torch.from_numpy(rng.uniform(size=(1, 32, 32, 3)).astype(np.float32))
    filt.enforce(lr, g)
    filt.upscale(lr)
    filt.downscale(g)
    assert (K.sepfilter_edge.launches, K.sepfilter_down.launches,
            K.sepfilter_up.launches) == (0, 0, 0)


def test_polyphase_wrappers_reject_what_the_kernels_do_not_take():
    k = torch.ones(3)
    a = torch.zeros(1, 4, 4, 3)
    with pytest.raises(ValueError, match='together'):
        K.sepfilter_up(a, k, k, 2, (0, 0), b=a)
    with pytest.raises(ValueError, match='x2 size'):
        K.sepfilter_up(a, k, k, 2, (0, 0), b=a, g=torch.zeros(1, 4, 4, 3))
    with pytest.raises(ValueError, match='contiguous'):
        K.sepfilter_down(torch.zeros(1, 8, 8, 3).transpose(1, 2), k, k, 2,
                         (0, 0))
    with pytest.raises(ValueError, match='fp32'):
        K.sepfilter_up(a.double(), k, k, 2, (0, 0))
