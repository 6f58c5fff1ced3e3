"""The CEM filter's polyphase entry points on the CPU: ``sepfilter_down`` and
``sepfilter_up`` (and ``CEMFilters``, which routes through them) against
exsr's ``CEMFilters``, the host-built tap lists of the up kernel and the
adjoint kernel's bands against the plain version, and the launch counters.
The CUDA kernels themselves are tested by tests/test_torch_cuda.py."""
import dataclasses

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


# even tap counts: replicate padding by k // 2 on both sides, then a VALID
# correlation, so each axis with an even count grows by one sample
EVEN = [4, 6, 8]
EVEN_SF = [(2, (0, 0)), (3, (1, 1)), (4, (1, 2))]


def _even_taps(k, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(k), rng.standard_normal(k + 2)


@pytest.mark.parametrize('k', EVEN)
@pytest.mark.parametrize('sf,pre', EVEN_SF)
def test_even_taps_match_exsr_filters(k, sf, pre):
    """The three entry points (their plain versions, on the CPU) with even
    tap counts against exsr's ``filter_replicate_same_separable``,
    ``downscale_op`` and ``upscale_op``, shapes included, to 1e-5."""
    from exsr.ops import filters as JF
    kc, kr = _even_taps(k, 10 * k + sf)
    rng = np.random.default_rng(sf)
    lr = rng.uniform(size=(2, 7, 5, 3)).astype(np.float32)
    hr = rng.uniform(size=(2, 7 * sf, 5 * sf, 3)).astype(np.float32)
    tc, tr = (torch.tensor(t, dtype=torch.float32) for t in (kc, kr))
    w2d = JF.depthwise_weights(np.outer(kc, kr), 3)
    cases = (
        (K.sepfilter_edge(torch.from_numpy(hr), tc, tr),
         JF.filter_replicate_same_separable(
             jnp.asarray(hr), JF.depthwise_weights_1d(kc, 3, 0),
             JF.depthwise_weights_1d(kr, 3, 1)),
         (2, 7 * sf + 1, 5 * sf + 1, 3)),
        (K.sepfilter_down(torch.from_numpy(hr), tc, tr, sf, pre),
         JF.downscale_op(jnp.asarray(hr), w2d, sf, pre), None),
        (K.sepfilter_up(torch.from_numpy(lr), tc, tr, sf, pre),
         JF.upscale_op(jnp.asarray(lr), w2d, sf, pre),
         (2, 7 * sf + 1, 5 * sf + 1, 3)),
    )
    for out, ref, shape in cases:
        assert out.shape == ref.shape
        if shape is not None:
            assert tuple(out.shape) == shape
        np.testing.assert_allclose(_np(out), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize('k', EVEN)
@pytest.mark.parametrize('sf,pre', EVEN_SF)
@pytest.mark.parametrize('kind', ['E', 'D', 'U'])
def test_even_tap_adjoint_tables_are_the_adjoint(k, sf, pre, kind):
    """``<A x, y> == <x, A^T y>`` in float64 to 1e-12 for the tables of
    every map with even taps, whose output has grown by one sample: the
    tables take the grown output in and give the input's shape back."""
    kc, kr = _even_taps(k, 7 * k + sf)
    tabs = K.AdjointTables(kc, kr)
    tc, tr = torch.from_numpy(kc), torch.from_numpy(kr)
    rng = np.random.default_rng(k + sf)
    h, w = (7, 5) if kind == 'U' else (7 * sf + 1, 5 * sf)
    x = torch.from_numpy(rng.standard_normal((2, h, w, 3)))
    y = {'E': lambda: K.sepfilter_edge_plain(x, tc, tr),
         'D': lambda: K.sepfilter_down_plain(x, tc, tr, sf, pre),
         'U': lambda: K.sepfilter_up_plain(x, tc, tr, sf, pre)}[kind]()
    rows, cols = tabs.get(kind, h, w, sf, pre, 'cpu', torch.float64)
    assert (rows.n_in, cols.n_in) == tuple(y.shape[1:3])
    yy = torch.from_numpy(rng.standard_normal(tuple(y.shape)))
    xt = K.sepfilter_taps_plain(yy, rows, cols)
    assert xt.shape == x.shape
    lhs, rhs = (y * yy).sum().item(), (x * xt).sum().item()
    assert abs(lhs - rhs) <= 1e-12 * max(1.0, abs(lhs))
    # the gradient of the entry point is that adjoint
    xg = x.clone().float().requires_grad_(True)
    fwd = {'E': lambda t: K.sepfilter_edge(t, tc.float(), tr.float()),
           'D': lambda t: K.sepfilter_down(t, tc.float(), tr.float(), sf,
                                           pre),
           'U': lambda t: K.sepfilter_up(t, tc.float(), tr.float(), sf,
                                         pre)}[kind]
    fwd(xg).backward(yy.float())
    np.testing.assert_allclose(xg.grad.numpy(), xt.numpy(), atol=1e-5)


@pytest.mark.parametrize('k', EVEN)
@pytest.mark.parametrize('sf,pre', EVEN_SF)
def test_even_tap_lists_equal_the_plain_up_filter(k, sf, pre):
    """The up kernel's tap lists with even taps hold one column per grown
    output sample and, applied in numpy, equal the plain up filter; the
    kernel's staging bounds still hold every entry."""
    kc, kr = _even_taps(k, 3 * k + sf)
    h, w = 9, 4
    rtab = K.polyphase_taps(h, sf, pre[0], kc.size)
    ctab = K.polyphase_taps(w, sf, pre[1], kr.size)
    assert (rtab.shape[1], ctab.shape[1]) == (h * sf + 1, w * sf + 1)
    a = np.random.default_rng(sf).uniform(-1, 1, size=(2, h, w, 3))
    out = apply_polyphase_taps(a, kc, kr, rtab, ctab)
    ref = K.sepfilter_up_plain(torch.from_numpy(a), torch.from_numpy(kc),
                               torch.from_numpy(kr), sf, pre)
    np.testing.assert_allclose(out, _np(ref), atol=1e-12)
    for n_lr in (1, 13, 37):
        tab = K.polyphase_taps(n_lr, sf, pre[0], k)
        n = tab.shape[1]
        for tile in (32, 64):
            span = (tile - 1 + 2 * (k // 2) + sf - 1) // sf + 1
            for i0 in range(0, n, tile):
                last = min(i0 + tile, n) - 1
                lo = max(0, (i0 - k // 2 - pre[0]) // sf)
                hi = min(n_lr - 1, (last + k // 2 - pre[0]) // sf)
                e = tab[:, i0:last + 1]
                idx = e[e >= 0] >> 8
                assert lo <= idx.min() and idx.max() <= hi
                assert hi - lo + 1 <= span


def test_even_tap_enforce_fails_in_exsr_and_in_the_port():
    """exsr's behaviour, not a fault of the port: at x3 an estimated 13 x 13
    Gaussian kernel gives 4-tap down and up filters, so U grows the HR
    image by one pixel and exsr's ``enforce`` fails on ``g`` of the
    ungrown size; the port's ``enforce`` raises on the same shapes.  Its
    ``downscale`` and ``upscale`` return exsr's shapes and values."""
    from exsr.ops.resize import gaussian_2d
    kernel = gaussian_2d(1.0, 13)
    jc = J.CEM.create(J.CEMConf(scale_factor=3), upscale_kernel=kernel)
    tc = T.CEM.create(T.CEMConf(scale_factor=3), upscale_kernel=kernel)
    jf, tf = jc.device_filters(3), tc.device_filters(3, device='cpu')
    assert [t.numel() for t in tf.w_down_1d + tf.w_up_1d] == [4] * 4
    rng = np.random.default_rng(8)
    lr = rng.uniform(size=(1, 20, 20, 3)).astype(np.float32)
    g = rng.uniform(size=(1, 60, 60, 3)).astype(np.float32)
    tl, tg = torch.from_numpy(lr), torch.from_numpy(g)
    down, up = jf.downscale(jnp.asarray(g)), jf.upscale(jnp.asarray(lr))
    assert down.shape == (1, 20, 20, 3) and up.shape == (1, 61, 61, 3)
    np.testing.assert_allclose(_np(tf.downscale(tg)), np.asarray(down),
                               atol=1e-5)
    np.testing.assert_allclose(_np(tf.upscale(tl)), np.asarray(up),
                               atol=1e-5)
    with pytest.raises(TypeError, match=r'incompatible shapes.*'
                       r'\(1, 60, 60, 3\), \(1, 61, 61, 3\)'):
        jf.enforce(jnp.asarray(lr), jnp.asarray(g))
    with pytest.raises(ValueError, match='x3 size'):
        tf.enforce(tl, tg)


# (kind, sf, pre, taps, (h, w) of the forward's input): the x4 CEM's tap
# counts on axes shorter than the taps and on sizes whose last tiles are
# ragged, and even taps; each tiled for a launch on 1 and on 16 images
KERNEL_TABLE_CASES = [('E', 1, 0, 27, (3, 2)), ('E', 1, 0, 27, (56, 57)),
                      ('U', 4, 1, 17, (2, 1)), ('U', 4, 1, 17, (56, 53)),
                      ('D', 4, 1, 17, (5, 3)), ('D', 4, 1, 17, (224, 210)),
                      ('E', 1, 0, 4, (13, 21)), ('U', 3, 2, 4, (9, 7)),
                      ('D', 2, 0, 6, (41, 30))]


def _from_bands(t):
    """The kernel's bands of ``t`` as plain tables, ``[width, n_out]``:
    entry ``u`` of an output is input sample ``base + u`` of its band."""
    o = torch.arange(t.idx.shape[1])
    idx = t.base[o // K.BAND][None, :] + torch.arange(t.width)[:, None]
    return dataclasses.replace(t, idx=idx.int(),
                               w=t.band[o // K.BAND, :, o % K.BAND].T)


@pytest.mark.parametrize('batch', [1, 16])
@pytest.mark.parametrize('kind,sf,pre,k,hw', KERNEL_TABLE_CASES)
def test_kernel_bands_are_the_plain_tables(kind, sf, pre, k, hw, batch):
    """``AxisTable.build``'s bands: the tile ``adjoint_tile`` picks for the
    batch, a multiple of the band; every band ``width`` samples wide from
    a ``base`` inside its tile's ``[lo, hi]``, which holds every sample the
    tile's outputs read; each weight where the plain tables put it (0
    elsewhere).  Through the plain version they give the plain tables'
    output bit for bit: the same products in the same order, and zeros."""
    rng = np.random.default_rng(k + 10 * sf)
    tabs = K.AdjointTables(rng.standard_normal(k), rng.standard_normal(k))
    rows, cols = tabs.get(kind, *hw, sf, (pre, pre), 'cpu', batch=batch)
    assert (rows.tile, cols.tile) == K.adjoint_tile(kind, *hw, batch)
    for t in (rows, cols):
        n_out = t.idx.shape[1]
        assert t.tile % K.BAND == 0
        n_bands = -(-n_out // t.tile) * t.tile // K.BAND
        assert t.band.shape == (n_bands, t.width, K.BAND)
        staged = t.hi - t.lo + 1
        assert int(staged.max()) == t.span
        assert bool((staged >= min(t.width, t.n_in)).all())
        tile_of = torch.arange(n_bands) * K.BAND // t.tile
        assert bool((t.base >= t.lo[tile_of]).all())
        assert bool((t.base + t.width - 1 <= t.hi[tile_of]).all())
        o = torch.arange(n_out)
        live = t.idx >= 0
        assert bool((t.idx[live] >= t.lo[o // t.tile].expand_as(
            t.idx)[live]).all())
        assert bool((t.idx[live] <= t.hi[o // t.tile].expand_as(
            t.idx)[live]).all())
        u = t.idx - t.base[o // K.BAND]
        assert bool(((u[live] >= 0) & (u[live] < t.width)).all())
        assert torch.equal(
            t.band[(o // K.BAND).expand_as(t.idx)[live], u[live],
                   (o % K.BAND).expand_as(t.idx)[live]], t.w[live])
        assert int((t.band != 0).sum()) == int((t.w[live] != 0).sum())
    y = torch.from_numpy(rng.uniform(size=(batch, rows.n_in, cols.n_in, 3))
                         .astype(np.float32))
    assert torch.equal(K.sepfilter_taps_plain(y, _from_bands(rows),
                                              _from_bands(cols)),
                       K.sepfilter_taps_plain(y, rows, cols))
