"""exsr_torch host-side and filter ops against their exsr counterparts
(resize, inv_hth, filters, serve).  CPU, fp32 on the device side."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exsr.ops import filters as JF
from exsr.ops import inv_hth as JI
from exsr.ops import resize as JR
from exsr.utils import serve as JS
from exsr_torch.ops import filters as TF
from exsr_torch.ops import inv_hth as TI
from exsr_torch.ops import resize as TR
from exsr_torch.utils import serve as TS


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize('sf', [2, 3, 4])
def test_resize_kernels_and_strides_match(sf):
    np.testing.assert_array_equal(TR.downscale_kernel(sf),
                                  JR.downscale_kernel(sf))
    np.testing.assert_array_equal(TR.padded_upscale_kernel(sf),
                                  JR.padded_upscale_kernel(sf))
    for shape, center in [((7, 9), False), ((8, 6), True)]:
        for t, j in zip(TR.calc_strides(shape, sf, center),
                        JR.calc_strides(shape, sf, center)):
            np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize('sf,zero_pad', [(4, False), (0.25, False),
                                         (0.5, True), (3, False)])
def test_imresize_matches_numpy_path(sf, zero_pad):
    rng = np.random.default_rng(0)
    im = rng.uniform(size=(24, 24, 2))
    np.testing.assert_allclose(
        TR.imresize(im, sf, use_zero_padding=zero_pad),
        JR.imresize(im, sf, use_zero_padding=zero_pad, allow_native=False),
        atol=1e-12)


def test_estimated_and_blurry_kernels_match():
    g = TR.gaussian_2d(1.3, size=13)
    np.testing.assert_allclose(g, JR.gaussian_2d(1.3, size=13), atol=1e-15)
    tr, jr = TR.KernelRegistry(), JR.KernelRegistry()
    tr.set_blurry_cubic(2, 0.8)
    jr.set_blurry_cubic(2, 0.8)
    np.testing.assert_allclose(tr.get(2), jr.get(2), atol=1e-15)
    k = JR.gaussian_2d(1.1, size=11)
    tr.set_estimated(2, k)
    jr.set_estimated(2, k)
    np.testing.assert_allclose(tr.get(2), jr.get(2), atol=1e-15)


@pytest.mark.parametrize('sf', [2, 4])
def test_inv_hth_and_margins_match(sf):
    dk = JR.downscale_kernel(sf)
    t_inv, t_m = TI.compute_inv_hth(dk, sf)
    j_inv, j_m = JI.compute_inv_hth(dk, sf)
    np.testing.assert_allclose(t_inv, j_inv, atol=1e-12)
    assert t_m == j_m
    assert TI.invalid_margin_size_downscale(sf, 0.999) == \
        JI.invalid_margin_size_downscale(sf, 0.999)


@pytest.mark.parametrize('k', [(5, 5), (4, 4), (3, 6)])
def test_filter_replicate_same_matches(k):
    """Includes even kernels, whose floor(k/2) padding grows the output."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 11, 13, 3)).astype(np.float32)
    kern = rng.normal(size=k)
    ref = JF.filter_replicate_same(jnp.asarray(x),
                                   JF.depthwise_weights(kern, 3))
    out = TF.filter_replicate_same(_t(x), TF.depthwise_weights(kern, 3))
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_separable_filter_and_factors_match():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(1, 16, 12, 3)).astype(np.float32)
    col, row = rng.normal(size=7), rng.normal(size=5)
    t_fac = TF.separable_factors(np.outer(col, row))
    j_fac = JF.separable_factors(np.outer(col, row))
    for a, b in zip(t_fac, j_fac):
        np.testing.assert_allclose(a, b, atol=1e-12)
    assert TF.separable_factors(rng.normal(size=(5, 5))) is None
    ref = JF.filter_replicate_same_separable(
        jnp.asarray(x), JF.depthwise_weights_1d(col, 3, 0),
        JF.depthwise_weights_1d(row, 3, 1))
    out = TF.filter_replicate_same_separable(
        _t(x), TF.depthwise_weights_1d(col, 3, 0),
        TF.depthwise_weights_1d(row, 3, 1))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_resampling_primitives_match():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 6, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        TF.zero_stuff(_t(x), 4, (1, 2)).numpy(),
        np.asarray(JF.zero_stuff(jnp.asarray(x), 4, (1, 2))))
    np.testing.assert_array_equal(
        TF.nearest_upsample(_t(x), 3).numpy(),
        np.asarray(JF.nearest_upsample(jnp.asarray(x), 3)))
    np.testing.assert_array_equal(
        TF.aliased_subsample(_t(x), 2, (1, 0)).numpy(),
        np.asarray(JF.aliased_subsample(jnp.asarray(x), 2, (1, 0))))
    np.testing.assert_array_equal(
        TF.replicate_pad(_t(x), 2, 3).numpy(),
        np.asarray(JF.replicate_pad(jnp.asarray(x), 2, 3)))


@pytest.mark.parametrize('out_hw', [(8, 8), (12, 20)])
def test_bilinear_resize_matches(out_hw):
    """x4 downscale (the generator's Z resize) and a mixed resize."""
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, size=(2, 32, 40, 3)).astype(np.float32)
    ref = JF.bilinear_resize(jnp.asarray(x), *out_hw)
    out = TF.bilinear_resize(_t(x), *out_hw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


def test_serve_policy_matches():
    table = {8: 10.0, 16: 30.0, 32: 25.0}
    for n in (1, 8, 9, 17, 33):
        assert TS.best_bucket(n, table) == JS.best_bucket(n, table)
        assert TS.alt_bucket(n) == JS.alt_bucket(n)
        assert TS.best_bucket(n) == n  # empty default table: identity
    a = np.ones((3, 2, 2, 1), np.float32)
    (t_pad,), t_n = TS.pad_batch([torch.from_numpy(a)], 8)
    (j_pad,), j_n = JS.pad_batch([a], 8)
    assert t_n == j_n == 3
    np.testing.assert_array_equal(t_pad.numpy(), j_pad)
