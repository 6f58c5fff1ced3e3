"""The port's C++ ``imresize`` path against its numpy path and exsr's
``imresize``, on the CPU (``g++`` builds the library at first use).

Both directions at x2 and x4, HWC and HW images, within 1e-12; the route
is taken exactly where exsr takes it; a failed build raises instead of
falling back to numpy, as exsr would.
"""
import numpy as np
import pytest

from exsr.ops import resize as JR
from exsr_torch.native import NativeBuildError
from exsr_torch.native import separable
from exsr_torch.ops import resize as R

TOL = 1e-12


def _img(shape, seed):
    return np.random.default_rng(seed).uniform(size=shape)


@pytest.mark.parametrize('sf', [2, 4])
@pytest.mark.parametrize('gray', [False, True])
def test_native_imresize_matches_numpy_and_exsr(sf, gray):
    hr = _img((48, 56) if gray else (48, 56, 3), sf)
    lr = _img((12, 14) if gray else (12, 14, 3), sf + 1)
    for im, factor in ((hr, 1.0 / sf), (lr, float(sf))):
        got = R.imresize(im, factor)
        assert got.dtype == np.float64 and got.ndim == im.ndim
        np.testing.assert_allclose(
            got, R.imresize(im, factor, allow_native=False), rtol=0,
            atol=TOL)
        np.testing.assert_allclose(got, JR.imresize(im, factor), rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(
            got, JR.imresize(im, factor, allow_native=False), rtol=0,
            atol=TOL)


def test_native_route_is_taken_where_exsr_takes_it(monkeypatch):
    """The C++ path runs for the default call; zero padding,
    ``align_center`` and ``allow_native=False`` take numpy, and agree
    with exsr's numpy path there."""
    calls = []
    for name in ('downscale', 'upscale'):
        real = getattr(separable, name)
        monkeypatch.setattr(separable, name, lambda *a, _r=real, _n=name:
                            calls.append(_n) or _r(*a))
    hr = _img((32, 40, 3), 7)
    R.imresize(hr, 0.25)
    R.imresize(hr[:8, :10], 4.0)
    assert calls == ['downscale', 'upscale']
    for kw in ({'allow_native': False}, {'use_zero_padding': True},
               {'align_center': True}):
        out = R.imresize(hr, 0.5, **kw)
        np.testing.assert_allclose(out, JR.imresize(hr, 0.5, **kw),
                                   rtol=0, atol=TOL)
    assert calls == ['downscale', 'upscale']


def test_sepconv_edge_matches_the_numpy_filter():
    from scipy.signal import correlate2d
    img = _img((9, 11, 2), 3)
    kcol, krow = np.array([0.25, 0.5, 0.25]), np.array([0.1, 0.2, 0.7])
    got = separable.sepconv_edge(img, kcol, krow)
    want = np.stack([correlate2d(np.pad(img[..., c], 1, mode='edge'),
                                 np.outer(kcol, krow), 'valid')
                     for c in range(2)], -1)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_failed_build_raises_and_is_not_replaced_by_numpy(monkeypatch,
                                                          tmp_path):
    import exsr_torch.native as N
    monkeypatch.setattr(separable, '_lib', None)
    monkeypatch.setattr(separable, '_error', None)
    monkeypatch.setattr(N, 'CXX', 'no-such-compiler-exsr')
    monkeypatch.setattr(N, 'BUILD_DIR', tmp_path / 'build')
    hr = _img((16, 16, 3), 1)
    with pytest.raises(NativeBuildError):
        R.imresize(hr, 0.5)
    # the outcome is kept, and the numpy path is still asked for by name
    with pytest.raises(NativeBuildError):
        R.imresize(hr, 0.5)
    np.testing.assert_allclose(R.imresize(hr, 0.5, allow_native=False),
                               JR.imresize(hr, 0.5, allow_native=False),
                               rtol=0, atol=TOL)


def test_loader_synthesises_lr_through_the_native_path(monkeypatch,
                                                       tmp_path):
    """``LRHRDataset`` without an LR folder takes the C++ path, as
    exsr's loader does, and gives exsr's LR image."""
    from PIL import Image
    from exsr.data.datasets import LRHRDataset as JDS
    from exsr_torch.data.datasets import LRHRDataset
    rgb = (np.random.default_rng(2).uniform(size=(40, 48, 3)) * 255
           ).astype(np.uint8)
    Image.fromarray(rgb).save(tmp_path / 'a.png')
    calls = []
    real = separable.downscale
    monkeypatch.setattr(separable, 'downscale',
                        lambda *a: calls.append(1) or real(*a))
    got = LRHRDataset(hr_root=str(tmp_path), scale=4, train=False)[0]
    want = JDS(hr_root=str(tmp_path), scale=4, train=False)[0]
    assert calls
    np.testing.assert_allclose(got['lr'], want['lr'], rtol=0, atol=1e-7)
