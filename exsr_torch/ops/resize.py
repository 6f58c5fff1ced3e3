"""Host-side resize-kernel synthesis and integer-factor resampling.

Counterpart of ``exsr/ops/resize.py``, kept as its own numpy copy so that
the port imports nothing of ``exsr``.  Everything here runs once at setup
time (numpy, float64) and produces the small constant filters that the
device-side ops (:mod:`exsr_torch.ops.filters`) consume.  The CEM's
consistency guarantee is an analytic property of these exact taps, so the
arithmetic follows ``exsr`` line for line; ``tests/test_torch_ops.py``
holds the two equal.

Left out: ``exsr``'s optional C++ fast path for :func:`imresize`
(``_native_imresize``); the numpy path below gives the same numbers.
"""
from __future__ import annotations

import numpy as np
from scipy.signal import convolve2d

_DELTA_SIZE = 11  # size of the probe delta image used by the reference


def _cv2_cubic_coeffs(t: float) -> np.ndarray:
    """The 4 cubic interpolation weights exactly as cv2 computes them.

    cv2 evaluates the Keys polynomial (a = -0.75) in float32 and derives
    the 4th weight as the 1-residual; the reference's kernel is a cv2
    output, so bit-parity requires that arithmetic, not just the math.
    """
    a = np.float32(-0.75)
    t = np.float32(t)
    one = np.float32(1.0)
    c0 = ((a * (t + one) - np.float32(5) * a) * (t + one)
          + np.float32(8) * a) * (t + one) - np.float32(4) * a
    c1 = ((a + np.float32(2)) * t - (a + np.float32(3))) * t * t + one
    u = one - t
    c2 = ((a + np.float32(2)) * u - (a + np.float32(3))) * u * u + one
    c3 = one - c0 - c1 - c2
    return np.array([c0, c1, c2, c3], dtype=np.float64)


def bicubic_upscale_profile(sf: int) -> np.ndarray:
    """1-D tap profile of bicubic upscaling by integer ``sf``.

    Output pixel ``i`` samples source coordinate ``(i + 0.5)/sf - 0.5``; a
    unit impulse at source position ``c`` receives cv2's cubic weight for
    its tap of the 4-tap window.  The support is cropped to nonzero taps.
    """
    c = int(np.ceil(_DELTA_SIZE / 2)) - 1  # delta position (5 for size 11)
    taps = np.zeros(sf * _DELTA_SIZE, dtype=np.float64)
    for i in range(sf * _DELTA_SIZE):
        # cv2 casts the source coordinate to float32 BEFORE splitting it
        # into integer and fractional parts
        fx = np.float32((i + 0.5) * (1.0 / sf) - 0.5)
        sx = int(np.floor(fx))
        tap = c - (sx - 1)  # which of the 4 window taps the delta occupies
        if 0 <= tap <= 3:
            taps[i] = _cv2_cubic_coeffs(np.float32(fx) - np.float32(sx))[tap]
    nz = np.nonzero(taps)[0]
    return taps[nz[0]:nz[-1] + 1]


def bicubic_upscale_kernel_2d(sf: int) -> np.ndarray:
    """2-D separable bicubic upscaling kernel (sums to ``sf**2``)."""
    p = bicubic_upscale_profile(sf)
    return np.outer(p, p)


def calc_strides(shape_hw, factor, align_center: bool = False):
    """Pre/post zero-stuffing offsets for integer-factor resampling.

    For an even factor the retained sample cannot sit in the middle of its
    ``f``-cell; :func:`upscale_kernel_padding` compensates so that there is
    no net translation (``exsr/ops/resize.py:88``).
    """
    factor = float(factor)
    f = int(np.maximum(factor, 1.0 / factor))
    if align_center:
        mult = factor if factor > 1 else 1.0
        half = np.ceil(np.array(shape_hw[:2], dtype=np.float64) / 2.0 * mult)
        pre = np.mod(half, f)
        pre[pre == 0] = f
        pre = (pre - 1).astype(np.int64)
        post = f - pre - 1
    else:
        post = (np.floor(f / 2) * np.ones(2)).astype(np.int64)
        pre = (f - post - 1).astype(np.int64)
    return pre, post


def upscale_kernel_padding(sf: int):
    """Zero padding of the kernel that compensates the stride asymmetry:
    one extra row/col for even factors."""
    pre, post = calc_strides((0, 0), sf)
    post_pad = np.maximum(0, pre - post)
    pre_pad = np.maximum(0, post - pre)
    return pre_pad, post_pad


def _energy_distribution(filt: np.ndarray) -> np.ndarray:
    """Fraction of filter L2 energy retained when cropping concentric
    frames."""
    energies = [np.sqrt(np.sum(filt ** 2))]
    for m in range(1, int(np.ceil(filt.shape[0] / 2))):
        energies.append(np.sqrt(np.sum(filt[m:-m, m:-m] ** 2)))
    return np.asarray(energies) / energies[0]


def _round_int(v) -> int:
    return int(np.round(v))


def center_mass(kernel: np.ndarray, ds_factor: int) -> np.ndarray:
    """Re-center an (estimated) kernel on its center of mass.

    Pads the kernel so its center of mass lands in the array middle, then
    crops low-energy margins so that ``(size - 1 + (ds_factor+1) % 2)`` is a
    multiple of ``ds_factor``.
    """
    if kernel.shape[0] != kernel.shape[1]:
        raise ValueError('only square kernels are supported')
    ksz = kernel.shape[0]
    xg, yg = np.meshgrid(np.arange(ksz), np.arange(ksz))
    xc = convolve2d(xg, kernel, mode='valid')[0, 0] + 1
    yc = convolve2d(yg, kernel, mode='valid')[0, 0] + 1
    x_pad, y_pad = 2 * (ksz / 2 - xc), 2 * (ksz / 2 - yc)
    padding_diff = np.round(np.abs(y_pad)) - np.round(np.abs(x_pad))
    pre_x, post_x = np.maximum(0, -x_pad), np.maximum(0, x_pad)
    pre_y, post_y = np.maximum(0, -y_pad), np.maximum(0, y_pad)

    def split_extra(pre, post, diff):
        # the side that receives the extra (odd) padding is decided by the
        # rounding quantization error
        offset_right = np.round(post) - post - (np.round(pre) - pre)
        pre, post = _round_int(pre), _round_int(post)
        if offset_right > 0:
            post += int(np.ceil(diff / 2))
            pre += int(np.floor(diff / 2))
        else:
            pre += int(np.ceil(diff / 2))
            post += int(np.floor(diff / 2))
        return pre, post

    if padding_diff > 0:
        pre_y, post_y = _round_int(pre_y), _round_int(post_y)
        pre_x, post_x = split_extra(pre_x, post_x, padding_diff)
    elif padding_diff < 0:
        pre_x, post_x = _round_int(pre_x), _round_int(post_x)
        pre_y, post_y = split_extra(pre_y, post_y, -padding_diff)
    kernel = np.pad(kernel, ((_round_int(pre_y), _round_int(post_y)),
                             (_round_int(pre_x), _round_int(post_x))))
    margins = np.argwhere(_energy_distribution(kernel) < 0.99)[0][0] \
        * np.ones(2, dtype=np.int64)
    side = 0
    while np.mod(kernel.shape[0] - np.sum(margins) - 1
                 + np.mod(ds_factor + 1, 2), ds_factor) != 0:
        margins[side] -= 1
        side = (side + 1) % 2
    kernel = kernel[margins[0]:-margins[1], margins[0]:-margins[1]]
    return kernel / np.sum(kernel)


def gaussian_2d(sigma: float, size: int | None = None) -> np.ndarray:
    """Normalized 2-D Gaussian holding >= 99% of the 1-D energy."""
    from scipy.stats import norm
    if size is None:
        size = int(1 + 2 * np.ceil(-1 * norm.ppf(0.005, scale=sigma)))
    elif size % 2 != 1:
        raise ValueError('size must be odd')
    n = np.arange(size) - (size - 1) / 2.0
    g1 = np.exp(-(n ** 2) / (2.0 * sigma ** 2))
    g = np.outer(g1, g1)
    return g / np.sum(g)


class KernelRegistry:
    """Per-scale-factor cache of upscaling kernels."""

    def __init__(self):
        self._kernels: dict[int, np.ndarray] = {}

    def get(self, sf: int) -> np.ndarray:
        if sf not in self._kernels:
            self._kernels[sf] = bicubic_upscale_kernel_2d(sf)
        return self._kernels[sf]

    def set_estimated(self, sf: int, ds_kernel: np.ndarray) -> None:
        """Register an estimated *downscaling* kernel (e.g. from KernelGAN):
        rotated 180 degrees, recentered and rescaled to sum ``sf**2``."""
        if abs(1.0 - np.sum(ds_kernel)) >= np.finfo(np.float32).eps:
            raise ValueError('estimated kernel must sum to 1')
        k = np.rot90(ds_kernel, 2)
        k = center_mass(k, ds_factor=sf) * sf ** 2
        pre_pad, post_pad = upscale_kernel_padding(sf)
        if not np.all(np.mod(np.array(k.shape) + post_pad + pre_pad - 1, sf)
                      == 0):
            raise ValueError('kernel size must be compatible with sf')
        self._kernels[sf] = k

    def set_blurry_cubic(self, sf: int, sigma: float) -> None:
        """Bicubic kernel convolved with a Gaussian blur."""
        self._kernels[sf] = convolve2d(bicubic_upscale_kernel_2d(sf),
                                       gaussian_2d(sigma))


def padded_upscale_kernel(sf: int, registry: KernelRegistry | None = None
                          ) -> np.ndarray:
    """The upscaling antialiasing kernel, padded per the stride convention:
    size 4*sf for even sf (one zero row/col prepended), 4*sf-1 for odd sf.
    Sums to ``sf**2``."""
    registry = registry or KernelRegistry()
    pre_pad, post_pad = upscale_kernel_padding(sf)
    return np.pad(registry.get(sf),
                  ((pre_pad[0], post_pad[0]), (pre_pad[1], post_pad[1])))


def downscale_kernel(sf: int, registry: KernelRegistry | None = None
                     ) -> np.ndarray:
    """The canonical downsampling kernel h (sums to 1): rot180 of the
    padded upscale kernel, divided by ``sf**2``."""
    k = padded_upscale_kernel(sf, registry)
    return (np.rot90(k, 2) / sf ** 2).astype(np.float64)


def imresize(im: np.ndarray, scale_factor: float,
             registry: KernelRegistry | None = None,
             use_zero_padding: bool = False) -> np.ndarray:
    """Integer-factor resampling of an HWC (or HW) numpy image.

    Upscaling zero-stuffs then filters; downscaling filters then
    subsamples; borders are edge- or zero-padded.
    """
    registry = registry or KernelRegistry()
    sf = float(scale_factor)
    f = int(np.maximum(sf, 1.0 / sf))
    pre_stride, _ = calc_strides(im.shape, sf)
    kernel = padded_upscale_kernel(f, registry)
    if sf < 1:
        kernel = np.rot90(kernel * sf ** 2, 2)
    pad = np.floor(np.array(kernel.shape) / 2).astype(np.int64)
    squeeze = im.ndim < 3
    if squeeze:
        im = im[..., None]
    desired = (sf * np.array(im.shape[:2])).astype(np.int64)
    if not np.all(sf * np.array(im.shape[:2]) == desired):
        raise ValueError('the downscale factor must divide the image size')

    def filt(x):
        if use_zero_padding:
            return convolve2d(x, kernel, 'same')
        xp = np.pad(x, ((pad[0], pad[0]), (pad[1], pad[1])), mode='edge')
        return convolve2d(xp, kernel, 'valid')

    out = []
    for ch in range(im.shape[2]):
        if sf > 1:
            stuffed = np.zeros(desired, dtype=im.dtype)
            stuffed[pre_stride[0]::f, pre_stride[1]::f] = im[:, :, ch]
            out.append(filt(stuffed))
        else:
            out.append(filt(im[:, :, ch])[pre_stride[0]::f,
                                          pre_stride[1]::f])
    result = np.stack(out, -1)
    return result[..., 0] if squeeze else result


def aliased_downsample(arr: np.ndarray, factor: int) -> np.ndarray:
    """Center-aligned strided subsampling without filtering."""
    pre, _ = calc_strides(arr.shape, 1.0 / factor, align_center=True)
    return arr[pre[0]::factor, pre[1]::factor]
