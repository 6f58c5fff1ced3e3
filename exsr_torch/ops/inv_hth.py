"""Construction of the inv(h^T h) filter at the heart of the CEM.

Counterpart of ``exsr/ops/inv_hth.py`` (numpy copy).  One-time, host-side
float64: build hTh = (h * rot180(h)) * sf^2, alias-downsample it, invert it
in the Fourier domain with a magnitude floor, re-center on the maximum and
crop low-energy margins.  The result is a small constant filter shipped to
the device.
"""
from __future__ import annotations

import numpy as np
from scipy.signal import convolve2d

from exsr_torch.ops.resize import KernelRegistry, aliased_downsample, imresize

NFFT_ADD = 36  # FFT zero-padding of the reference's inversion
_TEST_IM_SIZE = 100


def compute_inv_hth(ds_kernel: np.ndarray, sf: int,
                    lower_magnitude_bound: float = 0.01,
                    desired_energy_portion: float = 1 - 1e-6,
                    filter_perturbation_limit: float = 0.999):
    """Return ``(inv_hTh, inv_hTh_invalidity_half_size)``.

    The filter satisfies ``H H^T (inv_hTh * y) ~= y`` for any LR image y,
    where H is the downsampling operator.
    """
    hth = convolve2d(ds_kernel, np.rot90(ds_kernel, 2)) * sf ** 2
    hth = aliased_downsample(hth, sf)
    pad = NFFT_ADD // 2
    hth_fft = np.fft.fft2(np.pad(hth, ((pad, pad), (pad, pad))))
    # wide kernels wipe out some frequencies entirely; bound the magnitude
    # from below before inversion to keep inv_hTh stable
    magnitude_boost = np.maximum(1.0, lower_magnitude_bound / np.abs(hth_fft))
    inv = np.real(np.fft.ifft2(1.0 / (hth_fft * magnitude_boost)))
    # re-center the filter on its maximum
    max_row, max_col = np.unravel_index(np.argmax(inv), inv.shape)
    if not np.all(np.equal(np.ceil(np.array(inv.shape) / 2),
                           np.array([max_row, max_col]) - 1)):
        half = int(np.min([inv.shape[0] - max_row - 1,
                           inv.shape[0] - max_col - 1, max_row, max_col]))
        inv = inv[max_row - half:max_row + half + 1,
                  max_col - half:max_col + half + 1]
    invalidity_half_size = invalid_margin_size_conv(
        inv, filter_perturbation_limit)
    margins_2_drop = inv.shape[0] // 2 - invalid_margin_size_conv(
        inv, desired_energy_portion)
    if margins_2_drop > 0:
        inv = inv[margins_2_drop:-margins_2_drop,
                  margins_2_drop:-margins_2_drop]
    return inv, int(invalidity_half_size)


def _margin_from_probe(output_im: np.ndarray,
                       max_allowed_perturbation: float) -> int:
    """Boundary-invalidity margin from a constant-image filter probe: the
    deepest pixel whose relative perturbation exceeds the limit."""
    n = output_im.shape[0]
    center = int(n / 2)
    out = output_im / output_im[center, center]
    out[out <= 0] = max_allowed_perturbation / 2  # hard-invalid pixels
    invalid = np.exp(-np.abs(np.log(out))) < max_allowed_perturbation
    col = np.argwhere(invalid[:center, center])
    row = np.argwhere(invalid[center, :center])
    # a compact kernel may perturb no pixel at all: margin 0
    margins = [(col[-1][0] + 1) if col.size else 0,
               (row[-1][0] + 1) if row.size else 0]
    return int(np.max(margins))


def invalid_margin_size_conv(filt: np.ndarray,
                             max_allowed_perturbation: float) -> int:
    """Invalidity margin (LR pixels) of plain 'same' convolution with
    ``filt``."""
    ones = np.ones((_TEST_IM_SIZE, _TEST_IM_SIZE))
    return _margin_from_probe(convolve2d(ones, filt, mode='same'),
                              max_allowed_perturbation)


def invalid_margin_size_downscale(sf: int, max_allowed_perturbation: float,
                                  registry: KernelRegistry | None = None
                                  ) -> int:
    """Invalidity margin (LR pixels) of the zero-padded downscale op."""
    ones = np.ones((sf * _TEST_IM_SIZE, sf * _TEST_IM_SIZE))
    probe = imresize(ones, 1.0 / sf, registry=registry,
                     use_zero_padding=True)
    return _margin_from_probe(probe, max_allowed_perturbation)
