"""The CEM of the x4 bicubic kernel, worked out again for the reference.

The taps are a frozen copy of the numpy synthesis in
``exsr_torch/ops/resize.py`` and ``exsr_torch/ops/inv_hth.py`` (bicubic
kernels only, the numpy path of the resize), so that the reference
derives its filters itself and takes nothing that the program built.
The combine is written plainly: each filter is one 2-D depthwise
correlation with replicate padding (no separable passes, no tap lists),
in float64.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from scipy.signal import convolve2d

from benchmark.reference.precision import no_tf32

_DELTA_SIZE = 11
NFFT_ADD = 36
_TEST_IM_SIZE = 100


def _cv2_cubic_coeffs(t: float) -> np.ndarray:
    """cv2's four cubic weights (Keys, a = -0.75) in its float32
    arithmetic, the fourth as the residual."""
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


def bicubic_profile(sf: int) -> np.ndarray:
    """1-D taps of bicubic upscaling by ``sf``, cropped to the nonzero
    ones."""
    c = int(np.ceil(_DELTA_SIZE / 2)) - 1
    taps = np.zeros(sf * _DELTA_SIZE, dtype=np.float64)
    for i in range(sf * _DELTA_SIZE):
        fx = np.float32((i + 0.5) * (1.0 / sf) - 0.5)
        sx = int(np.floor(fx))
        tap = c - (sx - 1)
        if 0 <= tap <= 3:
            taps[i] = _cv2_cubic_coeffs(np.float32(fx) - np.float32(sx))[tap]
    nz = np.nonzero(taps)[0]
    return taps[nz[0]:nz[-1] + 1]


def calc_strides(shape_hw, factor, align_center: bool = False):
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


def padded_upscale_kernel(sf: int) -> np.ndarray:
    """The bicubic upscaling kernel (sums to ``sf**2``), padded by one row
    and column before it for an even ``sf``."""
    pre, post = calc_strides((0, 0), sf)
    post_pad, pre_pad = np.maximum(0, pre - post), np.maximum(0, post - pre)
    p = bicubic_profile(sf)
    return np.pad(np.outer(p, p), ((pre_pad[0], post_pad[0]),
                                   (pre_pad[1], post_pad[1])))


def downscale_kernel(sf: int) -> np.ndarray:
    return (np.rot90(padded_upscale_kernel(sf), 2) / sf ** 2).astype(
        np.float64)


def _imresize_down_zero_pad(im: np.ndarray, sf: int) -> np.ndarray:
    """Downscale by ``1/sf`` with zero borders (the margin probe)."""
    pre, _ = calc_strides(im.shape, 1.0 / sf)
    kernel = np.rot90(padded_upscale_kernel(sf) / sf ** 2, 2)
    return convolve2d(im, kernel, 'same')[pre[0]::sf, pre[1]::sf]


def _margin_from_probe(out: np.ndarray, limit: float) -> int:
    n = out.shape[0]
    center = int(n / 2)
    out = out / out[center, center]
    out[out <= 0] = limit / 2
    invalid = np.exp(-np.abs(np.log(out))) < limit
    col = np.argwhere(invalid[:center, center])
    row = np.argwhere(invalid[center, :center])
    margins = [(col[-1][0] + 1) if col.size else 0,
               (row[-1][0] + 1) if row.size else 0]
    return int(np.max(margins))


def _margin_conv(filt: np.ndarray, limit: float) -> int:
    ones = np.ones((_TEST_IM_SIZE, _TEST_IM_SIZE))
    return _margin_from_probe(convolve2d(ones, filt, mode='same'), limit)


def inv_hth(ds_kernel: np.ndarray, sf: int, lower_bound: float = 0.01,
            energy: float = 1 - 1e-6, limit: float = 0.999):
    """``(inv_hTh, its invalidity half size)``: hTh aliased by ``sf``,
    inverted in the Fourier domain with a magnitude floor, re-centred on
    its maximum, its low-energy frame cropped."""
    hth = convolve2d(ds_kernel, np.rot90(ds_kernel, 2)) * sf ** 2
    pre, _ = calc_strides(hth.shape, 1.0 / sf, align_center=True)
    hth = hth[pre[0]::sf, pre[1]::sf]
    pad = NFFT_ADD // 2
    fft = np.fft.fft2(np.pad(hth, ((pad, pad), (pad, pad))))
    inv = np.real(np.fft.ifft2(
        1.0 / (fft * np.maximum(1.0, lower_bound / np.abs(fft)))))
    r, c = np.unravel_index(np.argmax(inv), inv.shape)
    if not np.all(np.equal(np.ceil(np.array(inv.shape) / 2),
                           np.array([r, c]) - 1)):
        half = int(np.min([inv.shape[0] - r - 1, inv.shape[0] - c - 1, r,
                           c]))
        inv = inv[r - half:r + half + 1, c - half:c + half + 1]
    half_size = _margin_conv(inv, limit)
    drop = inv.shape[0] // 2 - _margin_conv(inv, energy)
    if drop > 0:
        inv = inv[drop:-drop, drop:-drop]
    return inv, int(half_size)


@dataclasses.dataclass(frozen=True)
class CemTaps:
    sf: int
    ds_kernel: np.ndarray       # h, sums to 1
    inv_hth: np.ndarray
    pre: tuple[int, int]
    margins_lr: int


def cem_taps(sf: int, limit: float = 0.999) -> CemTaps:
    """The bicubic CEM's filters and its LR invalidity margin (twice the
    downscale's, plus the inv_hTh filter's)."""
    h = downscale_kernel(sf)
    probe = _imresize_down_zero_pad(
        np.ones((sf * _TEST_IM_SIZE, sf * _TEST_IM_SIZE)), sf)
    ds_margin = _margin_from_probe(probe, limit)
    inv, inv_margin = inv_hth(h, sf)
    pre, _ = calc_strides((0, 0), sf)
    return CemTaps(sf=sf, ds_kernel=h, inv_hth=inv,
                   pre=(int(pre[0]), int(pre[1])),
                   margins_lr=2 * ds_margin + inv_margin)


def _replicate_pad(x, ph: int, pw: int):
    """NHWC replicate padding, ``ph`` rows and ``pw`` columns a side."""
    return F.pad(x.permute(0, 3, 1, 2), (pw, pw, ph, ph),
                 mode='replicate').permute(0, 2, 3, 1)


def _filter_same(x, kernel2d: np.ndarray):
    """Depthwise correlation of NHWC ``x`` with a 2-D kernel, replicate
    padded by ``k // 2`` (an even kernel grows the output by one)."""
    kh, kw = kernel2d.shape
    c = x.shape[-1]
    w = torch.as_tensor(kernel2d, dtype=x.dtype, device=x.device)
    w = w[None, None].repeat(c, 1, 1, 1)
    xp = _replicate_pad(x, kh // 2, kw // 2).permute(0, 3, 1, 2)
    return F.conv2d(xp, w, groups=c).permute(0, 2, 3, 1)


class PlainCem:
    """``out = U(inv_hTh * lr) + (g - U(inv_hTh * D g))`` in ``dtype``
    (float64 unless given), with D the downscale (filter, then keep
    sub-pixel ``pre`` of each ``sf`` cell) and U the upscale (zero
    stuffing at ``pre``, then filter)."""

    def __init__(self, taps: CemTaps, dtype=torch.float64):
        self.t, self.dtype = taps, dtype

    def down(self, x):
        t = self.t
        y = _filter_same(x, np.rot90(t.ds_kernel, 2).copy())
        return y[:, t.pre[0]::t.sf, t.pre[1]::t.sf, :]

    def up(self, x):
        t = self.t
        n, h, w, c = x.shape
        z = x.new_zeros((n, h, t.sf, w, t.sf, c))
        z[:, :, t.pre[0], :, t.pre[1], :] = x
        z = z.reshape(n, h * t.sf, w * t.sf, c)
        return _filter_same(z, t.ds_kernel * t.sf ** 2)

    def inv(self, x):
        return _filter_same(x, self.t.inv_hth)

    def enforce(self, lr, g):
        """The combine, computed and returned in ``dtype``; convolutions
        with TF32 off."""
        lr, g = lr.to(self.dtype), g.to(self.dtype)
        with no_tf32():
            return self.up(self.inv(lr)) + (
                g - self.up(self.inv(self.down(g))))


def serve(cem: PlainCem, generator, lr, z_hr):
    """What ``eval_sr``'s forward computes from host inputs: the inputs
    replicate-padded by the CEM's margins, the generator, the combine, the
    margins cropped, and the result clamped to [0, 1] (float32)."""
    m, sf = cem.t.margins_lr, cem.t.sf
    lr_in = _replicate_pad(lr, m, m)
    z_in = _replicate_pad(z_hr, sf * m, sf * m) if z_hr is not None else None
    out = cem.enforce(lr_in, generator(lr_in, z_in))
    mh = sf * m
    return out[:, mh:-mh, mh:-mh, :].clamp(0.0, 1.0).float()
