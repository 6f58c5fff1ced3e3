"""Depthwise filtering primitives of the CEM consistency chain (PyTorch).

Counterpart of ``exsr/ops/filters.py``.  Public functions take and return
NHWC tensors; inside, the convolutions run on ``x.permute(0, 3, 1, 2)``, an
NCHW view in ``channels_last`` memory.  Depthwise weights use PyTorch's
layout ``[C, 1, kh, kw]`` (``exsr`` uses HWIO ``[kh, kw, 1, C]``).

The CEM chain stays fp32: ``exsr`` runs it at ``precision=HIGHEST``, and
cuDNN would otherwise run fp32 convolutions in TF32 on the GPU, which
breaks the ~1e-6 consistency guarantee.  :func:`depthwise_correlate`
turns TF32 off around its convolution
(:func:`exsr_torch.device.full_fp32`).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from exsr_torch.device import full_fp32


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC tensor -> NCHW view (``channels_last`` memory, no copy)."""
    return x.permute(0, 3, 1, 2)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW tensor -> NHWC view (contiguous when ``x`` is channels_last)."""
    return x.permute(0, 2, 3, 1)


def depthwise_weights(kernel2d, channels: int, dtype=torch.float32,
                      device=None) -> torch.Tensor:
    """Tile a 2-D kernel into depthwise-conv weights ``[C, 1, kh, kw]``."""
    k = torch.as_tensor(np.asarray(kernel2d, np.float64), dtype=dtype,
                        device=device)
    return k[None, None].repeat(channels, 1, 1, 1)


def depthwise_weights_1d(taps, channels: int, axis: int,
                         dtype=torch.float32, device=None) -> torch.Tensor:
    """Weights of a 1-D depthwise filter along H (``axis=0``) or W."""
    t = np.asarray(taps, np.float64)
    k2 = t[:, None] if axis == 0 else t[None, :]
    return depthwise_weights(k2, channels, dtype, device)


def separable_factors(kernel2d: np.ndarray, tol: float = 1e-10):
    """Rank-1 factorization ``k = outer(col, row)`` if the 2-D kernel is
    (numerically) separable, else None.

    The CEM's bicubic kernels are exact outer products, and inv_hTh of a
    separable filter is itself separable, so the whole CEM filter chain
    reduces to 1-D passes.
    """
    k = np.asarray(kernel2d, dtype=np.float64)
    u, s, vt = np.linalg.svd(k)
    if s[0] == 0 or (len(s) > 1 and s[1] > tol * s[0]):
        return None
    col = u[:, 0] * np.sqrt(s[0])
    row = vt[0] * np.sqrt(s[0])
    # canonical sign: the SVD's is arbitrary, flipping both factors leaves
    # the outer product unchanged
    if col.sum() < 0 and row.sum() < 0:
        col, row = -col, -row
    if not np.allclose(np.outer(col, row), k,
                       atol=10 * tol * max(abs(s[0]), 1.0)):
        return None
    return col, row


def replicate_pad(x: torch.Tensor, pad_h: int, pad_w: int | None = None
                  ) -> torch.Tensor:
    """Replicate (edge) padding of an NHWC tensor's spatial dims."""
    if pad_w is None:
        pad_w = pad_h
    return to_nhwc(F.pad(to_nchw(x), (pad_w, pad_w, pad_h, pad_h),
                         mode='replicate'))


def depthwise_correlate(x: torch.Tensor, weights: torch.Tensor
                        ) -> torch.Tensor:
    """VALID depthwise cross-correlation of NHWC ``x`` with ``[C,1,kh,kw]``
    weights, in full fp32 (TF32 off)."""
    with full_fp32():
        y = F.conv2d(to_nchw(x), weights.to(x.dtype), groups=x.shape[-1])
    return to_nhwc(y)


def filter_replicate_same(x: torch.Tensor, weights: torch.Tensor
                          ) -> torch.Tensor:
    """Depthwise correlation with replicate padding to 'same' size.

    pad = floor(k/2) on each side, so an even kernel grows the output by
    one pixel (``exsr/ops/filters.py:58-68``).
    """
    kh, kw = weights.shape[2], weights.shape[3]
    return depthwise_correlate(replicate_pad(x, kh // 2, kw // 2), weights)


def filter_replicate_same_separable(x: torch.Tensor, w_col: torch.Tensor,
                                    w_row: torch.Tensor) -> torch.Tensor:
    """Separable :func:`filter_replicate_same`: column taps ``[C,1,kh,1]``
    along H, then row taps ``[C,1,1,kw]`` along W.  Replicate padding
    commutes across the two passes, so this equals the 2-D filter up to fp
    summation order."""
    kh, kw = w_col.shape[2], w_row.shape[3]
    y = depthwise_correlate(replicate_pad(x, kh // 2, 0), w_col)
    return depthwise_correlate(replicate_pad(y, 0, kw // 2), w_row)


def clip_unit(x: torch.Tensor) -> torch.Tensor:
    """``x`` clipped to [0, 1] as ``jnp.clip`` clips: a maximum, then a
    minimum, each of which splits the gradient at an exact tie
    (``torch.clamp`` would pass all of it)."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))


def zero_stuff(x: torch.Tensor, f: int, pre: tuple[int, int]
               ) -> torch.Tensor:
    """Zero-stuffing upsample: each pixel lands at sub-position ``pre`` of
    its f x f cell."""
    n, h, w, c = x.shape
    out = x.new_zeros((n, h, f, w, f, c))
    out[:, :, pre[0], :, pre[1], :] = x
    return out.reshape(n, h * f, w * f, c)


def aliased_subsample(x: torch.Tensor, f: int, pre: tuple[int, int]
                      ) -> torch.Tensor:
    """Strided subsampling at sub-position ``pre`` of each f x f cell (a
    view)."""
    return x[:, pre[0]::f, pre[1]::f, :]


def bilinear_resize(x: torch.Tensor, out_h: int, out_w: int
                    ) -> torch.Tensor:
    """Bilinear resize of NHWC with half-pixel centers, antialias off
    (``exsr`` uses ``jax.image.resize(antialias=False)``)."""
    y = F.interpolate(to_nchw(x), size=(out_h, out_w), mode='bilinear',
                      align_corners=False)
    return to_nhwc(y)


def nearest_upsample(x: torch.Tensor, f: int) -> torch.Tensor:
    """Nearest-neighbour upsample of NHWC by integer factor ``f``."""
    n, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(n, h, f, w, f, c)
    return x.reshape(n, h * f, w * f, c)
