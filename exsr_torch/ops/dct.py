"""Blockwise orthonormal DCT of the JPEG pipeline.

Counterpart of ``exsr/ops/dct.py``.  The 2-D DCT-II of a ``bs x bs`` block
is ``M @ X @ M.T`` against the orthonormal basis ``M`` (:func:`dct_matrix`)
and its inverse ``M.T @ C @ M``: two fp32 matrix products per transform, as
``exsr``'s einsum.  On CUDA the caller runs them with TF32 off
(:func:`exsr_torch.device.full_fp32`): a TF32 product would move a DC
coefficient of ~1000 by up to ~0.5, across a quantisation bin.

Layout is NHWC: images are ``[N, H, W, 1]`` and coefficients
``[N, H/bs, W/bs, bs*bs]`` with coefficient ``c = ky*bs + kx``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def dct_matrix(n: int = 8) -> np.ndarray:
    """Orthonormal DCT-II basis ``M`` (float64) with ``coeffs = M @ x``:
    ``M[k, i] = f_k cos(pi k (2i + 1) / 2n)``, ``f_0 = 1/sqrt(n)``,
    ``f_k = sqrt(2/n)``."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    m = np.cos(np.pi * k * (2 * i + 1) / (2 * n))
    m[0] *= 1.0 / np.sqrt(n)
    m[1:] *= np.sqrt(2.0 / n)
    return m


def _basis(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(dct_matrix(n), dtype=like.dtype, device=like.device)


def blockize(image: torch.Tensor, bs: int = 8) -> torch.Tensor:
    """``[N, H, W, 1]`` image -> ``[N, H/bs, W/bs, bs, bs]`` blocks."""
    n, h, w, c = image.shape
    if c != 1:
        raise ValueError(f'blockize takes one channel, got {c}')
    x = image.reshape(n, h // bs, bs, w // bs, bs)
    return x.permute(0, 1, 3, 2, 4)


def unblockize(blocks: torch.Tensor) -> torch.Tensor:
    """``[N, hb, wb, bs, bs]`` blocks -> ``[N, hb*bs, wb*bs, 1]`` image."""
    n, hb, wb, bsy, bsx = blocks.shape
    x = blocks.permute(0, 1, 3, 2, 4).reshape(n, hb * bsy, wb * bsx)
    return x[..., None]


def block_dct2(blocks: torch.Tensor) -> torch.Tensor:
    """2-D orthonormal DCT-II over the trailing two ``(bs, bs)`` dims."""
    m = _basis(blocks.shape[-1], blocks)
    return m @ blocks @ m.T


def block_idct2(coeffs: torch.Tensor) -> torch.Tensor:
    """2-D orthonormal DCT-III, the inverse of :func:`block_dct2`."""
    m = _basis(coeffs.shape[-1], coeffs)
    return m.T @ coeffs @ m


def image_to_dct(image: torch.Tensor, bs: int = 8) -> torch.Tensor:
    """``[N, H, W, 1]`` -> ``[N, H/bs, W/bs, bs*bs]`` DCT coefficients."""
    coeffs = block_dct2(blockize(image, bs))
    return coeffs.reshape(coeffs.shape[:3] + (bs * bs,))


def dct_to_image(coeffs: torch.Tensor, bs: int = 8) -> torch.Tensor:
    """Inverse of :func:`image_to_dct`."""
    blocks = coeffs.reshape(coeffs.shape[:3] + (bs, bs))
    return unblockize(block_idct2(blocks))
