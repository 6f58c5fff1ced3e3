"""Mask-driven patch extraction for local Z-edit objectives.

Counterpart of ``exsr/zopt/patches.py``.  The host computes the flat pixel
indices of each valid patch once per mask (``[P, patch_size**2]`` int32,
numpy and scipy); the device gathers them with one index.  Selection:
binary opening of the mask by a patch-size square, sliding-window
candidates fully inside the mask, then greedy row-major dropping of
patches whose pixels are already covered beyond the overlap fraction.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.ndimage import binary_opening


def patch_indices_from_mask(mask: np.ndarray, patch_size: int,
                            patches_overlap: float = 1.0,
                            return_non_covered: bool = False):
    """Flat pixel indices of valid patches: int32 ``[P, patch_size**2]``.

    ``patches_overlap``: the largest fraction of a candidate's pixels that
    accepted patches may already cover (1 keeps all).  With
    ``return_non_covered``, also the flat indices of masked pixels that no
    accepted patch covers (or None).
    """
    mask = binary_opening(mask.astype(bool),
                          np.ones([patch_size, patch_size], dtype=bool))
    h, w = mask.shape
    ids = np.arange(mask.size).reshape(mask.shape)
    ph = h - patch_size + 1
    pw = w - patch_size + 1
    if ph <= 0 or pw <= 0:
        empty = np.zeros((0, patch_size ** 2), np.int32)
        return (empty, None) if return_non_covered else empty
    win_ids = np.lib.stride_tricks.sliding_window_view(
        ids, (patch_size, patch_size)).reshape(-1, patch_size ** 2)
    win_valid = np.lib.stride_tricks.sliding_window_view(
        mask, (patch_size, patch_size)).reshape(-1, patch_size ** 2)
    candidates = win_ids[np.all(win_valid, axis=1)]
    taken = np.zeros(mask.size, dtype=bool)
    if patches_overlap < 1 and len(candidates):
        keep = np.ones(len(candidates), dtype=bool)
        for i, patch in enumerate(candidates):
            covered = taken[patch]
            if (patches_overlap == 0 and covered.any()) or \
                    covered.mean() > patches_overlap:
                keep[i] = False
                continue
            taken[patch] = True
        candidates = candidates[keep]
    elif len(candidates):
        taken[candidates.reshape(-1)] = True
    out = candidates.astype(np.int32)
    if return_non_covered:
        masked = np.flatnonzero(mask.reshape(-1))
        non_covered = masked[~taken[masked]].astype(np.int32)
        return out, (non_covered if non_covered.size else None)
    return out


def gather_patches(img_2d: torch.Tensor, indices: torch.Tensor
                   ) -> torch.Tensor:
    """``[..., H, W]`` image(s) -> ``[..., P, patch_size**2]`` patches."""
    flat = img_2d.reshape(*img_2d.shape[:-2], -1)
    return flat[..., indices.long()]


def masked_patch_std(img_gray: torch.Tensor, indices: torch.Tensor,
                     non_covered: torch.Tensor | None = None
                     ) -> torch.Tensor:
    """Per-patch STD (ddof 1) of ``[..., H, W]`` grayscale image(s) over
    the patches, then the STD of the leftover non-covered pixels."""
    stds = torch.std(gather_patches(img_gray, indices), dim=-1,
                     correction=1)
    if non_covered is not None:
        flat = img_gray.reshape(*img_gray.shape[:-2], -1)
        extra = torch.std(flat[..., non_covered.long()], dim=-1,
                          correction=1)
        stds = torch.cat([stds, extra[..., None]], -1)
    return stds
