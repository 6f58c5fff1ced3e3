"""Color-space conversions and image conversion in MATLAB's conventions.

The port's own copy of ``exsr/utils/color.py``; numpy only.  uint8 inputs
stay in [0, 255] and are rounded; float inputs are taken as [0, 1].
"""
from __future__ import annotations

import numpy as np
import torch

_RGB2YCBCR = np.array([[65.481, -37.797, 112.0],
                       [128.553, -74.203, -93.786],
                       [24.966, 112.0, -18.214]])
_YCBCR2RGB = np.array([[0.00456621, 0.00456621, 0.00456621],
                       [0, -0.00153632, 0.00791071],
                       [0.00625893, -0.00318811, 0]])


def rgb2ycbcr(img: np.ndarray, only_y: bool = True) -> np.ndarray:
    in_type = img.dtype
    x = img.astype(np.float64)
    if in_type != np.uint8:
        x = x * 255.0
    if only_y:
        out = x @ np.array([65.481, 128.553, 24.966]) / 255.0 + 16.0
    else:
        out = x @ _RGB2YCBCR / 255.0 + np.array([16.0, 128.0, 128.0])
    if in_type == np.uint8:
        return out.round().astype(np.uint8)
    return (out / 255.0).astype(in_type)


def ycbcr2rgb(img: np.ndarray) -> np.ndarray:
    in_type = img.dtype
    x = img.astype(np.float64)
    if in_type != np.uint8:
        x = x * 255.0
    out = x @ _YCBCR2RGB * 255.0 + np.array([-222.921, 135.576, -276.836])
    if in_type == np.uint8:
        return out.round().astype(np.uint8)
    return (out / 255.0).astype(in_type)


def modcrop(img: np.ndarray, scale: int) -> np.ndarray:
    """Crop so that both spatial dims are multiples of ``scale``."""
    h, w = img.shape[:2]
    return img[:h - h % scale, :w - w % scale, ...]


def tensor2img(x, min_max=(0.0, 1.0)) -> np.ndarray:
    """``[N, H, W, C]`` (first image) or ``[H, W, C]`` float values in
    ``min_max`` -> uint8 HWC image.  A tensor, on the GPU or not, is
    copied to the host here."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    arr = np.asarray(x)
    if arr.ndim == 4:
        arr = arr[0]
    arr = np.clip((arr - min_max[0]) / (min_max[1] - min_max[0]), 0, 1)
    return (arr * 255.0).round().astype(np.uint8)
