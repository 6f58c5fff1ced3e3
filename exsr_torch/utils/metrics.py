"""Evaluation metrics: PSNR and SSIM on [0, 255] images, as MATLAB computes
them (float64, 11 x 11 Gaussian SSIM window of sigma 1.5 with a valid
crop, channel-averaged for RGB), and the LR-consistency error.

The port's own copy of ``exsr/utils/metrics.py``; numpy and scipy only.
"""
from __future__ import annotations

import math

import numpy as np
from scipy.signal import convolve2d

from exsr_torch.ops.resize import imresize


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    n = np.arange(size) - (size - 1) / 2.0
    g = np.exp(-(n ** 2) / (2.0 * sigma ** 2))
    g /= g.sum()
    return np.outer(g, g)


def calculate_psnr(img1: np.ndarray, img2: np.ndarray) -> float:
    """PSNR of two [0, 255] images."""
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    mse = np.mean((img1 - img2) ** 2)
    if mse == 0:
        return float('inf')
    return 20 * math.log10(255.0 / math.sqrt(mse))


def _ssim_2d(img1: np.ndarray, img2: np.ndarray) -> float:
    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    window = _gaussian_window()

    def filt(x):
        if x.ndim == 3:
            return np.stack([convolve2d(x[..., c], window, 'valid')
                             for c in range(x.shape[-1])], -1)
        return convolve2d(x, window, 'valid')

    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    mu1 = filt(img1)
    mu2 = filt(img2)
    sigma1_sq = filt(img1 ** 2) - mu1 ** 2
    sigma2_sq = filt(img2 ** 2) - mu2 ** 2
    sigma12 = filt(img1 * img2) - mu1 * mu2
    ssim_map = ((2 * mu1 * mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1 ** 2 + mu2 ** 2 + c1) * (sigma1_sq + sigma2_sq + c2))
    return float(ssim_map.mean())


def calculate_ssim(img1: np.ndarray, img2: np.ndarray) -> float:
    """SSIM of two [0, 255] images, gray or RGB (the RGB SSIM map averages
    its channels)."""
    if img1.shape != img2.shape:
        raise ValueError('Input images must have the same dimensions.')
    if img1.ndim == 3 and img1.shape[2] == 1:
        img1, img2 = img1[..., 0], img2[..., 0]
    return _ssim_2d(img1, img2)


def crop_border(img: np.ndarray, border: int) -> np.ndarray:
    if border == 0:
        return img
    return img[border:-border, border:-border, ...]


def lr_consistency_error(sr: np.ndarray, lr: np.ndarray, scale: int
                         ) -> float:
    """Mean ``|downscale(SR) - LR|`` inside a 4-pixel LR margin."""
    down = imresize(sr, 1.0 / scale)
    m = 4
    return float(np.mean(np.abs(down - lr)[m:-m, m:-m]))
