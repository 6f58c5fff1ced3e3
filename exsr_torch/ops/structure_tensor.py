"""Image-gradient structure tensors and the closed-form 2x2 symmetric SVD.

Counterpart of ``exsr/ops/structure_tensor.py``.  The explorable-SR latent
control Z is tied to the local gradient statistics of the output: the 2x2
structure tensor ``[[Ix^2, IxIy], [IxIy, Iy^2]]`` is eigendecomposed in
closed form, and its (lambda0, lambda1, theta) maps to and from the
3-channel Z of the SVD sliders.  NHWC tensors, built on the port's
depthwise filters (:mod:`exsr_torch.ops.filters`).
"""
from __future__ import annotations

import numpy as np
import torch

from exsr_torch.ops import filters as F

EPSILON = 1e-30

# 2x2 forward-difference filters: d/dx and d/dy
GRAD_X = np.array([[-1.0, 1.0], [0.0, 0.0]])
GRAD_Y = np.array([[-1.0, 0.0], [1.0, 0.0]])


def image_gradients(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel 2x2-difference gradients of an NHWC image: VALID
    correlation, ``[N, H-1, W-1, C]``."""
    c = x.shape[-1]
    wx = F.depthwise_weights(GRAD_X, c, x.dtype, x.device)
    wy = F.depthwise_weights(GRAD_Y, c, x.dtype, x.device)
    return F.depthwise_correlate(x, wx), F.depthwise_correlate(x, wy)


def structure_tensor_elements(x: torch.Tensor):
    """Per-pixel (Ix^2, Iy^2, Ix*Iy) maps, each ``[N, H-1, W-1, C]``."""
    ix, iy = image_gradients(x)
    return ix * ix, iy * iy, ix * iy


def svd_symmetric_2x2(a: torch.Tensor, d: torch.Tensor, b: torch.Tensor):
    """Closed-form singular values and angle of the symmetric
    ``[[a, b], [b, d]]``: ``(lambda0, lambda1, theta)``, lambda0 >=
    lambda1.  S1 and S2 are computed in float64, as ``exsr``'s (whose
    upcast holds where JAX runs with 64-bit types on)."""
    theta = 0.5 * torch.atan2(2 * b * (a + d), a ** 2 - d ** 2)
    a64, d64, b64 = a.double(), d.double(), b.double()
    s1 = a64 ** 2 + d64 ** 2 + 2 * (b64 ** 2)
    s2 = (a64 + d64) * torch.sqrt((a64 - d64) ** 2 + (2 * b64) ** 2
                                  + EPSILON)
    lam0 = torch.sqrt((s1 + s2) / 2 + EPSILON).to(a.dtype)
    lam1 = torch.sqrt((s1 - s2) / 2 + EPSILON).to(a.dtype)
    return lam0, lam1, theta


def valid_struct_tensor(a: torch.Tensor, d: torch.Tensor, b: torch.Tensor
                        ) -> torch.Tensor:
    """Numerical-validity indicator of the closed-form SVD."""
    return ((2 * b * (a + d)) ** 2 + (a ** 2 - d ** 2) ** 2) > EPSILON


def svd_to_latent_z(lambda0, lambda1, theta, max_lambda: float = 1.0
                    ) -> torch.Tensor:
    """(lambda0, lambda1, theta) slider controls -> 3-channel Z, channels
    last: lambda in [0, max_lambda] maps to [-max_lambda, max_lambda]."""
    lambda0, lambda1, theta = (torch.as_tensor(v, dtype=torch.float32)
                               for v in (lambda0, lambda1, theta))
    s, c = torch.sin(theta), torch.cos(theta)
    return torch.stack([
        2 * max_lambda * (lambda1 * s ** 2 + lambda0 * c ** 2) - max_lambda,
        2 * max_lambda * (lambda0 * s ** 2 + lambda1 * c ** 2) - max_lambda,
        2 * (lambda0 - lambda1) * s * c,
    ], dim=-1)
