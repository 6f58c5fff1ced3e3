"""Training losses of the SR trainer.

Counterpart of ``exsr/losses/losses.py``: the adversarial losses (vanilla,
lsgan, wgan) with the optional hinge clamp, the range loss, the WGAN
gradient penalty and the plain distances.  Functions of NHWC tensors.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def gan_loss(gan_type: str, pred: torch.Tensor, target_is_real: bool,
             hinge_threshold: float | None = None) -> torch.Tensor:
    """Adversarial loss on raw critic outputs: ``vanilla`` is binary cross
    entropy with logits, ``lsgan`` the squared distance to the label, any
    ``wgan*`` the signed mean.  ``hinge_threshold`` clamps real predictions
    from above and fake ones from below first."""
    if hinge_threshold is not None:
        t = pred.new_tensor(hinge_threshold)
        pred = (torch.minimum(pred, t) if target_is_real
                else torch.maximum(pred, -t))
    if gan_type == 'vanilla':
        labels = torch.full_like(pred, 1.0 if target_is_real else 0.0)
        return F.binary_cross_entropy_with_logits(pred, labels)
    if gan_type == 'lsgan':
        labels = torch.full_like(pred, 1.0 if target_is_real else 0.0)
        return torch.mean((pred - labels) ** 2)
    if 'wgan' in gan_type:
        return -pred.mean() if target_is_real else pred.mean()
    raise NotImplementedError(f'GAN type [{gan_type}] is not found')


def range_loss(x: torch.Tensor, legit_range=(0.0, 1.0),
               chroma_mode: bool = False) -> torch.Tensor:
    """Mean deviation outside ``[lo, hi]`` over all pixels; with
    ``chroma_mode`` the first channel is left out.  ``torch.maximum``
    splits the gradient at a tie, as ``jnp.maximum`` does."""
    lo, hi = legit_range
    if chroma_mode:
        x = x[..., 1:]
    zero = x.new_zeros(())
    return torch.maximum(torch.maximum(x - hi, zero),
                         torch.maximum(lo - x, zero)).mean()


def gradient_penalty(d_apply: Callable, real: torch.Tensor,
                     fake: torch.Tensor, alpha: torch.Tensor
                     ) -> torch.Tensor:
    """WGAN-GP: the mean of ``(||grad_x D(x)||_2 - 1)^2`` at ``x = alpha *
    real + (1 - alpha) * fake``, ``alpha`` ``[B, 1, 1, 1]`` uniform in
    [0, 1).  The input gradient keeps its graph (``create_graph``), so the
    penalty differentiates it in the critic's parameters."""
    interp = (alpha * real + (1.0 - alpha) * fake).detach().requires_grad_()
    grads, = torch.autograd.grad(d_apply(interp).sum(), interp,
                                 create_graph=True)
    norms = torch.sqrt(torch.sum(grads.reshape(grads.shape[0], -1) ** 2,
                                 dim=1) + 1e-12)
    return torch.mean((norms - 1.0) ** 2)


def l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a - b).abs().mean()


def l2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a - b) ** 2)


def masked_l1(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor
              ) -> torch.Tensor:
    """L1 over a CEM loss mask."""
    return (mask * (a - b)).abs().mean()
