"""Z-space optimizer: the edit engine.

Counterpart of ``exsr/zopt/optimizer.py``.  Each Adam step runs the frozen
CEM-wrapped generator forward and backward on the latent map:

* ``Z = z_range * tanh(theta)``; a frozen-region mask blends the optimized
  and the initial pre-tanh Z;
* Adam on ``theta`` only, as ``optax.scale_by_adam()`` then ``scale(-lr)``
  (b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias corrections in
  fp32); the generator's weights take no gradient;
* the minimum-loss Z across the steps is returned, not the last;
* a negative ``max_iters`` iterates until the loss plateaus, capped at five
  chunks of ``|max_iters|`` steps;
* :meth:`ZOptimizer.optimize_rounds` is the GUI's round loop: rounds of a
  few steps, each accepted when its last loss beat the best so far, else
  reverted to the best Z with Adam reset and the learning rate divided by
  ``lr_decay``; rounds after the rate falls below ``min_lr`` do nothing
  and report NaN losses.

``exsr`` compiles each loop into one device program; here the steps run
from a host loop that reads the device once per chunk or round (the
losses), so the host does not wait on the device inside a round.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

MIN_LR = 1e-5
B1, B2, EPS = 0.9, 0.999, 1e-8


def atanh_init(z: torch.Tensor, z_range: float) -> torch.Tensor:
    """Map an existing Z into pre-tanh space."""
    eps = torch.finfo(z.dtype).eps
    return torch.atanh(torch.clamp(z / z_range, -1 + eps, 1 - eps))


def xavier_uniform_like(z: torch.Tensor, generator: torch.Generator,
                        gain: float = 100.0) -> torch.Tensor:
    """``torch.nn.init.xavier_uniform_(z, gain=100)`` on a ``[B, H, W, C]``
    map (fans computed on ``[B, C, h, w]``: fan_in = C*h*w, fan_out =
    B*h*w), drawn from ``generator`` on its device."""
    b, h, w, c = z.shape
    a = gain * np.sqrt(6.0 / (c * h * w + b * h * w))
    u = torch.rand(z.shape, generator=generator, dtype=z.dtype,
                   device=generator.device)
    return ((u * 2 - 1) * a).to(z.device)


def adam_init(theta: torch.Tensor):
    """``optax.scale_by_adam().init``: (count, mu, nu)."""
    return (0, torch.zeros_like(theta), torch.zeros_like(theta))


def adam_update(g: torch.Tensor, state, lr: float):
    """One ``scale_by_adam`` then ``scale(-lr)`` update:
    ``(update, new state)``."""
    count, mu, nu = state
    count += 1
    mu = (1 - B1) * g + B1 * mu
    nu = (1 - B2) * (g * g) + B2 * nu
    c1 = 1 - np.float32(B1) ** np.float32(count)
    c2 = 1 - np.float32(B2) ** np.float32(count)
    u = (mu / float(c1)) / (torch.sqrt(nu / float(c2)) + EPS)
    return (-1.0 * u) * float(np.float32(lr)), (count, mu, nu)


@dataclasses.dataclass
class ZOptimizer:
    """Z-space optimizer for one objective.

    ``forward_fn(z) -> out``: the frozen CEM-wrapped generator, closed over
    its weights and the LR input (or ``forward_fn(z, obj_args)``).
    ``objective_fn(out, z) -> scalar`` (or ``(out, z, obj_args)``).
    """
    forward_fn: Callable
    objective_fn: Callable
    lr: float = 0.1
    z_range: float = 1.0

    def init_state(self, pre_tanh_z: torch.Tensor):
        return adam_init(pre_tanh_z)

    def _effective(self, theta, z_mask, frozen_theta):
        if z_mask is None:
            return theta
        return z_mask * theta + (1.0 - z_mask) * frozen_theta

    def z_of(self, theta, z_mask=None, frozen_theta=None) -> torch.Tensor:
        return self.z_range * torch.tanh(
            self._effective(theta, z_mask, frozen_theta))

    def loss_and_grad(self, theta, z_mask, frozen_theta, obj_args=None):
        """The loss at ``theta`` and its gradient, both on the device."""
        with torch.enable_grad():
            theta = theta.detach().requires_grad_(True)
            z = self.z_of(theta, z_mask, frozen_theta)
            if obj_args is None:
                loss = self.objective_fn(self.forward_fn(z), z)
            else:
                loss = self.objective_fn(self.forward_fn(z, obj_args), z,
                                         obj_args)
            (g,) = torch.autograd.grad(loss, theta)
        return loss.detach(), g

    def _run(self, theta, opt_state, z_mask, frozen_theta, lr, obj_args,
             n_steps):
        best_loss = torch.full((), float('inf'), device=theta.device)
        best_theta = theta
        losses = []
        for _ in range(n_steps):
            loss, g = self.loss_and_grad(theta, z_mask, frozen_theta,
                                         obj_args)
            u, opt_state = adam_update(g, opt_state, lr)
            better = loss < best_loss
            best_loss = torch.where(better, loss, best_loss)
            best_theta = torch.where(better, theta, best_theta)
            theta = theta + u
            losses.append(loss)
        return theta, opt_state, best_loss, best_theta, torch.stack(losses)

    def optimize(self, pre_tanh_z: torch.Tensor, max_iters: int,
                 opt_state=None, z_mask: torch.Tensor | None = None,
                 frozen_theta: torch.Tensor | None = None,
                 use_min_loss_z: bool = True, lr: float | None = None,
                 obj_args=None):
        """Run the edit loop; returns ``(z, pre_tanh_z, opt_state,
        losses)``.

        ``max_iters`` < 0 runs in plateau mode: chunks of ``|max_iters|``
        steps until the relative improvement over a chunk falls below
        ``1e-2 * lr``, at most 5 chunks.
        """
        cur_lr = self.lr if lr is None else lr
        theta = pre_tanh_z
        if opt_state is None:
            opt_state = self.init_state(theta)
        if frozen_theta is None:
            frozen_theta = theta
        all_losses = []
        best = (np.inf, theta)
        if max_iters > 0:
            chunks, chunk_len = 1, max_iters
        else:
            chunks, chunk_len = 5, -max_iters
        for c in range(chunks):
            theta, opt_state, best_loss, best_theta, losses = self._run(
                theta, opt_state, z_mask, frozen_theta, cur_lr, obj_args,
                chunk_len)
            all_losses.extend(losses.cpu().tolist())
            if float(best_loss) < best[0]:
                best = (float(best_loss), best_theta)
            if max_iters < 0 and c > 0:
                ref = all_losses[max_iters]
                if (ref - all_losses[-1]) / (abs(ref) + 1e-30) \
                        < 1e-2 * self.lr:
                    break
        final_theta = best[1] if (use_min_loss_z
                                  and best[0] <= all_losses[-1]) else theta
        z = self.z_of(final_theta, z_mask, frozen_theta)
        return z, final_theta, opt_state, np.asarray(all_losses, np.float32)

    def optimize_rounds(self, pre_tanh_z: torch.Tensor, n_rounds: int,
                        iters_per_round: int = 5, lr: float | None = None,
                        z_mask: torch.Tensor | None = None,
                        frozen_theta: torch.Tensor | None = None,
                        lr_decay: float = 5.0, min_lr: float = MIN_LR,
                        obj_args=None):
        """The round loop: returns ``(z, best_theta, best_loss, final_lr,
        losses[n_rounds * iters_per_round])``, NaN after the rounds stop.
        One read of the device per round (its losses)."""
        if frozen_theta is None:
            frozen_theta = pre_tanh_z
        theta = best_theta = pre_tanh_z
        opt_state = adam_init(theta)
        best_loss = np.float32(np.inf)
        cur_lr = np.float32(self.lr if lr is None else lr)
        active = True
        out = np.full(n_rounds * iters_per_round, np.nan, np.float32)
        for r in range(n_rounds):
            if not active:
                break
            th, st, losses = theta, opt_state, []
            for _ in range(iters_per_round):
                loss, g = self.loss_and_grad(th, z_mask, frozen_theta,
                                             obj_args)
                u, st = adam_update(g, st, cur_lr)
                th = th + u
                losses.append(loss)
            losses = torch.stack(losses).float().cpu().numpy()
            out[r * iters_per_round:(r + 1) * iters_per_round] = losses
            if losses[-1] < best_loss:
                theta, opt_state = th, st
                best_loss, best_theta = losses[-1], th
            else:
                theta, opt_state = best_theta, adam_init(best_theta)
                cur_lr = np.float32(cur_lr / np.float32(lr_decay))
            active = bool(cur_lr >= min_lr)
        z = self.z_of(best_theta, z_mask, frozen_theta)
        return z, best_theta, float(best_loss), float(cur_lr), out
