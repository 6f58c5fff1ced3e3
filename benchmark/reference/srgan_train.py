"""The explorable-SR GAN's dual training steps, written plainly from the
published method (Bahat & Michaeli, "Explorable Super Resolution", and
the reference's ``codes/models/SRRaGAN_model.py`` as configured by
``train_explorable_SR.json``): WGAN-GP, a VGG-128 critic with batch
norm, range, latent (L_struct) and optimal-Z losses, and Adam.

* Z: per-image draws ``u`` ``[B, 1, 1, 3]`` through the structure-tensor
  sliders (``lambda0 = u0``, ``lambda1 = u1``, ``theta = 2 pi u2``).
* MAP Z: ``iters`` Adam steps (lr 1, optax's bias-corrected form) on
  pre-tanh Z from ``theta0`` against the L1 distance to the ground truth
  inside the CEM margins, the generator frozen; Z* is ``tanh`` of it.
* D step: the critic on the real crop, then on each fake (Z*, then the
  drawn Z), ``(2 * -D(real) + 2 * D(fake)) / 2`` plus 10 x the gradient
  penalty at ``alpha * real + (1 - alpha) * fake``, averaged over the
  fakes.
* G step: for Z* and the drawn Z, 5000 x the range excess / 2 and the
  critic's ``-D(fake)`` / 2; 100 x the L1 to the ground truth for Z*;
  for the drawn Z, L_struct: the structure-tensor moments of the output
  over the HR's, mapped through the 5 / 95 percentiles of the ratios seen
  so far (this step's on an empty record), against ``Z / 2``.

Everything is float32 with TF32 off (or at a control's precision; a
caller runs the steps inside :func:`benchmark.reference.precision.flags`,
which covers the backward passes too), one module-free function per
layer; the CEM is :class:`benchmark.reference.cem.PlainCem` in float32.  Each step returns its loss and the gradients
and its terms of the drawn Z (those the MAP loop does not reach), and
leaves the Adam update to :func:`adam`.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import cem as rcem
from benchmark.reference.precision import flags, rounding

BN_EPS = 1e-5


# ------------------------------------------------------------------ critic
def critic_shapes(nf: int = 64, in_nc: int = 3, patch: int = 128) -> dict:
    """``{name: shape}`` of the VGG-128 critic (names of ``exsr_torch``'s
    ``DiscriminatorVGG128``): ten conv blocks, 3 x 3 then 4 x 4 stride 2
    in turn, batch norm after all but the first, the FC head."""
    feats = [nf, nf, 2 * nf, 2 * nf, 4 * nf, 4 * nf, 8 * nf, 8 * nf, 8 * nf,
             8 * nf]
    out, cin, size = {}, in_nc, patch
    for i, co in enumerate(feats):
        k = 4 if i % 2 else 3
        out[f'conv{i}.conv.weight'] = (co, cin, k, k)
        out[f'conv{i}.conv.bias'] = (co,)
        if i:
            for leaf in ('weight', 'bias', 'running_mean', 'running_var'):
                out[f'conv{i}.bn.{leaf}'] = (co,)
        size = size // 2 if k == 4 else size
        cin = co
    out['fc0.weight'] = (100, size * size * cin)
    out['fc0.bias'] = (100,)
    out['fc1.weight'] = (1, 100)
    out['fc1.bias'] = (1,)
    return out


def critic(p: dict, precision: str = 'float32'):
    """``D(x)``: NHWC ``[B, 128, 128, 3]`` to logits ``[B, 1]``; batch norm
    by the batch's mean and biased variance."""
    def op(fn, x, w, *a, **k):
        rnd = rounding(precision, x)
        if rnd is not None:
            x, w = rnd(x), rnd(w)
        with flags(precision):
            return fn(x, w, *a, **k)

    def d(x):
        h = x.permute(0, 3, 1, 2)
        for i in range(10):
            k = 4 if i % 2 else 3
            h = op(F.conv2d, h, p[f'conv{i}.conv.weight'],
                   p[f'conv{i}.conv.bias'], stride=2 if k == 4 else 1,
                   padding=(k - 1) // 2)
            if i:
                var, mean = torch.var_mean(h, dim=(0, 2, 3), correction=0)
                h = (h - mean[:, None, None]) * torch.rsqrt(
                    var[:, None, None] + BN_EPS)
                h = h * p[f'conv{i}.bn.weight'][:, None, None] + \
                    p[f'conv{i}.bn.bias'][:, None, None]
            h = F.leaky_relu(h, 0.2)
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        h = F.leaky_relu(op(F.linear, h, p['fc0.weight'], p['fc0.bias']),
                         0.2)
        return op(F.linear, h, p['fc1.weight'], p['fc1.bias'])
    return d


# --------------------------------------------------------------- pieces
def latent_z(u: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The structure-tensor sliders to the 3-channel Z, ``[B, h, w, 3]``."""
    l0, l1, th = u[..., 0], u[..., 1], 2 * np.pi * u[..., 2]
    s, c = torch.sin(th), torch.cos(th)
    z = torch.stack([2 * (l1 * s ** 2 + l0 * c ** 2) - 1,
                     2 * (l0 * s ** 2 + l1 * c ** 2) - 1,
                     2 * (l0 - l1) * s * c], dim=-1)
    return z.expand(u.shape[0], h, w, 3)


def st_moments(img: torch.Tensor) -> torch.Tensor:
    """``[3, B]``: means over pixels and channels of Ix^2, Iy^2 and IxIy,
    with forward differences on the ``(H-1) x (W-1)`` grid."""
    ix = img[:, :-1, 1:] - img[:, :-1, :-1]
    iy = img[:, 1:, :-1] - img[:, :-1, :-1]
    return torch.stack([ix * ix, iy * iy, ix * iy]).mean(dim=(2, 3, 4))


def l_struct(sr, hr, z, noise=1.0 / 255.0):
    """The latent loss of one step on an empty record of ratios: the
    output's moments over ``sqrt(Ixx Iyy)`` of the HR, against ``Z / 2``
    scaled into the 5 / 95 percentile span of this step's ratios."""
    m_sr, m_hr = st_moments(sr), st_moments(hr)
    measured = m_sr / (torch.sqrt(m_hr[0]) * torch.sqrt(m_hr[1]) + noise)
    lo = torch.quantile(measured, 0.05, dim=1)
    hi = torch.quantile(measured, 0.95, dim=1)
    target = z.mean(dim=(1, 2)) / 2.0 * (hi - lo) + (hi + lo) / 2.0
    return (measured.T - target).abs().mean()


def gradient_penalty(d, real, fake, alpha):
    x = (alpha * real + (1.0 - alpha) * fake).detach().requires_grad_()
    g, = torch.autograd.grad(d(x).sum(), x, create_graph=True)
    norms = torch.sqrt((g.reshape(g.shape[0], -1) ** 2).sum(1) + 1e-12)
    return ((norms - 1.0) ** 2).mean()


class Steps:
    """The two dual steps of one configuration.  ``g_fn(params,
    precision)`` builds the generator; ``params`` are dicts of leaf
    tensors (the caller makes them leaves that require gradients)."""

    def __init__(self, cfg: dict, g_fn, precision: str = 'float32'):
        t = cfg['train']
        self.t, self.precision, self.g_fn = t, precision, g_fn
        self.taps = rcem.cem_taps(cfg['scale'])
        self.cem = rcem.PlainCem(self.taps, dtype=torch.float32)
        self.m = cfg['scale'] * self.taps.margins_lr

    def g_apply(self, gp, lr, z):
        """The CEM-wrapped generator without pre-padding, its margins
        cropped."""
        out = self.cem.enforce(lr, self.g_fn(gp, self.precision)(lr, z))
        m = self.m
        return out[:, m:-m, m:-m, :]

    def map_z(self, gp, lr, ref, theta0):
        theta = theta0.clone()
        mu, nu = torch.zeros_like(theta), torch.zeros_like(theta)
        for i in range(1, self.t['optimal_z_iters'] + 1):
            th = theta.detach().requires_grad_()
            loss = (self.g_apply(gp, lr, torch.tanh(th)) - ref).abs().mean()
            g, = torch.autograd.grad(loss, th)
            mu = 0.1 * g + 0.9 * mu
            nu = 0.001 * g * g + 0.999 * nu
            c1 = float(1 - np.float32(0.9) ** np.float32(i))
            c2 = float(1 - np.float32(0.999) ** np.float32(i))
            theta = theta - self.t['optimal_z_lr'] * (mu / c1) / (
                torch.sqrt(nu / c2) + 1e-8)
        return torch.tanh(theta).detach()

    def d_step(self, gp, dp, batch, draws):
        """``(loss, the drawn Z's term, {leaf: gradient}, the critic's
        mean logits on the real crop and on the drawn Z's fake)`` of one
        dual D step."""
        lr, hr = batch['lr'], batch['hr']
        m = self.m
        ref = hr[:, m:-m, m:-m, :]
        z = latent_z(draws['u'], hr.shape[1], hr.shape[2])
        gdet = {k: v.detach() for k, v in gp.items()}
        z_star = self.map_z(gdet, lr, ref, draws['theta0'][0])
        with torch.no_grad():
            fakes = [self.g_apply(gdet, lr, z_star), self.g_apply(gdet, lr, z)]
        d = critic(dp, self.precision)
        pred_real = d(ref)
        total = 0.0
        for fake, alpha in zip(fakes, draws['alpha'][0]):
            pred_fake = d(fake)
            term = (2 * -pred_real.mean() + 2 * pred_fake.mean()) / 2.0 + \
                self.t['gp_weight'] * gradient_penalty(d, ref, fake, alpha)
            total = total + term
        total = total / len(fakes)
        grads = torch.autograd.grad(total, list(dp.values()),
                                    allow_unused=True)
        logits = [float(pred_real.detach().mean()),
                  float(pred_fake.detach().mean())]
        return total.detach(), term.detach(), _grads(dp, grads), logits

    def g_step(self, gp, dp, batch, draws):
        """``(loss, the drawn Z's terms, {leaf: gradient}, the drawn Z's
        range and latent terms as weighed)`` of one dual G step."""
        t = self.t
        lr, hr = batch['lr'], batch['hr']
        m = self.m
        ref = hr[:, m:-m, m:-m, :]
        z = latent_z(draws['u'], hr.shape[1], hr.shape[2])
        gdet = {k: v.detach() for k, v in gp.items()}
        z_star = self.map_z(gdet, lr, ref, draws['theta0'][0])
        d = critic({k: v.detach() for k, v in dp.items()}, self.precision)
        total = 0.0
        for zz, is_opt in ((z_star, True), (z, False)):
            fake = self.g_apply(gp, lr, zz)
            excess = torch.clamp(fake - 1.0, min=0) + torch.clamp(-fake,
                                                                   min=0)
            l_range = t['range_weight'] * excess.mean() / 2
            term = l_range + t['gan_weight'] * -d(fake).mean() / 2
            if is_opt:
                term = term + t['optimal_z_weight'] * (fake - ref).abs().mean()
            else:
                l_lat = t['latent_weight'] * l_struct(fake, ref, zz)
                term = term + l_lat
            total = total + term
        grads = torch.autograd.grad(total, list(gp.values()),
                                    allow_unused=True)
        return (total.detach(), term.detach(), _grads(gp, grads),
                [float(l_range.detach()), float(l_lat.detach())])


def _grads(params: dict, grads) -> dict:
    """Gradients by name, a leaf the loss does not reach given zeros."""
    return {k: torch.zeros_like(p) if g is None else g
            for (k, p), g in zip(params.items(), grads)}


def adam(params: dict, grads: dict, state: dict, lr: float) -> None:
    """One Adam update in place (betas 0.9, 0.999, eps 1e-8, bias
    corrected), ``state`` holding ``t`` and each leaf's moments."""
    t = state['t'] = state.get('t', 0) + 1
    with torch.no_grad():
        for k, p in params.items():
            g = grads[k]
            mu = state.setdefault(('mu', k), torch.zeros_like(p))
            nu = state.setdefault(('nu', k), torch.zeros_like(p))
            mu.mul_(0.9).add_(0.1 * g)
            nu.mul_(0.999).add_(0.001 * g * g)
            denom = (nu / (1 - 0.999 ** t)).sqrt() + 1e-8
            p.sub_(lr * (mu / (1 - 0.9 ** t)) / denom)


def leaf_gaps(prog: dict, ref: dict) -> tuple:
    """``(median, worst)`` over the leaves of ``ref`` of the gap of norms,
    ``| |p| - |r| | / max(|r|, the median leaf's |r|)``."""
    rn = {k: float(ref[k].norm()) for k in ref}
    med = float(np.median(list(rn.values())))
    gaps = [abs(float(prog[k].norm()) - n) / max(n, med)
            for k, n in rn.items()]
    if not all(math.isfinite(g) for g in gaps):
        return math.inf, math.inf
    return float(np.median(gaps)), max(gaps)
