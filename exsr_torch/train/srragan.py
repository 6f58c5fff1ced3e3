"""The explorable-SR GAN trainer: D and G steps, with the host controller
beside them.

Counterpart of ``exsr/train/srragan.py``.  Each step is a host loop of
eager PyTorch on the device: it draws its random numbers from the train
state's ``torch.Generator``, computes the gradients from those draws
(:meth:`SRRaGANTrainer.d_grads`, :meth:`SRRaGANTrainer.g_grads`, the
counterparts of ``exsr``'s ``_d_grads`` and ``_g_grads``), and applies one
Adam update.  The semantics are ``exsr``'s:

* Z per batch: per-image uniform draws ``u`` ``[B, 1, 1, nz]``, mapped
  through ``svd_to_latent_z`` in the SVD modes, else ``2u - 1``;
* the dual G step, once the generator has started learning: a MAP term on
  the Z* of ``optimal_z_iters`` inner Adam steps on pre-tanh Z against L1
  to the ground truth (generator frozen, Xavier-uniform gain-100 start,
  Z* detached), plus the static-Z term;
* losses: range, pixel, VGG feature, the optimal-Z L1, L_struct on the
  static Z, and the adversarial term, with ``exsr``'s dual-step
  normalizations; all on crops with the CEM margins removed;
* the D step: the real pass then one fake pass per Z, the fakes detached;
  a non-relativistic D doubles each term; WGAN-GP adds one penalty per
  fake, whose second-order gradient runs through D only;
* ``grad_accum_*`` microbatches run one after another, their gradients
  averaged before the one update; D's running statistics and the
  L_struct ring carry from one microbatch to the next.

The outer optimizers are ``torch.optim.Adam`` with the learning rate
``lr * multistep_lr(step) * lr_scale`` set before every update, which is
``optax.scale_by_adam`` followed by that scale.  Steps run in full fp32:
TF32 is off inside them, as ``exsr`` trains in fp32.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import numpy as np
import torch

from exsr_torch.device import resolve_device
from exsr_torch.losses import losses as L
from exsr_torch.losses.filter_loss import (FilterLossConfig, RatioStats,
                                           filter_loss, num_latent_channels)
from exsr_torch.ops.structure_tensor import svd_to_latent_z
from exsr_torch.zopt.optimizer import (adam_init, adam_update,
                                       xavier_uniform_like)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The training options (``exsr``'s ``TrainConfig``)."""
    scale: int = 4
    patch_size: int = 208
    lr_g: float = 1e-5
    lr_d: float = 1e-5
    beta1_g: float = 0.9
    beta2_g: float = 0.999
    beta1_d: float = 0.9
    beta2_d: float = 0.999
    lr_steps: tuple[int, ...] = (50_000, 100_000, 200_000, 300_000)
    lr_gamma: float = 0.5
    gan_type: str = 'wgan-gp'
    gan_weight: float = 1.0
    gp_weight: float = 10.0
    range_weight: float | None = 5000.0
    latent_weight: float | None = 1.0
    pixel_weight: float | None = None
    feature_weight: float | None = None
    optimal_z_weight: float | None = 100.0
    optimal_z_iters: int = 10
    optimal_z_lr: float = 1.0
    latent_channels: str = 'SVDinNormedOut_structure_tensor'
    relativistic: bool = False
    add_quantization_noise: bool = False
    hinge_threshold: float | None = None
    d_update_ratio: int = 10
    d_valid_steps_4_g_update: int = 10
    min_d_prob_ratio_4_g: float = 1.05
    min_mean_d_correct: float = 0.9
    d_init_iters: int = 0
    steps_4_loss_std: int = 500
    std_4_lr_drop: float | None = 1e6
    niter: int = 510_000
    input_range: tuple[float, float] = (0.0, 1.0)
    # microbatches of one virtual batch, their gradients averaged
    grad_accum_g: int = 1
    grad_accum_d: int = 1
    # the D judges the CEM's (low, high) pair; needs a pair-input D and a
    # g_apply_decomp
    decomposed_d: bool = False

    @property
    def num_latent_channels(self) -> int:
        return num_latent_channels(self.latent_channels)

    @property
    def svd_mode(self) -> bool:
        return self.latent_channels in ('SVD_structure_tensor',
                                        'SVDinNormedOut_structure_tensor')


def multistep_lr(base: float, steps, gamma: float, step: int) -> float:
    """MultiStepLR's value at ``step``, in float32 as ``exsr`` computes
    it."""
    lr = np.float32(base)
    for s in steps:
        if step >= s:
            lr = lr * np.float32(gamma)
    return float(lr)


@contextlib.contextmanager
def full_fp32():
    """cuDNN convolutions and matmuls in full fp32 (TF32 off) within the
    block."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


@dataclasses.dataclass
class TrainState:
    """Everything a training run carries from step to step: the generator
    and the discriminator (with its running statistics), one Adam each,
    the L_struct ring, the random-number generator of the draws, the step
    and the learning-rate scale that instability rollbacks halve."""
    g: torch.nn.Module
    d: torch.nn.Module
    g_opt: torch.optim.Adam
    d_opt: torch.optim.Adam
    ratio_stats: RatioStats
    generator: torch.Generator
    step: int = 0
    lr_scale: float = 1.0

    def state_dict(self) -> dict:
        """A dict of tensors, numbers and nested dicts that
        ``torch.load(..., weights_only=True)`` reads back; ``'g_params'``
        is the generator's state dict, as evaluation loads it."""
        return {'g_params': self.g.state_dict(),
                'd_vars': self.d.state_dict(),
                'g_opt': self.g_opt.state_dict(),
                'd_opt': self.d_opt.state_dict(),
                'ratio_stats': self.ratio_stats.state_dict(),
                'rng': self.generator.get_state(),
                'step': int(self.step), 'lr_scale': float(self.lr_scale)}

    def load_state_dict(self, state: dict) -> 'TrainState':
        device = self.ratio_stats.buffer.device
        self.g.load_state_dict(state['g_params'])
        self.d.load_state_dict(state['d_vars'])
        self.g_opt.load_state_dict(state['g_opt'])
        self.d_opt.load_state_dict(state['d_opt'])
        self.ratio_stats = RatioStats.from_state_dict(state['ratio_stats'],
                                                      device)
        self.generator.set_state(state['rng'].cpu())
        self.step = int(state['step'])
        self.lr_scale = float(state['lr_scale'])
        return self


def _microbatches(accum: int, *tensors):
    """Split ``[B, ...]`` tensors into ``accum`` consecutive
    microbatches: one tuple per microbatch."""
    b = tensors[0].shape[0]
    if b % accum:
        raise ValueError(f'batch {b} not divisible by accum {accum}')
    return list(zip(*(t.split(b // accum) for t in tensors)))


def _grads(params) -> list:
    """The parameters' gradients, a parameter that the loss does not reach
    given zeros (as ``jax.grad`` gives it, so that Adam moves it alike)."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return [p.grad for p in params]


def _mean_metrics(parts: list[dict]) -> dict:
    if len(parts) == 1:
        return parts[0]
    return {k: torch.stack([p[k] for p in parts]).mean() for k in parts[0]}


class SRRaGANTrainer:
    """The D and G steps of one model configuration.

    ``g_apply(g, lr, z_hr) -> generated`` is the CEM-wrapped generator in
    train mode (no pre-pad), ``g`` the generator module;
    ``g_apply_decomp`` the same returning the CEM's ``(low, high)`` pair
    (for ``decomposed_d``).  The discriminator is a module whose
    ``forward(x, update_stats)`` returns logits and moves its running
    statistics only when ``update_stats`` is set.  ``f_apply`` is the
    perceptual feature net of ``feature_weight``.
    """

    def __init__(self, cfg: TrainConfig, g_apply: Callable, margins_hr: int,
                 f_apply: Callable | None = None,
                 g_apply_decomp: Callable | None = None):
        if cfg.decomposed_d and g_apply_decomp is None:
            raise ValueError('decomposed_d=True requires g_apply_decomp')
        self.cfg = cfg
        self.g_apply = g_apply
        self.f_apply = f_apply
        self.g_apply_decomp = g_apply_decomp
        self.margins_hr = margins_hr
        self.filter_cfg = FilterLossConfig(latent_channels=cfg.latent_channels)

    # ------------------------------------------------------------------ init
    def init_state(self, g: torch.nn.Module, d: torch.nn.Module,
                   seed: int = 0, device=None) -> TrainState:
        """A fresh state on ``device`` (CUDA unless ``'cpu'``): the modules
        moved there, new Adam states, an empty ring (width at least 1,
        also for Z-less generators) and a generator seeded with
        ``seed``."""
        cfg = self.cfg
        device = resolve_device(device)
        g, d = g.to(device), d.to(device)
        return TrainState(
            g=g, d=d,
            g_opt=torch.optim.Adam(g.parameters(), lr=cfg.lr_g,
                                   betas=(cfg.beta1_g, cfg.beta2_g),
                                   eps=1e-8),
            d_opt=torch.optim.Adam(d.parameters(), lr=cfg.lr_d,
                                   betas=(cfg.beta1_d, cfg.beta2_d),
                                   eps=1e-8),
            ratio_stats=RatioStats.create(max(cfg.num_latent_channels, 1),
                                          device=device),
            generator=torch.Generator(device=device).manual_seed(seed))

    # ------------------------------------------------------------- utilities
    def unpad(self, x: torch.Tensor) -> torch.Tensor:
        m = self.margins_hr
        return x[:, m:-m, m:-m, :] if m > 0 else x

    def sample_z(self, u: torch.Tensor, zh: int, zw: int):
        """``(z_hr, svd_targets)`` from the per-image uniform draws ``u``
        ``[B, 1, 1, nz]``."""
        cfg = self.cfg
        b, nz = u.shape[0], cfg.num_latent_channels
        if cfg.svd_mode:
            theta = 2 * np.pi * u[..., -1]
            svd = {'theta': theta, 'lambda0_ratio': u[..., 0],
                   'lambda1_ratio': u[..., 1]}
            z = svd_to_latent_z(u[..., 0], u[..., 1], theta)
        else:
            svd = None
            z = 2 * u - 1
        return z.expand(b, zh, zw, nz).contiguous(), svd

    def _gan(self, pred, real: bool):
        return L.gan_loss(self.cfg.gan_type, pred, real,
                          self.cfg.hinge_threshold)

    # ------------------------------------------------------------ the draws
    def _rand(self, state: TrainState, *shape) -> torch.Tensor:
        g = state.generator
        return torch.rand(shape, generator=g, device=g.device)

    def _theta0(self, state: TrainState, shape) -> torch.Tensor:
        return xavier_uniform_like(
            torch.empty(shape, device=state.generator.device),
            state.generator, gain=100.0)

    def draw_d(self, state: TrainState, hr_shape, dual: bool) -> dict:
        """The D step's random numbers: ``u`` ``[B, 1, 1, nz]``; per
        microbatch the MAP loop's start ``theta0`` (dual only) and one
        penalty ``alpha`` ``[b, 1, 1, 1]`` per fake (WGAN-GP only); the
        quantization ``noise`` ``[B, H, W, C]`` when enabled."""
        cfg = self.cfg
        b, hh, wh, c = hr_shape
        accum = max(1, cfg.grad_accum_d)
        bm, nz = b // accum, cfg.num_latent_channels
        draws = {'u': self._rand(state, b, 1, 1, nz)}
        if dual:
            draws['theta0'] = [self._theta0(state, (bm, hh, wh, nz))
                               for _ in range(accum)]
        if cfg.gan_type == 'wgan-gp':
            draws['alpha'] = [[self._rand(state, bm, 1, 1, 1)
                               for _ in range(2 if dual else 1)]
                              for _ in range(accum)]
        if cfg.add_quantization_noise:
            draws['noise'] = (self._rand(state, b, hh, wh, c) - 0.5) / 255.0
        return draws

    def draw_g(self, state: TrainState, hr_shape, dual: bool) -> dict:
        """The G step's random numbers: ``u`` and, dual only, one
        ``theta0`` per microbatch."""
        cfg = self.cfg
        b, hh, wh, _ = hr_shape
        accum = max(1, cfg.grad_accum_g)
        nz = cfg.num_latent_channels
        draws = {'u': self._rand(state, b, 1, 1, nz)}
        if dual:
            draws['theta0'] = [self._theta0(state, (b // accum, hh, wh, nz))
                               for _ in range(accum)]
        return draws

    # ------------------------------------------------------- MAP inner loop
    def _optimal_z(self, g, lr_img, hr_unpadded, theta0) -> torch.Tensor:
        """``optimal_z_iters`` Adam steps (lr ``optimal_z_lr``) on pre-tanh
        Z from ``theta0`` against L1 to the ground truth, the generator
        frozen; returns the detached ``tanh`` of the result."""
        theta = theta0
        opt_state = adam_init(theta)
        for _ in range(self.cfg.optimal_z_iters):
            th = theta.detach().requires_grad_()
            fake = self.unpad(self.g_apply(g, lr_img, torch.tanh(th)))
            grad, = torch.autograd.grad((fake - hr_unpadded).abs().mean(),
                                        th)
            upd, opt_state = adam_update(grad, opt_state,
                                         self.cfg.optimal_z_lr)
            theta = theta + upd
        return torch.tanh(theta).detach()

    # ---------------------------------------------------------------- D step
    def _d_loss(self, state, lr_img, ref, z, theta0, alphas, dual):
        """The D loss of one microbatch and its metrics; moves D's running
        statistics (the real pass, then each fake pass)."""
        cfg, d = self.cfg, state.d
        decomp = cfg.decomposed_d
        b = ref.shape[0]

        @torch.no_grad()
        def gen(z_in):
            if decomp:
                low, high = self.g_apply_decomp(state.g, lr_img, z_in)
                return self.unpad(low), self.unpad(high)
            return self.unpad(self.g_apply(state.g, lr_img, z_in))

        fakes = [gen(z)]
        if dual:
            fakes.insert(0, gen(self._optimal_z(state.g, lr_img, ref,
                                                theta0)))
        total = 0.0
        real_in = (fakes[0][0], ref - fakes[0][0]) if decomp else ref
        pred_real = d(real_in, True)
        metrics, logits_diffs = {}, []
        for i, fake in enumerate(fakes):
            pred_fake = d(fake, True)
            if cfg.relativistic:
                l_real = self._gan(pred_real - pred_fake.mean(), True)
                l_fake = self._gan(pred_fake - pred_real.mean(), False)
            else:
                l_real = 2 * self._gan(pred_real, True)
                l_fake = 2 * self._gan(pred_fake, False)
            step_loss = (l_real + l_fake) / 2.0
            if cfg.gan_type == 'wgan-gp':
                if decomp:
                    # the D sees the interpolate split around the fake's
                    # fixed low-frequency component
                    low = fake[0]
                    gp = L.gradient_penalty(
                        lambda x, lo=low: d((lo, x - lo), False), ref,
                        fake[0] + fake[1], alphas[i])
                else:
                    gp = L.gradient_penalty(lambda x: d(x, False), ref,
                                            fake, alphas[i])
                step_loss = step_loss + cfg.gp_weight * gp
                metrics[f'l_d_gp_{i}'] = gp.detach()
            total = total + step_loss
            logits_diffs.append(
                (pred_real - pred_fake).detach().reshape(b, -1).mean(dim=1))
            metrics.update({f'l_d_real_{i}': l_real.detach(),
                            f'l_d_fake_{i}': l_fake.detach(),
                            f'D_real_{i}': pred_real.detach().mean(),
                            f'D_fake_{i}': pred_fake.detach().mean()})
        total = total / len(fakes)
        diffs = torch.stack(logits_diffs)
        metrics['D_logits_diff'] = diffs.mean()
        metrics['Correctly_distinguished'] = (diffs > 0).float().mean()
        metrics['l_d_total'] = total.detach()
        return total, metrics

    def d_grads(self, state: TrainState, lr_img: torch.Tensor,
                hr: torch.Tensor, draws: dict, dual: bool):
        """The D loss's gradients (left in the parameters' ``.grad``, and
        returned in ``d.parameters()`` order) and metrics, from
        ``draws``; moves D's running statistics."""
        cfg = self.cfg
        accum = max(1, cfg.grad_accum_d)
        if cfg.add_quantization_noise:
            hr = hr + draws['noise']
        z, _ = self.sample_z(draws['u'], hr.shape[1], hr.shape[2])
        ref = self.unpad(hr)
        params = list(state.d.parameters())
        state.d_opt.zero_grad(set_to_none=True)
        parts = []
        for i, (lr_i, ref_i, z_i) in enumerate(
                _microbatches(accum, lr_img, ref, z)):
            total, m = self._d_loss(
                state, lr_i, ref_i, z_i,
                draws['theta0'][i] if dual else None,
                draws['alpha'][i] if 'alpha' in draws else None, dual)
            (total / accum).backward(inputs=params)
            parts.append(m)
        return _grads(params), _mean_metrics(parts)

    def d_step(self, state: TrainState, batch: dict, dual: bool = True,
               draws: dict | None = None):
        """One D update: draws, gradients, Adam.  ``batch`` holds device
        tensors ``'lr'`` ``[B, h, w, 3]`` and ``'hr'`` ``[B, H, W, 3]``."""
        with full_fp32():
            if draws is None:
                draws = self.draw_d(state, batch['hr'].shape, dual)
            _, metrics = self.d_grads(state, batch['lr'], batch['hr'],
                                      draws, dual)
            self._update(state, state.d_opt, self.cfg.lr_d)
        return state, metrics

    # ---------------------------------------------------------------- G step
    def _g_loss(self, state, lr_img, ref, z_static, svd, theta0,
                ratio_stats, dual, use_gan):
        """The G loss of one microbatch, its metrics and the updated
        L_struct ring."""
        cfg, d = self.cfg, state.d
        z_opt = (self._optimal_z(state.g, lr_img, ref, theta0)
                 if dual else None)
        n_steps = 2 if dual else 1
        metrics, total, new_stats = {}, 0.0, ratio_stats
        zs = ([(z_opt, True)] if dual else []) + [(z_static, False)]
        for z, is_opt in zs:
            if cfg.decomposed_d:
                # the losses other than the adversarial one see the summed
                # image; the D sees the pair
                low, high = self.g_apply_decomp(state.g, lr_img, z)
                low, high = self.unpad(low), self.unpad(high)
                fake = low + high
            else:
                low = None
                fake = self.unpad(self.g_apply(state.g, lr_img, z))
            if cfg.range_weight:
                l_range = L.range_loss(fake, cfg.input_range)
                total = total + cfg.range_weight * l_range / n_steps
                metrics['l_g_range'] = l_range.detach()
            if cfg.pixel_weight:
                l_pix = (fake - ref).abs().mean()
                total = total + cfg.pixel_weight * l_pix / n_steps
                metrics['l_g_pix'] = l_pix.detach()
            if cfg.feature_weight and self.f_apply is not None:
                with torch.no_grad():
                    real_fea = self.f_apply(ref)
                l_fea = (self.f_apply(fake) - real_fea).abs().mean()
                total = total + cfg.feature_weight * l_fea / n_steps
                metrics['l_g_fea'] = l_fea.detach()
            if is_opt and cfg.optimal_z_weight:
                l_map = (fake - ref).abs().mean()
                total = total + cfg.optimal_z_weight * l_map
                metrics['l_g_optimalZ'] = l_map.detach()
            if (not is_opt) and cfg.latent_weight:
                l_lat, new_stats = filter_loss(self.filter_cfg, ratio_stats,
                                               fake, ref, z, svd)
                total = total + cfg.latent_weight * l_lat.mean()
                metrics['l_g_latent'] = l_lat.detach().mean()
            if use_gan:
                pred_fake = d((low, high) if cfg.decomposed_d else fake,
                              False)
                if cfg.relativistic:
                    real_in = (low, ref - low) if cfg.decomposed_d else ref
                    pred_real = d(real_in, False).detach()
                    l_gan = (self._gan(pred_real - pred_fake.mean(), False)
                             + self._gan(pred_fake - pred_real.mean(),
                                         True)) / 2
                else:
                    l_gan = self._gan(pred_fake, True)
                total = total + cfg.gan_weight * l_gan / n_steps
                metrics['l_g_gan'] = l_gan.detach()
        metrics['l_g_total'] = total.detach()
        return total, metrics, new_stats

    def g_grads(self, state: TrainState, lr_img: torch.Tensor,
                hr: torch.Tensor, draws: dict, dual: bool, use_gan: bool):
        """The G loss's gradients (left in the generator's ``.grad`` and
        returned in ``g.parameters()`` order; D's parameters take none),
        metrics and the updated L_struct ring, from ``draws``."""
        cfg = self.cfg
        accum = max(1, cfg.grad_accum_g)
        z_static, svd = self.sample_z(draws['u'], hr.shape[1], hr.shape[2])
        ref = self.unpad(hr)
        svd_keys = list(svd) if svd else []
        params = list(state.g.parameters())
        state.g_opt.zero_grad(set_to_none=True)
        stats, parts = state.ratio_stats, []
        for i, mb in enumerate(_microbatches(
                accum, lr_img, ref, z_static,
                *[svd[k] for k in svd_keys])):
            svd_i = dict(zip(svd_keys, mb[3:])) if svd else None
            total, m, stats = self._g_loss(
                state, mb[0], mb[1], mb[2], svd_i,
                draws['theta0'][i] if dual else None, stats, dual, use_gan)
            (total / accum).backward(inputs=params)
            stats = stats.detached()
            parts.append(m)
        return _grads(params), _mean_metrics(parts), stats

    def g_step(self, state: TrainState, batch: dict, dual: bool = True,
               use_gan: bool = True, draws: dict | None = None):
        """One G update: draws, gradients, Adam; D and its Adam state are
        left as they were."""
        with full_fp32():
            if draws is None:
                draws = self.draw_g(state, batch['hr'].shape, dual)
            _, metrics, state.ratio_stats = self.g_grads(
                state, batch['lr'], batch['hr'], draws, dual, use_gan)
            self._update(state, state.g_opt, self.cfg.lr_g)
        return state, metrics

    def _update(self, state: TrainState, opt: torch.optim.Adam,
                base_lr: float) -> None:
        lr = state.lr_scale * multistep_lr(base_lr, self.cfg.lr_steps,
                                           self.cfg.lr_gamma, state.step)
        for group in opt.param_groups:
            group['lr'] = lr
        opt.step()
        opt.zero_grad(set_to_none=True)

    @staticmethod
    def advance(state: TrainState) -> TrainState:
        """One outer-iteration tick, whether G, D or both ran."""
        state.step += 1
        return state

    def eval_forward(self, g, lr_img, z):
        with torch.no_grad(), full_fp32():
            return self.g_apply(g, lr_img, z)
