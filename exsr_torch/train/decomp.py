"""The explorable-JPEG (DnCNN) trainer: D and G steps in the DCT domain.

Counterpart of ``exsr/train/decomp.py``, shaped as the port's SR trainer
(:mod:`exsr_torch.train.srragan`): each step draws its random numbers
from the train state's ``torch.Generator`` (:meth:`DecompTrainer.draw_d`,
:meth:`DecompTrainer.draw_g`), computes the gradients from those draws
(:meth:`DecompTrainer.d_grads`, :meth:`DecompTrainer.g_grads`) and applies
one Adam update, in full fp32 (TF32 off).  The semantics are ``exsr``'s:

* inputs are the quantised DCT coefficients of the batch's Y crops, each
  at its own quality factor; the generator's sigmoid head keeps every
  output coefficient within its quantisation bin;
* Z per batch: per-image uniform draws ``u`` ``[B, 1, 1, nz]``, mapped
  through ``svd_to_latent_z`` and tiled onto the latent channels in the
  SVD modes, else ``2u - 1``;
* the critic judges the coefficients multiplied by the quantisation table
  (``dct_premult_d``), behind Z and the compressed input when
  ``inject_z_to_d`` / ``concat_d_input`` ask for them (``[z, comp, x]``);
* the D step: the real pass, then one pass per fake, the optimal-Z fake
  (dual only) first; a non-relativistic D doubles each term; WGAN-GP adds
  one penalty per fake, D called without moving its statistics; the fakes
  are generated without cuDNN (:func:`_without_cudnn`);
* the dual G step: a MAP term on the Z* of ``optimal_z_iters`` inner Adam
  steps on pre-tanh Z against L1 to the uncompressed image (the generator
  frozen, uniform start in +-``100 sqrt(6 / (nz hb wb + b hb wb))``, Z*
  detached), plus the static-Z term; the range and adversarial terms are
  divided by the number of Zs, the MAP term is not; L_struct on the static
  Z only, and only when ``latent_channels`` is a string.

Data parallelism (``dp``) as the SR trainer's
(:mod:`exsr_torch.train.srragan`): every rank takes the global batch and
draws and computes on its slice, batch norm (the generator's and a
batch-normed critic's) and the L_struct ring see the global batch, the
MAP loop's L1 is the local sum over the global count, and the gradients
and metrics are averaged over ranks.

Every train-mode forward normalises batch norm by the batch.  The
generator's running statistics move only in the static-Z forward of the G
step, from the weights before its update; the D step's fakes, the MAP
loop and the optimal-Z term leave them alone, as ``exsr``'s
``g_stats_apply`` keeps them from that one forward only.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from exsr_torch.device import full_fp32, resolve_device
from exsr_torch.jpeg.codec import JPEGCodec
from exsr_torch.losses import losses as L
from exsr_torch.losses.filter_loss import (FilterLossConfig, RatioStats,
                                           filter_loss, num_latent_channels)
from exsr_torch.ops.structure_tensor import svd_to_latent_z
from exsr_torch.parallel import dist as P
from exsr_torch.train.srragan import TrainState, adam_step, param_grads
from exsr_torch.zopt.optimizer import (adam_init, adam_update,
                                       xavier_uniform_like)


@dataclasses.dataclass(frozen=True)
class DecompConfig:
    """The Y model's training options (``exsr``'s ``DecompConfig``)."""
    patch_size: int = 256
    lr_g: float = 1e-4
    lr_d: float = 1e-4
    beta1: float = 0.9
    lr_steps: tuple[int, ...] = ()
    lr_gamma: float = 0.5
    gan_type: str = 'wgan-gp'
    gan_weight: float | None = 1.0
    gp_weight: float = 10.0
    range_weight: float | None = 5000.0
    latent_weight: float | None = 1.0
    optimal_z_weight: float | None = 100.0
    optimal_z_iters: int = 10
    optimal_z_lr: float = 1.0
    latent_channels: str | int = 64
    relativistic: bool = False
    hinge_threshold: float | None = None
    dct_premult_d: bool = True
    concat_d_input: bool = False
    inject_z_to_d: bool = False
    chroma_mode: bool = False
    niter: int = 2_000_000

    @property
    def num_latent_channels(self) -> int:
        return num_latent_channels(self.latent_channels)

    @property
    def svd_mode(self) -> bool:
        return self.latent_channels in ('SVD_structure_tensor',
                                        'SVDinNormedOut_structure_tensor')


def repeat_z_3_channels(z3: torch.Tensor, num_channels: int
                        ) -> torch.Tensor:
    """Tile a 3-channel Z onto ``num_channels`` channels (NHWC)."""
    if num_channels <= 3:
        return z3[..., :num_channels]
    reps, rem = divmod(num_channels, 3)
    return torch.cat([z3.repeat(1, 1, 1, reps), z3[..., :rem]], dim=-1)


def z_to_3_channels(z: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`repeat_z_3_channels`: the mean of each channel's
    copies."""
    n, h, w, c = z.shape
    if c <= 3:
        return z
    pad = -c % 3
    zp = torch.nn.functional.pad(z, (0, pad)).reshape(n, h, w, -1, 3)
    reps, rem = divmod(c, 3)
    norm = torch.tensor([reps + (i < rem) for i in range(3)],
                        dtype=z.dtype, device=z.device)
    return zp.sum(dim=3) / norm


@contextlib.contextmanager
def _without_cudnn():
    """PyTorch's own convolutions (im2col and cuBLAS) instead of cuDNN's
    within the block.  For the D step's fakes: at the Y model's shapes
    cuDNN picks FFT convolutions, whose fp32 rounding the critic's
    gradient (ill-conditioned in its input) amplifies; on an H100 80GB
    HBM3 they put the D gradients ten times farther from float64 than the
    CPU's rounding does, and ran slower than the plain GEMM path
    (``chip_smoke.py`` phases 17-18 record both as controls)."""
    saved = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = saved


def adam_for(module: torch.nn.Module, lr: float, beta1: float
             ) -> torch.optim.Adam:
    """``optax.scale_by_adam(b1=beta1)`` then the learning rate."""
    return torch.optim.Adam(module.parameters(), lr=lr, betas=(beta1, 0.999),
                            eps=1e-8)


class DecompTrainer:
    """The D and G steps of the Y model.  ``g`` is a
    :class:`~exsr_torch.models.dncnn.DnCNN`, ``d`` a
    :class:`~exsr_torch.models.dncnn.DnCNNDiscriminator` (or any module
    with ``forward(x, update_stats=...)``); batches hold device tensors
    ``'uncomp'`` ``[B, H, W, 1]`` in [0, 255] and ``'qf'`` ``[B]``."""

    def __init__(self, cfg: DecompConfig, dp=None):
        self.cfg = cfg
        self.dp = P.active(dp)
        self.codec = JPEGCodec()
        # an integer latent_channels gives plain control channels and no
        # L_struct loss
        self.latent_loss_active = (cfg.latent_weight is not None
                                   and isinstance(cfg.latent_channels, str))
        self.filter_cfg = FilterLossConfig(
            latent_channels=cfg.latent_channels
            if isinstance(cfg.latent_channels, str) else 'structure_tensor',
            noise_std=1.0)

    def init_state(self, g: torch.nn.Module, d: torch.nn.Module,
                   seed: int = 0, device=None) -> TrainState:
        """A fresh state on ``device`` (CUDA unless ``'cpu'``)."""
        cfg = self.cfg
        device = resolve_device(device)
        g, d = g.to(device), d.to(device)
        P.join(self.dp, g, d)
        return TrainState(
            g=g, d=d, g_opt=adam_for(g, cfg.lr_g, cfg.beta1),
            d_opt=adam_for(d, cfg.lr_d, cfg.beta1),
            ratio_stats=RatioStats.create(
                3 if cfg.svd_mode else max(cfg.num_latent_channels, 1),
                device=device),
            generator=torch.Generator(device=device).manual_seed(seed))

    # ------------------------------------------------------------- helpers
    def sample_z(self, u: torch.Tensor, hb: int, wb: int):
        """``(z, svd_targets)`` ``[B, hb, wb, nz]`` from the per-image
        uniform draws ``u`` (``[B, 1, 1, 3]`` in the SVD modes, else
        ``[B, 1, 1, nz]``)."""
        cfg = self.cfg
        b, nz = u.shape[0], cfg.num_latent_channels
        if cfg.svd_mode:
            theta = 2 * np.pi * u[..., -1]
            svd = {'theta': theta, 'lambda0_ratio': u[..., 0],
                   'lambda1_ratio': u[..., 1]}
            z = repeat_z_3_channels(
                svd_to_latent_z(u[..., 0], u[..., 1], theta), nz)
        else:
            svd = None
            z = 2 * u - 1
        return z.expand(b, hb, wb, nz).contiguous(), svd

    @staticmethod
    def forward(g, comp, z, update_stats: bool = False) -> torch.Tensor:
        """The generator in train mode (batch statistics)."""
        return g(comp, z, train=True, update_stats=update_stats)

    @torch.no_grad()
    def decode(self, g, comp, z, qf) -> torch.Tensor:
        """The decoded Y image of ``comp`` at ``z``: the generator in eval
        mode (running statistics), as evaluation runs it."""
        with full_fp32():
            return self.codec.extract(g(comp, z), qf)

    def _d_input(self, coeffs, comp, z, qf) -> torch.Tensor:
        x = coeffs * self.codec.q_tables(qf) if self.cfg.dct_premult_d \
            else coeffs
        parts = []
        if self.cfg.inject_z_to_d and z is not None:
            parts.append(z)
        if self.cfg.concat_d_input:
            parts.append(comp)
        return torch.cat(parts + [x], dim=-1) if parts else x

    def _gan(self, pred, real: bool):
        return L.gan_loss(self.cfg.gan_type, pred, real,
                          self.cfg.hinge_threshold)

    def _inputs(self, batch):
        """``(uncomp, qf, comp)`` of the rank's slice of the batch."""
        batch = {k: P.shard(self.dp, batch[k]) for k in ('uncomp', 'qf')}
        qf = batch['qf'].float()
        comp = self.codec.compress(batch['uncomp'], qf, quantize=True)
        return batch['uncomp'], qf, comp

    # ----------------------------------------------------------- the draws
    def _u(self, state, b):
        g = state.generator
        nz = 3 if self.cfg.svd_mode else self.cfg.num_latent_channels
        return torch.rand((b, 1, 1, nz), generator=g, device=g.device)

    def _theta0(self, state, shape):
        # uniform in +-100 sqrt(6 / (nz hb wb + b hb wb)): exsr's bound
        return xavier_uniform_like(
            torch.empty(shape, device=state.generator.device),
            state.generator, gain=100.0)

    def draw_d(self, state: TrainState, comp_shape, dual: bool) -> dict:
        """The D step's random numbers for coefficients of ``comp_shape``
        ``[B, hb, wb, 64]``: ``u``, the MAP start ``theta0`` (dual only)
        and one penalty ``alpha`` ``[B, 1, 1, 1]`` per fake, the optimal-Z
        fake's first (WGAN-GP only)."""
        b, hb, wb = comp_shape[:3]
        g = state.generator
        draws = {'u': self._u(state, b)}
        if dual:
            draws['theta0'] = self._theta0(
                state, (b, hb, wb, self.cfg.num_latent_channels))
        if 'gp' in self.cfg.gan_type:
            draws['alpha'] = [torch.rand((b, 1, 1, 1), generator=g,
                                         device=g.device)
                              for _ in range(2 if dual else 1)]
        return draws

    def draw_g(self, state: TrainState, comp_shape, dual: bool) -> dict:
        """The G step's random numbers: ``u`` and, dual only, ``theta0``."""
        b, hb, wb = comp_shape[:3]
        draws = {'u': self._u(state, b)}
        if dual:
            draws['theta0'] = self._theta0(
                state, (b, hb, wb, self.cfg.num_latent_channels))
        return draws

    def _comp_shape(self, batch):
        b, h, w = batch['uncomp'].shape[:3]
        return (b, h // 8, w // 8, 64)

    # ------------------------------------------------------- MAP inner loop
    def _optimal_z(self, g, comp, uncomp, qf, theta0) -> torch.Tensor:
        """``optimal_z_iters`` Adam steps (lr ``optimal_z_lr``) on pre-tanh
        Z from ``theta0`` against L1 of the decoded image to ``uncomp``
        (both / 255), the generator frozen; the detached ``tanh`` of the
        result."""
        theta, opt_state = theta0, adam_init(theta0)
        target = uncomp / 255.0
        for _ in range(self.cfg.optimal_z_iters):
            th = theta.detach().requires_grad_()
            img = self.codec.extract(self.forward(g, comp, torch.tanh(th)),
                                     qf)
            err = (img / 255.0 - target).abs()
            grad, = torch.autograd.grad(P.count_mean(self.dp, err), th)
            upd, opt_state = adam_update(grad, opt_state,
                                         self.cfg.optimal_z_lr)
            theta = theta + upd
        return torch.tanh(theta).detach()

    # --------------------------------------------------------------- D step
    def d_grads(self, state: TrainState, batch: dict, draws: dict,
                dual: bool):
        """The D loss's gradients (left in ``.grad`` and returned in
        ``d.parameters()`` order) and metrics, from ``draws``."""
        cfg, g, d = self.cfg, state.g, state.d
        uncomp, qf, comp = self._inputs(batch)
        b, hb, wb = comp.shape[:3]
        z, _ = self.sample_z(P.shard(self.dp, draws['u']), hb, wb)
        ref = self._d_input(self.codec.compress(uncomp, qf, quantize=False),
                            comp, z, qf)
        with torch.no_grad(), _without_cudnn():
            fakes = [self._d_input(self.forward(g, comp, z), comp, z, qf)]
        if dual:
            z_opt = self._optimal_z(g, comp, uncomp, qf,
                                    P.shard(self.dp, draws['theta0']))
            with torch.no_grad(), _without_cudnn():
                fakes.insert(0, self._d_input(self.forward(g, comp, z_opt),
                                              comp, z_opt, qf))
        params = list(d.parameters())
        state.d_opt.zero_grad(set_to_none=True)
        # the running statistics chain real -> fake_0 -> fake_1
        pred_real = d(ref, update_stats=True)
        total, metrics, diffs = 0.0, {}, []
        for i, fake in enumerate(fakes):
            pred_fake = d(fake, update_stats=True)
            if cfg.relativistic:
                mean_fake = P.global_mean(self.dp, pred_fake)
                mean_real = P.global_mean(self.dp, pred_real)
                l_real = self._gan(pred_real - mean_fake, True)
                l_fake = self._gan(pred_fake - mean_real, False)
            else:
                l_real = 2 * self._gan(pred_real, True)
                l_fake = 2 * self._gan(pred_fake, False)
            step_loss = (l_real + l_fake) / 2
            if 'gp' in cfg.gan_type and cfg.gp_weight > 0:
                gp = L.gradient_penalty(
                    lambda x: d(x, update_stats=False), ref, fake,
                    P.shard(self.dp, draws['alpha'][i]))
                step_loss = step_loss + cfg.gp_weight * gp
            total = total + step_loss
            diffs.append((pred_real - pred_fake).detach().reshape(b, -1)
                         .mean(dim=1))
            metrics.update({f'l_d_real_{i}': l_real.detach(),
                            f'l_d_fake_{i}': l_fake.detach()})
        total = total / len(fakes)
        total.backward(inputs=params)
        diffs = torch.stack(diffs)
        metrics['D_logits_diff'] = diffs.mean()
        metrics['Correctly_distinguished'] = (diffs > 0).float().mean()
        metrics['l_d_total'] = total.detach()
        return P.reduced(self.dp, param_grads(params), metrics)

    def d_step(self, state: TrainState, batch: dict, dual: bool = True,
               draws: dict | None = None):
        """One D update: draws, gradients, Adam."""
        with full_fp32():
            if draws is None:
                draws = self.draw_d(state, self._comp_shape(batch), dual)
            _, metrics = self.d_grads(state, batch, draws, dual)
            adam_step(state, state.d_opt, self.cfg.lr_d, self.cfg)
        return state, metrics

    # --------------------------------------------------------------- G step
    def g_grads(self, state: TrainState, batch: dict, draws: dict,
                dual: bool, use_gan: bool):
        """The G loss's gradients (left in ``.grad``, returned in
        ``g.parameters()`` order), metrics and the updated L_struct ring,
        from ``draws``.  Moves the generator's running statistics (the
        static-Z forward)."""
        cfg, g, d = self.cfg, state.g, state.d
        uncomp, qf, comp = self._inputs(batch)
        hb, wb = comp.shape[1:3]
        z_static, svd = self.sample_z(P.shard(self.dp, draws['u']), hb, wb)
        z_opt = (self._optimal_z(g, comp, uncomp, qf,
                                 P.shard(self.dp, draws['theta0']))
                 if dual else None)
        n_steps = 2 if dual else 1
        params = list(g.parameters())
        state.g_opt.zero_grad(set_to_none=True)
        total, metrics, ratio_stats = 0.0, {}, state.ratio_stats
        zs = ([(z_opt, True)] if dual else []) + [(z_static, False)]
        for z, is_opt in zs:
            coeffs = self.forward(g, comp, z, update_stats=not is_opt)
            img = self.codec.extract(coeffs, qf)
            if cfg.range_weight:
                l_range = L.range_loss(img / 255.0)
                total = total + cfg.range_weight * l_range / n_steps
                metrics['l_g_range'] = l_range.detach()
            if is_opt and cfg.optimal_z_weight:
                l_map = (img / 255.0 - uncomp / 255.0).abs().mean()
                total = total + cfg.optimal_z_weight * l_map
                metrics['l_g_optimalZ'] = l_map.detach()
            if (not is_opt) and self.latent_loss_active:
                z3 = z_to_3_channels(z) if cfg.svd_mode else z
                l_lat, ratio_stats = filter_loss(
                    self.filter_cfg, state.ratio_stats, img, uncomp, z3, svd,
                    dp=self.dp)
                total = total + cfg.latent_weight * l_lat.mean()
                metrics['l_g_latent'] = l_lat.detach().mean()
            if use_gan:
                pred_fake = d(self._d_input(coeffs, comp, z, qf),
                              update_stats=False)
                l_gan = self._gan(pred_fake, True)
                total = total + (cfg.gan_weight or 0.0) * l_gan / n_steps
                metrics['l_g_gan'] = l_gan.detach()
        total.backward(inputs=params)
        metrics['l_g_total'] = total.detach()
        return (*P.reduced(self.dp, param_grads(params), metrics),
                ratio_stats.detached())

    def g_step(self, state: TrainState, batch: dict, dual: bool = True,
               use_gan: bool = True, draws: dict | None = None):
        """One G update: draws, gradients, Adam; D is left as it was."""
        with full_fp32():
            if draws is None:
                draws = self.draw_g(state, self._comp_shape(batch), dual)
            _, metrics, state.ratio_stats = self.g_grads(
                state, batch, draws, dual, use_gan)
            adam_step(state, state.g_opt, self.cfg.lr_g, self.cfg)
        return state, metrics

    @staticmethod
    def advance(state: TrainState) -> TrainState:
        state.step += 1
        return state
