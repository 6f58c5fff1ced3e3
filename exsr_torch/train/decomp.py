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

A ``data x spatial`` grid (``mesh``, ``spatial > 1``) splits each image's
height too, as ``exsr``'s ``ShardingRules`` shard ``'uncomp'`` on
``(data, spatial)``: the rank keeps whole rows of 8 x 8 blocks
(:class:`~exsr_torch.parallel.mesh.TrainGrid` with ``align=8``), the
codec and the generator run on them
(:func:`exsr_torch.parallel.spatial.dncnn_module`: one halo exchange a
forward, batch norm over every rank of the grid), the pixel losses are
shares of the global mean, and the critic, its penalty and L_struct run
on the data row's images gathered whole, each whole loss taken
``1 / spatial`` times.

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
from exsr_torch.parallel import spatial
from exsr_torch.parallel.mesh import TrainGrid
from exsr_torch.train.srragan import TrainState, adam_step, param_grads
from exsr_torch.utils.logging import span
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


def grid_of(dp, mesh, align: int):
    """A trainer's ``(dp, grid)`` from its ``dp`` or ``mesh`` argument:
    the data group's ranks (None in one process) and the
    :class:`~exsr_torch.parallel.mesh.TrainGrid` of a grid with
    ``spatial > 1`` (None otherwise), shards aligned to ``align`` image
    rows."""
    grid = None
    if mesh is not None:
        if dp is not None:
            raise ValueError('pass dp or mesh, not both: a mesh holds its '
                             'data group (mesh.dp)')
        dp = mesh.dp
        if mesh.spatial > 1:
            grid = TrainGrid(mesh, 0, align)
    return P.active(dp), grid


def join(trainer, g: torch.nn.Module, *critics: torch.nn.Module) -> None:
    """Rank 0's weights on every rank; the batch norms of the generator
    over every rank of a grid (it runs on the rank's rows), the critics'
    over the data group (they run on the gathered images)."""
    if trainer.grid is None:
        P.join(trainer.dp, g, *critics)
    else:
        trainer.grid.join(g, world=True)
        trainer.grid.join(*critics)


def shard_rows(trainer, x: torch.Tensor) -> torch.Tensor:
    """The rank's slice of a global NHWC tensor: its samples, and on a
    grid its rows."""
    if trainer.grid is None:
        return P.shard(trainer.dp, x)
    return trainer.grid.rows(x)


def gather_rows(trainer, x: torch.Tensor) -> torch.Tensor:
    """The data row's whole images of the rank's rows ``x`` (``x`` itself
    without a grid), differentiable."""
    if trainer.grid is None:
        return x
    return trainer.grid.gather(x, trainer.grid.mesh.spatial * x.shape[1])


def share(trainer, e: torch.Tensor) -> torch.Tensor:
    """The mean of the elementwise ``e``; on a grid the rank's share of
    the data row's mean (summed over the spatial group, the mean)."""
    if trainer.grid is None:
        return e.mean()
    return trainer.grid.share(e, trainer.grid.mesh.spatial * e.shape[1])


def part(trainer, loss: torch.Tensor) -> torch.Tensor:
    """A loss computed on whole images; on a grid the rank's ``1 /
    spatial`` of it."""
    return loss if trainer.grid is None else trainer.grid.part(loss)


def reduced(trainer, grads: list, metrics: dict):
    """``(grads, metrics)`` of one process's step on the global batch."""
    if trainer.grid is None:
        return P.reduced(trainer.dp, grads, metrics)
    return trainer.grid.reduce(grads, metrics)


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
    ``'uncomp'`` ``[B, H, W, 1]`` in [0, 255] and ``'qf'`` ``[B]``.
    ``dp`` is a data-parallel rank, ``mesh`` a rank of a ``data x
    spatial`` grid (pass one or neither); every rank passes the global
    batch and draws."""

    ALIGN = 8   # image rows of one block row

    def __init__(self, cfg: DecompConfig, dp=None, mesh=None):
        self.cfg = cfg
        self.dp, self.grid = grid_of(dp, mesh, self.ALIGN)
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
        join(self, g, d)
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
        """``(uncomp, qf, comp)`` of the rank's slice of the batch (on a
        grid its rows)."""
        if self.grid is not None:
            self.grid.check(batch['uncomp'])
        uncomp = shard_rows(self, batch['uncomp'])
        qf = P.shard(self.dp, batch['qf']).float()
        return uncomp, qf, self.codec.compress(uncomp, qf, quantize=True)

    def _forward(self, g, comp, z, update_stats: bool = False):
        """:meth:`forward`; on a grid on the rank's block rows."""
        if self.grid is None:
            return self.forward(g, comp, z, update_stats)
        return spatial.dncnn_module(
            g, comp, z, spatial.Rows.equal(self.grid.mesh, comp.shape[1]),
            True, update_stats)

    def _whole_inputs(self, batch, qf, uncomp, comp):
        """``(uncomp, comp)`` of the data row's whole images (the rank's
        own on one process)."""
        if self.grid is None:
            return uncomp, comp
        uncomp = P.shard(self.dp, batch['uncomp'])
        return uncomp, self.codec.compress(uncomp, qf, quantize=True)

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
        result.  The span ``exsr.map_loop``."""
        with span('exsr.map_loop'):
            theta, opt_state = theta0, adam_init(theta0)
            for _ in range(self.cfg.optimal_z_iters):
                grad = self._map_grad(g, comp, uncomp, qf, theta)
                upd, opt_state = adam_update(grad, opt_state,
                                             self.cfg.optimal_z_lr)
                theta = theta + upd
            return torch.tanh(theta).detach()

    def _map_grad(self, g, comp, uncomp, qf, theta) -> torch.Tensor:
        """The MAP objective's gradient at pre-tanh Z ``theta``: the L1
        mean over the global batch (each rank's share, no collective of
        its own; on a grid over the rank's block rows, the halos'
        adjoints bringing the neighbours' terms)."""
        th = theta.detach().requires_grad_()
        img = self.codec.extract(self._forward(g, comp, torch.tanh(th)), qf)
        err = (img / 255.0 - uncomp / 255.0).abs()
        loss = P.count_mean(self.dp, err) if self.grid is None else \
            share(self, err) / self.grid.mesh.data
        return torch.autograd.grad(loss, th)[0]

    # --------------------------------------------------------------- D step
    def d_grads(self, state: TrainState, batch: dict, draws: dict,
                dual: bool):
        """The D loss's gradients (left in ``.grad`` and returned in
        ``d.parameters()`` order) and metrics, from ``draws``."""
        cfg, g, d = self.cfg, state.g, state.d
        uncomp, qf, comp = self._inputs(batch)
        hb, wb = comp.shape[1:3]
        u = P.shard(self.dp, draws['u'])
        z, _ = self.sample_z(u, hb, wb)
        # the critic's inputs are the data row's whole images
        uncomp_w, comp_w = self._whole_inputs(batch, qf, uncomp, comp)
        b, hb_w = comp_w.shape[:2]
        z_w = z if self.grid is None else self.sample_z(u, hb_w, wb)[0]
        ref = self._d_input(self.codec.compress(uncomp_w, qf,
                                                quantize=False),
                            comp_w, z_w, qf)

        @torch.no_grad()
        def fake(z_in, z_in_w):
            with _without_cudnn():
                coeffs = gather_rows(self, self._forward(g, comp, z_in))
            return self._d_input(coeffs, comp_w, z_in_w, qf)
        fakes = [fake(z, z_w)]
        if dual:
            z_opt = self._optimal_z(g, comp, uncomp, qf,
                                    shard_rows(self, draws['theta0']))
            fakes.insert(0, fake(z_opt, gather_rows(self, z_opt)
                                 if cfg.inject_z_to_d else None))
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
        total = part(self, total / len(fakes))
        total.backward(inputs=params)
        diffs = torch.stack(diffs)
        metrics['D_logits_diff'] = diffs.mean()
        metrics['Correctly_distinguished'] = (diffs > 0).float().mean()
        metrics = {k: part(self, v) for k, v in metrics.items()}
        metrics['l_d_total'] = total.detach()
        return reduced(self, param_grads(params), metrics)

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
        u = P.shard(self.dp, draws['u'])
        z_static, svd = self.sample_z(u, hb, wb)
        z_opt = (self._optimal_z(g, comp, uncomp, qf,
                                 shard_rows(self, draws['theta0']))
                 if dual else None)
        # L_struct and the critic see the data row's whole images
        uncomp_w, comp_w = self._whole_inputs(batch, qf, uncomp, comp)
        z_static_w = z_static if self.grid is None else \
            self.sample_z(u, comp_w.shape[1], wb)[0]
        n_steps = 2 if dual else 1
        params = list(g.parameters())
        state.g_opt.zero_grad(set_to_none=True)
        total, metrics, ratio_stats = 0.0, {}, state.ratio_stats
        zs = ([(z_opt, True)] if dual else []) + [(z_static, False)]
        for z, is_opt in zs:
            coeffs = self._forward(g, comp, z, update_stats=not is_opt)
            img = self.codec.extract(coeffs, qf)
            if cfg.range_weight:
                l_range = share(self, L.range_excess(img / 255.0))
                total = total + cfg.range_weight * l_range / n_steps
                metrics['l_g_range'] = l_range.detach()
            if is_opt and cfg.optimal_z_weight:
                l_map = share(self, (img / 255.0 - uncomp / 255.0).abs())
                total = total + cfg.optimal_z_weight * l_map
                metrics['l_g_optimalZ'] = l_map.detach()
            if (not is_opt) and self.latent_loss_active:
                z3 = z_to_3_channels(z_static_w) if cfg.svd_mode \
                    else z_static_w
                l_lat, ratio_stats = filter_loss(
                    self.filter_cfg, state.ratio_stats, gather_rows(self, img),
                    uncomp_w, z3, svd, dp=self.dp)
                l_lat = part(self, l_lat.mean())
                total = total + cfg.latent_weight * l_lat
                metrics['l_g_latent'] = l_lat.detach()
            if use_gan:
                z_w = None
                if cfg.inject_z_to_d:
                    z_w = gather_rows(self, z) if is_opt else z_static_w
                pred_fake = d(self._d_input(gather_rows(self, coeffs),
                                            comp_w, z_w, qf),
                              update_stats=False)
                l_gan = part(self, self._gan(pred_fake, True))
                total = total + (cfg.gan_weight or 0.0) * l_gan / n_steps
                metrics['l_g_gan'] = l_gan.detach()
        total.backward(inputs=params)
        metrics['l_g_total'] = total.detach()
        return (*reduced(self, param_grads(params), metrics),
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
