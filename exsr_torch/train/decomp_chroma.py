"""The explorable-JPEG chroma trainer.

Counterpart of ``exsr/train/decomp_chroma.py``.  A second DnCNN
reconstructs the low-frequency DCT coefficients of the two chroma
channels, conditioned on a Y channel:

* the codec runs on 16 x 16 blocks; chroma downsampling is modelled by
  keeping each chroma block's low-frequency 8 x 8 quadrant;
* the chroma generator takes ``[Y coefficients (256), quantised chroma
  low frequencies (128)]`` and returns the two channels' 2 x 64 low
  frequencies;
* the Y channel is the frozen Y generator's output (eval mode, Z = 0),
  mixed per image with the real Y by a Bernoulli(0.5) draw, so that the
  critic cannot tell real from fake by Y alone;
* one :meth:`ChromaDecompTrainer.step` runs the D update, then the G
  update against the updated D: pixel L1 on CbCr (weighted by
  ``optimal_z_weight``), plus range, plus the adversarial term.

Data parallelism (``dp``) as the Y trainer's: every rank draws the
global step's numbers and keeps its slice of them and of the batch; the
chroma generator's batch norm sees the global batch; the gradients and
metrics are averaged over ranks.  On a ``data x spatial`` grid (``mesh``)
the rank keeps whole rows of 16 x 16 cells: the frozen Y generator runs
on their 8 x 8 block rows (eval mode, so its only collective is its halo
exchange), the chroma generator on the cell rows (batch norm over every
rank of the grid), ``is_fake`` is sliced on ``data``, the pixel losses
are shares of the global mean and the critic runs on the data row's
inputs gathered whole, its losses taken ``1 / spatial`` times.

Both steps run in full fp32 (TF32 off).  The chroma generator runs in
train mode (batch statistics); its running statistics move only in the G
step's forward, as ``exsr``'s ``g_stats_apply`` keeps them.
"""
from __future__ import annotations

import torch

from exsr_torch.device import full_fp32, resolve_device
from exsr_torch.jpeg.codec import JPEGCodec
from exsr_torch.losses import losses as L
from exsr_torch.losses.filter_loss import RatioStats
from exsr_torch.parallel import dist as P
from exsr_torch.parallel import spatial
from exsr_torch.train import decomp as Y
from exsr_torch.train.decomp import DecompConfig, adam_for
from exsr_torch.train.srragan import TrainState, adam_step, param_grads


def regroup_y_coeffs_16(y_coeffs8: torch.Tensor) -> torch.Tensor:
    """``[N, H/8, W/8, 64]`` Y coefficients -> ``[N, H/16, W/16, 256]``:
    each 2 x 2 neighbourhood of 8 x 8 blocks onto one 16 x 16 cell."""
    n, hb, wb, c = y_coeffs8.shape
    x = y_coeffs8.reshape(n, hb // 2, 2, wb // 2, 2, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, hb // 2, wb // 2, 4 * c)


class ChromaDecompTrainer:
    """``gy`` is the frozen Y :class:`~exsr_torch.models.dncnn.DnCNN`
    (with ``y_latent_channels`` latent channels, fed zeros), the state's
    ``g`` the chroma generator, its ``d`` the critic.  Batches hold device
    tensors ``'uncomp'`` ``[B, H, W, 3]`` YCbCr in [0, 255] and ``'qf'``
    ``[B]``; ``dp`` or ``mesh`` as :class:`~exsr_torch.train.decomp.
    DecompTrainer`'s."""

    ALIGN = 16  # image rows of one cell row

    def __init__(self, cfg: DecompConfig, gy: torch.nn.Module, dp=None,
                 mesh=None):
        if not cfg.chroma_mode:
            raise ValueError('ChromaDecompTrainer needs chroma_mode=True')
        self.cfg = cfg
        self.dp, self.grid = Y.grid_of(dp, mesh, self.ALIGN)
        self.gy = gy.requires_grad_(False)
        self.codec_y = JPEGCodec()
        self.codec = JPEGCodec(chroma_mode=True, block_size=16)

    def init_state(self, gc: torch.nn.Module, d: torch.nn.Module,
                   seed: int = 0, device=None) -> TrainState:
        """A fresh state on ``device`` (CUDA unless ``'cpu'``), the Y
        generator moved there too.  The L_struct ring is unused."""
        cfg = self.cfg
        device = resolve_device(device)
        self.gy.to(device)
        gc, d = gc.to(device), d.to(device)
        if self.grid is None:
            P.join(self.dp, self.gy, gc, d)
        else:
            # the frozen Y generator runs in eval mode: weights only
            self.grid.rules.replicate(self.gy)
            Y.join(self, gc, d)
        return TrainState(
            g=gc, d=d, g_opt=adam_for(gc, cfg.lr_g, cfg.beta1),
            d_opt=adam_for(d, cfg.lr_d, cfg.beta1),
            ratio_stats=RatioStats.create(1, device=device),
            generator=torch.Generator(device=device).manual_seed(seed))

    # --------------------------------------------------------------- pieces
    @torch.no_grad()
    def fake_y(self, y_img: torch.Tensor, qf, is_fake=None) -> torch.Tensor:
        """The Y generator's decoding of the quantised Y, or, with
        ``is_fake`` ``[B]`` (bool), the real Y where it is False."""
        comp_y = self.codec_y.compress(y_img, qf, quantize=True)
        nz = self.gy.nz
        z = comp_y.new_zeros(comp_y.shape[:3] + (nz,)) if nz else None
        if self.grid is None:
            coeffs = self.gy(comp_y, z)
        else:
            coeffs = spatial.dncnn_module(
                self.gy, comp_y, z,
                spatial.Rows.equal(self.grid.mesh, comp_y.shape[1]))
        fake = self.codec_y.extract(coeffs, qf)
        if is_fake is None:
            return fake
        return torch.where(is_fake[:, None, None, None], fake, y_img)

    def chroma_inputs(self, ycbcr, y_for_cond, qf):
        """``(packed generator input [.., 256 + 128], reference chroma low
        frequencies [.., 128])``."""
        img = torch.cat([y_for_cond, ycbcr[..., 1:]], dim=-1)
        packed = self.codec.compress_ycbcr(img, qf,
                                           downsample_or_quantize=True)
        ref = self.codec.compress_ycbcr(
            ycbcr, qf, downsample_or_quantize='downsample_only')
        return packed, ref[..., 256:]

    @staticmethod
    def forward(gc, packed, update_stats: bool = False) -> torch.Tensor:
        """The chroma generator in train mode (batch statistics)."""
        return gc(packed, None, train=True, update_stats=update_stats)

    def _forward(self, gc, packed, update_stats: bool = False):
        """:meth:`forward`; on a grid on the rank's cell rows."""
        if self.grid is None:
            return self.forward(gc, packed, update_stats)
        return spatial.dncnn_module(
            gc, packed, None,
            spatial.Rows.equal(self.grid.mesh, packed.shape[1]), True,
            update_stats)

    @torch.no_grad()
    def decode(self, gc, packed, qf) -> torch.Tensor:
        """The chroma generator's CbCr image ``[N, H, W, 2]``, in train
        mode without moving its statistics, as ``exsr``'s ``decode``."""
        with full_fp32():
            return self.codec.extract_ycbcr(self.forward(gc, packed), qf)

    # ---------------------------------------------------------------- draws
    def draw(self, state: TrainState, batch_size: int) -> dict:
        """A step's random numbers: ``is_fake`` ``[B]`` (Bernoulli 0.5,
        which images get the Y generator's output) and the penalty's
        ``alpha`` ``[B, 1, 1, 1]`` (WGAN-GP only)."""
        g = state.generator
        draws = {'is_fake': torch.rand((batch_size,), generator=g,
                                       device=g.device) < 0.5}
        if 'gp' in self.cfg.gan_type:
            draws['alpha'] = torch.rand((batch_size, 1, 1, 1), generator=g,
                                        device=g.device)
        return draws

    def local(self, batch: dict, draws: dict):
        """``(batch, draws)``: the rank's slices of the global step's batch
        and draws (the whole of them in one process; on a grid the images'
        rows)."""
        if self.grid is not None:
            self.grid.check(batch['uncomp'])
        return ({k: Y.shard_rows(self, v) if v.dim() == 4
                 else P.shard(self.dp, v) for k, v in batch.items()},
                {k: P.shard(self.dp, v) for k, v in draws.items()})

    def prepare(self, batch: dict, draws: dict) -> dict:
        """The step's inputs: the packed generator input, the reference
        chroma, the target CbCr and the QFs."""
        ycbcr, qf = batch['uncomp'], batch['qf'].float()
        y_cond = self.fake_y(ycbcr[..., :1], qf, draws['is_fake'])
        packed, ref_chroma = self.chroma_inputs(ycbcr, y_cond, qf)
        return {'packed': packed, 'ref_chroma': ref_chroma,
                'target': ycbcr[..., 1:], 'qf': qf}

    # ----------------------------------------------------------------- step
    def d_grads(self, state: TrainState, inputs: dict, draws: dict):
        """The critic's gradients (in ``d.parameters()`` order) and
        metrics."""
        cfg, d = self.cfg, state.d
        packed = inputs['packed']
        with torch.no_grad():
            fake = self._forward(state.g, packed)
            real_in = Y.gather_rows(self, torch.cat(
                [packed[..., :256], inputs['ref_chroma']], -1))
            fake_in = Y.gather_rows(self, torch.cat(
                [packed[..., :256], fake], -1))
        params = list(d.parameters())
        state.d_opt.zero_grad(set_to_none=True)
        pred_real = d(real_in, update_stats=True)
        pred_fake = d(fake_in, update_stats=True)
        loss = (2 * L.gan_loss(cfg.gan_type, pred_real, True)
                + 2 * L.gan_loss(cfg.gan_type, pred_fake, False)) / 2
        if 'gp' in cfg.gan_type:
            loss = loss + cfg.gp_weight * L.gradient_penalty(
                lambda x: d(x, update_stats=False), real_in, fake_in,
                draws['alpha'])
        loss = Y.part(self, loss)
        loss.backward(inputs=params)
        return Y.reduced(self, param_grads(params),
                         {'l_d_total': loss.detach()})

    def g_grads(self, state: TrainState, inputs: dict, use_gan: bool):
        """The chroma generator's gradients (in ``g.parameters()`` order)
        and metrics; moves its running statistics."""
        cfg = self.cfg
        packed, qf = inputs['packed'], inputs['qf']
        params = list(state.g.parameters())
        state.g_opt.zero_grad(set_to_none=True)
        coeffs = self._forward(state.g, packed, update_stats=True)
        img = self.codec.extract_ycbcr(coeffs, qf)
        m = {}
        l_pix = Y.share(self, (img / 255.0 - inputs['target'] / 255.0).abs())
        m['l_g_pix'] = l_pix.detach()
        loss = (cfg.optimal_z_weight or 1.0) * l_pix
        if cfg.range_weight:
            l_range = Y.share(self, L.range_excess(img / 255.0))
            m['l_g_range'] = l_range.detach()
            loss = loss + cfg.range_weight * l_range
        if use_gan:
            pred = state.d(Y.gather_rows(self, torch.cat(
                [packed[..., :256], coeffs], -1)), update_stats=False)
            l_gan = Y.part(self, L.gan_loss(cfg.gan_type, pred, True))
            m['l_g_gan'] = l_gan.detach()
            loss = loss + (cfg.gan_weight or 0.0) * l_gan
        loss.backward(inputs=params)
        m['l_g_total'] = loss.detach()
        return Y.reduced(self, param_grads(params), m)

    def step(self, state: TrainState, batch: dict, use_gan: bool = True,
             draws: dict | None = None):
        """One D update, then one G update against the updated D; the
        state's step advances."""
        with full_fp32():
            if draws is None:
                draws = self.draw(state, batch['uncomp'].shape[0])
            batch, draws = self.local(batch, draws)
            inputs = self.prepare(batch, draws)
            _, metrics = self.d_grads(state, inputs, draws)
            adam_step(state, state.d_opt, self.cfg.lr_d, self.cfg)
            _, g_metrics = self.g_grads(state, inputs, use_gan)
            adam_step(state, state.g_opt, self.cfg.lr_g, self.cfg)
        state.step += 1
        return state, {**metrics, **g_metrics}
