"""Headless explorable-JPEG edit session: the GUI's JPEG backend as a
library.

Counterpart of ``exsr/apps/jpeg_session.py``: a quality factor, real JPEG
files opened by their quantised coefficients, Z edits over the DnCNN's
64-channel DCT-domain latent through the GUI's 3-channel controls, and
consistency by clamping to the quantisation bins.

  open_image / open_jpeg_file / open_coefficients -> set_region ->
  set_uniform_z3 / optimize(objective, ...) -> undo / redo;
  attach_chroma -> compose_rgb.

The generator runs on ``device`` (CUDA unless the caller asks for the
CPU), in fp32 with TF32 off (:func:`exsr_torch.device.full_fp32`), as
``exsr`` decodes.  The state the caller reads (``out``, ``cur_z``,
``y_image``) is numpy, as ``exsr``'s; the quantised coefficients ``comp``
stay on the device.  Random alternatives draw from a ``torch.Generator``
seeded by ``seed`` (``exsr`` seeds them from the clock).  Opening an image
clears the selected region (``exsr`` keeps the old block mask of the
previous image).  'digit' takes the classifier as a callable in
``data['classifier_apply']``, as :class:`exsr_torch.apps.session.
EditSession` does.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from exsr_torch.device import full_fp32, resolve_device
from exsr_torch.jpeg.codec import LUMA_Q_TABLE, JPEGCodec, consistency_clamp
from exsr_torch.models.dncnn import DnCNN, DnCNNConfig
from exsr_torch.ops.filters import clip_unit
from exsr_torch.train.decomp import repeat_z_3_channels
from exsr_torch.utils.color import rgb2ycbcr, ycbcr2rgb
from exsr_torch.zopt import objectives as obj
from exsr_torch.zopt.optimizer import ZOptimizer, atanh_init, \
    xavier_uniform_like


def _state_dict(params) -> dict:
    sd = params.state_dict() if isinstance(params, torch.nn.Module) \
        else params
    return {k: torch.as_tensor(v).detach() for k, v in sd.items()}


@dataclasses.dataclass
class JPEGEditSession:
    nf: int = 320
    nb: int = 10
    latent_channels: int = 64
    qf: float = 10
    time_budget_s: float = 30.0
    device: object = None        # None: CUDA; 'cpu' to run on the CPU
    seed: int = 0                # random alternatives

    def __post_init__(self):
        self._device = resolve_device(self.device)
        self._rng = torch.Generator().manual_seed(self.seed)
        self.codec = JPEGCodec()
        self.generator = self._frozen(DnCNN(DnCNNConfig(
            n_channels=self.nf, depth=self.nb,
            num_latent_channels=self.latent_channels)))
        self.params = None
        self.chroma_params = None
        self.y_image = None      # [1, H, W, 1] in [0, 255]
        self.comp = None         # quantised coefficients, on the device
        self.cur_z = None        # [1, hb, wb, latent_channels]
        self.region_mask = None  # [H, W]
        self.out = None          # [1, H, W, 1] in [0, 1]
        self.file_q_table = None
        self.file_chroma = None
        self._cbcr_input = None
        self._ycbcr_full_range = False
        self._block_mask = None
        self._alternatives = None
        self._zo_cache = {}
        self._history: deque = deque(maxlen=100)
        self._redo: deque = deque(maxlen=100)

    def _frozen(self, net: torch.nn.Module) -> torch.nn.Module:
        return net.to(self._device).eval().requires_grad_(False)

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=self._device)

    # --------------------------------------------------------------- weights
    def init_random_params(self, seed: int = 0):
        """Seeded random weights (the port's DnCNN initialisation)."""
        self.load_params(DnCNN(self.generator.cfg, seed=seed))

    def load_params(self, params):
        """Generator weights: the port's DnCNN or its state dict
        (``exsr_torch.models.convert.dncnn_from_exsr_vars`` converts
        ``exsr``'s variables).  The generator runs in eval mode: batch norm
        by its running statistics."""
        self.params = {k: v.to(self._device)
                       for k, v in _state_dict(params).items()}
        self.generator.load_state_dict(self.params)
        self._zo_cache.clear()

    def _g_apply(self, coeffs: torch.Tensor, z: torch.Tensor
                 ) -> torch.Tensor:
        return self.generator(coeffs, z, train=False)

    def attach_chroma(self, gc_params, nf: int = 320, nb: int = 10):
        """Attach a trained chroma generator (the port's DnCNN or its state
        dict; None attaches none): CbCr is then reconstructed by it,
        conditioned on the edited Y, instead of taken from the input.  Its
        head predicts the chroma's low frequencies only (``in_nc`` 256 +
        128, ``out_nc`` 128, 8 x 8 blocks), as ``train_jpeg --chroma``
        trains it."""
        self.chroma_generator = self._frozen(DnCNN(DnCNNConfig(
            n_channels=nf, depth=nb, in_nc=256 + 128, out_nc=2 * 64,
            chroma_generator=True, block_size=8, num_latent_channels=0)))
        self.codec_chroma = JPEGCodec(chroma_mode=True, block_size=16)
        self.chroma_params = None
        if gc_params is not None:
            self.chroma_params = {k: v.to(self._device) for k, v in
                                  _state_dict(gc_params).items()}
            self.chroma_generator.load_state_dict(self.chroma_params)

    @full_fp32()
    @torch.no_grad()
    def decode_chroma(self) -> np.ndarray:
        """``[H, W, 2]`` CbCr (0..255) from the attached chroma generator,
        conditioned on the current edited Y and the input chroma."""
        if self.chroma_params is None:
            raise RuntimeError('attach_chroma with weights first')
        if self.out is None or self._cbcr_input is None:
            raise RuntimeError('open an image with chroma first')
        h16 = (self.out.shape[1] // 16) * 16
        w16 = (self.out.shape[2] // 16) * 16
        y_cond = self.out[:, :h16, :w16, 0] * 255.0
        cbcr = self._cbcr_input[None, :h16, :w16]
        img = self._t(np.concatenate([y_cond[..., None], cbcr], axis=-1))
        qf = self._qf_arr()
        packed = self.codec_chroma.compress_ycbcr(
            img, qf, downsample_or_quantize=True)
        coeffs = self.chroma_generator(packed, None, train=False)
        out = self.codec_chroma.extract_ycbcr(coeffs, qf)
        full = np.full(self.out.shape[1:3] + (2,), 128.0, np.float32)
        full[:h16, :w16] = out[0].cpu().numpy()
        return full

    # --------------------------------------------------------------- loading
    def open_image(self, rgb_image: np.ndarray, qf: float | None = None):
        """Compress an RGB image in [0, 1] at the session's QF and decode
        it."""
        if qf is not None:
            self.qf = qf
        ycbcr = rgb2ycbcr(rgb_image.astype(np.float32),
                          only_y=False) * 255.0
        y = ycbcr[..., 0]
        h, w = (y.shape[0] // 8) * 8, (y.shape[1] // 8) * 8
        self.file_q_table = None
        self.file_chroma = None
        # the input chroma conditions the optional chroma generator
        self._cbcr_input = ycbcr[:h, :w, 1:].astype(np.float32)
        self._ycbcr_full_range = False   # MATLAB's studio swing
        self.y_image = y[:h, :w][None, ..., None].astype(np.float32)
        with full_fp32():
            self.comp = self.codec.compress(self._t(self.y_image),
                                            self._qf_arr(), quantize=True)
        self._reset_edit_state(h, w)
        self._history.clear()
        self._redo.clear()
        return self.recompute()

    def _reset_edit_state(self, h: int, w: int):
        hb, wb = self.comp.shape[1:3]
        self.cur_z = np.zeros((1, hb, wb, self.latent_channels), np.float32)
        self.region_mask = np.ones((h, w), np.float32)
        self._block_mask = None
        self._alternatives = None   # retained Zs belong to the old image

    def open_jpeg_file(self, path: str, native: bool | None = None):
        """Open a baseline JPEG for editing by its quantised Y coefficients
        and its DQT (:func:`exsr_torch.jpeg.jfif.decode_jfif`; ``native``
        as there)."""
        with open(path, 'rb') as f:
            return self.open_jpeg_bytes(f.read(), native)

    @full_fp32()
    def open_jpeg_bytes(self, data: bytes, native: bool | None = None):
        """Byte-string variant of :meth:`open_jpeg_file`.  A colour file's
        decoded chroma planes are kept, to compose the edited Y to colour
        (JFIF full-range)."""
        from exsr_torch.jpeg.jfif import decode_jfif
        from exsr_torch.ops.dct import dct_to_image
        dec = decode_jfif(data, native)
        y = dec['components'][0]
        out = self.open_coefficients(y.coeffs.astype(np.float32),
                                     y.q_table.astype(np.float64))
        if len(dec['components']) == 3:
            hpix, wpix = self.region_mask.shape
            chroma = []
            for comp in dec['components'][1:]:
                deq = comp.coeffs.astype(np.float64) * \
                    comp.q_table.reshape(-1)[None, None, :]
                # float32 on the CPU, as exsr's IDCT of these planes
                px = dct_to_image(torch.as_tensor(
                    deq[None], dtype=torch.float32), bs=8)
                px = px[0, :, :, 0].numpy() + 128.0
                px = np.repeat(np.repeat(px, y.sampling[1]
                                         // comp.sampling[1], 0),
                               y.sampling[0] // comp.sampling[0], 1)
                chroma.append(px[:hpix, :wpix])
            self.file_chroma = np.stack(chroma, -1)  # [H, W, 2], 0..255
            self._cbcr_input = self.file_chroma.astype(np.float32)
            self._ycbcr_full_range = True
        return out

    def open_coefficients(self, coeffs: np.ndarray, q_table: np.ndarray):
        """Open quantised Y coefficients ``[hb, wb, 64]`` (or with a batch
        axis) and their 8 x 8 table; the QF is recovered from the table as
        the reference's ``Set_Q_Table(QF=False)`` does (it may not be an
        integer)."""
        self.file_q_table = np.asarray(q_table, np.float32)
        self.file_chroma = None
        self._cbcr_input = None
        ratio = float(np.mean(LUMA_Q_TABLE / q_table))
        if ratio < 1:
            self.qf = 50 * ratio
        else:
            self.qf = 50 * float(np.mean(
                (2 * LUMA_Q_TABLE - q_table) / LUMA_Q_TABLE))
        self.comp = self._t(coeffs[None] if coeffs.ndim == 3 else coeffs)
        hb, wb = self.comp.shape[1:3]
        self._reset_edit_state(hb * 8, wb * 8)
        self.y_image = None
        return self.recompute()

    def compose_rgb(self) -> np.ndarray:
        """The edited Y composed to colour, ``[H, W, 3]`` in [0, 1]: by
        the attached chroma generator, else the opened file's chroma
        (JFIF full-range BT.601), else grey."""
        y = self.out[0, :, :, 0] * 255.0
        if self.chroma_params is not None and self._cbcr_input is not None:
            cbcr = self.decode_chroma()
            if self._ycbcr_full_range:
                return self._full_range_inverse(y, cbcr)
            ycbcr = np.concatenate([y[..., None], cbcr], -1)
            return np.clip(ycbcr2rgb(ycbcr.astype(np.float32) / 255.0),
                           0.0, 1.0)
        if self.file_chroma is None:
            g = np.clip(y / 255.0, 0, 1)
            return np.stack([g, g, g], -1)
        return self._full_range_inverse(y, self.file_chroma)

    @staticmethod
    def _full_range_inverse(y: np.ndarray, cbcr: np.ndarray) -> np.ndarray:
        """Full-range BT.601 YCbCr (0..255, chroma centred on 128) -> RGB
        in [0, 1] (ITU T.871)."""
        cb = cbcr[:, :, 0] - 128.0
        cr = cbcr[:, :, 1] - 128.0
        r = y + 1.402 * cr
        g = y - 0.344136 * cb - 0.714136 * cr
        b = y + 1.772 * cb
        return np.clip(np.stack([r, g, b], -1) / 255.0, 0.0, 1.0)

    def _qf_arr(self) -> torch.Tensor:
        return self._t([float(self.qf)])

    def _q_arr(self):
        """A real file's DQT (exact decoding and consistency), else None:
        the QF-scaled table."""
        if self.file_q_table is None:
            return None
        return self._t(self.file_q_table.reshape(1, 1, 1, 64))

    def _decode(self, z: np.ndarray) -> np.ndarray:
        """The clamped, clipped decode of ``comp`` at ``z``, on the host."""
        with full_fp32(), torch.no_grad():
            coeffs = consistency_clamp(self._g_apply(self.comp, self._t(z)),
                                       self.comp)
            img = self.codec.extract(coeffs, self._qf_arr(), q=self._q_arr())
            return torch.clamp(img / 255.0, 0, 1).cpu().numpy()

    def recompute(self):
        self.out = self._decode(self.cur_z)
        return self.out

    # ----------------------------------------------------------------- state
    def _push(self):
        self._history.append(self.cur_z.copy())
        self._redo.clear()

    def undo(self):
        if self._history:
            self._redo.append(self.cur_z.copy())
            self.cur_z = self._history.pop()
            self.recompute()
        return self.out

    def redo(self):
        if self._redo:
            self._history.append(self.cur_z.copy())
            self.cur_z = self._redo.pop()
            self.recompute()
        return self.out

    def _block_mask4(self) -> np.ndarray:
        bm = self._block_mask
        if bm is None:
            bm = np.ones(self.cur_z.shape[1:3], np.float32)
        return bm[None, :, :, None]

    # ------------------------------------------------ alternatives (random)
    def _alternative_z(self, i: int) -> np.ndarray:
        alt = self._alternatives
        if alt is None or not 0 <= i < len(alt['zs']):
            raise IndexError(f'no retained alternative {i}: run optimize '
                             'with a random objective and n_alternatives > 1')
        return alt['zs'][i:i + 1]

    def alternative_out(self, i: int) -> np.ndarray:
        """Decoded output of retained random alternative ``i``."""
        return self._decode(self._alternative_z(i))

    def copy_alternative(self, i: int):
        """Adopt alternative ``i``'s Z inside the selected region (in
        8 x 8-block space)."""
        alt_z = self._alternative_z(i)
        self._push()
        m = self._block_mask4()
        self.cur_z = alt_z * m + self.cur_z * (1 - m)
        return self.recompute()

    def copy_default_to_alternatives(self):
        """Push the current Z into every retained alternative inside the
        selected region."""
        if self._alternatives is None:
            raise RuntimeError('no retained alternatives: run optimize with '
                               'a random objective and n_alternatives > 1')
        m = self._block_mask4()
        alt = self._alternatives
        alt['zs'] = alt['zs'] * (1 - m) + self.cur_z * m

    def set_region(self, mask: np.ndarray):
        """A pixel mask; JPEG edits smear it to whole 8 x 8 blocks."""
        h, w = mask.shape
        m = mask.reshape(h // 8, 8, w // 8, 8).max(axis=(1, 3))
        self.region_mask = np.repeat(np.repeat(m, 8, 0), 8, 1) \
            .astype(np.float32)
        self._block_mask = m.astype(np.float32)

    def set_uniform_z3(self, values3):
        """The 3-channel GUI control, tiled onto the latent channels, over
        the selected blocks."""
        self._push()
        z3 = torch.as_tensor(np.asarray(values3, np.float32)
                             .reshape(1, 1, 1, 3))
        z = repeat_z_3_channels(z3, self.latent_channels).numpy()
        m = self._block_mask4()
        self.cur_z = (1 - m) * self.cur_z + m * z
        return self.recompute()

    # --------------------------------------------------------------- imprint
    @full_fp32()
    @torch.no_grad()
    def find_optimal_imprint_mask(self, desired_image_y: np.ndarray,
                                  desired_mask: np.ndarray, rect,
                                  top_left, target_dims):
        """Fine-tune an imprint's border.

        Coarse-to-fine search over shifts of the source rectangle ``rect =
        [x, y, w, h]`` in the desired Y image ([0, 255]): each candidate
        crop (and its mask) is resized to ``target_dims`` (h, w),
        composited onto the current Y image at ``top_left`` (y, x), and
        scored by its DCT mass outside the quantisation bins,
        ``sum(max(0, |c - c_fixed| - 0.5))``.  Stage 1 tries offsets -7..8
        in steps of 3 per coordinate and keeps the best 10; stage 2 refines
        by -1..1.  Returns ``(best_rect, refined_mask)``, the original
        rectangle's mask resized into the winning rectangle."""
        from exsr_torch.utils.misc import (resize_categorical_image,
                                           resize_scribble_image)
        if self.y_image is None:
            raise RuntimeError('open an image first')
        fixed = self.y_image[0, :, :, 0]
        qf = self._qf_arr()
        fixed_coeffs = self.codec.compress(self._t(self.y_image), qf,
                                           q=self._q_arr(), quantize=True)
        ty, tx = top_left
        th, tw = target_dims
        orig_rect = np.asarray(rect, int)
        rect_mask_mean = float(desired_mask[
            rect[1]:rect[1] + rect[3], rect[0]:rect[0] + rect[2]].mean())
        min_overlap = 0.5 * rect_mask_mean

        def score(cands):
            imprints = []
            for c in cands:
                crop = resize_scribble_image(
                    desired_image_y[c[1]:c[1] + c[3], c[0]:c[0] + c[2]],
                    (th, tw))
                m = resize_categorical_image(
                    desired_mask[c[1]:c[1] + c[3], c[0]:c[0] + c[2]]
                    .astype(np.uint8), (th, tw), inclusive=True)
                comp = fixed.copy()
                comp[ty:ty + th, tx:tx + tw] = \
                    crop * m + comp[ty:ty + th, tx:tx + tw] * (1 - m)
                imprints.append(comp)
            scores = []
            for i in range(0, len(imprints), 128):
                chunk = self._t(np.stack(imprints[i:i + 128])[..., None])
                coeffs = self.codec.compress(chunk, qf.expand(len(chunk)),
                                             quantize=False)
                viol = torch.clamp(
                    torch.abs(coeffs - fixed_coeffs) - 0.5, min=0.0)
                scores.append(viol.sum(dim=(1, 2, 3)).cpu().numpy())
            return np.concatenate(scores)

        h_im, w_im = desired_image_y.shape[:2]
        rects = [orig_rect]
        for offsets, keep in ((range(-7, 9, 3), 10), ((-1, 0, 1), 1)):
            cands = []
            for r in rects:
                for dx in offsets:
                    for dy in offsets:
                        for dw in offsets:
                            for dh in offsets:
                                c = r + np.asarray([dx, dy, dw, dh])
                                if (c[:2] >= 0).all() and (c[2:] >= 4).all()\
                                        and c[0] + c[2] <= w_im \
                                        and c[1] + c[3] <= h_im:
                                    cands.append(c)
            cands = [c for c in cands if desired_mask[
                c[1]:c[1] + c[3], c[0]:c[0] + c[2]].mean() >= min_overlap]
            cands = list({tuple(c): c for c in cands}.values())
            order = np.argsort(score(cands))
            rects = [cands[i] for i in order[:keep]]
        best = rects[0]
        orig_mask = desired_mask[
            orig_rect[1]:orig_rect[1] + orig_rect[3],
            orig_rect[0]:orig_rect[0] + orig_rect[2]].astype(np.uint8)
        refined = np.zeros_like(desired_mask)
        refined[best[1]:best[1] + best[3], best[0]:best[0] + best[2]] = \
            resize_categorical_image(orig_mask, (best[3], best[2]),
                                     inclusive=True)
        return best, refined

    # -------------------------------------------------------------- optimize
    @full_fp32()
    def optimize(self, objective: str, data: dict | None = None,
                 max_iters: int = 25, lr: float = 0.1,
                 n_alternatives: int = 1):
        """Gradient Z edit in the DCT-domain latent.

        ``objective``: 'l1', 'scribble', 'max_STD', 'min_STD',
        'STD_increase', 'STD_decrease', 'TV', 'random_*' and 'digit',
        optionally prefixed with 'local_'; a distance objective also takes
        'max_' ('max_l1'), which maximises the distance.  As in ``exsr`` a
        name holding 'l1' takes the l1 branch before the random one.  A
        random objective with ``n_alternatives`` > 1 optimises a batch of
        diverse decodings and keeps the extras for browsing.  Returns
        ``{'out', 'losses', 'n_alternatives'}``."""
        if self.params is None:
            raise RuntimeError('load or init generator params first')
        if self.region_mask is None or self.region_mask.sum() <= 0:
            raise ValueError('empty region selection: select a region (or '
                             'invert back)')
        data = data or {}
        self._push()
        qf = self._qf_arr()
        q = self._q_arr()
        b = n_alternatives if 'random' in objective else 1
        comp = self.comp if b == 1 else self.comp.repeat(b, 1, 1, 1)

        def forward(z):
            coeffs = self._g_apply(comp, z)
            return clip_unit(self.codec.extract(coeffs, qf, q=q) / 255.0)

        z0 = self._t(np.repeat(self.cur_z, b, axis=0))
        with torch.no_grad():
            initial_out = forward(z0)
        mask = self.region_mask
        mask_dev = self._t(mask)
        helpers = obj.STDHelpers.create(mask, local='local' in objective,
                                        device=self._device)
        initial_std = helpers(initial_out)
        name = objective.replace('local_', '')
        # 'max_' flips a distance objective's sign; the STD objectives
        # carry their own min/max meaning
        negate = name.startswith('max_') and 'STD' not in name
        if negate:
            name = name[len('max_'):]
        obj_args = None
        if 'scribble' in name:
            desired, l1_mask, tv_masks = self._scribble_targets_y(
                data, mask, initial_out.cpu().numpy())
            loss = obj.scribble(desired, l1_mask, tv_masks)
        elif 'l1' in name:
            loss = obj.l1_to_desired(self._t(data['desired']), mask_dev)
        elif name in ('max_STD', 'min_STD', 'STD_increase', 'STD_decrease'):
            desired_std = None
            if 'crease' in name:
                inc = data.get('STD_increment', 0.03)
                desired_std = initial_std + (inc if 'increase' in name
                                             else -inc)
            loss = obj.std_objective(helpers, name, desired_std)
        elif 'TV' in name:
            loss = obj.tv_objective(helpers, initial_std)
        elif 'random' in name:
            loss = obj.diversity_objective(
                name, mask_dev if mask.min() < 1 else None,
                helpers=helpers if 'local' in objective else None,
                initial_std=initial_std,
                initial_image=initial_out if 'limited' in name else None,
                rmse_weight=data.get('rmse_weight', 0.0))
        elif name == 'digit':
            # the Y output is replicated to the classifier's three
            # channels by the views' transform; the target digit comes in
            # through obj_args, so one optimizer serves all ten
            classifier = data['classifier_apply']
            ys, xs = np.nonzero(mask > 0)
            bounds = (int(ys.min()), int(xs.min()), int(ys.max()),
                      int(xs.max()))
            mvt = tuple(data.get('multiview_classification', (1, 3)))
            loss = obj.digit_objective_traced(
                classifier, obj.digit_views_transform(bounds, mvt))
            obj_args = {'digit': int(data['digit_2_resemble'])}
        else:
            raise NotImplementedError(objective)
        if negate:
            loss = obj.negated(loss)

        if name == 'digit':
            key = ('digit', bounds, mvt, id(self.comp),
                   data.get('classifier_cache_key', id(classifier)))
            if key not in self._zo_cache:
                self._zo_cache[key] = ZOptimizer(
                    lambda z, a: forward(z), loss, lr=lr)
            zo = self._zo_cache[key]
        else:
            zo = ZOptimizer(forward, loss, lr=lr)
        theta0 = atanh_init(z0, 1.0)
        if b > 1:   # alternatives: keep the current Z, randomise the rest
            rand = xavier_uniform_like(theta0, self._rng)
            theta0 = torch.cat([theta0[:1], rand[1:]], dim=0)
        bm = self._block_mask
        z_mask = (self._t(bm[None, :, :, None]) if bm is not None
                  and bm.min() < 1 else None)
        z, _, _, losses = zo.optimize(theta0, max_iters, z_mask=z_mask,
                                      frozen_theta=theta0,
                                      obj_args=obj_args)
        z = z.detach().cpu().numpy()
        self.cur_z = z[:1]
        if b > 1:
            self._alternatives = {'zs': z[1:]}
        self.recompute()
        return {'out': self.out, 'losses': losses,
                'n_alternatives': b - 1 if b > 1 else 0}

    def _scribble_targets_y(self, data, mask, initial_out):
        """Y-channel desired image and masks of a scribble or brightness
        edit: the SR session's recipe with the HSV value scaling applied to
        Y itself (Y is the value channel of a Y-only output)."""
        from exsr_torch.utils.misc import scribble_mask_components
        scribble_mask = np.asarray(data['scribble_mask'])
        desired = np.asarray(data['desired'], np.float32)
        if desired.ndim == 3 and desired.shape[-1] == 3:
            # RGB strokes to luma, in the convention the image was opened
            # in (JFIF full range for a file, MATLAB's studio swing else)
            if self._ycbcr_full_range:
                desired = desired @ np.array([0.299, 0.587, 0.114],
                                             np.float32)
            else:
                desired = rgb2ycbcr(desired, only_y=True)
        desired = np.asarray(desired, np.float32).squeeze()[None, ..., None]
        brightness = float(data.get('brightness_factor', 0.0))
        mult, l1_mask, tv_masks = scribble_mask_components(
            scribble_mask, mask, brightness)
        if brightness:
            cur = np.clip(initial_out[0, :, :, 0], 0, 1)
            sel = (scribble_mask == 2) | (scribble_mask == 3)
            desired[0, :, :, 0] = np.where(
                sel, np.clip(cur * mult, 0, 1), desired[0, :, :, 0])
        return (self._t(desired), self._t(l1_mask),
                [self._t(m) for m in tv_masks])
