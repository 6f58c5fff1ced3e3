"""Headless interactive edit session: the GUI's backend as a library.

Counterpart of ``exsr/apps/session.py``:

  open_image -> set_region -> optimize(objective, ...) / set_z_from_svd ->
  undo / redo -> save_z / load_z.

* Local edits crop every tensor to the mask's bounding rectangle plus the
  CEM's margins, bucketed to multiples of ``CROP_BUCKET_LR`` LR pixels,
  and merge the optimized Z back.  With ``fast_edit`` the crop carries its
  margins and the forward skips the replicate pre-pad.
* The edit loop runs rounds of ``ITERS_PER_ROUND`` Adam steps within a
  wall-clock budget, reverts Z when a round did not lower the loss and
  divides the learning rate by ``LR_DECAY_ON_PLATEAU``
  (:meth:`exsr_torch.zopt.optimizer.ZOptimizer.optimize_rounds`).  Every
  step runs the frozen CEM-wrapped generator forward and backward: the
  grouped trunk by default (``fast_trunk``), whose stage-4 epilogue and
  CEM filters are the port's kernels on CUDA, backward included.
* Z history and redo stacks, uniform Z, the SVD sliders, brightness edits
  through the CEM's consistency enforcement, scribble targets.

The state the caller reads (``lr_image``, ``cur_z``, ``sr``) is numpy, as
``exsr``'s is; the forward runs on ``device`` (CUDA unless the caller asks
for the CPU).  Random alternatives and ``random_*`` objectives draw from a
``torch.Generator`` seeded by ``seed`` (``exsr`` seeds them from the
clock).  Forwards and edits run with TF32 off
(:func:`exsr_torch.device.full_fp32`), as ``exsr`` computes in fp32.
``estimate_kernel`` runs KernelGAN on the open LR image and rebuilds the
CEM around its kernel.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable

import numpy as np
import torch

from exsr_torch.cem.cem import CEM, CEMConf, cem_wrap, consistent_downsample
from exsr_torch.device import full_fp32, resolve_device
from exsr_torch.models.rrdb import RRDBNet
from exsr_torch.models.rrdb_fast import pack_grouped_params, \
    rrdbnet_apply_fast
from exsr_torch.ops.filters import clip_unit
from exsr_torch.ops.resize import imresize
from exsr_torch.ops.structure_tensor import svd_to_latent_z
from exsr_torch.utils.misc import (bilinear_sample_line, first_autocorr_peak,
                                   overlap_normalized_autocorr,
                                   scribble_mask_components)
from exsr_torch.utils.serve import alt_bucket
from exsr_torch.zopt import objectives as obj
from exsr_torch.zopt.histogram import SoftHistogramLoss
from exsr_torch.zopt.optimizer import ZOptimizer, atanh_init, \
    xavier_uniform_like

DEFAULT_TIME_BUDGET_S = 30.0
ITERS_PER_ROUND = 5
INITIAL_LR = 1e-1
LR_DECAY_ON_PLATEAU = 5.0
CROP_BUCKET_LR = 8


def _bucket(lo: int, hi: int, size: int, bucket: int) -> tuple[int, int]:
    """Expand [lo, hi) to a bucket multiple, clipped to [0, size)."""
    length = hi - lo
    target = min(size, int(np.ceil(length / bucket)) * bucket)
    lo = max(0, min(lo - (target - length) // 2, size - target))
    return lo, lo + target


def _state_dict(params) -> dict:
    sd = params.state_dict() if isinstance(params, torch.nn.Module) \
        else params
    return {k: torch.as_tensor(v).detach() for k, v in sd.items()}


@dataclasses.dataclass
class EditSession:
    scale: int = 4
    nb: int = 23
    nf: int = 64
    latent_channels: int = 3
    z_range: float = 1.0
    time_budget_s: float = DEFAULT_TIME_BUDGET_S
    edit_dtype: torch.dtype | None = None  # e.g. torch.bfloat16 trunk
    fast_edit: bool = True       # the crop carries the margins; no pre-pad
    fast_trunk: bool = True      # the grouped trunk (rrdb_fast)
    iters_per_round: int = ITERS_PER_ROUND
    rounds_per_launch: int = 6   # rounds between checks of the budget
    device: object = None        # None: CUDA; 'cpu' to run on the CPU
    seed: int = 0                # random alternatives / random_* draws

    def __post_init__(self):
        self._device = resolve_device(self.device)
        self._rng = torch.Generator().manual_seed(self.seed)
        self._build_cem(None)
        self.generator = RRDBNet(nb=self.nb, nf=self.nf, upscale=self.scale,
                                 latent_channels=self.latent_channels,
                                 dtype=self.edit_dtype).to(self._device)
        self.generator.requires_grad_(False)
        self.params = None
        self._packed = None
        self._build_forward()
        self.lr_image = None        # [1, h, w, 3]
        self.hr_gt = None
        self.cur_z = None           # [1, H, W, C]
        self.region_mask_hr = None  # [H, W]
        self.sr = None
        self._history: deque = deque(maxlen=100)
        self._redo: deque = deque(maxlen=100)
        self._alternatives = None
        self.d_apply = None         # optional critic for 'Adversarial'
        self.vgg_apply = None       # optional feature net for 'VGG'

    def _t(self, a, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype,
                               device=self._device)

    def _build_cem(self, upscale_kernel):
        self.estimated_kernel = (upscale_kernel
                                 if isinstance(upscale_kernel, np.ndarray)
                                 else None)
        self.cem = CEM.create(CEMConf(scale_factor=self.scale),
                              upscale_kernel=upscale_kernel)
        self.filters = self.cem.device_filters(3, device=self._device)

    def _build_forward(self):
        if self.fast_trunk:
            def g_apply(p, x, z):
                return rrdbnet_apply_fast(None, x, z, packed=p,
                                          upscale=self.scale,
                                          dtype=self.edit_dtype)
        else:
            def g_apply(p, x, z):
                return p(x, z)
        self._wrapped = cem_wrap(g_apply, self.filters, upscale=self.scale)
        m = self.cem.invalidity_margins_lr

        def crop_fwd(pre_pad):
            def fwd(p, lr, z):
                return clip_unit(self._wrapped(p, lr, z, m, pre_pad=pre_pad))
            return fwd
        # differentiable forwards of an edit window, with and without the
        # replicate pre-pad
        self._crop_fwd = {True: crop_fwd(True), False: crop_fwd(False)}
        # ZOptimizers of the l1 edit by (objective, shapes): their data
        # (LR crop, desired image, mask) comes in through obj_args
        self._zopt_cache = {}

    @full_fp32()
    def _fwd(self, p, lr, z) -> torch.Tensor:
        """The clipped CEM-wrapped forward of a whole image (pre-padded),
        without gradients."""
        with torch.no_grad():
            return self._crop_fwd[True](p, self._t(lr), self._t(z))

    @property
    def eff_params(self):
        """The weights in the form the forward takes: the packed grouped
        weights with ``fast_trunk``, else the generator module."""
        return self._packed if self.fast_trunk else self.generator

    def _repack(self):
        if self.fast_trunk and self.params is not None:
            self._packed = pack_grouped_params(self.params,
                                               dtype=self.edit_dtype)
        else:
            self._packed = None

    # --------------------------------------------------------------- kernels
    def set_kernel(self, kernel: np.ndarray | str | None):
        """Rebuild the CEM chain for another downscaling kernel (an
        estimated ndarray, ``'blurry_cubic_<sigma>'``, or None for
        bicubic); the SR view is recomputed if an image is open."""
        self._build_cem(kernel)
        self._build_forward()
        if self.lr_image is not None:
            if self.hr_gt is not None:
                # an HR-sourced session re-derives its LR working image so
                # that the consistency invariant holds under the new kernel
                lr = consistent_downsample(
                    self._t(self.hr_gt), self.filters,
                    self.cem.ds_kernel_invalidity_half_size_lr)
                self.lr_image = lr.cpu().numpy()
            self.recompute()
        return self.sr

    def estimate_kernel(self, max_iters: int = 3000) -> np.ndarray:
        """Estimate the open LR image's downscaling kernel with KernelGAN
        (x2, composed to x4 at scale 4) on the session's device and switch
        the CEM to it; returns the kernel."""
        if self.lr_image is None:
            raise ValueError('open an image first')
        from exsr_torch.kernelgan.kernelgan import estimate_sr_kernel
        kernel = estimate_sr_kernel(self.lr_image[0], self.scale, max_iters,
                                    self._device)
        self.set_kernel(kernel)
        return kernel

    # -------------------------------------------------------------- loading
    def load_params(self, params):
        """Load generator weights: the port's RRDBNet or its state dict
        (``exsr_torch.models.convert.from_exsr_params`` converts exsr's).
        The generator stays frozen: no weight takes a gradient."""
        self.params = {k: v.to(self._device)
                       for k, v in _state_dict(params).items()}
        self.generator.load_state_dict(self.params)
        self._repack()
        self._zopt_cache.clear()

    def init_random_params(self, seed: int = 0):
        """Seeded random weights (the port's RRDBNet initialisation)."""
        self.load_params(RRDBNet(nb=self.nb, nf=self.nf, upscale=self.scale,
                                 latent_channels=self.latent_channels,
                                 seed=seed))

    def attach_esrgan(self, params=None, nb: int | None = None,
                      seed: int = 1):
        """A plain (Z-less, CEM-less) ESRGAN comparison model on the LR
        image; ``params`` is its RRDBNet or state dict, seeded random
        weights when None."""
        nb = self.nb if nb is None else nb
        net = RRDBNet(nb=nb, upscale=self.scale, latent_channels=0,
                      seed=seed)
        if params is not None:
            net.load_state_dict(_state_dict(params))
        self._esrgan = net.to(self._device).requires_grad_(False)
        self._esrgan_cache = None

    @full_fp32()
    def esrgan_sr(self) -> np.ndarray:
        """The comparison SR of the attached ESRGAN model, cached per LR
        image."""
        if getattr(self, '_esrgan', None) is None:
            raise RuntimeError('attach_esrgan first')
        self._require_image()
        cache = self._esrgan_cache
        if cache is not None and cache[0] is self.lr_image:
            return cache[1]
        with torch.no_grad():
            out = clip_unit(self._esrgan(self._t(self.lr_image), None))
        self._esrgan_cache = (self.lr_image, out.cpu().numpy())
        return self._esrgan_cache[1]

    def _require_image(self):
        if self.lr_image is None:
            raise RuntimeError('open an image first')

    def open_image(self, image: np.ndarray, is_hr: bool = True):
        """An HR input is consistently downsampled to form the LR working
        image."""
        img = self._t(image[None].astype(np.float32))
        if is_hr:
            self.hr_gt = img.cpu().numpy()
            lr = consistent_downsample(
                img, self.filters, self.cem.ds_kernel_invalidity_half_size_lr)
            self.lr_image = lr.cpu().numpy()
        else:
            self.hr_gt = None
            self.lr_image = img.cpu().numpy()
        h, w = self.lr_image.shape[1:3]
        self.cur_z = np.zeros((1, h * self.scale, w * self.scale,
                               self.latent_channels), np.float32)
        self.region_mask_hr = np.ones((h * self.scale, w * self.scale),
                                      np.float32)
        self._history.clear()
        self._redo.clear()
        self._alternatives = None   # retained Zs belong to the old image
        self.recompute()
        return self.sr

    def recompute(self):
        self.sr = self._fwd(self.eff_params, self.lr_image,
                            self.cur_z).cpu().numpy()
        return self.sr

    # ----------------------------------------------- alternatives (random)
    def _alternative_z(self, i: int) -> np.ndarray:
        alt = self._alternatives
        if alt is None or not 0 <= i < len(alt['zs']):
            raise IndexError('no retained alternative '
                             f'{i}: run optimize with n_alternatives > 1')
        z = self.cur_z.copy()
        ys, xs = alt['hr_slice']
        z[:, ys, xs] = alt['zs'][i:i + 1]
        return z

    def alternative_sr(self, i: int) -> np.ndarray:
        """SR output of retained random alternative ``i``."""
        return self._fwd(self.eff_params, self.lr_image,
                         self._alternative_z(i)).cpu().numpy()

    def copy_alternative(self, i: int):
        """Adopt alternative ``i``'s Z inside the selected region."""
        alt_z = self._alternative_z(i)
        self._push_history()
        m = self.region_mask_hr[None, :, :, None].astype(np.float32)
        self.cur_z = alt_z * m + self.cur_z * (1 - m)
        self.recompute()
        return self.sr

    def copy_default_to_alternatives(self):
        """Push the current Z into every retained alternative inside the
        selected region."""
        alt = self._alternatives
        if alt is None:
            raise RuntimeError('no retained alternatives: run optimize '
                               'with n_alternatives > 1')
        ys, xs = alt['hr_slice']
        m = self.region_mask_hr[ys, xs][None, :, :, None] \
            .astype(np.float32)
        alt['zs'] = alt['zs'] * (1 - m) + self.cur_z[:, ys, xs] * m

    def invert_region(self):
        self.set_region(1.0 - self.region_mask_hr)

    # ---------------------------------------------------------------- state
    def _push_history(self):
        self._history.append(self.cur_z.copy())
        self._redo.clear()

    def undo(self):
        if self._history:
            self._redo.append(self.cur_z.copy())
            self.cur_z = self._history.pop()
            self.recompute()
        return self.sr

    def redo(self):
        if self._redo:
            self._history.append(self.cur_z.copy())
            self.cur_z = self._redo.pop()
            self.recompute()
        return self.sr

    def set_region(self, mask_hr: np.ndarray):
        if mask_hr.shape != self.region_mask_hr.shape:
            raise ValueError(f'region {mask_hr.shape} is not the image\'s '
                             f'{self.region_mask_hr.shape}')
        self.region_mask_hr = mask_hr.astype(np.float32)

    def clear_region(self):
        self.region_mask_hr = np.ones_like(self.region_mask_hr)

    def estimate_periodicity(self, origin_yx, points_yx):
        """Autocorrelation-based cycle lengths for the periodicity tool:
        the gray values of the current SR image are sampled along
        origin -> point in ~0.1-pixel steps, and the first peak of their
        overlap-normalized autocorrelation rescales each direction to one
        cycle.  Returns the (y, x) period vectors for
        ``data['periodicity_points']``."""
        img = np.asarray(self.sr[0]).mean(-1)
        origin = np.asarray(origin_yx, np.float64)
        out = []
        for p in points_yx:
            p = np.asarray(p, np.float64)
            vec = p - origin
            n = int(np.abs(vec).max() / 0.1)
            vals = bilinear_sample_line(img, origin[0], origin[1], p[0],
                                        p[1], n)
            peak = first_autocorr_peak(overlap_normalized_autocorr(vals))
            cur = vec
            if peak is not None:
                length = float(np.linalg.norm(vec))
                cur = vec / length * (length / n * peak)
            out.append(cur)
        return out

    def set_uniform_z(self, values):
        """Constant Z over the selected region."""
        self._push_history()
        vals = np.asarray(values, np.float32).reshape(1, 1, 1, -1)
        m = self.region_mask_hr[None, :, :, None]
        self.cur_z = (1 - m) * self.cur_z + m * vals
        return self.recompute()

    def set_z_from_svd(self, lambda0: float, lambda1: float, theta: float):
        """The SVD sliders over the region."""
        return self.set_uniform_z(
            svd_to_latent_z(lambda0, lambda1, theta).numpy())

    # ------------------------------------------------------------- cropping
    def _crop_box(self):
        """LR-domain bounding box of the region mask, bucketed."""
        mask = self.region_mask_hr
        if mask.min() >= 1.0:
            return None
        ys, xs = np.nonzero(mask > 0)
        s = self.scale
        m = self.cem.invalidity_margins_lr
        y0, y1 = ys.min() // s - m, ys.max() // s + 1 + m
        x0, x1 = xs.min() // s - m, xs.max() // s + 1 + m
        h, w = self.lr_image.shape[1:3]
        y0, y1 = _bucket(max(0, y0), min(h, y1), h, CROP_BUCKET_LR)
        x0, x1 = _bucket(max(0, x0), min(w, x1), w, CROP_BUCKET_LR)
        return y0, y1, x0, x1

    # ------------------------------------------------------------- optimize
    @full_fp32()
    def optimize(self, objective: str, data: dict | None = None,
                 max_iters: int | None = None,
                 time_budget_s: float | None = None,
                 n_alternatives: int = 1, lr: float = INITIAL_LR):
        """Gradient-based Z edit.

        ``objective``: 'l1', 'scribble', 'max_STD', 'min_STD',
        'STD_increase', 'STD_decrease', 'Mag', 'TV', 'periodicity',
        'periodicity_nonInt', 'hist', 'dict', 'VGG', 'Adversarial',
        'random_l1', 'limited_random_l1', 'desired_SVD', 'digit',
        optionally prefixed with 'local_'; distance objectives also take a
        'max_' prefix ('max_l1', ...), which maximizes the distance.
        Returns ``{'sr', 'losses', 'final_loss', 'rounds',
        'n_alternatives'}``.
        """
        if self.params is None:
            raise RuntimeError('load or init generator params first')
        if self.region_mask_hr.sum() <= 0:
            raise ValueError('empty region selection: select a region (or '
                             'invert back)')
        data = data or {}
        self._push_history()
        box = self._crop_box()
        s = self.scale
        if box is None:
            lr_crop = self.lr_image
            z_full = self.cur_z
            mask_hr = self.region_mask_hr
            hr_slice = (slice(None), slice(None))
        else:
            y0, y1, x0, x1 = box
            lr_crop = self.lr_image[:, y0:y1, x0:x1]
            z_full = self.cur_z[:, y0 * s:y1 * s, x0 * s:x1 * s]
            mask_hr = self.region_mask_hr[y0 * s:y1 * s, x0 * s:x1 * s]
            hr_slice = (slice(y0 * s, y1 * s), slice(x0 * s, x1 * s))

        # the objective's images are cropped to the same HR window
        data = dict(data)
        for key in ('desired', 'reference_image_min', 'reference_image_max'):
            if key in data and hasattr(data[key], 'ndim'):
                arr = np.asarray(data[key])
                if arr.ndim == 4 and arr.shape[1:3] == \
                        self.region_mask_hr.shape:
                    data[key] = arr[:, hr_slice[0], hr_slice[1]]
        if 'scribble_mask' in data and np.asarray(
                data['scribble_mask']).shape == self.region_mask_hr.shape:
            data['scribble_mask'] = np.asarray(
                data['scribble_mask'])[hr_slice[0], hr_slice[1]]

        # an alternatives request runs at the next batch bucket; rows past
        # the request are extra random candidates, dropped below
        n_req = n_alternatives
        b = alt_bucket(n_req) if n_req > 1 else n_req
        lr_batch = self._t(np.repeat(lr_crop, b, axis=0))
        z_batch = np.repeat(z_full, b, axis=0)
        margins = self.cem.invalidity_margins_lr
        # the crop box already holds the margins: with fast_edit skip the
        # pre-pad, which would pad a second margin
        use_prepad = not (self.fast_edit and box is not None)
        crop_fwd = self._crop_fwd[use_prepad]

        def forward(z):
            return crop_fwd(self.eff_params, lr_batch, z)

        obj_args = None
        name = objective.replace('local_', '')
        cacheable = (name == 'l1' and 'random' not in objective
                     and 'scribble' not in objective)
        if cacheable:
            obj_args = {
                'lr': lr_batch,
                'desired': self._t(np.asarray(data['desired'], np.float32)),
                'mask': self._t(mask_hr[None, :, :, None]),
            }
            key = ('l1', tuple(lr_batch.shape), use_prepad, b)
            if key not in self._zopt_cache:
                def forward_a(z, args):
                    return clip_unit(self._wrapped(
                        self.eff_params, args['lr'], z, margins,
                        pre_pad=use_prepad))

                def loss_a(out, z, args):
                    m = args['mask']
                    return obj.abs_(out * m - args['desired'] * m).mean()

                self._zopt_cache[key] = ZOptimizer(
                    forward_a, loss_a, lr=lr, z_range=self.z_range)
            zo = self._zopt_cache[key]
        else:
            with torch.no_grad():
                initial_out = forward(self._t(z_batch)).cpu().numpy()
            loss_fn = self._build_objective(objective, data, mask_hr,
                                            initial_out, forward,
                                            z0=self._t(z_batch))
            zo = ZOptimizer(forward, loss_fn, lr=lr, z_range=self.z_range)
        eps = np.finfo(np.float32).eps
        theta0 = np.arctanh(np.clip(z_batch / self.z_range, -1 + eps,
                                    1 - eps)).astype(np.float32)
        if b > 1 or 'random' in objective:
            rand = xavier_uniform_like(torch.from_numpy(theta0),
                                       self._rng).numpy()
            theta0 = np.concatenate([theta0[:1], rand[1:]], axis=0) \
                if b > 1 else rand
        theta = self._t(theta0)
        frozen = self._t(np.repeat(np.arctanh(np.clip(
            z_full / self.z_range, -1 + eps, 1 - eps)).astype(np.float32),
            b, axis=0))
        z_mask = self._z_mask(mask_hr)

        budget = (self.time_budget_s if time_budget_s is None
                  else time_budget_s)
        deadline = time.time() + budget
        best_loss, best_theta, best_z = np.inf, theta, None
        losses_hist = []
        rounds = 0
        cur_lr = lr
        max_rounds = (None if max_iters is None else
                      int(np.ceil(max_iters / self.iters_per_round)))
        while time.time() < deadline and cur_lr >= 1e-5:
            n_rounds = self.rounds_per_launch
            if max_rounds is not None:
                n_rounds = min(n_rounds, max_rounds - rounds)
                if n_rounds <= 0:
                    break
            z, theta, chunk_best, cur_lr, losses = zo.optimize_rounds(
                theta, n_rounds=n_rounds,
                iters_per_round=self.iters_per_round, lr=cur_lr,
                z_mask=z_mask, frozen_theta=frozen,
                lr_decay=LR_DECAY_ON_PLATEAU, obj_args=obj_args)
            losses = losses[~np.isnan(losses)]
            losses_hist.extend(losses.tolist())
            rounds += int(np.ceil(len(losses) / self.iters_per_round))
            if chunk_best < best_loss:
                best_loss, best_theta, best_z = chunk_best, theta, z
        if best_z is None:   # the budget ran out before the first round
            best_z = zo.z_of(best_theta, z_mask, frozen)
        best_z = best_z.detach().float().cpu().numpy()
        if n_req > 1:
            # the optimized alternatives are kept for browsing; bucket rows
            # past the request are dropped
            self._alternatives = {'zs': best_z[1:n_req],
                                  'hr_slice': hr_slice}
        new_z = self.cur_z.copy()
        new_z[:, hr_slice[0], hr_slice[1]] = best_z[:1]
        self.cur_z = new_z
        self.recompute()
        return {'sr': self.sr, 'losses': losses_hist,
                'final_loss': best_loss, 'rounds': rounds,
                'n_alternatives': n_req - 1 if n_req > 1 else 0}

    def _z_mask(self, mask_hr):
        if mask_hr.min() >= 1.0:
            return None
        return self._t(mask_hr[None, :, :, None])

    # ------------------------------------------------- objective dispatcher
    def _build_objective(self, objective: str, data: dict, mask_hr,
                         initial_out: np.ndarray, forward,
                         z0: torch.Tensor | None = None) -> Callable:
        local = 'local' in objective
        mask = mask_hr.astype(np.float32)
        helpers = obj.STDHelpers.create(
            mask, local=local, overlap=1.0 if 'STD' in objective else 0.5,
            device=self._device)
        initial_std = helpers(self._t(initial_out))
        mask_dev = self._t(mask)
        constraining = None
        if mask.min() < 1 and 'non_local' in data:
            constraining = obj.non_local_constraint(
                self._t(initial_out), self._t(mask <= 0),
                weight=data.get('constraint_weight', 0.1))

        name = objective.replace('local_', '')
        # a 'max_' prefix on a distance objective flips its sign; the STD
        # and Mag objectives carry their own min/max meaning
        negate = (name.startswith('max_') and 'STD' not in name
                  and 'Mag' not in name)
        if negate:
            name = name[len('max_'):]
        if 'scribble' in name:
            desired, l1_mask, tv_masks = self._scribble_targets(
                data, mask, initial_out)
            loss = obj.scribble(desired, l1_mask, tv_masks)
        elif 'l1' in name and 'random' not in name:
            loss = obj.l1_to_desired(self._t(data['desired']), mask_dev)
        elif name in ('max_STD', 'min_STD', 'STD_increase', 'STD_decrease'):
            desired_std = None
            if 'increase' in name or 'decrease' in name:
                inc = data.get('STD_increment')
                if inc is None:
                    f = (obj.STD_CHANGE_FACTOR if 'increase' in name
                         else 1 / obj.STD_CHANGE_FACTOR)
                    desired_std = initial_std * f
                else:
                    desired_std = initial_std + (
                        inc if 'increase' in name else -inc)
            loss = obj.std_objective(helpers, name, desired_std)
        elif 'Mag' in name:
            # patch-magnitude edits are local by nature
            if helpers.indices is None:
                raise ValueError("Mag objectives need the 'local_' prefix")
            gray = initial_out.mean(axis=-1)[0]
            patches = gray.reshape(-1)[helpers.indices.cpu().numpy()].T
            std = np.maximum(patches.std(0, ddof=1, keepdims=True), 1 / 255)
            inc = data['STD_increment'] * (1 if 'increase' in name else -1)
            desired = ((patches - patches.mean(0, keepdims=True)) / std
                       * (std + inc) + patches.mean(0, keepdims=True))
            loss = obj.magnitude_objective(self._t(desired.T),
                                           helpers.indices)
        elif 'periodicity' in name:
            pts = data['periodicity_points']
            desired_std = (initial_std + data['STD_increment']
                           if 'Plus' in name and 'STD_increment' in data
                           else None)
            if 'nonInt' in name:
                grids = obj.periodicity_grids(pts, mask.shape,
                                              device=self._device)
                loss = obj.periodicity_nonint_objective(
                    grids, mask_dev, helpers, initial_std, desired_std)
            else:
                loss = obj.periodicity_objective(
                    [np.array(p, int) for p in pts], mask_dev, helpers,
                    initial_std, desired_std)
        elif 'TV' in name:
            loss = obj.tv_objective(helpers, initial_std)
        elif 'hist' in name or 'dict' in name:
            temperature = 5e-4 if 'hist' in name else 1e-3
            desired_images = [np.asarray(d) for d in data['desired']]
            if data.get('auto_temperature') and 'hist' in name:
                # gradient-based calibration on a patch-size-3 probe loss
                # from the default 0.05
                cal = SoftHistogramLoss.create(
                    desired_images=desired_images,
                    desired_masks=data.get('desired_masks'),
                    input_mask=mask, patch_size=3 if 'patch' in name else 1,
                    temperature=0.05, device=self._device)
                temperature = cal.auto_temperature(
                    lambda th: forward(self.z_range * torch.tanh(th)),
                    atanh_init(z0, self.z_range))
            shl = SoftHistogramLoss.create(
                desired_images=desired_images,
                desired_masks=data.get('desired_masks'), input_mask=mask,
                patch_size=6 if 'patch' in name else 1,
                temperature=temperature,
                dictionary_not_histogram='dict' in name,
                no_patch_dc='noDC' in name,
                no_patch_std='no_localSTD' in name, device=self._device)
            if 'localSTD' in name:
                def loss(out, z):
                    return shl(out, z) + 1e4 * (
                        (helpers(out) - initial_std) ** 2).mean()
            else:
                loss = shl
        elif 'desired_SVD' in name:
            loss = obj.desired_svd_objective(
                self._t(data['reference_image_min']),
                self._t(data['reference_image_max']),
                self._t(data['desired_Z']), mask_dev)
        elif name == 'digit':
            ys, xs = np.nonzero(mask > 0)
            bounds = (int(ys.min()), int(xs.min()), int(ys.max()),
                      int(xs.max()))
            loss = obj.digit_objective(
                data['classifier_apply'], bounds,
                int(data['digit_2_resemble']),
                multiview=tuple(data.get('multiview_classification',
                                         (1, 3))))
        elif 'VGG' in name and 'random' not in name:
            if self.vgg_apply is None:
                raise RuntimeError('no feature net attached (vgg_apply)')
            with torch.no_grad():
                desired_feat = self.vgg_apply(self._t(data['desired']))
            loss = obj.vgg_objective(self.vgg_apply, desired_feat)
        elif 'Adversarial' in name:
            if self.d_apply is None:
                raise RuntimeError('no critic attached (d_apply)')
            loss = obj.adversarial_objective(self.d_apply)
        elif 'random' in name:
            loss = obj.diversity_objective(
                name, mask_dev if mask.min() < 1 else None,
                helpers=helpers if local else None,
                initial_std=initial_std,
                initial_image=self._t(initial_out)
                if 'limited' in name else None,
                rmse_weight=data.get('rmse_weight', 0.0),
                feature_fn=self.vgg_apply if 'VGG' in name else None)
        else:
            raise NotImplementedError(objective)
        if negate:
            loss = obj.negated(loss)
        if constraining is not None:
            loss = obj.with_constraint(loss, constraining)
        return loss

    def _scribble_targets(self, data, mask, initial_out):
        """Desired image and masks of a scribble or brightness edit."""
        scribble_mask = data['scribble_mask']
        desired = np.asarray(data['desired']).copy()
        brightness = data.get('brightness_factor', 0.0)
        mult, l1_mask, tv_masks = scribble_mask_components(
            scribble_mask, mask, brightness)
        if brightness:
            # HSV value-channel scaling of the current output
            cur = np.clip(initial_out[0], 0, 1)
            mx = cur.max(-1)
            scaled = cur * (mult[..., None] * mx[..., None]
                            / np.maximum(mx[..., None], 1e-6))
            sel = ((scribble_mask == 2) | (scribble_mask == 3))[..., None]
            desired = np.where(sel, np.clip(scaled, 0, 1)[None], desired)
        return (self._t(desired), self._t(l1_mask),
                [self._t(m) for m in tv_masks])

    # -------------------------------------------------------------- editing
    def find_optimal_imprint_location(self, imprint: np.ndarray,
                                      search_mask: np.ndarray,
                                      n_trials: int = 200, seed: int = 0):
        """Random search for the most LR-consistent placement of an
        imprint: sample top-left positions inside the search region, score
        each by the LR-consistency error of the composite over the
        imprint's footprint; returns the best position and its score."""
        ih, iw = imprint.shape[:2]
        H, W = self.region_mask_hr.shape
        ys, xs = np.nonzero(search_mask > 0)
        y_lo, y_hi = ys.min(), min(ys.max(), H - ih)
        x_lo, x_hi = xs.min(), min(xs.max(), W - iw)
        if y_hi < y_lo or x_hi < x_lo:
            raise ValueError('imprint larger than the region')
        rng = np.random.default_rng(seed)
        sr = np.asarray(self.sr[0], np.float64)
        best = (np.inf, (int(y_lo), int(x_lo)))
        s = self.scale
        for _ in range(n_trials):
            y = int(rng.integers(y_lo, y_hi + 1))
            x = int(rng.integers(x_lo, x_hi + 1))
            composite = sr.copy()
            composite[y:y + ih, x:x + iw] = imprint
            # score only the imprint's LR footprint
            y0, x0 = max(0, y // s - 4), max(0, x // s - 4)
            y1 = min(H // s, (y + ih) // s + 4)
            x1 = min(W // s, (x + iw) // s + 4)
            crop = composite[y0 * s:y1 * s, x0 * s:x1 * s]
            down = imresize(crop, 1.0 / s)
            err = float(np.abs(
                down - self.lr_image[0, y0:y1, x0:x1]).mean())
            if err < best[0]:
                best = (err, (y, x))
        return {'position': best[1], 'consistency_error': best[0]}

    def imprint(self, imprint_rgb: np.ndarray, position: tuple[int, int],
                optimize_iters: int = 25,
                imprint_mask: np.ndarray | None = None):
        """Paste an imprint at an HR position (cropped to the canvas), make
        it LR-consistent, and pull Z toward it with an l1 edit;
        ``imprint_mask`` (0..1, imprint-sized) keeps the current output
        where it is 0."""
        y, x = position
        desired_full = np.asarray(self.sr[0], np.float64).copy()
        ih = min(imprint_rgb.shape[0], desired_full.shape[0] - y)
        iw = min(imprint_rgb.shape[1], desired_full.shape[1] - x)
        if ih <= 0 or iw <= 0:
            raise ValueError(f'imprint position {position} is outside the '
                             'image')
        patch = np.asarray(imprint_rgb, np.float64)[:ih, :iw]
        if imprint_mask is not None:
            imprint_mask = np.asarray(imprint_mask)[:ih, :iw]
            m = np.asarray(imprint_mask, np.float64)[..., None]
            patch = m * patch + (1 - m) * desired_full[y:y + ih, x:x + iw]
        desired_full[y:y + ih, x:x + iw] = patch
        consistent = self.cem.enforce_dt_on_image_pair(
            self.lr_image[0].astype(np.float64), desired_full)
        mask = np.zeros(self.region_mask_hr.shape, np.float32)
        # transparent pixels stay unconstrained
        mask[y:y + ih, x:x + iw] = (1.0 if imprint_mask is None else
                                    np.asarray(imprint_mask, np.float32))
        self.set_region(mask)
        return self.optimize(
            'l1', data={'desired': np.clip(consistent, 0, 1)[None]
                        .astype(np.float32)},
            max_iters=optimize_iters)

    def enforce_hsv_edit(self, edited_hr: np.ndarray):
        """Make an external HR edit LR-consistent."""
        consistent = self.cem.enforce_dt_on_image_pair(
            self.lr_image[0], edited_hr.astype(np.float64))
        return np.clip(consistent, 0, 1)

    # ---------------------------------------------------------------- state
    def save_z(self, path: str):
        np.savez(path, z=self.cur_z, scale=self.scale)

    def load_z(self, path: str):
        with np.load(path) as data:
            if int(data['scale']) != self.scale:
                raise ValueError(f'Z saved at scale {int(data["scale"])}, '
                                 f'the session runs x{self.scale}')
            z = data['z']
        self._push_history()
        self.cur_z = z
        return self.recompute()
