"""Differentiable histogram / patch-dictionary loss (KDE).

Counterpart of ``exsr/zopt/histogram.py``:

* bins are linspace centres for grayscale histograms, or the desired
  image's own deduplicated pixels or patches in KDE / dictionary mode
  (built on the host once per edit: the pruned bin count depends on the
  data);
* soft counts ``exp(-(|x - bin| (+ wraparound))^2 / T)``, averaged over
  the value dimensions and normalized by the desired image's normalizer,
  with one extra leak bin in KDE mode;
* the KL(desired || produced) objective (``torch.nn.KLDivLoss``
  semantics on log-probabilities), or the -log-mean-exp dictionary
  distance;
* the binary-search temperature calibration, and the gradient-based one:
  Adam on log-temperature maximizing the norm of dKL/d(pre-tanh Z), whose
  own gradient is a gradient of a gradient (``torch.autograd.grad`` with
  ``create_graph``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from exsr_torch.zopt.objectives import abs_
from exsr_torch.zopt.optimizer import adam_init, adam_update
from exsr_torch.zopt.patches import gather_patches, patch_indices_from_mask

SQRT_EPSILON = 1e-7
EXP_POWER = 2


def prune_bins(values: np.ndarray, bin_width: float) -> np.ndarray:
    """Drop near-duplicate columns of ``[num_dims, N]``: those whose every
    dimension lies closer than bin_width/2 to an earlier kept column."""
    kept: list[np.ndarray] = []
    out_idx = []
    for i in range(values.shape[1]):
        v = values[:, i]
        dup = False
        if kept:
            arr = np.stack(kept, 1)
            dup = bool(np.any(np.all(np.abs(arr - v[:, None])
                                     < bin_width / 2, axis=0)))
        if not dup:
            kept.append(v)
            out_idx.append(i)
    return values[:, out_idx]


@dataclasses.dataclass
class SoftHistogram:
    """Soft histogram for one configuration, on a device."""
    bins: torch.Tensor         # [num_dims, n_bins]
    bin_width: float
    max_value: float
    temperature: float
    kde: bool
    dictionary: bool
    normalizer: torch.Tensor | None = None

    def counts(self, values: torch.Tensor, temperature=None
               ) -> torch.Tensor:
        """values ``[num_dims, N]`` -> soft counts ``[n_bins]`` (or the
        dictionary distances ``[N]``)."""
        t = self.temperature if temperature is None else temperature
        x = values[:, :, None].float()
        b = self.bins[:, None, :]
        d = abs_(x - b)
        d = torch.minimum(d, abs_(x - b - self.max_value))
        d = torch.minimum(d, abs_(x - b + self.max_value))
        logk = -((d + SQRT_EPSILON) ** EXP_POWER) / t
        logk = logk.mean(0)                       # [N, n_bins]
        if self.dictionary:
            return -torch.log(torch.exp(logk).mean(1))
        return torch.exp(logk).mean(0)

    def histogram(self, values: torch.Tensor, normalizer=None,
                  temperature=None):
        """Normalized soft histogram ``[n_bins (+1)]``: ``(hist, norm)``."""
        n = values.shape[1]
        counts = self.counts(values, temperature)
        if normalizer is None:
            normalizer = counts.sum() / n
        hist = counts / normalizer / n
        if self.kde:  # leak bin for the mass outside the sampled bins
            hist = torch.cat([hist, (1.0 - torch.clamp(hist.sum(),
                                                       max=1.0))[None]])
        return hist, normalizer


def kl_div(log_pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """``torch.nn.KLDivLoss(reduction='mean')`` on (log-input, probs),
    zero where the target is."""
    safe = torch.where(target > 0, target * (torch.log(
        torch.clamp(target, min=1e-30)) - log_pred),
        torch.zeros((), dtype=target.dtype, device=target.device))
    return safe.mean()


def _log_eps(h: torch.Tensor) -> torch.Tensor:
    return torch.log(h + torch.finfo(h.dtype).eps)


@dataclasses.dataclass
class SoftHistogramLoss:
    """Builder and callable objective: histogram or dictionary over masked
    gray images or patches."""
    hist: SoftHistogram
    desired_hist: torch.Tensor | None
    input_indices: torch.Tensor | None     # patch gather indices
    input_mask_flat: torch.Tensor | None   # masked pixels (pixel mode)
    patch_size: int
    no_patch_dc: bool
    no_patch_std: bool
    mean_patches_std: float | None
    desired_vals: torch.Tensor | None = None  # [num_dims, N]

    @classmethod
    def create(cls, desired_images: list[np.ndarray],
               desired_masks: list[np.ndarray] | None,
               input_mask: np.ndarray, bins: int = 256, vmin: float = 0.0,
               vmax: float = 1.0, patch_size: int = 1,
               temperature: float = 5e-4,
               dictionary_not_histogram: bool = False,
               no_patch_dc: bool = False, no_patch_std: bool = False,
               device=None):
        """Grayscale histogram or dictionary objective from desired
        image(s) and masks (HWC float arrays in [0, 1]; gray is the channel
        mean)."""
        bin_width = (vmax - vmin) / (bins - 1)
        num_dims = patch_size ** 2
        kde = patch_size > 1
        mean_patches_std = None
        if patch_size > 1:
            overlap = (num_dims - patch_size) / num_dims
            cols = []
            for im, msk in zip(desired_images, desired_masks):
                gray = im.mean(-1)
                idx = patch_indices_from_mask(msk, patch_size,
                                              patches_overlap=overlap)
                cols.append(gray.reshape(-1)[idx.T])   # [k*k, P]
            desired_vals = np.concatenate(cols, 1)
            if no_patch_dc:
                desired_vals = desired_vals - desired_vals.mean(
                    0, keepdims=True)
                if no_patch_std:
                    stds = np.maximum(desired_vals.std(0, ddof=1,
                                                       keepdims=True),
                                      1 / 255)
                    desired_vals = desired_vals / stds
                    mean_patches_std = float(stds.mean())
                    desired_vals = desired_vals * mean_patches_std
            in_idx = patch_indices_from_mask(input_mask, patch_size,
                                             patches_overlap=0.5)
            input_indices = torch.as_tensor(in_idx, device=device)
            input_mask_flat = None
        else:
            im, msk = desired_images[0], (desired_masks[0]
                                          if desired_masks else None)
            gray = im.mean(-1).reshape(1, -1)
            desired_vals = gray[:, msk.reshape(-1).astype(bool)] \
                if msk is not None else gray
            input_indices = None
            input_mask_flat = torch.as_tensor(
                np.flatnonzero(input_mask.reshape(-1)), device=device)
        if kde:
            bin_vals = prune_bins(desired_vals, bin_width)
        else:
            bin_vals = np.linspace(vmin, vmax, bins)[None, :]
        hist = SoftHistogram(
            bins=torch.as_tensor(bin_vals, dtype=torch.float32,
                                 device=device),
            bin_width=bin_width, max_value=vmax, temperature=temperature,
            kde=kde, dictionary=dictionary_not_histogram)
        desired = torch.as_tensor(desired_vals, dtype=torch.float32,
                                  device=device)
        desired_hist = None
        if not dictionary_not_histogram:
            desired_hist, norm = hist.histogram(desired)
            hist = dataclasses.replace(hist, normalizer=norm)
        return cls(hist=hist, desired_hist=desired_hist,
                   input_indices=input_indices,
                   input_mask_flat=input_mask_flat, patch_size=patch_size,
                   no_patch_dc=no_patch_dc, no_patch_std=no_patch_std,
                   mean_patches_std=mean_patches_std, desired_vals=desired)

    def _image_values(self, image: torch.Tensor) -> torch.Tensor:
        """One image ``[H, W, C]`` -> ``[num_dims, N]`` values."""
        gray = image.mean(-1)
        if self.patch_size > 1:
            vals = gather_patches(gray, self.input_indices).T  # [k*k, P]
            if self.no_patch_dc:
                vals = vals - vals.mean(0, keepdim=True)
                if self.no_patch_std:
                    vals = vals / torch.clamp(
                        vals.std(0, correction=1, keepdim=True),
                        min=1 / 255) * self.mean_patches_std
            return vals
        flat = gray.reshape(-1)
        if self.input_mask_flat is not None:
            flat = flat[self.input_mask_flat]
        return flat[None, :]

    def _loss(self, out, desired_hist, normalizer, temperature=None):
        losses = []
        for i in range(out.shape[0]):
            vals = self._image_values(out[i])
            if self.hist.dictionary:
                losses.append(self.hist.counts(vals, temperature).mean())
            else:
                h, _ = self.hist.histogram(vals, normalizer, temperature)
                losses.append(kl_div(_log_eps(h), desired_hist))
        return torch.stack(losses).mean()

    def __call__(self, out: torch.Tensor, z=None) -> torch.Tensor:
        return self._loss(out, self.desired_hist, self.hist.normalizer)

    def calibrate_temperature(self, initial_image: torch.Tensor,
                              desired_kl: float = 1.0,
                              tolerance: float = 0.1) -> float:
        """Binary-search the temperature for a target initial KL divergence
        (the desired histogram recomputed at every candidate)."""
        if self.hist.dictionary:
            raise ValueError('calibration needs a histogram objective')
        lo, hi = 0.1, 1.0
        within = False
        first_too_big = None
        vals = self._image_values(torch.as_tensor(initial_image))
        for _ in range(60):
            t = float(np.exp((lo + hi) / 2))
            if not np.isfinite(t) or t == 0:
                break
            with torch.no_grad():
                dh, norm = self.hist.histogram(self.desired_vals,
                                               temperature=t)
                h, _ = self.hist.histogram(vals, norm, temperature=t)
                kl = float(kl_div(torch.log(h + 1e-12), dh))
            too_big = kl > desired_kl
            if kl > 0 and abs(np.log(kl / desired_kl)) <= np.log(
                    1 + tolerance):
                return t
            if not within:
                if first_too_big is None:
                    first_too_big = too_big
                else:
                    within = first_too_big != too_big
                if not within:
                    if too_big:
                        hi += 10
                    else:
                        lo -= 10
            if within:
                if too_big:
                    lo = np.log(t)
                else:
                    hi = np.log(t)
        return float(self.hist.temperature)

    def auto_temperature(self, image_of_theta, theta0: torch.Tensor,
                         n_iters: int = 50, lr: float = 0.5) -> float:
        """Gradient-based temperature calibration: Adam (lr 0.5) on
        log-temperature maximizing ``||d KL(hist(G(theta)),
        hist(desired)) / d theta||_2`` at ``theta0``, both histograms at
        the candidate temperature; returns the temperature that reached
        the largest gradient norm along the way.  ``image_of_theta`` maps
        pre-tanh Z to the clipped HR output batch."""
        if self.hist.dictionary:
            raise ValueError('unsupported for a dictionary objective')

        def neg_grad_norm(log_t):
            t = torch.exp(log_t)
            dh, norm = self.hist.histogram(self.desired_vals, temperature=t)
            theta = theta0.detach().requires_grad_(True)
            kl = self._loss(image_of_theta(theta), dh, norm, t)
            (g,) = torch.autograd.grad(kl, theta, create_graph=True)
            return -torch.sqrt((g.float() ** 2).sum())

        log_t = torch.tensor(np.log(self.hist.temperature),
                             dtype=torch.float32, device=theta0.device)
        opt = adam_init(log_t)
        best_val, best_log_t = float('inf'), log_t
        with torch.enable_grad():
            for _ in range(n_iters):
                log_t = log_t.detach().requires_grad_(True)
                val = neg_grad_norm(log_t)
                (g,) = torch.autograd.grad(val, log_t)
                v = float(val.detach())
                if v < best_val:
                    best_val, best_log_t = v, log_t.detach()
                u, opt = adam_update(g, opt, lr)
                log_t = log_t.detach() + u
        return float(torch.exp(best_log_t))
