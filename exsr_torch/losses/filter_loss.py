"""The latent structure-tensor loss L_struct, and its running statistics.

Counterpart of ``exsr/losses/filter_loss.py``.  It ties the latent control
Z to measured output statistics: per-image structure-tensor moments of the
SR output, normalized by the HR image's, must follow the Z channels mapped
through running 5 / 95 percentile bounds.

The statistics live on the device as a ring buffer (:class:`RatioStats`,
``[C, 10000]`` with a write cursor and a count), updated by one indexed
write per step and reduced by ``torch.nanquantile`` (linear interpolation,
as ``jnp.nanpercentile``), so a step reads nothing back to the host.  As in
``exsr``, the loss is differentiated through the updated buffer, its
bounds included.

Modes: ``'SVDinNormedOut_structure_tensor'`` (the training default),
``'structure_tensor'``, ``'SVD_structure_tensor'`` and
``'STD_directional'``.
"""
from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch

from exsr_torch.ops.structure_tensor import (image_gradients,
                                             svd_symmetric_2x2,
                                             valid_struct_tensor)

RESERVOIR = 10_000
LOWER_Q, UPPER_Q = 0.05, 0.95


@dataclasses.dataclass
class RatioStats:
    """Per-channel running ratio reservoir on the device: ``buffer``
    ``[C, size]``, ``cursor`` the next write position and ``count`` the
    values ever written (0-d int64 tensors)."""
    buffer: torch.Tensor
    cursor: torch.Tensor
    count: torch.Tensor

    @classmethod
    def create(cls, num_channels: int, size: int = RESERVOIR, device=None
               ) -> 'RatioStats':
        zero = torch.zeros((), dtype=torch.int64, device=device)
        return cls(buffer=torch.zeros(num_channels, size, device=device),
                   cursor=zero, count=zero.clone())

    def update(self, values: torch.Tensor) -> 'RatioStats':
        """A new ring with the ``[C, B]`` measured ratios appended."""
        size = self.buffer.shape[1]
        b = values.shape[1]
        idx = (self.cursor + torch.arange(b, device=values.device)) % size
        buf = self.buffer.detach().clone()
        buf[:, idx] = values.to(buf.dtype)
        return RatioStats(buffer=buf, cursor=(self.cursor + b) % size,
                          count=self.count + b)

    def bounds(self) -> tuple[torch.Tensor, torch.Tensor]:
        """``(lower, upper)``: the 5 and 95 percentiles of each channel
        over the filled part of the ring."""
        size = self.buffer.shape[1]
        pos = torch.arange(size, device=self.buffer.device)[None, :]
        filled = pos < torch.clamp(self.count, max=size)
        vals = torch.where(filled, self.buffer,
                           self.buffer.new_tensor(float('nan')))
        return (torch.nanquantile(vals, LOWER_Q, dim=1),
                torch.nanquantile(vals, UPPER_Q, dim=1))

    def detached(self) -> 'RatioStats':
        """The same ring cut from the graph of the step that wrote it."""
        return RatioStats(self.buffer.detach(), self.cursor, self.count)

    def state_dict(self) -> dict:
        return {'buffer': self.buffer, 'cursor': self.cursor,
                'count': self.count}

    @classmethod
    def from_state_dict(cls, d: dict, device=None) -> 'RatioStats':
        return cls(**{k: d[k].to(device) for k in
                      ('buffer', 'cursor', 'count')})


def structure_tensor_moments(img: torch.Tensor) -> torch.Tensor:
    """``[3, B]``: the spatial and channel means of (Ix^2, Iy^2, IxIy)."""
    ix, iy = image_gradients(img)
    moments = torch.stack([ix * ix, iy * iy, ix * iy], dim=0)
    return moments.mean(dim=(2, 3, 4))


def num_latent_channels(latent_channels: str | int) -> int:
    """The latent channels a ``latent_channels`` option names: an int as
    it is, ``'STD_1dir'`` 2, else the first digits in the string, or 3."""
    if isinstance(latent_channels, int):
        return latent_channels
    if latent_channels == 'STD_1dir':
        return 2
    m = re.search(r'(\d)+', latent_channels)
    return int(m.group(0)) if m else 3


@dataclasses.dataclass(frozen=True)
class FilterLossConfig:
    latent_channels: str = 'SVDinNormedOut_structure_tensor'
    noise_std: float = 1.0 / 255.0


def filter_loss(cfg: FilterLossConfig, stats: RatioStats,
                sr: torch.Tensor, hr: torch.Tensor, z: torch.Tensor,
                svd: dict[str, torch.Tensor] | None = None
                ) -> tuple[torch.Tensor, RatioStats]:
    """Per-image L_struct and the updated running statistics.

    ``z`` is the HR-domain latent map ``[B, H, W, C]``; its spatial mean is
    the per-image control.  For ``'SVD_structure_tensor'``, ``svd`` holds
    the ``lambda0_ratio``, ``lambda1_ratio`` and ``theta`` maps the Z was
    made from.  The loss is ``[B, C]``, or ``[C]`` in the SVD mode (a mean
    over the valid images).  An integer ``latent_channels`` has no
    structural mapping and raises.
    """
    mode = cfg.latent_channels
    cur_z = z.mean(dim=(1, 2))  # [B, C]

    if mode == 'STD_directional':
        return _std_directional(cfg, stats, sr, hr, cur_z)

    m_sr = structure_tensor_moments(sr)   # [3, B]
    m_hr = structure_tensor_moments(hr)

    if mode == 'SVD_structure_tensor':
        lam0_s, lam1_s, th_s = svd_symmetric_2x2(*m_sr)
        lam0_h, lam1_h, _ = svd_symmetric_2x2(*m_hr)
        valid = valid_struct_tensor(*m_sr) & valid_struct_tensor(*m_hr)
        measured = torch.stack([lam0_s / (lam0_h + cfg.noise_std),
                                lam1_s / (lam1_h + cfg.noise_std),
                                th_s], dim=0)  # [3, B]
        new_stats = stats.update(measured)
        lower, upper = new_stats.bounds()
        mid = (upper + lower) / 2.0
        span = upper - lower
        # lambda channels: the measured ratio normalized into the [0, 1]
        # target space; theta: the pi-periodic angular difference
        meas0 = (measured[0] - mid[0]) / (span[0] + 1e-30) + 0.5
        meas1 = (measured[1] - mid[1]) / (span[1] + 1e-30) + 0.5
        meas2 = measured[2] / np.pi
        tgt0 = svd['lambda0_ratio'].mean(dim=(1, 2))
        tgt1 = svd['lambda1_ratio'].mean(dim=(1, 2))
        tgt2 = (torch.remainder(svd['theta'], np.pi) - np.pi / 2).mean(
            dim=(1, 2)) / np.pi
        d0 = (meas0 - tgt0).abs()
        d1 = (meas1 - tgt1).abs()
        dt = meas2 - tgt2
        d2 = torch.minimum(torch.minimum(dt.abs(), (dt + 1.0).abs()),
                           (dt - 1.0).abs())
        diffs = torch.stack([d0, d1, d2], dim=1)  # [B, 3]
        w = valid.to(diffs.dtype)[:, None]
        loss = torch.sum(diffs * w, dim=0) / torch.clamp(w.sum(), min=1.0)
        return loss, new_stats

    if mode == 'SVDinNormedOut_structure_tensor':
        normalizer = torch.sqrt(m_hr[0]) * torch.sqrt(m_hr[1])  # [B]
        measured = m_sr / (normalizer[None, :] + cfg.noise_std)
    elif mode == 'structure_tensor':
        # the HR ratio of the diagonal moments only; IxIy stays as it is
        measured = torch.stack(
            [m_sr[0] / (m_hr[0] + torch.sign(m_sr[0]) * cfg.noise_std),
             m_sr[1] / (m_hr[1] + torch.sign(m_sr[1]) * cfg.noise_std),
             m_sr[2]], dim=0)
    else:
        raise NotImplementedError(
            f'latent_channels={mode!r} has no L_struct mapping: use a '
            "named mode ('SVDinNormedOut_structure_tensor', "
            "'structure_tensor', 'SVD_structure_tensor', "
            "'STD_directional') or disable latent_weight")

    new_stats = stats.update(measured)
    lower, upper = new_stats.bounds()
    mid = (upper + lower) / 2.0
    span = upper - lower
    target = cur_z / 2.0 * span[None, :] + mid[None, :]  # [B, 3]
    return (measured.T - target).abs(), new_stats


def _std_directional(cfg, stats, sr, hr, cur_z):
    """``'STD_directional'``: channel 0 controls the STD ratio of the
    directional residual, channels 1:3 the direction and magnitude."""
    def central_diffs(img):
        dx = (img[:, :, 2:, :] - img[:, :, :-2, :])[:, 1:-1, :, :] / 2
        dy = (img[:, 2:, :, :] - img[:, :-2, :, :])[:, :, 1:-1, :] / 2
        return dx, dy

    dx_s, dy_s = central_diffs(sr)
    dx_h, dy_h = central_diffs(hr)
    dirn = cur_z[:, 1:3]
    dirn = dirn / torch.sqrt(torch.sum(dirn ** 2, dim=1, keepdim=True)
                             + 1e-30)
    d_s = (dirn[:, 0, None, None, None] * dx_s
           + dirn[:, 1, None, None, None] * dy_s)
    d_h = (dirn[:, 0, None, None, None] * dx_h
           + dirn[:, 1, None, None, None] * dy_h)
    mag_ratio = d_s.abs().mean(dim=(1, 2, 3)) / (
        d_h.abs().mean(dim=(1, 2, 3)) + cfg.noise_std)
    std_ratio = (sr[:, 1:-1, 1:-1] - d_s).abs().mean(dim=(1, 2, 3)) / (
        (hr[:, 1:-1, 1:-1] - d_h).abs().mean(dim=(1, 2, 3))
        + cfg.noise_std)
    measured = torch.stack([std_ratio, mag_ratio], dim=0)  # [2, B]
    new_stats = stats.update(measured)
    lower, upper = new_stats.bounds()
    mid, span = (upper + lower) / 2.0, upper - lower
    mag_normal = torch.sqrt(torch.sum(cur_z[:, 1:3] ** 2, dim=1))
    target = torch.stack([cur_z[:, 0] * span[0] + mid[0],
                          mag_normal / np.sqrt(2) * span[1] + mid[1]],
                         dim=1)
    return (measured.T - target).abs(), new_stats
