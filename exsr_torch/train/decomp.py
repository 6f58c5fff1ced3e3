"""The explorable-JPEG trainer's Z helpers.

Counterpart of ``exsr/train/decomp.py:90-114``: the 3-channel GUI control
tiled onto the generator's latent channels, and back.  NHWC.
(``DecompTrainer`` is not ported yet.)
"""
from __future__ import annotations

import torch


def repeat_z_3_channels(z3: torch.Tensor, num_channels: int
                        ) -> torch.Tensor:
    """Tile a 3-channel Z onto ``num_channels`` channels."""
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
