"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the current CUDA device; without one this raises instead
    of carrying on on the CPU.  Pass ``device='cpu'`` to run on the CPU.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'exsr_torch runs on CUDA by default and no CUDA device is '
                "available; pass device='cpu' to run on the CPU")
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device(device)
