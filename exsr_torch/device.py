"""Device selection and fp32 precision for the port's entry points."""
from __future__ import annotations

import contextlib

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


@contextlib.contextmanager
def full_fp32():
    """cuDNN convolutions and CUDA matmuls in full fp32 (TF32 off) within
    the block; both flags are restored after it.

    PyTorch's default runs cuDNN's fp32 convolutions in TF32 (a 10-bit
    mantissa), which is not the computation ``exsr`` does.  Every fp32
    entry point of the port runs its forward and backward inside this
    block, so none depends on the caller's process-wide flags.  The flags
    are global, so a backward that autograd runs on another thread sees
    them too.
    """
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
