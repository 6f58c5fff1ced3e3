"""Convolutions of the references, at full precision and at the precisions
of the controls.

The reference computes in float32 with TF32 off, its backward passes
too: a caller runs the whole computation inside :func:`flags`.  A control
computes at the step below the configuration's precision: ``tf32`` (10
explicit mantissa bits) below float32, ``fp8`` (e4m3, each tensor scaled
by its largest magnitude to the format's largest, 448) below bfloat16.
On the card ``tf32`` is the card's own: :func:`flags` turns TF32 on for
cuDNN and the matmuls, forward and backward.  ``fp8``, and ``tf32`` on
the CPU (which has none), round both operands of every convolution in
software and accumulate in float32, in the forward pass only (the
backward passes the gradient through the rounding unchanged).
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def flags(precision: str = 'float32'):
    """TF32 on for cuDNN and the matmuls within the block for ``tf32``,
    off for any other precision; the caller's flags restored after."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    on = precision == 'tf32'
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def no_tf32():
    return flags('float32')


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to the nearest value with 10 mantissa bits (ties to
    even), as a TF32 operand."""
    bits = x.float().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


FP8_MAX = 448.0


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 after scaling the tensor's largest magnitude
    to 448, and scale back (per-tensor scaling, as fp8 inference does)."""
    x = x.float()
    amax = x.abs().max().clamp_min(1e-30)
    scale = FP8_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


def straight_through(rnd):
    """``rnd`` in the forward pass and the identity in the backward, so
    that a control can be differentiated (the training steps, the
    gradient penalty's second order)."""
    def f(x):
        return x + (rnd(x.detach()) - x).detach()
    return f


ROUNDING = {'float32': None, 'tf32': straight_through(round_tf32),
            'fp8': straight_through(round_fp8)}


def rounding(precision: str, x: torch.Tensor):
    """The software rounding of operands at ``precision`` for tensors on
    ``x``'s device, or None (float32; ``tf32`` on the card, whose own
    arithmetic :func:`flags` selects)."""
    if precision == 'tf32' and x.is_cuda:
        return None
    return ROUNDING[precision]


def conv3x3(precision: str):
    """``f(x, w, b)``: the 3 x 3 SAME convolution of NCHW ``x`` in
    float32 at ``precision`` (within the caller's :func:`flags`)."""
    def f(x, w, b):
        x, w = x.float(), w.float()
        rnd = rounding(precision, x)
        if rnd is not None:
            x, w = rnd(x), rnd(w)
        with flags(precision):
            return F.conv2d(x, w, b.float(), padding=1)
    return f
