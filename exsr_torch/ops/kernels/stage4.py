"""The RDB stage-4 epilogue of the grouped trunk as one kernel.

Replaces ``stage4_pallas`` (``exsr/ops/pallas/stage4.py:82``) and its
row-chunked twin ``stage4_pallas_chunked`` (``stage4.py:138``)::

    out = cast(0.2 * ((conv3x3_SAME(c3, w4) + b4) + sum_g P_g[..., :nf])) + x

``c3`` is ``[B,h,w,gc]``, each ``P_g`` is ``[B,h,w,nf+(4-g)*gc]`` of which
only the leading ``nf`` channels are read (s4-first packing,
``exsr/models/rrdb_fast.py:62-69``), ``x`` and ``out`` are ``[B,h,w,nf]``,
``w4`` is HWIO ``[3,3,gc,nf]`` and ``b4`` fp32 ``[nf]``.  bf16 or fp32, with
fp32 accumulation; the scaled sum is cast to the dtype before ``x`` is
added, as ``stage4.py:72-78`` does.

On the H100 the bf16 function is bound by bytes (832 bytes per pixel
against ~44 flops per byte).  The bf16 CUDA kernel
(``exsr_torch/csrc/stage4.cu``) runs one persistent block per SM over 8 x 8
output tiles: producer warps bring each tile's inputs (``c3`` with its
halo, the four nf-wide partial slices, ``x``) into a two-stage shared-memory
ring by ``cp.async`` while consumer warps run the previous tile's conv on
the tensor cores (``mma.sync``, fragments by ``ldmatrix``, ``w4`` staged
once per block) and its epilogue.  Every input is read once and ``out``
written once.  fp32 (``build_model``'s default, so every ``eval_sr``
forward, edit step and server edit: 69 launches a forward) runs the conv
on fp32 FMA (TF32 stays off) in persistent blocks over 16 x 16 tiles:
``w4`` staged once per block, producer warps copying ``c3``'s halo and
summing the four P slices into shared memory while the consumers run the
conv (8 pixels x 8 outputs a thread, ``exsr_torch/csrc/fma_conv.cuh``),
``x`` read in the epilogue.

Gradients.  :func:`stage4` is a ``torch.autograd.Function`` on both
devices.  Its backward for ``g = d loss / d out`` is ``x_bar = g``, ``s =
0.2 * g`` in the compute dtype (bf16(0.2) in bf16, as the forward scales),
``P_bar_g = s`` on channels ``[:nf]`` and zero beyond, and ``c3_bar =
conv3x3^T(s, w4)`` (``w4_bar`` and ``b4_bar`` only when asked for).  The
transposed conv is a plain cuDNN call (``torch.nn.grad.conv2d_input``),
not a kernel of this port: the TPU kernel has no backward, and ``exsr``
computes this gradient with XLA, outside any Pallas kernel.  In fp32 it
runs with TF32 off, as the forward's FMA conv does.  The backward reads no
P buffer, so none is saved.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from exsr_torch.device import full_fp32
from exsr_torch.ops.filters import to_nchw, to_nhwc
from exsr_torch.ops.kernels import build


def stage4_plain(c3, p0, p1, p2, p3, x, w4, b4):
    """Plain PyTorch version: ``F.conv2d`` in fp32 (float64 for float64
    inputs) on the dtype's values, plus the slice sums, in the kernel's
    rounding order."""
    nf = x.shape[-1]
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    w = w4.to(c3.dtype).to(acc).permute(3, 2, 0, 1)  # HWIO -> OIHW
    conv = to_nhwc(F.conv2d(to_nchw(c3).to(acc), w, padding=1))
    partial = (p0[..., :nf].to(acc) + p1[..., :nf].to(acc)
               + p2[..., :nf].to(acc) + p3[..., :nf].to(acc))
    return ((conv + b4.to(acc)) + partial).mul(0.2).to(x.dtype) + x


def _check(c3, ps, x, w4, b4) -> None:
    if x.dim() != 4 or c3.dim() != 4:
        raise ValueError('c3 and x must be NHWC [B, h, w, C]')
    gc, nf = c3.shape[-1], x.shape[-1]
    if c3.shape[:3] != x.shape[:3]:
        raise ValueError(f'c3 {tuple(c3.shape)} and x {tuple(x.shape)} '
                         'differ in [B, h, w]')
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'dtype must be fp32 or bf16, got {x.dtype}')
    for i, p in enumerate(ps):
        if p.dim() != 4 or p.shape[:3] != x.shape[:3] or p.shape[-1] < nf:
            raise ValueError(f'P{i} {tuple(p.shape)} must be [B, h, w, >= '
                             f'{nf}]')
    if tuple(w4.shape) != (3, 3, gc, nf):
        raise ValueError(f'w4 must be HWIO (3, 3, {gc}, {nf}), got '
                         f'{tuple(w4.shape)}')
    if tuple(b4.shape) != (nf,):
        raise ValueError(f'b4 must be [{nf}], got {tuple(b4.shape)}')
    for name, t in (('c3', c3), ('P0', ps[0]), ('P1', ps[1]), ('P2', ps[2]),
                    ('P3', ps[3]), ('x', x)):
        if t.dtype != x.dtype:
            raise ValueError(f'{name} is {t.dtype}, x is {x.dtype}')
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous NHWC')
    for name, t in (('c3', c3), ('w4', w4), ('b4', b4)) + tuple(
            (f'P{i}', p) for i, p in enumerate(ps)):
        if t.device != x.device:
            raise ValueError(f'{name} is on {t.device}, x on {x.device}')


def _stage4_kernel(c3, ps, x, w4, b4):
    b, h, w, gc = c3.shape
    nf = x.shape[-1]
    if nf % 16 or nf > 64 or gc % 2:
        raise NotImplementedError(
            f'the CUDA kernel takes nf in (16, 32, 48, 64) and even gc, got '
            f'nf={nf} gc={gc}')
    if any(p.shape[-1] % 8 for p in ps):
        raise NotImplementedError('P channel counts must be multiples of 8')
    is_bf16 = int(x.dtype == torch.bfloat16)
    lib = build.load('stage4', _SIGNATURES)
    smem = lib.exsr_stage4_smem(gc, nf, is_bf16)
    if smem > 227 * 1024:
        raise ValueError(f'gc={gc} nf={nf} needs {smem} bytes of shared '
                         'memory, more than a block has')
    w4 = w4.to(c3.dtype).contiguous()
    b4 = b4.float().contiguous()
    out = torch.empty_like(x)
    if any(t.data_ptr() % 16 for t in (c3, x, w4, out) + ps):
        raise ValueError('tensors must be 16-byte aligned')
    err = lib.exsr_stage4(
        c3.data_ptr(), *(p.data_ptr() for p in ps), x.data_ptr(),
        w4.data_ptr(), b4.data_ptr(), out.data_ptr(), b, h, w, gc, nf,
        *(p.shape[-1] for p in ps), is_bf16,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, 'stage4')
    stage4.launches += 1
    return out


class _Stage4(torch.autograd.Function):
    """The kernel (its plain version on the CPU) and the backward of the
    module's docstring."""

    @staticmethod
    def forward(ctx, c3, p0, p1, p2, p3, x, w4, b4):
        ps = (p0, p1, p2, p3)
        ctx.widths = tuple(p.shape[-1] for p in ps)
        ctx.c3_shape, ctx.b4_dtype = c3.shape, b4.dtype
        ctx.save_for_backward(w4, c3 if ctx.needs_input_grad[6] else None)
        if x.device.type == 'cpu':
            return stage4_plain(c3, *ps, x, w4, b4)
        return _stage4_kernel(c3, ps, x, w4, b4)

    @staticmethod
    def backward(ctx, g):
        w4, c3 = ctx.saved_tensors
        need = ctx.needs_input_grad
        nf = g.shape[-1]
        s = g * torch.tensor(0.2, dtype=g.dtype).item()
        w = w4.to(g.dtype).permute(3, 2, 0, 1)  # HWIO -> OIHW
        grads = [None] * 8
        with full_fp32():
            if need[0]:
                b, h, wd, gc = ctx.c3_shape
                grads[0] = to_nhwc(torch.nn.grad.conv2d_input(
                    (b, gc, h, wd), w, to_nchw(s), padding=1))
            if need[6]:
                gw = torch.nn.grad.conv2d_weight(
                    to_nchw(c3.to(g.dtype)), w.shape, to_nchw(s), padding=1)
                grads[6] = gw.permute(2, 3, 1, 0).to(w4.dtype)
        for k in range(4):
            if need[1 + k]:
                grads[1 + k] = F.pad(s, (0, ctx.widths[k] - nf))
        if need[5]:
            grads[5] = g
        if need[7]:
            grads[7] = s.to(ctx.b4_dtype).sum((0, 1, 2))
        return tuple(grads)


def stage4(c3, p0, p1, p2, p3, x, w4, b4, row_chunk: int | None = None):
    """``0.2*(conv3x3(c3, w4) + b4 + sum_g p_g[..., :nf]) + x``.

    ``row_chunk`` is accepted for ``stage4_pallas_chunked``'s API and does
    nothing: the chunking existed only for a Mosaic compile limit.  A CPU
    tensor goes to :func:`stage4_plain`; a CUDA tensor launches the kernel.
    Differentiable in every input (the backward is in the module's
    docstring).
    """
    ps = (p0, p1, p2, p3)
    _check(c3, ps, x, w4, b4)
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'unsupported device {x.device}')
    return _Stage4.apply(c3, *ps, x, w4, b4)


stage4.launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    'exsr_stage4': ([_P] * 9 + [_I] * 10 + [_P], _I),
    'exsr_stage4_smem': ([_I] * 3, ctypes.c_size_t),
}
