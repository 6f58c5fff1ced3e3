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

On the H100 the function is bound by bytes (832 bytes per pixel in bf16
against ~44 flops per byte).  The bf16 CUDA kernel
(``exsr_torch/csrc/stage4.cu``) runs one persistent block per SM over 8 x 8
output tiles: producer warps bring each tile's inputs (``c3`` with its
halo, the four nf-wide partial slices, ``x``) into a two-stage shared-memory
ring by ``cp.async`` while consumer warps run the previous tile's conv on
the tensor cores (``mma.sync``, fragments by ``ldmatrix``, ``w4`` staged
once per block) and its epilogue.  Every input is read once and ``out``
written once.  The fp32 kernel keeps an fp32 FMA conv (TF32 is off in the
port).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from exsr_torch.ops.filters import to_nchw, to_nhwc
from exsr_torch.ops.kernels import build


def stage4_plain(c3, p0, p1, p2, p3, x, w4, b4):
    """Plain PyTorch version: ``F.conv2d`` in fp32 on the dtype's values,
    plus the slice sums, in the kernel's rounding order."""
    nf = x.shape[-1]
    w = w4.to(c3.dtype).float().permute(3, 2, 0, 1)  # HWIO -> OIHW
    conv = to_nhwc(F.conv2d(to_nchw(c3).float(), w, padding=1))
    partial = (p0[..., :nf].float() + p1[..., :nf].float()
               + p2[..., :nf].float() + p3[..., :nf].float())
    return ((conv + b4.float()) + partial).mul(0.2).to(x.dtype) + x


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


def stage4(c3, p0, p1, p2, p3, x, w4, b4, row_chunk: int | None = None):
    """``0.2*(conv3x3(c3, w4) + b4 + sum_g p_g[..., :nf]) + x``.

    ``row_chunk`` is accepted for ``stage4_pallas_chunked``'s API and does
    nothing: the chunking existed only for a Mosaic compile limit.  A CPU
    tensor goes to :func:`stage4_plain`; a CUDA tensor launches the kernel
    (no gradient).
    """
    ps = (p0, p1, p2, p3)
    _check(c3, ps, x, w4, b4)
    if x.device.type == 'cpu':
        return stage4_plain(c3, p0, p1, p2, p3, x, w4, b4)
    if x.device.type != 'cuda':
        raise ValueError(f'unsupported device {x.device}')
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (c3, x, w4, b4) + ps):
        raise NotImplementedError('stage4 has no backward on CUDA')
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
        c3.data_ptr(), p0.data_ptr(), p1.data_ptr(), p2.data_ptr(),
        p3.data_ptr(), x.data_ptr(), w4.data_ptr(), b4.data_ptr(),
        out.data_ptr(), b, h, w, gc, nf, *(p.shape[-1] for p in ps),
        is_bf16, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, 'stage4')
    stage4.launches += 1
    return out


stage4.launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    'exsr_stage4': ([_P] * 9 + [_I] * 10 + [_P], _I),
    'exsr_stage4_smem': ([_I] * 3, ctypes.c_size_t),
}
