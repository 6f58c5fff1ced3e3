"""Separable edge-clamped depthwise filter: the CEM filter chain's kernel.

Replaces ``sepfilter_edge_pallas`` (``exsr/ops/pallas/sepfilter.py:76``).
:func:`sepfilter_edge` computes, on fp32 NHWC ``[B, H, W, C]``, the
correlation with ``kcol`` along H and then with ``krow`` along W, with
replicate (edge-clamped) borders: ``filters.filter_replicate_same_separable``
for odd tap counts.

On the H100 it is bound by bytes (68 flops per 8 bytes at the HR shape of
the main path), so the CUDA kernel (``exsr_torch/csrc/sepfilter.cu``) reads
its input once and writes its output once: each block stages a row x column
tile plus its clamped halo in shared memory and runs both passes there, in
fp32 FMA with no TF32.
"""
from __future__ import annotations

import ctypes

import torch

from exsr_torch.ops import filters
from exsr_torch.ops.kernels import build


def sepfilter_edge_plain(x: torch.Tensor, kcol: torch.Tensor,
                         krow: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: replicate padding plus depthwise convs."""
    c = x.shape[-1]
    w_col = kcol.reshape(1, 1, -1, 1).expand(c, 1, -1, 1)
    w_row = krow.reshape(1, 1, 1, -1).expand(c, 1, 1, -1)
    return filters.filter_replicate_same_separable(x, w_col, w_row)


def _check(x: torch.Tensor, kcol: torch.Tensor, krow: torch.Tensor) -> None:
    if x.dim() != 4 or x.dtype != torch.float32:
        raise ValueError(f'x must be fp32 [B, H, W, C], got {x.dtype} '
                         f'{tuple(x.shape)}')
    if not x.is_contiguous():
        raise ValueError('x must be contiguous NHWC')
    for name, k in (('kcol', kcol), ('krow', krow)):
        if k.dim() != 1 or k.dtype != torch.float32 or k.numel() == 0:
            raise ValueError(f'{name} must be a non-empty 1-D fp32 tensor')
        if k.device != x.device:
            raise ValueError(f'{name} is on {k.device}, x on {x.device}')


def sepfilter_edge(x: torch.Tensor, kcol: torch.Tensor, krow: torch.Tensor
                   ) -> torch.Tensor:
    """Separable edge-clamped correlation of fp32 NHWC ``x``.

    A CPU tensor goes to :func:`sepfilter_edge_plain`; a CUDA tensor
    launches the kernel, which takes odd tap counts only and no gradient.
    """
    _check(x, kcol, krow)
    if x.device.type == 'cpu':
        return sepfilter_edge_plain(x, kcol, krow)
    if x.device.type != 'cuda':
        raise ValueError(f'unsupported device {x.device}')
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError('sepfilter_edge has no backward on CUDA')
    kh, kw = kcol.numel(), krow.numel()
    if kh % 2 == 0 or kw % 2 == 0:
        raise NotImplementedError(
            f'the CUDA kernel takes odd tap counts only, got {kh} x {kw}')
    b, h, w, c = x.shape
    lib = build.load('sepfilter', _SIGNATURES)
    smem = lib.exsr_sepfilter_edge_smem(c, kh, kw)
    if smem > 227 * 1024:
        raise ValueError(f'{kh}+{kw} taps at C={c} need {smem} bytes of '
                         'shared memory, more than a block has')
    out = torch.empty_like(x)
    kcol, krow = kcol.contiguous(), krow.contiguous()
    err = lib.exsr_sepfilter_edge(
        x.data_ptr(), out.data_ptr(), kcol.data_ptr(), krow.data_ptr(),
        b, h, w, c, kh, kw, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, 'sepfilter_edge')
    sepfilter_edge.launches += 1
    return out


sepfilter_edge.launches = 0


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    'exsr_sepfilter_edge': ([_P] * 4 + [_I] * 6 + [_P], _I),
    'exsr_sepfilter_edge_smem': ([_I] * 3, ctypes.c_size_t),
}
