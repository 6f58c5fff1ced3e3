"""Separable edge-clamped depthwise filter: the CEM filter chain's kernels.

Replaces ``sepfilter_edge_pallas`` (``exsr/ops/pallas/sepfilter.py:76``).
:func:`sepfilter_edge` computes, on fp32 NHWC ``[B, H, W, C]``, the
correlation with ``kcol`` along H and then with ``krow`` along W, with
replicate (edge-clamped) borders: ``filters.filter_replicate_same_separable``
for odd tap counts.  Two polyphase forms serve the CEM's resampling:

- :func:`sepfilter_down`: the filter sampled at sub-position ``pre`` of
  every ``sf x sf`` cell (``aliased_subsample`` of the same-size result),
  computing only the kept outputs;
- :func:`sepfilter_up`: the filter applied to ``zero_stuff(a)``, computing
  only the products whose input is not a stuffed zero; with ``b`` and ``g``
  it returns ``U(a) + (g - U(b))``, the CEM's ``ortho + ns``.

On the H100 all three are bound by bytes, so the CUDA kernels
(``exsr_torch/csrc/sepfilter.cu``) read their inputs once and write their
output once: each block stages its tile and clamped halo in shared memory
by ``cp.async``.  They compute in fp32 FMA with no TF32, taking taps in the
same order as the same-size kernel: each polyphase form equals its
composition through :func:`sepfilter_edge` bit for bit.  Which taps of the
up filter meet a data row or column near a clamped edge depends on ``sf``
and ``pre``; the host builds those lists (:func:`polyphase_taps`) and the
kernel follows them.
"""
from __future__ import annotations

import ctypes

import numpy as np
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


def sepfilter_down_plain(x: torch.Tensor, kcol: torch.Tensor,
                         krow: torch.Tensor, sf: int,
                         pre: tuple[int, int]) -> torch.Tensor:
    """Plain version of :func:`sepfilter_down` (a strided view)."""
    return filters.aliased_subsample(sepfilter_edge_plain(x, kcol, krow),
                                     sf, pre)


def sepfilter_up_plain(a: torch.Tensor, kcol: torch.Tensor,
                       krow: torch.Tensor, sf: int, pre: tuple[int, int],
                       b: torch.Tensor | None = None,
                       g: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of :func:`sepfilter_up`: zero-stuffing, then the
    same-size filter; with ``b`` and ``g``, ``U(a) + (g - U(b))``."""
    a_up = sepfilter_edge_plain(filters.zero_stuff(a, sf, pre), kcol, krow)
    if b is None:
        return a_up
    b_up = sepfilter_edge_plain(filters.zero_stuff(b, sf, pre), kcol, krow)
    return a_up + (g - b_up)


def polyphase_taps(n_lr: int, sf: int, pre: int, k: int) -> np.ndarray:
    """Tap lists of the up filter along one axis of ``n_lr * sf`` HR
    samples, ``int32 [max entries, n_lr * sf]``.

    Entry ``e`` of HR index ``i`` is ``(I << 8) | r``: tap ``r`` of the
    ``k`` taps meets data sample ``I`` of the LR axis, for the ``e``-th
    such ``r`` in ascending order; ``-1`` after the last.  With replicate
    borders tap ``r`` reads HR sample ``clip(i - k//2 + r)``, which holds
    data only where it is ``pre`` modulo ``sf``: at ``sf`` 2, ``pre`` 0
    the first sample is data and repeats for every clamped tap.
    """
    if k > 255:
        raise ValueError(f'{k} taps: the tap index has 8 bits')
    n = n_lr * sf
    hr = np.clip(np.arange(n)[:, None] - k // 2 + np.arange(k)[None, :],
                 0, n - 1)
    data = (hr - pre) % sf == 0
    count = data.sum(1)
    order = np.argsort(~data, axis=1, kind='stable')[:, :count.max()]
    lr = (np.take_along_axis(hr, order, 1) - pre) // sf
    entries = np.where(np.arange(order.shape[1])[None, :] < count[:, None],
                       (lr << 8) | order, -1)
    return np.ascontiguousarray(entries.T, dtype=np.int32)


_tables: dict = {}


def _up_tables(n_lr: int, sf: int, pre: int, k: int, device):
    """(device tap lists, entries a sample) for one axis, cached."""
    key = (n_lr, sf, pre, k, device)
    hit = _tables.get(key)
    if hit is None:
        tab = polyphase_taps(n_lr, sf, pre, k)
        hit = (torch.from_numpy(tab).to(device), tab.shape[0])
        _tables[key] = hit
    return hit


def _check(x: torch.Tensor, kcol: torch.Tensor, krow: torch.Tensor,
           name: str = 'x') -> None:
    if x.dim() != 4 or x.dtype != torch.float32:
        raise ValueError(f'{name} must be fp32 [B, H, W, C], got {x.dtype} '
                         f'{tuple(x.shape)}')
    if not x.is_contiguous():
        raise ValueError(f'{name} must be contiguous NHWC')
    for kname, k in (('kcol', kcol), ('krow', krow)):
        if k.dim() != 1 or k.dtype != torch.float32 or k.numel() == 0:
            raise ValueError(f'{kname} must be a non-empty 1-D fp32 tensor')
        if k.device != x.device:
            raise ValueError(f'{kname} is on {k.device}, {name} on '
                             f'{x.device}')


def _on_cuda(what: str, kcol, krow, *tensors) -> bool:
    """False for CPU tensors (the plain version runs); True where the
    kernel launches; raises for what the kernel does not take."""
    x = tensors[0]
    if x.device.type == 'cpu':
        return False
    if x.device.type != 'cuda':
        raise ValueError(f'unsupported device {x.device}')
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(f'{what} has no backward on CUDA')
    kh, kw = kcol.numel(), krow.numel()
    if kh % 2 == 0 or kw % 2 == 0:
        raise NotImplementedError(
            f'the CUDA kernel takes odd tap counts only, got {kh} x {kw}')
    return True


def _check_smem(smem: int, what: str) -> None:
    if smem > 227 * 1024:
        raise ValueError(f'{what} needs {smem} bytes of shared memory, more '
                         'than a block has')


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def sepfilter_edge(x: torch.Tensor, kcol: torch.Tensor, krow: torch.Tensor
                   ) -> torch.Tensor:
    """Separable edge-clamped correlation of fp32 NHWC ``x``.

    A CPU tensor goes to :func:`sepfilter_edge_plain`; a CUDA tensor
    launches the kernel, which takes odd tap counts only and no gradient.
    """
    _check(x, kcol, krow)
    if not _on_cuda('sepfilter_edge', kcol, krow, x):
        return sepfilter_edge_plain(x, kcol, krow)
    kh, kw = kcol.numel(), krow.numel()
    b, h, w, c = x.shape
    lib = build.load('sepfilter', _SIGNATURES)
    _check_smem(lib.exsr_sepfilter_edge_smem(c, kh, kw),
                f'sepfilter_edge with {kh}+{kw} taps at C={c}')
    out = torch.empty_like(x)
    kcol, krow = kcol.contiguous(), krow.contiguous()
    err = lib.exsr_sepfilter_edge(
        x.data_ptr(), out.data_ptr(), kcol.data_ptr(), krow.data_ptr(),
        b, h, w, c, kh, kw, _stream(x))
    build.check(lib, err, 'sepfilter_edge')
    sepfilter_edge.launches += 1
    return out


def sepfilter_down(x: torch.Tensor, kcol: torch.Tensor, krow: torch.Tensor,
                   sf: int, pre: tuple[int, int]) -> torch.Tensor:
    """``aliased_subsample(sepfilter_edge(x, kcol, krow), sf, pre)``: HR in,
    LR out.  CPU: :func:`sepfilter_down_plain`; CUDA: the down kernel, which
    computes the kept outputs only."""
    _check(x, kcol, krow)
    if not _on_cuda('sepfilter_down', kcol, krow, x):
        return sepfilter_down_plain(x, kcol, krow, sf, pre)
    kh, kw = kcol.numel(), krow.numel()
    b, h, w, c = x.shape
    ho, wo = len(range(pre[0], h, sf)), len(range(pre[1], w, sf))
    out = x.new_empty((b, ho, wo, c))
    if out.numel() == 0:
        return out
    lib = build.load('sepfilter', _SIGNATURES)
    _check_smem(lib.exsr_sepfilter_down_smem(c, kh, kw, sf),
                f'sepfilter_down with {kh}+{kw} taps at C={c}, sf {sf}')
    kcol, krow = kcol.contiguous(), krow.contiguous()
    err = lib.exsr_sepfilter_down(
        x.data_ptr(), out.data_ptr(), kcol.data_ptr(), krow.data_ptr(),
        b, h, w, c, kh, kw, sf, pre[0], pre[1], ho, wo, _stream(x))
    build.check(lib, err, 'sepfilter_down')
    sepfilter_down.launches += 1
    return out


def sepfilter_up(a: torch.Tensor, kcol: torch.Tensor, krow: torch.Tensor,
                 sf: int, pre: tuple[int, int], b: torch.Tensor | None = None,
                 g: torch.Tensor | None = None) -> torch.Tensor:
    """``sepfilter_edge(zero_stuff(a, sf, pre), kcol, krow)``: LR in, HR
    out.  With ``b`` (LR, as ``a``) and ``g`` (HR): ``U(a) + (g - U(b))``.
    CPU: :func:`sepfilter_up_plain`; CUDA: the up kernel, which multiplies
    only the taps that land on data."""
    _check(a, kcol, krow, 'a')
    if (b is None) != (g is None):
        raise ValueError('pass b and g together, or neither')
    n, h, w, c = a.shape
    tensors = (a,)
    if b is not None:
        _check(b, kcol, krow, 'b')
        _check(g, kcol, krow, 'g')
        if b.shape != a.shape or g.shape != (n, h * sf, w * sf, c):
            raise ValueError(f'b {tuple(b.shape)} must match a '
                             f'{tuple(a.shape)} and g {tuple(g.shape)} be '
                             f'its x{sf} size')
        tensors = (a, b, g)
    if not _on_cuda('sepfilter_up', kcol, krow, *tensors):
        return sepfilter_up_plain(a, kcol, krow, sf, pre, b, g)
    kh, kw = kcol.numel(), krow.numel()
    rtab, maxr = _up_tables(h, sf, pre[0], kh, a.device)
    ctab, maxc = _up_tables(w, sf, pre[1], kw, a.device)
    lib = build.load('sepfilter', _SIGNATURES)
    combine = b is not None
    _check_smem(lib.exsr_sepfilter_up_smem(c, kh, kw, sf, maxr, maxc,
                                           int(combine)),
                f'sepfilter_up with {kh}+{kw} taps at C={c}, sf {sf}')
    out = a.new_empty((n, h * sf, w * sf, c))
    kcol, krow = kcol.contiguous(), krow.contiguous()
    err = lib.exsr_sepfilter_up(
        a.data_ptr(), b.data_ptr() if combine else None,
        g.data_ptr() if combine else None, out.data_ptr(), kcol.data_ptr(),
        krow.data_ptr(), rtab.data_ptr(), ctab.data_ptr(), n, h, w, c, kh,
        kw, sf, pre[0], pre[1], maxr, maxc, _stream(a))
    build.check(lib, err, 'sepfilter_up')
    sepfilter_up.launches += 1
    return out


sepfilter_edge.launches = 0
sepfilter_down.launches = 0
sepfilter_up.launches = 0


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    'exsr_sepfilter_edge': ([_P] * 4 + [_I] * 6 + [_P], _I),
    'exsr_sepfilter_edge_smem': ([_I] * 3, ctypes.c_size_t),
    'exsr_sepfilter_down': ([_P] * 4 + [_I] * 11 + [_P], _I),
    'exsr_sepfilter_down_smem': ([_I] * 4, ctypes.c_size_t),
    'exsr_sepfilter_up': ([_P] * 8 + [_I] * 11 + [_P], _I),
    'exsr_sepfilter_up_smem': ([_I] * 7, ctypes.c_size_t),
}
