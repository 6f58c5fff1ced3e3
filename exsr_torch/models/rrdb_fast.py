"""Grouped-conv fast inference path of the explorable RRDB generator.

Counterpart of ``exsr/models/rrdb_fast.py``: the same math as
:class:`exsr_torch.models.rrdb.RRDBNet`, restructured so that a
residual-dense block runs one conv per *input group* whose output stacks
that group's contribution to every later stage::

    w0 : (nz+nf) -> nf+gc+gc+gc+gc    w2 : gc -> nf+gc+gc
    w1 :       gc -> nf+gc+gc+gc      w3 : gc -> nf+gc
    w4 :       gc -> nf (the stage-4 epilogue kernel's conv)

Stage i's pre-activation is the sum of the matching slices plus its bias.
The P buffers are packed s4-first (``P[g] = [stage 4 (nf) | stage g (gc) |
... | stage 3 (gc)]``), so the stage-4 part of every P buffer sits at
channel 0, where the epilogue kernel
(:func:`exsr_torch.ops.kernels.stage4.stage4`) reads it.

Public functions take NHWC tensors.  Packed conv weights are OIHW in
``channels_last`` memory, ready for ``F.conv2d`` on ``channels_last``
activations; ``w4`` is HWIO for the kernel.  Differentiable on both
devices (the Z-edit engine runs it forward and backward): the epilogue
kernel and the CEM filter kernels are autograd Functions, and autograd
keeps no P buffer alive, since the slice sums read P through views and the
epilogue's backward needs only ``w4``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from exsr_torch.ops.filters import (bilinear_resize, nearest_upsample,
                                    to_nchw, to_nhwc)
from exsr_torch.ops.kernels.rrdb_block import mul_in_dtype
from exsr_torch.ops.kernels.stage4 import stage4

_CL = torch.channels_last


def _conv(x, w, b=None):
    """3x3 SAME conv of NHWC ``x`` with OIHW ``w``, in ``x``'s dtype."""
    b = None if b is None else b.to(x.dtype)
    return to_nhwc(F.conv2d(to_nchw(x), w.to(x.dtype), b, padding=1))


def pack_grouped_params(params, dtype=None):
    """The port's RRDBNet (or its state dict) -> packed grouped weights.

    Returns ``(trunk, rest)``: ``trunk`` is a list with one entry per RRDB
    block, each ``{'rdb1'|'rdb2'|'rdb3': {'w0'..'w4', 'b0'..'b4'}}``;
    ``rest`` holds the non-trunk convs as ``{'weight', 'bias'}``, and each
    ``upconv{i}`` also ``'wt'``, its folded transposed-conv weight.  Weights
    and biases are cast to ``dtype`` (None keeps them), except ``b4``, which
    the epilogue takes in fp32.
    """
    sd = params.state_dict() if isinstance(params, nn.Module) else params
    sd = {k: v.detach() for k, v in sd.items()}
    nf = sd['trunk_conv.weight'].shape[0]
    nz = sd['trunk_conv.weight'].shape[1] - nf
    gc = sd['trunk.0.rdb1.conv0.weight'].shape[0]
    nb = 1 + max(int(k.split('.')[1]) for k in sd if k.startswith('trunk.'))
    bounds = [0, nz + nf] + [nz + nf + (g + 1) * gc for g in range(4)]

    def cast(t):
        t = t if dtype is None else t.to(dtype)
        return t.contiguous(memory_format=_CL) if t.dim() == 4 else t

    trunk = []
    for i in range(nb):
        block = {}
        for r in (1, 2, 3):
            pre = f'trunk.{i}.rdb{r}.conv'
            kernels = [sd[f'{pre}{c}.weight'] for c in range(5)]
            entry = {f'b{c}': cast(sd[f'{pre}{c}.bias']) for c in range(4)}
            entry['b4'] = sd[f'{pre}4.bias'].float()
            for g in range(4):
                lo, hi = bounds[g], bounds[g + 1]
                # group g feeds every stage c >= g; stage 4's part leads
                order = [4] + list(range(g, 4))
                entry[f'w{g}'] = cast(torch.cat(
                    [kernels[c][:, lo:hi] for c in order], 0))
            w4 = kernels[4][:, bounds[4]:bounds[5]].permute(2, 3, 1, 0)
            entry['w4'] = (w4 if dtype is None else w4.to(dtype)).contiguous()
            block[f'rdb{r}'] = entry
        trunk.append(block)

    rest = {}
    for name in ('fea_conv', 'trunk_conv', 'upconv0', 'upconv1', 'hr_conv0',
                 'hr_conv1'):
        if f'{name}.weight' not in sd:
            continue
        w = sd[f'{name}.weight']
        rest[name] = {'weight': cast(w), 'bias': cast(sd[f'{name}.bias'])}
        if name.startswith('upconv'):
            k4 = fold_upconv_kernel(w.permute(2, 3, 1, 0))
            rest[name]['wt'] = cast(k4.flip(0, 1).permute(2, 3, 0, 1))
    return trunk, rest


# phase-mixing matrix: row j of the 4-tap transposed-conv kernel takes
# these 3x3-kernel rows (see fold_upconv_kernel)
_M4 = np.array([[1., 0., 0.],
                [1., 1., 0.],
                [0., 1., 1.],
                [0., 0., 1.]])


def fold_upconv_kernel(k: torch.Tensor) -> torch.Tensor:
    """Fold ``conv3x3(nearest_upsample(x, 2))`` into one stride-2
    transposed-conv kernel (exact, zero borders included).

    ``k`` is HWIO ``[3, 3, ci, co]``; returns ``K4 = M @ k @ M^T`` HWIO
    ``[4, 4, ci, co]`` with M = [[1,0,0],[1,1,0],[0,1,1],[0,0,1]]
    (``exsr/models/rrdb_fast.py:87``).
    """
    m = torch.as_tensor(_M4, dtype=k.dtype, device=k.device)
    return torch.einsum('ud,ve,deco->uvco', m, m, k)


def _subpixel(x, wt, b=None):
    b = None if b is None else b.to(x.dtype)
    y = F.conv_transpose2d(to_nchw(x), wt.to(x.dtype), b, stride=2,
                           padding=1)
    return to_nhwc(y)


def subpixel_upconv(x: torch.Tensor, k4: torch.Tensor,
                    b: torch.Tensor | None = None) -> torch.Tensor:
    """Apply a :func:`fold_upconv_kernel` result to NHWC ``x``: one
    ``F.conv_transpose2d(stride=2, padding=1)`` with weight
    ``flip_hw(K4)`` as ``[ci, co, 4, 4]``; equals
    ``conv3x3(nearest_upsample(x, 2))``."""
    return _subpixel(x, k4.flip(0, 1).permute(2, 3, 0, 1), b)


def _rdb_grouped(x, z, e):
    """One residual-dense block in grouped form; the stage-4 tail is the
    epilogue kernel (its plain version on the CPU)."""
    gc, nf = e['w4'].shape[2], e['w4'].shape[3]
    widths = [gc, gc, gc, gc, nf]
    P = [None] * 4
    P[0] = _conv(torch.cat([z, x], -1) if z is not None else x, e['w0'])

    def sl(g, i):
        off = nf + sum(widths[g:i])
        return P[g][..., off:off + widths[i]]

    c = [None] * 4
    c[0] = F.leaky_relu(sl(0, 0) + e['b0'].to(x.dtype), 0.2)
    for i in range(1, 4):
        P[i] = _conv(c[i - 1], e[f'w{i}'])
        acc = sl(0, i)
        for g in range(1, i + 1):
            acc = acc + sl(g, i)
        c[i] = F.leaky_relu(acc + e[f'b{i}'].to(x.dtype), 0.2)
    return stage4(c[3], P[0], P[1], P[2], P[3], x, e['w4'], e['b4'])


def rrdb_trunk_fast(packed, lr, z_hr=None, *, dtype=torch.bfloat16):
    """LR-domain part of the forward: fea conv, the grouped trunk (a loop
    over the blocks), trunk conv and global residual.  Returns the
    pre-upsample features ``[N, h, w, nf]`` in ``dtype`` (None: ``lr``'s).
    """
    trunk, rest = packed
    n, h, w, _ = lr.shape
    if dtype is not None:
        lr = lr.to(dtype)
        z_hr = z_hr.to(dtype) if z_hr is not None else None
    z_lr = bilinear_resize(z_hr, h, w) if z_hr is not None else None
    x = torch.cat([z_lr, lr], -1) if z_lr is not None else lr
    fea = _conv(x, rest['fea_conv']['weight'], rest['fea_conv']['bias'])
    t = fea
    for bp in trunk:
        o = _rdb_grouped(t, z_lr, bp['rdb1'])
        o = _rdb_grouped(o, z_lr, bp['rdb2'])
        o = _rdb_grouped(o, z_lr, bp['rdb3'])
        t = mul_in_dtype(o, 0.2) + t
    tc = rest['trunk_conv']
    t_in = torch.cat([z_lr, t], -1) if z_lr is not None else t
    return fea + _conv(t_in, tc['weight'], tc['bias'])


def rrdb_tail_fast(packed, feats, z_hr=None, *, upscale: int = 4,
                   out_dtype=torch.float32):
    """HR-domain tail: upconvs (folded transposed convs at x2 stages) and
    the two HR convs.  Two ``[N, 4h, 4w, nf]`` buffers are live here."""
    _, rest = packed
    x = feats
    if z_hr is not None:
        z_hr = z_hr.to(x.dtype)
    n_up = 1 if upscale == 3 else int(np.log2(upscale))
    for i in range(n_up):
        uc = rest[f'upconv{i}']
        if upscale == 3:
            x = _conv(nearest_upsample(x, 3), uc['weight'], uc['bias'])
        else:
            x = _subpixel(x, uc['wt'], uc['bias'])
        x = F.leaky_relu(x, 0.2)
    for j in (0, 1):
        hc = rest[f'hr_conv{j}']
        h_in = torch.cat([z_hr, x], -1) if z_hr is not None else x
        x = _conv(h_in, hc['weight'], hc['bias'])
        if j == 0:
            x = F.leaky_relu(x, 0.2)
    return x.to(out_dtype)


def rrdbnet_apply_fast(params, lr, z_hr=None, *, upscale: int = 4,
                       dtype=torch.bfloat16, packed=None,
                       tail_chunk: int | None = None):
    """Grouped forward equal to ``RRDBNet(params)(lr, z_hr)``.

    ``params`` is the port's RRDBNet or its state dict; pass ``packed``
    (a :func:`pack_grouped_params` result) instead to pack once for many
    calls.  ``dtype`` is the trunk's compute dtype (None: ``lr``'s).
    ``tail_chunk`` runs the HR tail in batch chunks of that size, which caps
    its memory; the result is the same.
    """
    if packed is None:
        packed = pack_grouped_params(params, dtype=dtype)
    in_dtype = lr.dtype
    feats = rrdb_trunk_fast(packed, lr, z_hr, dtype=dtype)
    n = feats.shape[0]
    if tail_chunk is None or tail_chunk >= n:
        return rrdb_tail_fast(packed, feats, z_hr, upscale=upscale,
                              out_dtype=in_dtype)
    if n % tail_chunk:
        raise ValueError(f'batch {n} is not a multiple of tail_chunk '
                         f'{tail_chunk}')
    return torch.cat([
        rrdb_tail_fast(packed, feats[i:i + tail_chunk],
                       z_hr[i:i + tail_chunk] if z_hr is not None else None,
                       upscale=upscale, out_dtype=in_dtype)
        for i in range(0, n, tail_chunk)])
