"""The differentiable halo exchange of height-sharded NHWC tensors.

The ranks of one spatial group (:class:`exsr_torch.parallel.mesh.Mesh`)
hold consecutive row ranges of one global tensor, of the heights
``heights`` in rank order.  :func:`halo_exchange` returns the rank's rows
extended by up to ``top`` rows from above and ``bottom`` from below; at a
global edge fewer (none at the edge itself), so that the extended tensor's
edge is either the global edge, where a conv's zero padding or a CEM
filter's clamp is the unsharded operation's own, or ``top`` (``bottom``)
rows away from the shard.  :func:`received` says how many rows came.

A halo may be wider than a shard, and then spans several neighbours.  The
exchange is one ``all_gather`` in which every rank offers its first
``bottom`` and last ``top`` rows (its whole shard when that is shorter):
every row a rank needs lies there, since its neighbours' shards lie
wholly between it and the rows it needs.  gloo's CUDA support has
``all_gather`` but no point-to-point send of CUDA tensors that has been
checked on the card, so this is the one form.

The backward is the exact adjoint: each rank offers the gradients of its
halo rows in one more ``all_gather``, and each owner adds those of its
rows onto its own gradient.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def offsets(heights) -> list:
    """Each shard's first global row."""
    out, o = [], 0
    for h in heights:
        out.append(o)
        o += h
    return out


def received(heights, index: int, top: int, bottom: int) -> tuple:
    """Rows above and below that rank ``index`` receives."""
    o = offsets(heights)[index]
    return (min(top, o), min(bottom, sum(heights) - o - heights[index]))


def _spans(heights, top, bottom):
    """Per rank: the global rows of its top and bottom halos."""
    off, total = offsets(heights), sum(heights)
    return [((o - min(top, o), o),
             (o + h, o + h + min(bottom, total - o - h)))
            for o, h in zip(off, heights)]


def _gather(x, group):
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return parts


def _pad_rows(x, rows):
    """``x`` zero-padded along H to ``rows``."""
    if x.shape[1] == rows:
        return x.contiguous()
    pad = x.new_zeros((x.shape[0], rows - x.shape[1]) + tuple(x.shape[2:]))
    return torch.cat([x, pad], 1)


class _Halo(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, top, bottom, heights, index, group):
        ctx.args = (top, bottom, heights, index, group)
        ctx.h = x.shape[1]
        head = x[:, :min(bottom, ctx.h)]
        tail = x[:, ctx.h - min(top, ctx.h):]
        offer = torch.cat([_pad_rows(head, bottom), _pad_rows(tail, top)], 1)
        parts = _gather(offer, group)
        off = offsets(heights)
        (a0, a1), (b0, b1) = _spans(heights, top, bottom)[index]
        above, below = [], []
        for j, p in enumerate(parts):
            o, h = off[j], heights[j]
            n_head, n_tail = min(bottom, h), min(top, h)
            # rank j's offered rows: [o, o + n_head) and [o + h - n_tail,
            # o + h), kept where they meet this rank's halos
            if j < index:
                lo, hi = max(a0, o + h - n_tail), min(a1, o + h)
                if lo < hi:
                    s = bottom + n_tail - (o + h - lo)
                    above.append(p[:, s:s + hi - lo])
            elif j > index:
                lo, hi = max(b0, o), min(b1, o + n_head)
                if lo < hi:
                    below.append(p[:, lo - o:hi - o])
        return torch.cat(above + [x] + below, 1)

    @staticmethod
    def backward(ctx, g):
        top, bottom, heights, index, group = ctx.args
        na, nb = received(heights, index, top, bottom)
        g_above, g_x, g_below = g.split([na, ctx.h, nb], 1)
        offer = torch.cat([_pad_rows(g_above, top),
                           _pad_rows(g_below, bottom)], 1)
        parts = _gather(offer, group)
        spans = _spans(heights, top, bottom)
        o, h = offsets(heights)[index], heights[index]
        grad = g_x.clone(memory_format=torch.contiguous_format)
        for j, p in enumerate(parts):
            if j == index:
                continue
            (a0, a1), (b0, b1) = spans[j]
            # rank j's top halo rows [a0, a1) sit at p[:, 0:a1 - a0], its
            # bottom halo rows [b0, b1) at p[:, top:top + b1 - b0]
            for start, (lo, hi) in ((0, (a0, a1)), (top, (b0, b1))):
                lo_, hi_ = max(lo, o), min(hi, o + h)
                if lo_ < hi_:
                    grad[:, lo_ - o:hi_ - o] += \
                        p[:, start + lo_ - lo:start + hi_ - lo]
        return grad, None, None, None, None, None


def halo_exchange(x: torch.Tensor, top: int, bottom: int, mesh,
                  heights=None) -> torch.Tensor:
    """The rank's NHWC shard ``x`` with up to ``top`` rows of the shards
    above it and ``bottom`` rows of those below (:func:`received` says how
    many), differentiable.  ``heights`` are the spatial group's shard
    heights in rank order (all equal to ``x``'s when None).  Every rank of
    the group must call it with the same arguments."""
    if heights is None:
        heights = (x.shape[1],) * mesh.spatial
    heights = tuple(int(h) for h in heights)
    if len(heights) != mesh.spatial or \
            heights[mesh.spatial_index] != x.shape[1]:
        raise ValueError(f'shard of {x.shape[1]} rows at spatial index '
                         f'{mesh.spatial_index} against heights {heights}')
    if top < 0 or bottom < 0:
        raise ValueError(f'halo ({top}, {bottom}) must be non-negative')
    if mesh.spatial == 1 or top + bottom == 0:
        return x
    return _Halo.apply(x, top, bottom, heights, mesh.spatial_index,
                       mesh.spatial_group)
