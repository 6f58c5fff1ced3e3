"""The ``data x spatial`` rank grid and its sharding rules.

Counterpart of ``exsr/parallel/mesh.py``.  ``exsr`` lays its devices out
as ``reshape(data, spatial)`` and lets XLA shard NHWC activations as
``P('data', 'spatial', None, None)``: the batch over ``data``, the image
height over ``spatial``, the conv and CEM filter halos inserted by the
compiler.  The port runs one process per rank of an initialised
``torch.distributed`` group:

* :func:`make_mesh` places rank ``r`` at ``(r // spatial, r % spatial)``
  and creates one group per data row (the ranks that split one sample's
  height: the spatial group) and one per spatial column (the ranks that
  split the batch: the data group, with a :class:`DataParallel` over it);
* :class:`ShardingRules` slices a host batch into the rank's shard
  (:meth:`~ShardingRules.shard_batch`), broadcasts from rank 0
  (:meth:`~ShardingRules.replicate`) and gathers shards back in global
  order (:meth:`~ShardingRules.gather`, differentiable);
* :class:`TrainGrid` is the grid as a training step sees it: the rank's
  slices of the global batch and draws, the CEM margins cropped on
  shards (uneven, maybe empty), the kept image gathered whole, each
  loss's share, and the reduction of gradients and metrics.

The halos are written by hand: :mod:`exsr_torch.parallel.halo` exchanges
them, :mod:`exsr_torch.parallel.spatial` runs the CEM and the generator
on height shards.  In one process (a 1 x 1 grid) nothing needs a process
group.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from exsr_torch.device import resolve_device
from exsr_torch.parallel.dist import DataParallel, _Gather, sync_batch_norm
from exsr_torch.parallel.halo import _pad_rows, offsets


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A rank's place in the ``data x spatial`` grid, its device and its
    two groups (None in a 1 x 1 grid)."""
    data: int
    spatial: int
    device: torch.device
    rank: int = 0
    spatial_group: object = None
    data_group: object = None

    @property
    def world(self) -> int:
        return self.data * self.spatial

    @property
    def data_index(self) -> int:
        return self.rank // self.spatial

    @property
    def spatial_index(self) -> int:
        return self.rank % self.spatial

    @property
    def dp(self) -> DataParallel:
        """Data parallelism over the rank's spatial column."""
        return DataParallel(self.data_index, self.data, self.data_group,
                            self.device)

    @property
    def world_dp(self) -> DataParallel:
        """The whole grid as one group, for statistics of modules that run
        on the rank's rows: every rank holds different pixels."""
        return DataParallel(self.rank, self.world, None, self.device)

    @property
    def spatial_dp(self) -> DataParallel:
        """The rank's spatial group: the ranks that hold one sample's
        rows."""
        return DataParallel(self.spatial_index, self.spatial,
                            self.spatial_group, self.device)


def make_mesh(data: int | None = None, spatial: int = 1,
              device=None) -> Mesh:
    """The grid over the initialised process group (or one process, when
    none is initialised): ``data=None`` puts every rank the spatial axis
    leaves on ``data``.  ``device`` is the rank's (None: the current CUDA
    device, ``'cpu'`` to run on the CPU).  Every rank creates every group,
    in the same order, as ``torch.distributed.new_group`` requires."""
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        rank, world = 0, 1
    if spatial < 1 or world % spatial:
        raise ValueError(f'spatial {spatial} does not divide the world '
                         f'size {world}')
    if data is None:
        data = world // spatial
    if data * spatial != world:
        raise ValueError(f'mesh {data}x{spatial} != {world} ranks')
    device = resolve_device(device)
    if world == 1:
        return Mesh(1, 1, device)
    grid = np.arange(world).reshape(data, spatial)
    rows = [dist.new_group(grid[d].tolist()) for d in range(data)]
    cols = [dist.new_group(grid[:, s].tolist()) for s in range(spatial)]
    return Mesh(data, spatial, device, rank, rows[rank // spatial],
                cols[rank % spatial])


def _split(n: int, parts: int, index: int, what: str) -> slice:
    if n % parts:
        raise ValueError(f'{parts} ranks do not divide the {what} {n}')
    k = n // parts
    return slice(index * k, (index + 1) * k)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """The canonical shardings of the SR stack on one rank: NHWC
    activations on ``(data, spatial)``, any other per-sample leaf on
    ``data`` along its leading axis, scalars whole."""
    mesh: Mesh

    def batch_spec(self, x) -> tuple:
        """The index of the rank's shard of one leaf (``x[spec]``)."""
        nd = getattr(x, 'ndim', 0)
        if nd == 0:
            return ()
        m = self.mesh
        n = _split(x.shape[0], m.data, m.data_index, 'batch')
        if nd == 4:
            return n, _split(x.shape[1], m.spatial, m.spatial_index,
                             'height')
        return (n,)

    def shard_batch(self, batch):
        """The rank's shard of every leaf of a host batch (tensors or numpy
        arrays; dicts, lists and tuples of them)."""
        return _tree_map(lambda x: x[self.batch_spec(x)], batch)

    def replicate(self, tree):
        """Rank 0's tensors (or module parameters and buffers) on every
        rank, in place; the tree is returned."""
        if self.mesh.world > 1:
            def bcast(t):
                if isinstance(t, torch.nn.Module):
                    for p in list(t.parameters()) + list(t.buffers()):
                        dist.broadcast(p.data, 0)
                elif isinstance(t, torch.Tensor):
                    dist.broadcast(t.data, 0)
                return t
            _tree_map(bcast, tree)
        return tree

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Undo :meth:`shard_batch` for one tensor: the global tensor on
        every rank, in global order, gradients included."""
        m = self.mesh
        if x.dim() == 0 or m.world == 1:
            return x
        if x.dim() == 4 and m.spatial > 1:
            x = _Gather.apply(x, 1, m.spatial_group)
        if m.data > 1:
            x = _Gather.apply(x, 0, m.data_group)
        return x


class _GatherRows(torch.autograd.Function):
    """Height shards of the given ``heights`` (uneven, maybe empty)
    concatenated in rank order; the backward sums the output gradients
    over the group and keeps the rank's rows, as ``_Gather``'s does."""

    @staticmethod
    def forward(ctx, x, heights, index, group):
        ctx.args = (heights, index, group)
        padded = _pad_rows(x, max(heights))
        parts = [torch.empty_like(padded) for _ in heights]
        dist.all_gather(parts, padded, group=group)
        return torch.cat([p[:, :h] for p, h in zip(parts, heights)], 1)

    @staticmethod
    def backward(ctx, grad):
        heights, index, group = ctx.args
        total = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(total, group=group)
        o = offsets(heights)[index]
        return total[:, o:o + heights[index]], None, None, None


class TrainGrid:
    """A training step on a ``data x spatial`` grid (``spatial > 1``).

    Every rank takes the global batch and the global draws and keeps its
    slice: NHWC tensors on ``(data, height)`` (:meth:`rows`), per-sample
    leaves on ``data`` (the trainer's ``dp``, ``mesh.dp``).  The generator
    runs on the rank's rows; the CEM margins of its HR output are cropped
    where they lie (:meth:`kept`: only the global top and bottom lose rows,
    so the ranks keep uneven parts, some none).

    Each loss on a rank is a *share*: summed over the spatial group it is
    the loss of the data row's samples.  A pixel mean is the rank's kept
    pixels' sum over the row's count (:meth:`share`); a loss that needs
    the whole image runs on the gathered kept image (:meth:`gather`), the
    same on every rank of the group, and is taken ``1 / spatial`` times
    (:meth:`part`): the gather's backward sums the group's gradients.
    Gradients and metrics are then summed over the world and divided by
    ``data`` (:meth:`reduce`), which is one process's step on the global
    batch, the same on every rank.

    The JPEG trainers' form has no margins (``margins_hr=0``: every rank
    keeps its whole shard) and an ``align``: the image rows of one codec
    block (8 for the Y model, 16 for the chroma cells), which each shard's
    height must be a multiple of."""

    def __init__(self, mesh: Mesh, margins_hr: int = 0, align: int = 1):
        if mesh.spatial < 2:
            raise ValueError('TrainGrid is for spatial > 1; a data x 1 grid '
                             'is data parallelism (mesh.dp)')
        self.mesh, self.margins = mesh, int(margins_hr)
        self.align = int(align)
        self.rules = ShardingRules(mesh)

    def join(self, *modules: torch.nn.Module, world: bool = False) -> None:
        """Rank 0's weights on every rank, and batch norms over the data
        group; with ``world`` over the whole grid, for modules that run on
        the rank's rows (a critic on the gathered image sees the same
        pixels on every rank of a spatial group)."""
        dp = self.mesh.world_dp if world else self.mesh.dp
        for m in modules:
            self.rules.replicate(sync_batch_norm(m, dp))

    def check(self, x: torch.Tensor) -> None:
        """Raise unless the spatial ranks divide the height of ``x`` (the
        LR image) into whole blocks of ``align`` rows."""
        s, a, h = self.mesh.spatial, self.align, x.shape[1]
        if a == 1 and h % s:
            raise ValueError(f'{s} spatial ranks do not divide the LR '
                             f'height {h}')
        if h % (s * a):
            raise ValueError(f'{s} spatial ranks cannot give each rank '
                             f'whole blocks of {a} rows of the image height '
                             f'{h}')

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's ``(data, height)`` slice of a global NHWC tensor."""
        return x[self.rules.batch_spec(x)]

    def _span(self, h: int, index: int) -> tuple:
        """Rows ``[a, b)`` of spatial rank ``index``'s ``h``-row HR shard
        that the margin crop keeps."""
        o, m = index * h, self.margins
        a = min(max(m - o, 0), h)
        b = max(min(self.mesh.spatial * h - m - o, h), a)
        return a, b

    def kept_height(self, h: int) -> int:
        """The kept height of the image whose HR shards are ``h`` rows."""
        return self.mesh.spatial * h - 2 * self.margins

    def heights(self, kept: int) -> tuple:
        """Each spatial rank's kept rows of an image whose kept height is
        ``kept``."""
        h = (kept + 2 * self.margins) // self.mesh.spatial
        return tuple(b - a for a, b in (self._span(h, i)
                                        for i in range(self.mesh.spatial)))

    def kept(self, x: torch.Tensor) -> torch.Tensor:
        """The margin crop of the rank's HR shard: W on both sides, H where
        the global top and bottom margins meet the shard."""
        a, b = self._span(x.shape[1], self.mesh.spatial_index)
        m = self.margins
        return x[:, a:b, m:x.shape[2] - m]

    def gather(self, x: torch.Tensor, kept: int) -> torch.Tensor:
        """The kept image of the rank's samples, whole: every rank's
        :meth:`kept` rows over the spatial group, ``kept`` rows in all;
        differentiable."""
        m = self.mesh
        return _GatherRows.apply(x, self.heights(kept), m.spatial_index,
                                 m.spatial_group)

    def share(self, e: torch.Tensor, kept: int) -> torch.Tensor:
        """The rank's share of the mean of ``e`` (elementwise, on its kept
        rows) over the data row's kept pixels."""
        return e.sum() / (e.shape[0] * kept * e.shape[2] * e.shape[3])

    def part(self, loss: torch.Tensor) -> torch.Tensor:
        """The rank's share of a loss every rank of the group computes
        whole."""
        return loss / self.mesh.spatial

    @torch.no_grad()
    def reduce(self, grads: list, metrics: dict):
        """``(grads, metrics)`` summed over the world and divided by
        ``data``: the shares' sums over each spatial group, averaged over
        the data rows.  Gradients in place, through one flat all-reduce;
        the scalar metrics through one more, in float64."""
        d = self.mesh.data
        if grads:
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat)
            flat /= d
            offset = 0
            for g in grads:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()
        keys = [k for k, v in metrics.items()
                if isinstance(v, torch.Tensor) and v.dim() == 0]
        if keys:
            stacked = torch.stack([metrics[k].double() for k in keys])
            dist.all_reduce(stacked)
            stacked /= d
            metrics = {**metrics, **{k: v.to(metrics[k].dtype) for k, v
                                     in zip(keys, stacked.unbind())}}
        return grads, metrics
