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
  order (:meth:`~ShardingRules.gather`, differentiable).

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
from exsr_torch.parallel.dist import DataParallel, _Gather


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
