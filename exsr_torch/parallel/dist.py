"""Data parallelism over ``torch.distributed``: one process per card.

Counterpart of ``exsr/parallel/mesh.py``'s ``data`` axis.  ``exsr``'s
training CLIs shard every batch over the devices of one process and let
XLA insert the collectives; the port runs one process per card under
``torchrun`` and inserts them itself:

* :func:`init_from_env` joins the process group that ``torchrun``'s
  ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` describe (NCCL for CUDA,
  gloo for the CPU) and returns a :class:`DataParallel`; without those
  variables it returns None and the run is one process;
* :class:`DataParallel` holds the rank's slice of a global batch
  (:meth:`~DataParallel.shard`, :func:`local_batch_slice`) and the
  collectives a step needs: sums that carry gradients (their backward is
  the same sum, so a loss's cross-rank terms reach every rank's
  gradients, to any order), a gather in global sample order, one flat
  all-reduce of the gradients, the metrics' global means and the
  parameters' broadcast from rank 0;
* :func:`sync_batch_norm` makes every batch norm of a module normalise by
  the global batch's statistics, as ``exsr``'s does under ``jit``;
* :func:`shard`, :func:`global_mean`, :func:`count_mean`,
  :func:`reduced` and :func:`join` are a trainer's data-parallel pieces:
  given None (one process) each is the plain computation;
* :class:`RankRun` is a training CLI's place in the run: rank 0 prints
  and writes, every rank waits where rank 0 may have written, and all
  stop at the same step.

Only ``all_reduce``, ``all_gather``, ``broadcast`` and ``barrier`` are
used: gloo's CUDA support has no ``reduce_scatter``.  ``--batch`` stays
the global batch: every rank holds (collates, draws) the whole of it and
keeps its slice, so a run on R ranks computes what one process computes
on the whole batch.
"""
from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist


def local_batch_slice(global_batch: int, rank: int, world: int) -> slice:
    """The rank's contiguous slice of a global batch (``mesh.py``'s
    ``local_batch_slice``); the world size must divide the batch."""
    if global_batch % world:
        raise ValueError(f'the world size {world} does not divide the '
                         f'global batch {global_batch}')
    n = global_batch // world
    return slice(rank * n, (rank + 1) * n)


class _AllSum(torch.autograd.Function):
    """``all_reduce(SUM)`` whose backward is the same sum: each rank's
    input gradient is the sum over ranks of their output gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllSum.apply(grad, ctx.group), None


class _Gather(torch.autograd.Function):
    """``all_gather`` concatenated along ``dim`` in rank order; the
    backward sums the output gradients over ranks and keeps the rank's
    part."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        ctx.rank, ctx.n = dist.get_rank(group), x.shape[dim]
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, grad):
        total = _AllSum.apply(grad, ctx.group)
        return total.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """A rank of a data-parallel run of ``world`` processes."""
    rank: int
    world: int
    group: object = None
    device: torch.device = torch.device('cpu')

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def flag_any(self, flag: bool) -> torch.Tensor:
        """A 0-d tensor on the rank's device, nonzero when any rank's
        ``flag`` is set, so that all ranks stop at the same step; the
        caller may read it later (on CUDA the all-reduce is enqueued, not
        waited for)."""
        t = torch.tensor([float(flag)], device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t[0]

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's slice of a global ``[B, ...]`` tensor."""
        return x[local_batch_slice(x.shape[0], self.rank, self.world)]

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over ranks, gradients included."""
        return _AllSum.apply(x, self.group)

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The global mean of equal shards ``x``, gradients included."""
        return self.all_sum(x.sum()) / (x.numel() * self.world)

    def count_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's share of the global mean: the local sum over the
        global count.  Summed over ranks (as gradients are) it is the
        global mean; no collective runs."""
        return x.sum() / (x.numel() * self.world)

    def gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in rank order
        (global sample order for shards), gradients included."""
        return _Gather.apply(x, dim, self.group)

    @torch.no_grad()
    def reduce_grads(self, grads: list) -> list:
        """Every gradient replaced by its mean over ranks, through one
        flat all-reduce; the list is returned."""
        if not grads:
            return grads
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.group)
        flat /= self.world
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
        return grads

    @torch.no_grad()
    def reduce_metrics(self, metrics: dict) -> dict:
        """The scalar metrics' means over ranks, through one all-reduce
        (each is a mean over the rank's equal shard, so this is the global
        batch's)."""
        keys = [k for k, v in metrics.items()
                if isinstance(v, torch.Tensor) and v.dim() == 0]
        if not keys:
            return metrics
        stacked = torch.stack([metrics[k].double() for k in keys])
        dist.all_reduce(stacked, group=self.group)
        stacked /= self.world
        return {**metrics, **{k: v.to(metrics[k].dtype)
                              for k, v in zip(keys, stacked.unbind())}}

    @torch.no_grad()
    def broadcast_(self, module: torch.nn.Module) -> torch.nn.Module:
        """Rank 0's parameters and buffers on every rank."""
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, 0, group=self.group)
        return module

    def barrier(self) -> None:
        dist.barrier(group=self.group)


def sync_batch_norm(module: torch.nn.Module, dp: DataParallel | None
                    ) -> torch.nn.Module:
    """Point every :class:`~exsr_torch.models.discriminators.BatchNorm` of
    ``module`` at ``dp``: batch statistics over the global batch, the
    running statistics moved by them.  One process (``dp`` None or one
    rank) leaves them local."""
    from exsr_torch.models.discriminators import BatchNorm
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.dp = active(dp)
    return module


# A trainer's data-parallel pieces.  Each takes the trainer's ``dp``, None
# in one process, where it is the plain computation and no collective runs.
def active(dp: DataParallel | None) -> DataParallel | None:
    """``dp`` when it spans more than one rank, else None."""
    return dp if dp is not None and dp.world > 1 else None


def join(dp: DataParallel | None, *modules: torch.nn.Module) -> None:
    """Batch norms synced over the ranks and rank 0's weights on every
    rank."""
    if dp is not None:
        for m in modules:
            dp.broadcast_(sync_batch_norm(m, dp))


def shard(dp: DataParallel | None, x: torch.Tensor) -> torch.Tensor:
    """The rank's slice of a global batch tensor."""
    return x if dp is None else dp.shard(x)


def global_mean(dp: DataParallel | None, x: torch.Tensor) -> torch.Tensor:
    """The mean over the global batch, gradients included."""
    return x.mean() if dp is None else dp.mean(x)


def count_mean(dp: DataParallel | None, x: torch.Tensor) -> torch.Tensor:
    """The rank's share of the global mean (:meth:`DataParallel.count_mean`):
    per-sample gradients of the global mean, with no collective."""
    return x.mean() if dp is None else dp.count_mean(x)


def reduced(dp: DataParallel | None, grads: list, metrics: dict):
    """``(grads, metrics)`` as means over the ranks."""
    if dp is None:
        return grads, metrics
    return dp.reduce_grads(grads), dp.reduce_metrics(metrics)


def init_from_env(device=None):
    """``(dp, device)`` for a process that ``torchrun`` started.

    ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` come from the environment;
    without ``WORLD_SIZE`` this returns ``(None, device)`` untouched and
    nothing is initialised.  The rank's device is ``cuda:LOCAL_RANK``
    unless ``device`` is ``'cpu'``; the backend NCCL on CUDA and gloo on
    the CPU; the group joins through ``env://`` (``torchrun``'s
    ``MASTER_ADDR`` and ``MASTER_PORT``) unless one is already
    initialised."""
    if 'WORLD_SIZE' not in os.environ:
        return None, device
    rank = int(os.environ['RANK'])
    world = int(os.environ['WORLD_SIZE'])
    local = int(os.environ.get('LOCAL_RANK', rank))
    if device is not None and torch.device(device).type == 'cpu':
        device = torch.device('cpu')
    else:
        torch.cuda.set_device(local)
        device = torch.device('cuda', local)
    if not dist.is_initialized():
        if device.type == 'cuda':
            dist.init_process_group('nccl', rank=rank, world_size=world,
                                    device_id=device)
        else:
            dist.init_process_group('gloo', rank=rank, world_size=world)
    return DataParallel(rank, world, device=device), device


def check_batch(batch: int, world: int, accum: int = 1) -> None:
    """Raise unless the world size divides the global batch and each of
    its ``accum`` microbatches (``exsr`` would use fewer devices)."""
    if batch % accum or (batch // accum) % world:
        raise ValueError(
            f'--batch {batch} in {accum} microbatch(es) of '
            f'{batch // max(accum, 1)} cannot be split over {world} ranks: '
            f'the world size must divide each microbatch')


class RankRun:
    """A training CLI's place in a run that ``torchrun`` may have started:
    ``dp`` (None in one process) and ``device``; :meth:`say` prints on
    rank 0; :meth:`save` writes a checkpoint on rank 0, after which every
    rank waits at the steps where rank 0 may have written (the first call,
    multiples of ``ckpt_freq``, forced saves), so that a rollback on any
    rank reads a whole file; :meth:`stop` turns this rank's stop request
    into the ranks' agreement, one step late."""

    def __init__(self, device=None, ckpt_freq: int = 1):
        from exsr_torch.device import resolve_device
        self.dp, device = init_from_env(device)
        self.device = resolve_device(device)
        self.main = self.dp is None or self.dp.is_main
        self._freq, self._first, self._stop = ckpt_freq, True, None

    def check_batch(self, batch: int, accum: int = 1) -> None:
        if self.dp is not None:
            check_batch(batch, self.dp.world, accum)

    def say(self, *a) -> None:
        if self.main:
            print(*a, flush=True)

    def save(self, ckpts, step: int, state, force: bool = False,
             **kw) -> None:
        if self.main:
            ckpts.save(step, state, force=force, **kw)
        if self.dp is not None and (force or self._first
                                    or step % self._freq == 0):
            self.dp.barrier()
        self._first = False

    def stop(self, requested: bool) -> bool:
        """Whether to stop now: the request itself in one process; with
        ranks, whether any rank asked one step ago (this step's flags are
        all-reduced now and read at the next step, so no step waits on
        the device for them)."""
        if self.dp is None:
            return requested
        from exsr_torch.utils.misc import read_scalars, stage_scalars
        staged = stage_scalars({'stop': self.dp.flag_any(requested)})
        last, self._stop = self._stop, staged
        return last is not None and read_scalars(last)['stop'] > 0
