"""Programs with a fault planted under the timed path, for the checks
that a run of each cell comes out not correct when the program is
wrong: the tests drive them on the CPU, ``benchmark.calibrate --fault``
on the card at the cell's own size."""
from __future__ import annotations

import torch

from benchmark.drivers import serve, train


class Serve(serve.Program):
    """``eval_sr``'s entry, with ``altered`` (the first returned image
    shifted by one pixel) or ``half_batch`` (only the first half of the Z
    sweep computed, its images returned again for the second half)."""

    def __init__(self, fault=None):
        super().__init__()
        sweep = self.bucketed_sweep

        def broken(fwd, lr, zs, table=None):
            if fault == 'half_batch':
                outs = sweep(fwd, lr, zs[:(len(zs) + 1) // 2], table)
                return (outs + outs)[:len(zs)]
            outs = sweep(fwd, lr, zs, table)
            if fault == 'altered':
                outs[0] = torch.roll(outs[0], 1, dims=2)
            return outs
        self.bucketed_sweep = broken


class Train(train.Program):
    """The trainer, with ``unchanged`` (each step computes its gradients
    and returns the state without the update), ``half_batch`` (each step
    on the first half of the batch and its draws, the means taken over
    it) or ``half_batch_g`` (the G steps alone so)."""

    def __init__(self, fault=None):
        super().__init__()
        self.fault = fault

    def _half(self, batch, draws):
        def cut(x):
            if isinstance(x, list):
                return [cut(v) for v in x]
            return x[:x.shape[0] // 2]
        return ({k: cut(v) for k, v in batch.items()},
                {k: cut(v) for k, v in draws.items()})

    def d_step(self, trainer, state, batch, draws):
        if self.fault == 'half_batch':
            batch, draws = self._half(batch, draws)
        if self.fault == 'unchanged':
            _, metrics = trainer.d_grads(state, batch['lr'], batch['hr'],
                                         draws, True)
            state.d_opt.zero_grad(set_to_none=True)
            return state, metrics
        return super().d_step(trainer, state, batch, draws)

    def g_step(self, trainer, state, batch, draws):
        if self.fault in ('half_batch', 'half_batch_g'):
            batch, draws = self._half(batch, draws)
        if self.fault == 'unchanged':
            _, metrics, _ = trainer.g_grads(state, batch['lr'], batch['hr'],
                                            draws, True, True)
            state.g_opt.zero_grad(set_to_none=True)
            return state, metrics
        return super().g_step(trainer, state, batch, draws)


PROGRAMS = {'serve': Serve, 'train': Train}
