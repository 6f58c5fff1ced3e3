"""What the per-layer readers share: the port's own kernels by name, and
sums over the traced window.  A reader gets the run's context:
``trace`` (:class:`benchmark.trace.Trace`), ``requests`` (the traced
calls), ``host_ms`` (the benchmark's host spans) and ``counts`` (bytes and
operations from the cell's shapes)."""
from __future__ import annotations

import re
from pathlib import Path

from benchmark.counts.peaks import FP32_FLOPS, bound_ms
from benchmark.trace import busy_us

# the hand-written kernels of exsr_torch/csrc, by the start of their names
OWN = ('sepfilter_edge_kernel', 'sepfilter_down_kernel',
       'sepfilter_up_kernel', 'sepfilter_taps_kernel', 'stage4_kernel',
       'stage4_fma_kernel', 'rdb_kernel', 'rdb_fma_kernel')


def base_name(kernel: str) -> str:
    """``void (anonymous namespace)::stage4_kernel<64, 2>((anonymous
    namespace)::Args)`` -> ``stage4_kernel``."""
    name = kernel.replace('(anonymous namespace)::', '')
    if name.startswith('void '):
        name = name[5:]
    m = re.match(r'[\w:]+', name)
    return m.group(0).split('::')[-1] if m else name


def kernel_us(ctx, names) -> tuple:
    """``(microseconds, launches)`` of the traced kernels named
    ``names``."""
    hits = [e - s for n, s, e in ctx['trace'].kernels()
            if base_name(n) in names]
    return sum(hits), len(hits)


def cem_launches(ctx) -> dict:
    """``{kernel: (launches, microseconds, bound ms of one launch)}`` of
    the CEM filter kernels in the trace.  Means per launch keep the
    readers right where the profiler dropped some events."""
    out = {}
    for kernel, calls in ctx['counts']['cem'].items():
        us, n = kernel_us(ctx, (f'{kernel}_kernel',))
        if n:
            bound = sum(bound_ms(b, f, FP32_FLOPS)[0] for b, f in calls)
            out[kernel] = (n, us, bound / len(calls))
    return out


def idle_pct(ctx) -> float:
    """The traced window's share with no kernel, copy or fill running on
    the device, %."""
    tr = ctx['trace']
    return 100.0 * (1.0 - busy_us(tr) / tr.window_us)


def peak_pct(ctx) -> float:
    """The model operations of one traced request over its time in the
    trace and the peak, %."""
    c = ctx['counts']
    per_req_s = ctx['trace'].window_us / 1e6 / ctx['requests']
    return 100.0 * c['model_flops'] / per_req_s / c['peak_flops']


def same_as(metric: str):
    """The reader of ``metric``: a quantity read alike in cells that
    report another end-to-end metric is a metric of its own there."""
    from benchmark.run import load_module
    return load_module(Path(__file__).parent / f'{metric}.py').read
