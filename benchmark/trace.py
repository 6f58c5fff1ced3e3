"""From a ``torch.profiler`` trace to device busy time, idle gaps and time
by kernel.

The trace is the profiler's Chrome-trace export: device activity is the
complete events (``ph == 'X'``) of the categories in :data:`DEVICE`, on
the host's clock.  Busy time is the length of the union of those
intervals inside the window, never a sum of per-name totals: a range that
covers kernels (an autograd or ``record_function`` range, which the
profiler also lays on the device's timeline as ``gpu_user_annotation``)
and kernels that overlap on two streams are counted once.
"""
from __future__ import annotations

import json
from collections import defaultdict
from dataclasses import dataclass

DEVICE = ('kernel', 'gpu_memcpy', 'gpu_memset')
HOST = ('cpu_op', 'cuda_runtime', 'cuda_driver', 'user_annotation')


@dataclass
class Trace:
    device: list          # (name, cat, start_us, end_us), device activity
    host: list            # (name, start_us, end_us, tid), host ranges
    window: tuple         # (start_us, end_us)

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def kernels(self) -> list:
        """``(name, start_us, end_us)`` of the kernels in the window."""
        lo, hi = self.window
        return [(n, s, e) for n, c, s, e in self.device
                if c == 'kernel' and s >= lo and e <= hi]


def load(path: str, span: str) -> Trace:
    """Read a Chrome-trace export; the window runs from the first start
    to the last end of the host ranges named ``span`` (the benchmark's
    own ``record_function`` around each traced call)."""
    with open(path) as f:
        events = json.load(f)['traceEvents']
    device, host, spans = [], [], []
    for e in events:
        if e.get('ph') != 'X' or 'dur' not in e:
            continue
        s = float(e['ts'])
        end = s + float(e['dur'])
        cat = e.get('cat', '')
        if cat in DEVICE:
            device.append((e.get('name', ''), cat, s, end))
        elif cat in HOST:
            host.append((e.get('name', ''), s, end, e.get('tid')))
            if cat == 'user_annotation' and e.get('name') == span:
                spans.append((s, end))
    if not spans:
        raise ValueError(f'no {span!r} range in the trace')
    return Trace(device=device, host=host,
                 window=(min(s for s, _ in spans), max(e for _, e in spans)))


def union(intervals, lo: float, hi: float) -> list:
    """The union of ``(start, end)`` intervals clipped to ``[lo, hi]``, as
    sorted disjoint intervals."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_us(trace: Trace) -> float:
    """Microseconds of the window in which some device activity ran."""
    lo, hi = trace.window
    return sum(e - s for s, e in union(
        ((s, e) for _, _, s, e in trace.device), lo, hi))


def idle_gaps(trace: Trace) -> list:
    """``(start_us, end_us)`` of the window's stretches with no device
    activity."""
    lo, hi = trace.window
    gaps, t = [], lo
    for s, e in union(((s, e) for _, _, s, e in trace.device), lo, hi):
        if s > t:
            gaps.append((t, s))
        t = e
    if hi > t:
        gaps.append((t, hi))
    return gaps


def by_name(items) -> list:
    """``[[name, seconds], ...]`` summed by name, longest first."""
    tot = defaultdict(float)
    for name, us in items:
        tot[name] += us
    return sorted(([n, us / 1e6] for n, us in tot.items()),
                  key=lambda t: -t[1])


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps
    summed by what the host was doing at each gap's middle (the
    innermost host range around it, on any thread)."""
    lo, hi = trace.window
    ops = by_name((n, min(e, hi) - max(s, lo)) for n, _, s, e in trace.device
                  if e > lo and s < hi)
    labelled = []
    gaps = idle_gaps(trace)
    mids = sorted(((s + e) / 2, e - s) for s, e in gaps)
    host = sorted(trace.host, key=lambda h: h[1])
    stack, i = [], 0
    for mid, length in mids:
        # push what started by the middle; drop what ended: the top is
        # then the latest-started range still open, the innermost
        while i < len(host) and host[i][1] <= mid:
            stack.append(host[i])
            i += 1
        while stack and stack[-1][2] <= mid:
            stack.pop()
        labelled.append((stack[-1][0] if stack else '(no host range)',
                         length))
    return {'device_ops': ops[:top], 'idle_gaps': by_name(labelled)[:top]}
