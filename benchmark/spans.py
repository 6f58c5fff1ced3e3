"""The program's own spans and counters, for the per-layer readers.

The port records a span at each of its layer boundaries (``exsr.sweep``,
``exsr.forward``, ``exsr.generator``, ``exsr.cem``; ``exsr.d_step``,
``exsr.g_step``, ``exsr.map_loop``, ``exsr.backward``, ``exsr.adam``) and
two pixel counters (``px.generated``, ``px.returned``) while the profiler
is active, so in the traced requests or iteration of a ``--trace 1`` run:
in memory, each span with its device time from CUDA events
(``exsr_torch.utils.logging.recorded``), and in the trace as host ranges
of the same names.

The first reader of a run takes the records from the program and clears
them there; the run's context keeps them for the other readers.  A program
without them (one older than its spans) gives None, and so does a run that
recorded nothing: the readers then print no number.
"""
from __future__ import annotations

from benchmark.trace import idle_gaps

KEY = 'exsr_spans'
PREFIX = 'exsr.'


def records(ctx) -> dict | None:
    """``{'spans': [...], 'counters': {...}}`` of the run, or None."""
    if KEY not in ctx:
        ctx[KEY] = _take()
    return ctx[KEY]


def _take() -> dict | None:
    try:
        from exsr_torch.utils.logging import recorded, reset
    except ImportError:       # a program without spans
        return None
    out = recorded()
    reset()
    return out if out['spans'] or out['counters'] else None


def span_ms(rec: dict, names, whole: bool = False) -> float | None:
    """Device ms in the spans named ``names``: their self time, each less
    the device time of the spans nested directly in it, or with ``whole``
    their whole time; None where no such span has a device time."""
    spans = [s for s in rec['spans'] if s['device_ms'] is not None]
    inner = {}
    if not whole:
        for s in spans:
            if s['parent'] is not None:
                inner[s['parent']] = inner.get(s['parent'], 0.0) \
                    + s['device_ms']
    hits = [s['device_ms'] - inner.get(s['id'], 0.0)
            for s in spans if s['name'] in names]
    return sum(hits) if hits else None


def span_ms_per_request(ctx, names, whole: bool = False) -> float | None:
    """:func:`span_ms` over the run's traced requests."""
    rec = records(ctx)
    ms = span_ms(rec, names, whole) if rec else None
    return ms / ctx['requests'] if ms is not None else None


def idle_ms_per_request(ctx, pick) -> float | None:
    """Idle ms a traced request in the gaps for which ``pick`` holds:
    each gap of :func:`benchmark.trace.idle_gaps` put down to the
    program's ranges (``exsr.*`` in ``trace.host``) open at its middle,
    ``pick`` given their names, outermost first.  None without such
    ranges."""
    tr = ctx['trace']
    ranges = sorted((h for h in tr.host if h[0].startswith(PREFIX)),
                    key=lambda h: h[1])
    if not ranges:
        return None
    open_, i, us = [], 0, 0.0
    for s, e in idle_gaps(tr):
        mid = (s + e) / 2
        # push what started by the middle; keep what is still open
        while i < len(ranges) and ranges[i][1] <= mid:
            open_.append(ranges[i])
            i += 1
        open_ = [r for r in open_ if r[2] > mid]
        if pick([r[0] for r in open_]):
            us += e - s
    return us / 1e3 / ctx['requests']


def counter_ratio_pct(ctx, num: str, den: str) -> float | None:
    """Counter ``num`` over counter ``den``, %."""
    rec = records(ctx)
    c = rec['counters'] if rec else {}
    if not c.get(den) or num not in c:
        return None
    return 100.0 * c[num] / c[den]
