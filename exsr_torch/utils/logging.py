"""Logging of the training CLIs: metric series, a stdout tee, optional
TensorBoard scalars, a profiler trace, and the program's spans and
counters.

The port's own copy of ``exsr/utils/logging.py``.  :class:`MetricLog`
keeps ``(step, value)`` series and saves them as ``logs.npz`` with PDF
dashboards (matplotlib, when installed); :func:`profile_trace` is a
``torch.profiler`` trace (``exsr``'s is a ``jax.profiler`` one), written
as a Chrome trace.

:func:`span` and :func:`count` mark the program's layer boundaries (the
entry point, the generator, the CEM, the trainer's steps, MAP loop,
backward and Adam).  They record only while something is recording: the
torch profiler is active (as inside :func:`profile_trace`), or the block
runs inside :func:`recording`.  Otherwise a span is one shared null
context and a count does nothing.  :func:`recorded` returns what was kept
in memory, each span with its device time; :func:`reset` clears it.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import sys
import threading
import time

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler


class PrintLogger:
    """Tee stdout to ``<log_dir>/print_log.txt``."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._file = open(os.path.join(log_dir, 'print_log.txt'), 'a')
        self._stdout = sys.stdout
        sys.stdout = self

    def write(self, msg):
        self._stdout.write(msg)
        self._file.write(msg)

    def flush(self):
        self._stdout.flush()
        self._file.flush()

    def close(self):
        sys.stdout = self._stdout
        self._file.close()


class MetricLog:
    """(step, value) series per key, saved to and loaded from ``.npz``
    (one ``[n, 2]`` array per key); :meth:`load` can drop the points past
    a step, as a resumed run does."""

    def __init__(self, keys=()):
        self.series: dict[str, list] = {k: [] for k in keys}

    def append(self, step: int, **values):
        for k, v in values.items():
            self.series.setdefault(k, []).append((int(step), float(v)))

    def last(self, key: str, default=None):
        s = self.series.get(key)
        return s[-1][1] if s else default

    def window(self, key: str, min_step: int) -> list[float]:
        return [v for s, v in self.series.get(key, []) if s >= min_step]

    def save(self, path: str, extra: dict | None = None):
        payload = {k: np.asarray(v) for k, v in self.series.items() if v}
        if extra:
            payload.update({k: np.asarray(v) for k, v in extra.items()})
        np.savez(path, **payload)

    def load(self, path: str, max_step: int | None = None):
        data = np.load(path, allow_pickle=True)
        for k in data.files:
            vals = [tuple(p) for p in data[k]]
            if max_step is not None:
                vals = [p for p in vals if p[0] <= max_step]
            self.series[k] = vals
        return self

    def dashboard(self, out_dir: str, keys=None):
        """One PDF plot per metric in ``out_dir``; without matplotlib, one
        line that says so, and nothing written."""
        try:
            import matplotlib
        except ImportError:
            print('dashboard: matplotlib is not installed, no PDF plots '
                  f'written to {out_dir}', flush=True)
            return
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt
        os.makedirs(out_dir, exist_ok=True)
        for k in (keys or self.series):
            s = self.series.get(k)
            if not s:
                continue
            steps, vals = zip(*s)
            plt.figure(figsize=(6, 3))
            plt.plot(steps, vals)
            plt.title(k)
            plt.xlabel('step')
            plt.grid(alpha=0.3)
            plt.tight_layout()
            plt.savefig(os.path.join(out_dir, f'{k}.pdf'))
            plt.close()


class JsonlLogger:
    """One JSON object per line — machine-readable train log."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
        self._f = open(path, 'a')

    def log(self, **kv):
        self._f.write(json.dumps(kv) + '\n')
        self._f.flush()


class TensorboardWriter:
    """Optional TensorBoard scalar writer.  Without a TensorBoard backend
    it is a silent no-op, so callers construct it unconditionally;
    ``active`` says whether events are written."""

    def __init__(self, log_dir: str):
        self._w = None
        for mod, cls in (('torch.utils.tensorboard', 'SummaryWriter'),
                         ('tensorboardX', 'SummaryWriter')):
            try:
                import importlib
                self._w = getattr(importlib.import_module(mod), cls)(
                    log_dir)
                break
            except Exception:
                continue

    @property
    def active(self) -> bool:
        return self._w is not None

    def log(self, step: int, **scalars):
        if self._w is None:
            return
        for k, v in scalars.items():
            self._w.add_scalar(k, float(v), int(step))

    def close(self):
        if self._w is not None:
            self._w.close()


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True):
    """A ``torch.profiler`` trace of the block (CPU, and CUDA when there
    is a card), written to ``<log_dir>/trace.json`` for
    ``chrome://tracing`` or Perfetto; yields the profiler, or None when
    not ``enabled``.  The program's spans (:func:`span`) are recorded
    inside it, and appear in the trace as ``user_annotation`` ranges."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))


class _Recorder:
    """The process's spans and counters: the open ``recording()`` blocks,
    the closed spans, the counters and each thread's stack of open
    spans."""

    def __init__(self):
        self.depth = 0
        self.spans: list[dict] = []
        self.counters: dict[str, int] = {}
        self.lock = threading.Lock()
        self.local = threading.local()
        self.ids = itertools.count(1)

    def stack(self) -> list:
        st = getattr(self.local, 'stack', None)
        if st is None:
            st = self.local.stack = []
        return st


_REC = _Recorder()
_NULL = contextlib.nullcontext()


class _Span:
    """One recorded span: name, id, parent, root, host start and end
    (``perf_counter_ns``); a ``record_function`` range while the profiler
    is active; on CUDA a pair of timing events on the current stream,
    unless that stream is capturing a graph."""

    __slots__ = ('rec', 'range', 'stream')

    def __init__(self, name: str):
        self.rec = {'name': name}

    def __enter__(self):
        stack = _REC.stack()
        parent = stack[-1] if stack else None
        rec = self.rec
        rec['id'] = sid = next(_REC.ids)
        rec['parent'] = parent['id'] if parent else None
        rec['root'] = parent['root'] if parent else sid
        self.range = None
        if _autograd_profiler._is_profiler_enabled:
            self.range = torch.profiler.record_function(rec['name'])
            self.range.__enter__()
        rec['events'] = self.stream = None
        if torch.cuda.is_initialized() and \
                not torch.cuda.is_current_stream_capturing():
            self.stream = torch.cuda.current_stream()
            start = torch.cuda.Event(enable_timing=True)
            start.record(self.stream)
            rec['events'] = (start, torch.cuda.Event(enable_timing=True))
        stack.append(rec)
        rec['start_ns'] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        rec['end_ns'] = time.perf_counter_ns()
        if rec['events'] is not None:
            if torch.cuda.is_current_stream_capturing():
                rec['events'] = None
            else:
                rec['events'][1].record(self.stream)
        if self.range is not None:
            self.range.__exit__(*exc)
        _REC.stack().pop()
        _REC.spans.append(rec)
        return False


def span(name: str):
    """A context that records the block as the span ``name`` while
    something is recording (the profiler is active, or inside
    :func:`recording`); otherwise one shared null context."""
    if _REC.depth or _autograd_profiler._is_profiler_enabled:
        return _Span(name)
    return _NULL


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` while something is recording."""
    if _REC.depth or _autograd_profiler._is_profiler_enabled:
        with _REC.lock:
            _REC.counters[name] = _REC.counters.get(name, 0) + int(n)


@contextlib.contextmanager
def recording():
    """Record the spans and counters of the block, with or without the
    profiler."""
    with _REC.lock:
        _REC.depth += 1
    try:
        yield
    finally:
        with _REC.lock:
            _REC.depth -= 1


def recorded() -> dict:
    """What was recorded since the last :func:`reset`, left in place:
    ``{'spans': [...], 'counters': {name: n}}``.  Each span, in the order
    the spans closed, has ``name``, ``id``, ``parent`` (None for a root),
    ``root`` (the id shared by every span under one root), ``start_ns``
    and ``end_ns`` (host clock) and ``device_ms`` (from its events, after
    one synchronize; None without a card)."""
    spans = list(_REC.spans)
    if any(s['events'] is not None for s in spans):
        torch.cuda.synchronize()
    out = []
    for s in spans:
        ev = s['events']
        out.append({k: s[k] for k in ('name', 'id', 'parent', 'root',
                                      'start_ns', 'end_ns')}
                   | {'device_ms': (ev[0].elapsed_time(ev[1])
                                    if ev is not None else None)})
    with _REC.lock:
        counters = dict(_REC.counters)
    return {'spans': out, 'counters': counters}


def reset() -> None:
    """Clear the recorded spans and counters."""
    with _REC.lock:
        _REC.spans.clear()
        _REC.counters.clear()
