"""Logging of the training CLIs: metric series, a stdout tee, optional
TensorBoard scalars, a step timer and a profiler trace.

The port's own copy of ``exsr/utils/logging.py``.  :class:`MetricLog`
keeps ``(step, value)`` series and saves them as ``logs.npz`` with PDF
dashboards (matplotlib, when installed); :func:`profile_trace` is a
``torch.profiler`` trace (``exsr``'s is a ``jax.profiler`` one), written
as a Chrome trace.
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import time

import numpy as np


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


class StepTimer:
    """Steps per second, as an exponential moving average."""

    def __init__(self, ema: float = 0.9):
        self._t = time.perf_counter()
        self._ema = ema
        self.steps_per_s = 0.0

    def tick(self, n: int = 1) -> float:
        now = time.perf_counter()
        rate = n / max(now - self._t, 1e-9)
        self._t = now
        self.steps_per_s = (self._ema * self.steps_per_s
                            + (1 - self._ema) * rate
                            if self.steps_per_s else rate)
        return self.steps_per_s


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True):
    """A ``torch.profiler`` trace of the block (CPU, and CUDA when there
    is a card), written to ``<log_dir>/trace.json`` for
    ``chrome://tracing`` or Perfetto; yields the profiler, or None when
    not ``enabled``."""
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))
