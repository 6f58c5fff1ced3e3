"""Batch-bucketing policy for serving the generator.

Counterpart of ``exsr/utils/serve.py``.  ``best_bucket`` picks, over a
table of measured forward times per batch size, the batch a request of
``n`` images should run at: the fastest bucket that holds it, which may be
larger than ``n`` when a larger batch is absolutely faster.  ``pad_batch``
zero-pads a request to that bucket.

The port's table is empty, which is the identity policy: every request
runs at its own size.  ``exsr``'s table was measured on another device and
does not carry over; a table for the port comes from timing its forward on
the GPU.
"""
from __future__ import annotations

import bisect

import torch

MS_PER_FWD: dict[int, float] = {}

# alternatives-batch buckets of the interactive edit path
ALT_BUCKETS: tuple[int, ...] = (1, 2, 4, 8, 16, 32)


def alt_bucket(n: int, buckets: tuple[int, ...] = ALT_BUCKETS) -> int:
    """Round an alternatives-batch request up to the next bucket (``n``
    above the largest bucket is returned unchanged)."""
    for b in buckets:
        if b >= n:
            return b
    return n


def best_bucket(n: int, table: dict[int, float] | None = None) -> int:
    """Smallest-total-time bucket for a request of ``n`` images:
    ``argmin_{B >= n} t(B)`` over the table, or ``n`` when the table is
    empty or ``n`` exceeds its largest bucket."""
    table = MS_PER_FWD if table is None else table
    if not table:
        return n
    buckets = sorted(table)
    if n > buckets[-1]:
        return n
    cands = buckets[bisect.bisect_left(buckets, n):]
    return min(cands, key=lambda b: table[b])


def pad_batch(tensors, n_to: int):
    """Zero-pad every tensor's leading (batch) axis to ``n_to`` rows.

    Returns ``(padded, n_real)``; the caller keeps the first ``n_real``
    outputs.
    """
    tensors = list(tensors)
    if not tensors:
        return tensors, 0
    n_real = int(tensors[0].shape[0])
    if any(int(t.shape[0]) != n_real for t in tensors):
        raise ValueError('mismatched batch axes')
    if n_to <= n_real:
        return tensors, n_real
    return [torch.cat([t, t.new_zeros((n_to - n_real,) + tuple(t.shape[1:]))])
            for t in tensors], n_real
