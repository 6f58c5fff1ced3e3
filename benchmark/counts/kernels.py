"""Bytes and useful operations of the port's hand-written kernels, from
the shapes of one call.  Frozen copies of the arithmetic in
``exsr_torch/scripts/stage4_probe.py`` (``shape_bound``) and
``exsr_torch/ops/kernels/measure.py`` (``sepfilter_kernels``), written for
any height and width: each input byte is counted read once, each output
byte written once, and 2 operations a product.

Every function returns ``(bytes, flops)``; :func:`benchmark.counts.peaks.
bound_ms` turns them into the least time.
"""
from __future__ import annotations

import numpy as np


def stage4(pixels: int, nf: int, gc: int, dtype_bytes: int):
    """One stage-4 epilogue launch over ``pixels`` (batch x height x
    width): c3 (gc channels), the four nf-wide P reads, x and the output
    once, w4 and the fp32 b4; the 3 x 3 conv's ``2 * 9 * gc * nf``
    operations a pixel."""
    nbytes = dtype_bytes * (pixels * (gc + 6 * nf) + 9 * gc * nf) + 4 * nf
    flops = 2 * 9 * gc * nf * pixels
    return nbytes, flops


def out_len(n: int, k: int) -> int:
    """Outputs of the same-size filter along an axis of ``n`` samples and
    ``k`` taps: ``n``, or ``n + 1`` for an even ``k``."""
    return n + 1 - k % 2


def up_entries(n_lr: int, sf: int, pre: int, k: int) -> int:
    """Products of the up filter along one axis that meet data: over the
    HR outputs of ``n_lr * sf`` zero-stuffed samples (replicate borders),
    the taps whose clamped sample is a data sample (``pre`` modulo
    ``sf``)."""
    n = n_lr * sf
    hr = np.clip(np.arange(out_len(n, k))[:, None] - k // 2
                 + np.arange(k)[None, :], 0, n - 1)
    return int(((hr - pre) % sf == 0).sum())


def sepfilter_edge(batch: int, h: int, w: int, c: int, kh: int, kw: int):
    """The same-size filter: fp32 input and output once; a column and a
    row pass at every output pixel."""
    ho, wo = out_len(h, kh), out_len(w, kw)
    nbytes = 4 * batch * c * (h * w + ho * wo)
    flops = 2 * batch * c * ho * wo * (kh + kw)
    return nbytes, flops


def sepfilter_down(batch: int, h: int, w: int, c: int, kh: int, kw: int,
                   sf: int, pre):
    """The filter at the kept pixels only, HR ``h x w`` in: the column
    pass at the kept rows, the row pass at the kept pixels."""
    ho = len(range(pre[0], out_len(h, kh), sf))
    wo = len(range(pre[1], out_len(w, kw), sf))
    nbytes = 4 * batch * c * (h * w + ho * wo)
    flops = 2 * batch * c * (ho * w * kh + ho * wo * kw)
    return nbytes, flops


def sepfilter_up_combine(batch: int, h: int, w: int, c: int, kh: int,
                         kw: int, sf: int, pre):
    """``U(a) + (g - U(b))``, LR ``h x w`` a and b in, HR g in and out:
    both upscales' products that meet data (column pass along the LR
    width, row pass at every output row) and the combine's two adds."""
    ho, wo = out_len(h * sf, kh), out_len(w * sf, kw)
    lr, hr = batch * c * h * w, batch * c * ho * wo
    nbytes = 4 * (2 * lr + 2 * hr)
    e_rows = up_entries(h, sf, pre[0], kh)
    e_cols = up_entries(w, sf, pre[1], kw)
    flops = 2 * 2 * batch * c * (e_rows * w + e_cols * ho) + 2 * hr
    return nbytes, flops


def cem_forward(batch: int, h: int, w: int, c: int, k_down: int,
                k_inv: int, sf: int, pre) -> dict:
    """The CEM combine of one forward at LR ``h x w`` (the pre-padded
    size): the inv_hTh filter on the LR input and on the downscaled
    output (``sepfilter_edge`` twice), the downscale and the up-combine;
    ``{kernel: [(bytes, flops), ...]}``."""
    edge = sepfilter_edge(batch, h, w, c, k_inv, k_inv)
    return {
        'sepfilter_edge': [edge, edge],
        'sepfilter_down': [sepfilter_down(batch, h * sf, w * sf, c, k_down,
                                          k_down, sf, pre)],
        'sepfilter_up': [sepfilter_up_combine(batch, h, w, c, k_down,
                                              k_down, sf, pre)],
    }
