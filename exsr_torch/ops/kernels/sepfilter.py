"""Separable edge-clamped depthwise filter: the CEM filter chain's kernels.

Replaces ``sepfilter_edge_pallas`` (``exsr/ops/pallas/sepfilter.py:76``).
:func:`sepfilter_edge` computes, on fp32 NHWC ``[B, H, W, C]``, the
correlation with ``kcol`` along H and then with ``krow`` along W, with
replicate (edge-clamped) borders: ``filters.filter_replicate_same_separable``.
As there, an axis with an even tap count grows by one sample (replicate
padding by ``k // 2`` on both sides, then a VALID correlation:
:func:`out_len`).  Two polyphase forms serve the CEM's resampling:

- :func:`sepfilter_down`: the filter sampled at sub-position ``pre`` of
  every ``sf x sf`` cell (``aliased_subsample`` of the same-size result,
  grown or not), computing only the kept outputs;
- :func:`sepfilter_up`: the filter applied to ``zero_stuff(a)``, computing
  only the products whose input is not a stuffed zero; with ``b`` and ``g``
  it returns ``U(a) + (g - U(b))``, the CEM's ``ortho + ns``.

On the H100 all three are bound by bytes, so the CUDA kernels
(``exsr_torch/csrc/sepfilter.cu``) read their inputs once and write their
output once: each block stages its tile and clamped halo in shared memory
by ``cp.async``.  They compute in fp32 FMA with no TF32, taking taps in the
same order as the same-size kernel: each polyphase form equals its
composition through :func:`sepfilter_edge` bit for bit.  Which taps of the
up filter meet a data row or column near a clamped edge depends on ``sf``
and ``pre``; the host builds those lists (:func:`polyphase_taps`) and the
kernel follows them.

Gradients.  Each entry point runs through a ``torch.autograd.Function``
on both devices.  Every map is linear in its images, so its backward is its
adjoint, and the adjoint of a separable map is the separable map of the
transposed 1-D matrices: ``E^T`` for the same-size filter ``E``, ``D^T =
E^T S^T`` for ``D = S E`` (keep every ``sf``-th sample from ``pre``) and
``U^T = S E^T`` for ``U = E S^T``.  ``E^T`` is no clamped correlation: a
clamped tap folds back onto the edge sample.  So the host transposes each
1-D matrix (:func:`adjoint_taps`, kept per shape by the taps' owner in an
:class:`AdjointTables`) and one more kernel,
:func:`sepfilter_taps`, applies such tables along both axes.  It replaces
no TPU kernel: ``exsr`` differentiates the XLA path that its Pallas kernel
stands in for.  The adjoint of the adjoint is the forward again, so
gradients of gradients (the histogram loss's temperature search) run
through the same kernels.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses

import numpy as np
import torch

from exsr_torch.ops import filters
from exsr_torch.ops.kernels import build


def sepfilter_edge_plain(x: torch.Tensor, kcol: torch.Tensor,
                         krow: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: replicate padding plus depthwise convs."""
    c = x.shape[-1]
    w_col = kcol.reshape(1, 1, -1, 1).expand(c, 1, -1, 1)
    w_row = krow.reshape(1, 1, 1, -1).expand(c, 1, 1, -1)
    return filters.filter_replicate_same_separable(x, w_col, w_row)


def sepfilter_down_plain(x: torch.Tensor, kcol: torch.Tensor,
                         krow: torch.Tensor, sf: int,
                         pre: tuple[int, int]) -> torch.Tensor:
    """Plain version of :func:`sepfilter_down` (a strided view)."""
    return filters.aliased_subsample(sepfilter_edge_plain(x, kcol, krow),
                                     sf, pre)


def sepfilter_up_plain(a: torch.Tensor, kcol: torch.Tensor,
                       krow: torch.Tensor, sf: int, pre: tuple[int, int],
                       b: torch.Tensor | None = None,
                       g: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of :func:`sepfilter_up`: zero-stuffing, then the
    same-size filter; with ``b`` and ``g``, ``U(a) + (g - U(b))``."""
    a_up = sepfilter_edge_plain(filters.zero_stuff(a, sf, pre), kcol, krow)
    if b is None:
        return a_up
    b_up = sepfilter_edge_plain(filters.zero_stuff(b, sf, pre), kcol, krow)
    return a_up + (g - b_up)


def out_len(n: int, k: int) -> int:
    """Outputs of the same-size filter along an axis of ``n`` samples and
    ``k`` taps: ``n``, or ``n + 1`` for an even ``k``."""
    return n + 1 - k % 2


def polyphase_taps(n_lr: int, sf: int, pre: int, k: int) -> np.ndarray:
    """Tap lists of the up filter along one axis of ``n_lr * sf`` stuffed
    HR samples, ``int32 [max entries, out_len(n_lr * sf, k)]``.

    Entry ``e`` of HR index ``i`` is ``(I << 8) | r``: tap ``r`` of the
    ``k`` taps meets data sample ``I`` of the LR axis, for the ``e``-th
    such ``r`` in ascending order; ``-1`` after the last.  With replicate
    borders tap ``r`` reads HR sample ``clip(i - k//2 + r)``, which holds
    data only where it is ``pre`` modulo ``sf``: at ``sf`` 2, ``pre`` 0
    the first sample is data and repeats for every clamped tap.
    """
    if k > 255:
        raise ValueError(f'{k} taps: the tap index has 8 bits')
    n = n_lr * sf
    hr = np.clip(np.arange(out_len(n, k))[:, None] - k // 2
                 + np.arange(k)[None, :], 0, n - 1)
    data = (hr - pre) % sf == 0
    count = data.sum(1)
    order = np.argsort(~data, axis=1, kind='stable')[:, :count.max()]
    lr = (np.take_along_axis(hr, order, 1) - pre) // sf
    entries = np.where(np.arange(order.shape[1])[None, :] < count[:, None],
                       (lr << 8) | order, -1)
    return np.ascontiguousarray(entries.T, dtype=np.int32)


_tables: dict = {}


def _up_tables(n_lr: int, sf: int, pre: int, k: int, device):
    """(device tap lists, entries a sample) for one axis, cached."""
    key = (n_lr, sf, pre, k, device)
    hit = _tables.get(key)
    if hit is None:
        tab = polyphase_taps(n_lr, sf, pre, k)
        hit = (torch.from_numpy(tab).to(device), tab.shape[0])
        _tables[key] = hit
    return hit


def adjoint_taps(kind: str, n_in: int, sf: int, pre: int, k
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Tables of the adjoint of one axis of a forward map, as
    ``(int32 indices, float64 weights)``, each ``[max entries, n_in]``.

    ``kind`` is the forward map along an axis of ``n_in`` input samples,
    with taps ``k`` and replicate borders: ``'E'`` the same-size filter,
    ``'D'`` the filter kept at samples ``pre, pre + sf, ...`` (HR in, LR
    out), ``'U'`` the filter of the zero-stuffed signal (LR in, ``n_in *
    sf`` HR out); an even tap count grows the output axis by one sample
    (:func:`out_len`).  Entry ``e`` of adjoint output ``i`` (an input sample of
    the forward) is the ``e``-th forward output, ascending, whose taps meet
    sample ``i``, with the sum of those taps' weights (in float64: at a
    clamped edge several taps fold onto one sample); index ``-1`` and
    weight 0 after the last entry.
    """
    k = np.asarray(k, np.float64).reshape(-1)
    nk = k.size
    if kind not in ('E', 'D', 'U'):
        raise ValueError(f'kind must be E, D or U, got {kind!r}')
    n_sig = n_in * sf if kind == 'U' else n_in
    pos = np.arange(out_len(n_sig, nk))
    if kind == 'D':
        pos = pos[pre::sf]
    src = np.clip(pos[:, None] - nk // 2 + np.arange(nk)[None, :], 0,
                  n_sig - 1)
    if kind == 'U':
        data = (src - pre) % sf == 0
        src = (src - pre) // sf
    else:
        data = np.ones(src.shape, bool)
    n_out = pos.size
    fwd = np.zeros((n_out, n_in))
    touched = np.zeros((n_out, n_in), bool)
    rows = np.broadcast_to(np.arange(n_out)[:, None], src.shape)[data]
    np.add.at(fwd, (rows, src[data]), np.broadcast_to(k, src.shape)[data])
    touched[rows, src[data]] = True
    count = touched.sum(0)
    width = max(1, int(count.max()) if n_in else 1)
    order = np.argsort(~touched.T, axis=1, kind='stable')[:, :width]
    live = np.arange(width)[None, :] < count[:, None]
    idx = np.where(live, order, -1)
    w = np.where(live, np.take_along_axis(fwd.T, order, 1), 0.0)
    return (np.ascontiguousarray(idx.T, dtype=np.int32),
            np.ascontiguousarray(w.T))


BAND = 4  # outputs of a band (the kernel's kBand)


@dataclasses.dataclass(frozen=True)
class AxisTable:
    """One axis of a :func:`sepfilter_taps` product, on a device: output
    ``i`` is ``sum_e w[e, i] * input[idx[e, i]]`` over ``n_in`` input
    samples (``idx`` -1 and ``w`` 0 after an output's last entry), the
    plain version's tables.  ``lo`` and ``hi`` bound the input samples that
    each tile of ``tile`` outputs reads (int32, one per tile): those its
    outputs read, widened to at least ``width``; ``span`` is the largest
    ``hi - lo + 1``.

    The kernel's tables: the outputs in bands of :data:`BAND` (``tile`` a
    multiple of it, the last tile's padded with zero weights).  A band
    reads ``width`` consecutive input samples from ``base`` (int32, one a
    band, inside its tile's ``[lo, hi]``); ``band`` holds their weights,
    ``[bands, width, BAND]``, 0 where an output does not read a sample.
    ``width`` is the widest band's reach, the same for every band, so the
    kernel's loops have fixed trip counts."""
    idx: torch.Tensor
    w: torch.Tensor
    n_in: int
    tile: int
    lo: torch.Tensor
    hi: torch.Tensor
    span: int
    base: torch.Tensor
    band: torch.Tensor
    width: int

    @classmethod
    def build(cls, idx: np.ndarray, w: np.ndarray, n_in: int, tile: int,
              device, dtype=torch.float32) -> 'AxisTable':
        if tile % BAND:
            raise ValueError(f'tile {tile} is not a multiple of {BAND}')
        n_ent, n_out = idx.shape
        tiles = max(1, -(-n_out // tile))
        n_pad = tiles * tile
        ix = np.pad(idx, ((0, 0), (0, n_pad - n_out)), constant_values=-1)
        wx = np.pad(np.where(idx >= 0, w, 0), ((0, 0), (0, n_pad - n_out)))
        live = ix >= 0
        bands = ix.reshape(n_ent, -1, BAND)
        bl = bands >= 0
        b_lo = np.where(bl, bands, n_in).min((0, 2))
        b_hi = np.where(bl, bands, -1).max((0, 2))
        width = max(1, int((b_hi - b_lo).max()) + 1)
        t = ix.reshape(n_ent, tiles, tile)
        tl = live.reshape(n_ent, tiles, tile)
        lo = np.where(tl, t, n_in).min((0, 2))
        hi = np.where(tl, t, -1).max((0, 2))
        empty = hi < 0
        lo[empty], hi[empty] = 0, 0
        # every tile reads at least width samples (width <= n_in)
        hi = np.minimum(n_in - 1, np.maximum(hi, lo + width - 1))
        lo = np.maximum(0, np.minimum(lo, hi - width + 1))
        per_band = tile // BAND
        t_lo = np.repeat(lo, per_band)
        b_lo = np.where(b_hi >= 0, b_lo, t_lo)
        base = np.clip(b_lo, t_lo, np.repeat(hi, per_band) - width + 1)
        out_band = np.repeat(np.arange(n_pad // BAND), BAND)
        u = ix - np.repeat(base, BAND)[None, :]
        band = np.zeros((n_pad // BAND, width, BAND))
        e, o = np.nonzero(live)
        band[out_band[o], u[e, o], o % BAND] = wx[e, o]

        def put(a, **kw):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                device=device, **kw)
        return cls(put(idx), put(w, dtype=dtype), n_in, tile,
                   put(lo.astype(np.int32)), put(hi.astype(np.int32)),
                   int((hi - lo).max()) + 1, put(base.astype(np.int32)),
                   put(band, dtype=dtype), width)


# The H100 SXM's streaming multiprocessors: an adjoint launch takes the
# first of its kind's output tiles that gives it two blocks an SM
_SMS = 132
# adjoint output tiles (rows, columns), multiples of BAND, in order of
# preference, by the forward's kind: E^T (LR, same size: the column pass
# runs at tw + k - 1 input columns, so wide tiles waste least), D^T (LR
# -> HR: tall tiles, whose column bands share their few input rows), U^T
# (HR -> LR: a band of rows across the whole width reads its input rows
# whole, which device memory serves fastest)
_ADJ_TILES = {'E': ((8, 64), (8, 32), (8, 16), (4, 16), (4, 8)),
              'D': ((64, 64), (32, 64), (16, 64), (16, 32), (8, 32),
                    (8, 16)),
              'U': ((4, 128), (8, 32), (8, 16), (4, 16), (4, 8))}


def adjoint_tile(kind: str, n_h: int, n_w: int, batch: int
                 ) -> tuple[int, int]:
    """The output tile of an adjoint launch on ``batch`` images of ``n_h x
    n_w`` outputs: the first of the kind's tiles whose grid has at least
    two blocks an SM, else the last, the smallest (a small output fills
    fewer SMs, with the shortest chains)."""
    for th, tw in _ADJ_TILES[kind]:
        if batch * -(-n_h // th) * -(-n_w // tw) >= 2 * _SMS:
            return th, tw
    return _ADJ_TILES[kind][-1]


class AdjointTables:
    """The adjoint tables of one separable filter: :func:`adjoint_taps` of
    its float64 host taps, as :class:`AxisTable` pairs kept by kind, input
    shape, ``sf``, ``pre``, device, weight dtype and the launch's output
    tile (:func:`adjoint_tile`, from the batch).

    The owner of the taps keeps one (``CEMFilters`` does, built from the
    numpy filters), so a backward neither copies the taps from the device
    nor builds a table twice; :meth:`of` copies them from the device for a
    caller that holds only the tensors."""

    def __init__(self, kcol, krow):
        self.host = tuple(np.asarray(k, np.float64).reshape(-1)
                          for k in (kcol, krow))
        self._cache: dict = {}

    @classmethod
    def of(cls, kcol: torch.Tensor, krow: torch.Tensor) -> 'AdjointTables':
        return cls(*(k.detach().cpu().numpy() for k in (kcol, krow)))

    def get(self, kind: str, n_h: int, n_w: int, sf: int,
            pre: tuple[int, int], device, dtype=torch.float32,
            batch: int = 1) -> tuple[AxisTable, AxisTable]:
        """(row, column) tables that take :func:`sepfilter_taps` to the
        adjoint of the ``kind`` map whose input is ``n_h x n_w``, tiled
        for a launch on ``batch`` images."""
        tile = adjoint_tile(kind, n_h, n_w, batch)
        key = (kind, n_h, n_w, sf, tuple(pre), torch.device(device), dtype,
               tile)
        hit = self._cache.get(key)
        if hit is None:
            hit = tuple(
                AxisTable.build(*adjoint_taps(kind, n, sf, p, k),
                                _forward_len(kind, n, sf, p, k.size), t,
                                device, dtype)
                for n, p, k, t in zip((n_h, n_w), pre, self.host, tile))
            self._cache[key] = hit
        return hit


def _forward_len(kind: str, n: int, sf: int, pre: int, k: int) -> int:
    """Outputs of the forward map ``kind`` along an axis of ``n`` inputs:
    the inputs of its adjoint."""
    if kind == 'U':
        return out_len(n * sf, k)
    m = out_len(n, k)
    return len(range(pre, m, sf)) if kind == 'D' else m


def _axis_product(x: torch.Tensor, tab: AxisTable, dim: int
                  ) -> torch.Tensor:
    shape = [1] * x.dim()
    shape[dim] = tab.idx.shape[1]
    out = None
    for e in range(tab.idx.shape[0]):
        term = x.index_select(dim, tab.idx[e].clamp(min=0)) * \
            tab.w[e].to(x.dtype).view(shape)
        out = term if out is None else out + term
    return out


def sepfilter_taps_plain(x: torch.Tensor, rows: AxisTable,
                         cols: AxisTable) -> torch.Tensor:
    """Plain version of :func:`sepfilter_taps`: ``index_select`` and the
    weights, along H (entries ascending) and then along W."""
    return _axis_product(_axis_product(x, rows, 1), cols, 2)


def sepfilter_taps(x: torch.Tensor, rows: AxisTable, cols: AxisTable
                   ) -> torch.Tensor:
    """``out[n,i,j,c] = sum_e rows.w[e,i] * sum_f cols.w[f,j] *
    x[n, rows.idx[e,i], cols.idx[f,j], c]`` on NHWC ``x``.

    A CPU tensor goes to :func:`sepfilter_taps_plain`; a CUDA tensor (fp32)
    launches the kernel on the tables' bands: for each output tile a
    column pass from the input into shared memory, then a row pass into
    the output, in fp32 FMA."""
    if x.dim() != 4 or x.shape[1] != rows.n_in or x.shape[2] != cols.n_in:
        raise ValueError(f'x {tuple(x.shape)} does not match the tables '
                         f'({rows.n_in} x {cols.n_in} inputs)')
    if x.device.type == 'cpu':
        return sepfilter_taps_plain(x, rows, cols)
    if x.device.type != 'cuda':
        raise ValueError(f'unsupported device {x.device}')
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError('x must be contiguous fp32 NHWC')
    for t in (rows, cols):
        if t.band.device != x.device or t.band.dtype != torch.float32:
            raise ValueError('tables must be fp32, on the device of x')
    n, _, _, c = x.shape
    hout, wout = rows.idx.shape[1], cols.idx.shape[1]
    out = x.new_empty((n, hout, wout, c))
    if out.numel() == 0:
        return out
    lib = build.load('sepfilter', _SIGNATURES)
    smem = lib.exsr_sepfilter_taps_smem(c, rows.tile, cols.tile,
                                        rows.width, cols.width, cols.span)
    _check_smem(smem, f'sepfilter_taps at C={c}, tile {rows.tile} x '
                f'{cols.tile}, {cols.span} input columns')
    err = lib.exsr_sepfilter_taps(
        x.data_ptr(), out.data_ptr(), rows.base.data_ptr(),
        rows.band.data_ptr(), cols.base.data_ptr(), cols.band.data_ptr(),
        cols.lo.data_ptr(), cols.hi.data_ptr(), n, x.shape[1], x.shape[2],
        c, hout, wout, rows.width, cols.width, rows.tile, cols.tile,
        cols.span, _stream(x))
    build.check(lib, err, 'sepfilter_taps')
    sepfilter_taps.launches += 1
    return out


_float64_cpu = False


@contextlib.contextmanager
def float64_reference():
    """Within the block the entry points take float64 tensors on the CPU,
    where their plain versions compute in the input's dtype (the taps stay
    the fp32 values the kernels use): a float64 reference for a
    computation that runs in fp32.  CUDA tensors stay fp32 only."""
    global _float64_cpu
    saved, _float64_cpu = _float64_cpu, True
    try:
        yield
    finally:
        _float64_cpu = saved


def _check(x: torch.Tensor, kcol: torch.Tensor, krow: torch.Tensor,
           name: str = 'x') -> None:
    dtypes = (torch.float32, torch.float64) if _float64_cpu and \
        x.device.type == 'cpu' else (torch.float32,)
    if x.dim() != 4 or x.dtype not in dtypes:
        raise ValueError(f'{name} must be fp32 [B, H, W, C], got {x.dtype} '
                         f'{tuple(x.shape)}')
    if not x.is_contiguous():
        raise ValueError(f'{name} must be contiguous NHWC')
    for kname, k in (('kcol', kcol), ('krow', krow)):
        if k.dim() != 1 or k.dtype != torch.float32 or k.numel() == 0:
            raise ValueError(f'{kname} must be a non-empty 1-D fp32 tensor')
        if k.device != x.device:
            raise ValueError(f'{kname} is on {k.device}, {name} on '
                             f'{x.device}')


def _check_device(x) -> None:
    """Raise for a device that the kernels do not take (a CPU tensor runs
    the plain version)."""
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'unsupported device {x.device}')


def _check_smem(smem: int, what: str) -> None:
    if smem > 227 * 1024:
        raise ValueError(f'{what} needs {smem} bytes of shared memory, more '
                         'than a block has')


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _edge_kernel(x, kcol, krow):
    kh, kw = kcol.numel(), krow.numel()
    b, h, w, c = x.shape
    lib = build.load('sepfilter', _SIGNATURES)
    _check_smem(lib.exsr_sepfilter_edge_smem(c, kh, kw),
                f'sepfilter_edge with {kh}+{kw} taps at C={c}')
    out = x.new_empty((b, out_len(h, kh), out_len(w, kw), c))
    kcol, krow = kcol.contiguous(), krow.contiguous()
    err = lib.exsr_sepfilter_edge(
        x.data_ptr(), out.data_ptr(), kcol.data_ptr(), krow.data_ptr(),
        b, h, w, c, kh, kw, _stream(x))
    build.check(lib, err, 'sepfilter_edge')
    sepfilter_edge.launches += 1
    return out


def _down_kernel(x, kcol, krow, sf, pre):
    kh, kw = kcol.numel(), krow.numel()
    b, h, w, c = x.shape
    ho = len(range(pre[0], out_len(h, kh), sf))
    wo = len(range(pre[1], out_len(w, kw), sf))
    out = x.new_empty((b, ho, wo, c))
    if out.numel() == 0:
        return out
    lib = build.load('sepfilter', _SIGNATURES)
    _check_smem(lib.exsr_sepfilter_down_smem(c, kh, kw, sf),
                f'sepfilter_down with {kh}+{kw} taps at C={c}, sf {sf}')
    kcol, krow = kcol.contiguous(), krow.contiguous()
    err = lib.exsr_sepfilter_down(
        x.data_ptr(), out.data_ptr(), kcol.data_ptr(), krow.data_ptr(),
        b, h, w, c, kh, kw, sf, pre[0], pre[1], ho, wo, _stream(x))
    build.check(lib, err, 'sepfilter_down')
    sepfilter_down.launches += 1
    return out


def _up_kernel(a, kcol, krow, sf, pre, b=None, g=None):
    n, h, w, c = a.shape
    kh, kw = kcol.numel(), krow.numel()
    rtab, maxr = _up_tables(h, sf, pre[0], kh, a.device)
    ctab, maxc = _up_tables(w, sf, pre[1], kw, a.device)
    lib = build.load('sepfilter', _SIGNATURES)
    combine = b is not None
    _check_smem(lib.exsr_sepfilter_up_smem(c, kh, kw, sf, maxr, maxc,
                                           int(combine)),
                f'sepfilter_up with {kh}+{kw} taps at C={c}, sf {sf}')
    out = a.new_empty((n, out_len(h * sf, kh), out_len(w * sf, kw), c))
    kcol, krow = kcol.contiguous(), krow.contiguous()
    err = lib.exsr_sepfilter_up(
        a.data_ptr(), b.data_ptr() if combine else None,
        g.data_ptr() if combine else None, out.data_ptr(), kcol.data_ptr(),
        krow.data_ptr(), rtab.data_ptr(), ctab.data_ptr(), n, h, w, c, kh,
        kw, sf, pre[0], pre[1], maxr, maxc, _stream(a))
    build.check(lib, err, 'sepfilter_up')
    sepfilter_up.launches += 1
    return out


def _maps(kind, kcol, krow, sf, pre, n_h, n_w, adjoint=None):
    """``(A, A^T)`` for the map ``kind`` (``'E'``, ``'D'``, ``'U'``) on
    inputs of ``n_h x n_w``, each a function of one NHWC tensor: ``A`` is
    the plain version on the CPU and the kernel on CUDA, ``A^T``
    :func:`sepfilter_taps` on the tables of ``adjoint`` (made from the
    taps when None), float64 weights for float64 input (the plain
    version), fp32 otherwise."""
    plain, kernel, extra = {
        'E': (sepfilter_edge_plain, _edge_kernel, ()),
        'D': (sepfilter_down_plain, _down_kernel, (sf, pre)),
        'U': (sepfilter_up_plain, _up_kernel, (sf, pre))}[kind]

    def forward(x):
        return (plain if x.device.type == 'cpu' else kernel)(
            x, kcol, krow, *extra)

    def transpose(y):
        tabs = adjoint if adjoint is not None else \
            AdjointTables.of(kcol, krow)
        dtype = torch.float64 if y.dtype == torch.float64 else torch.float32
        return sepfilter_taps(y, *tabs.get(kind, n_h, n_w, sf, pre,
                                           y.device, dtype, y.shape[0]))
    return forward, transpose


class _Linear(torch.autograd.Function):
    """``A x`` for a linear map given as ``(A, A^T)``: the backward applies
    ``A^T`` through this Function with the two swapped, so the adjoint's
    own backward is ``A`` again (gradients of gradients)."""

    @staticmethod
    def forward(ctx, x, a, a_t):
        ctx.maps = (a, a_t)
        return a(x)

    @staticmethod
    def backward(ctx, gy):
        a, a_t = ctx.maps
        return _Linear.apply(gy.contiguous(), a_t, a), None, None


def _linear(kind, x, kcol, krow, sf=1, pre=(0, 0), adjoint=None):
    return _Linear.apply(x, *_maps(kind, kcol, krow, sf, pre, x.shape[1],
                                   x.shape[2], adjoint))


class _UpCombine(torch.autograd.Function):
    """``U a + (g - U b)``; the gradients of ``a`` and ``b`` share one
    ``U^T`` (``a_bar = U^T g_bar``, ``b_bar = -a_bar``, ``g`` passes
    ``g_bar`` through)."""

    @staticmethod
    def forward(ctx, a, b, g, combine, u, u_t):
        ctx.maps = (u, u_t)
        return combine(a, b, g)

    @staticmethod
    def backward(ctx, gy):
        u, u_t = ctx.maps
        need_a, need_b, need_g = ctx.needs_input_grad[:3]
        ga = gb = None
        if need_a or need_b:
            t = _Linear.apply(gy.contiguous(), u_t, u)
            ga = t if need_a else None
            gb = -t if need_b else None
        return ga, gb, gy if need_g else None, None, None, None


def _up_combine(a, b, g, kcol, krow, sf, pre, adjoint=None):
    def combine(a, b, g):
        if a.device.type == 'cpu':
            return sepfilter_up_plain(a, kcol, krow, sf, pre, b, g)
        return _up_kernel(a, kcol, krow, sf, pre, b, g)
    return _UpCombine.apply(a, b, g, combine,
                            *_maps('U', kcol, krow, sf, pre, a.shape[1],
                                   a.shape[2], adjoint))


def sepfilter_edge(x: torch.Tensor, kcol: torch.Tensor, krow: torch.Tensor,
                   adjoint: AdjointTables | None = None) -> torch.Tensor:
    """Separable edge-clamped correlation of fp32 NHWC ``x``.

    A CPU tensor goes to :func:`sepfilter_edge_plain`; a CUDA tensor
    launches the kernel.  An axis with an even tap count grows by one
    sample (:func:`out_len`).  Differentiable in
    ``x`` (the taps take no gradient): the backward launches
    :func:`sepfilter_taps` on CUDA, on the tables of ``adjoint`` (the
    taps' :class:`AdjointTables`; made from the taps when None).
    """
    _check(x, kcol, krow)
    _check_device(x)
    return _linear('E', x, kcol, krow, adjoint=adjoint)


def sepfilter_down(x: torch.Tensor, kcol: torch.Tensor, krow: torch.Tensor,
                   sf: int, pre: tuple[int, int],
                   adjoint: AdjointTables | None = None) -> torch.Tensor:
    """``aliased_subsample(sepfilter_edge(x, kcol, krow), sf, pre)``: HR in,
    LR out.  CPU: :func:`sepfilter_down_plain`; CUDA: the down kernel, which
    computes the kept outputs only.  Differentiable in ``x``, as
    :func:`sepfilter_edge`."""
    _check(x, kcol, krow)
    _check_device(x)
    return _linear('D', x, kcol, krow, sf, tuple(pre), adjoint)


def sepfilter_up(a: torch.Tensor, kcol: torch.Tensor, krow: torch.Tensor,
                 sf: int, pre: tuple[int, int], b: torch.Tensor | None = None,
                 g: torch.Tensor | None = None,
                 adjoint: AdjointTables | None = None) -> torch.Tensor:
    """``sepfilter_edge(zero_stuff(a, sf, pre), kcol, krow)``: LR in, HR
    out, grown by one sample along an axis with an even tap count.  With
    ``b`` (LR, as ``a``) and ``g`` (HR, the size of the output):
    ``U(a) + (g - U(b))``; a ``g`` of another size raises, as ``exsr``'s
    ``enforce`` fails on it.
    CPU: :func:`sepfilter_up_plain`; CUDA: the up kernel, which multiplies
    only the taps that land on data.  Differentiable in ``a``, ``b`` and
    ``g``, as :func:`sepfilter_edge`."""
    _check(a, kcol, krow, 'a')
    if (b is None) != (g is None):
        raise ValueError('pass b and g together, or neither')
    n, h, w, c = a.shape
    if b is not None:
        _check(b, kcol, krow, 'b')
        _check(g, kcol, krow, 'g')
        hr = (n, out_len(h * sf, kcol.numel()), out_len(w * sf, krow.numel()),
              c)
        if b.shape != a.shape or g.shape != hr:
            raise ValueError(f'b {tuple(b.shape)} must match a '
                             f'{tuple(a.shape)} and g {tuple(g.shape)} be '
                             f'the x{sf} size of a, {hr}')
    _check_device(a)
    if b is None:
        return _linear('U', a, kcol, krow, sf, tuple(pre), adjoint)
    return _up_combine(a, b, g, kcol, krow, sf, tuple(pre), adjoint)


sepfilter_edge.launches = 0
sepfilter_down.launches = 0
sepfilter_up.launches = 0
sepfilter_taps.launches = 0


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    'exsr_sepfilter_edge': ([_P] * 4 + [_I] * 6 + [_P], _I),
    'exsr_sepfilter_edge_smem': ([_I] * 3, ctypes.c_size_t),
    'exsr_sepfilter_down': ([_P] * 4 + [_I] * 11 + [_P], _I),
    'exsr_sepfilter_down_smem': ([_I] * 4, ctypes.c_size_t),
    'exsr_sepfilter_up': ([_P] * 8 + [_I] * 11 + [_P], _I),
    'exsr_sepfilter_up_smem': ([_I] * 7, ctypes.c_size_t),
    'exsr_sepfilter_taps': ([_P] * 8 + [_I] * 11 + [_P], _I),
    'exsr_sepfilter_taps_smem': ([_I] * 6, ctypes.c_size_t),
}
