"""Probe the CEM filter kernels (``exsr_torch/csrc/sepfilter.cu``) on the GPU.

Needs an NVIDIA H100 and ``nvcc``; run from the repository root::

    python3 exsr_torch/scripts/sepfilter_probe.py                # check, time
    python3 exsr_torch/scripts/sepfilter_probe.py --variants [NAME ...]
    python3 exsr_torch/scripts/sepfilter_probe.py --baseline OLD/sepfilter.cu
    python3 exsr_torch/scripts/sepfilter_probe.py --tiles

It prints the card's name and power limit, what ptxas reports for each
kernel instance (registers, spills), then one JSON line per entry point at
the main path's shapes (batch 16, x4 bicubic CEM), checked and timed by
``exsr_torch.ops.kernels.measure.sepfilter_kernels``, as ``chip_smoke.py``
phase 3 does, plus the same-size kernel's graph replay at HR; then one line
per adjoint of ``sepfilter_taps`` (U^T, E^T, D^T) at the edit crop (batch
1, LR 56), the training shape (batch 16, LR 52) and the main shape (batch
16, LR 128), checked and timed by ``measure.sepfilter_taps_kernels``
beside the plain version and the library chain.

``--variants`` builds copies of the source with one tiling choice changed
or one pass taken out (by exact text substitution; the script fails if a
pattern no longer matches) and times the entry points (the adjoints, for a
``taps_`` copy) with each, in the same process: all copies, or those
named.  A copy without a pass computes nothing useful, so only the tiling
copies are held to the plain versions.  ``taps_phases`` is a copy of the
adjoint with clock stamps: per adjoint and shape, its blocks' mean time,
how many ran at once, and the clocks of their phases.

``--tiles`` times each adjoint at each shape at every output tile of its
kind's list (``sepfilter._ADJ_TILES``), by graph replay, beside the tile
that ``adjoint_tile`` picks.

``--baseline`` builds another version of ``sepfilter.cu`` (an older
commit's, with the same C entry points) and times its same-size, down and
up kernels and its adjoints against this one's, by CUDA events and by
graph replay, in the order baseline, this, this, baseline.  A source
whose ``exsr_sepfilter_taps_smem`` takes four arguments has the first
adjoint design's interface (tables ``[entries, n_out]`` ending in -1,
indices not rebased, fixed tiles): its adjoints run on tables built that
way from the same ``adjoint_taps``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
from exsr_torch.cem.cem import CEM, CEMConf  # noqa: E402
from exsr_torch.ops.kernels import build  # noqa: E402
from exsr_torch.ops.kernels import sepfilter as K  # noqa: E402
from exsr_torch.ops.kernels.measure import (  # noqa: E402
    cuda_ms, graph_ms, sepfilter_kernels, sepfilter_taps_kernels, taps_inputs)

BATCH, LR, SCALE = 16, 128, 4
# the adjoints' shapes: (tag, batch, LR)
TAPS_SHAPES = (('edit', 1, 56), ('train', 16, 52), ('main', BATCH, LR))
# the first adjoint design's fixed output tiles, by the forward's kind
FIRST_TAPS_TILE = {'E': (16, 64), 'D': (32, 64), 'U': (8, 16)}
# the entry points a baseline build is timed on
ENTRY_POINTS = ('sepfilter_edge[hr]', 'sepfilter_edge[lr]', 'sepfilter_down',
                'sepfilter_up[up]', 'sepfilter_up[combine]')

# copies with one tiling choice changed, or with one pass taken out (those
# compute nothing useful: the time they save is what the pass costs while
# the rest runs)
VARIANTS = (
    ('edge_tile_32_rows', [('constexpr int kEdgeTileH = 16;',
                            'constexpr int kEdgeTileH = 32;')]),
    ('edge_no_passes', [('    if (ch >= TH / kR) break;',
                         '    if (ch >= TH / kR || kh > 0) break;'),
                        ('  for (int it = threadIdx.x; it < items; '
                         'it += kThreads) {',
                         '  for (int it = threadIdx.x; it < items * 0; '
                         'it += kThreads) {')]),
    ('down_no_passes', [('  for (int q = threadIdx.x; q < lx; q += kThreads) {',
                         '  for (int q = threadIdx.x; q < lx * 0; '
                         'q += kThreads) {'),
                        ('    for (int s = 0; s < kw; ++s) acc = ',
                         '    for (int s = 0; s < 0; ++s) acc = ')]),
    ('up_tile_32_columns', [('constexpr int kUpTileW = 64;',
                             'constexpr int kUpTileW = 32;')]),
    ('staging_through_registers', [
        ('      cp_async4(dst + left + f, src + in0 * C + f);',
         '      dst[left + f] = __ldg(src + in0 * C + f);')]),
    ('up_no_column_pass', [('      if (v < 0) break;\n      const float k =',
                            '      if (v < 0 || e >= 0) break;\n'
                            '      const float k =')]),
    ('up_no_row_pass', [('          if (e >= n) break;',
                         '          if (e >= 0) break;')]),
    # the adjoint: 4 input columns a thread in the column pass, 8 rows a
    # thread in the row pass; without both passes (the bands staged, no
    # output written), the passes without their loops over a band's
    # samples (the stores left), and without the row pass
    ('taps_4_columns', [('constexpr int kTapsQ = 2;',
                         'constexpr int kTapsQ = 4;')]),
    ('taps_8_rows', [('constexpr int kTapsRows = 4;',
                      'constexpr int kTapsRows = 8;')]),
    ('taps_no_passes', [
        ('  for (int it = warp; it < rbands * ngrp; it += kWarps) {',
         '  for (int it = warp; it < rbands * ngrp * 0; it += kWarps) {'),
        ('  for (int it = warp; it < rgroups * fchunks; it += kWarps) {',
         '  for (int it = warp; it < rgroups * fchunks * 0; '
         'it += kWarps) {')]),
    ('taps_no_band_loops', [
        ('    for (int u = 0; u < ur; ++u) {',
         '    for (int u = 0; u < ur * 0; ++u) {'),
        ('    for (int u = 0; u < uc; ++u) {',
         '    for (int u = 0; u < uc * 0; ++u) {')]),
    ('taps_no_row_pass', [
        ('  for (int it = warp; it < rgroups * fchunks; it += kWarps) {',
         '  for (int it = warp; it < rgroups * fchunks * 0; '
         'it += kWarps) {')]),
)

# the adjoint with clock stamps: each block's start and end on the global
# timer, its SM, and the clocks of its bands' staging, column pass and row
# pass (stores included), read back by exsr_taps_stamps
TAPS_STAMPS = 1 << 16
PHASES = [
    ('__device__ __forceinline__ void cp_async16(',
     f'__device__ unsigned long long g_taps_stamps[6 * {TAPS_STAMPS}];\n'
     '__device__ __forceinline__ unsigned long long gtime() {\n'
     '  unsigned long long t;\n'
     '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));\n'
     '  return t;\n}\n\n'
     '__device__ __forceinline__ void cp_async16('),
    ('  float* out = p.out + (size_t)blockIdx.z * p.hout * p.wout * C;\n',
     '  float* out = p.out + (size_t)blockIdx.z * p.hout * p.wout * C;\n'
     '  const unsigned long long g0 = gtime();\n'
     '  const long long k0 = clock64();\n'),
    ('  cp_async_wait_all();\n  __syncthreads();\n\n  // column pass,',
     '  cp_async_wait_all();\n  __syncthreads();\n'
     '  const long long k1 = clock64();\n\n  // column pass,'),
    ('  __syncthreads();\n\n  // row pass: a warp',
     '  __syncthreads();\n  const long long k2 = clock64();\n\n'
     '  // row pass: a warp'),
    ('            dst[((size_t)r * p.wout + g) * C] = acc[g][r];\n'
     '    }\n  }\n}',
     '            dst[((size_t)r * p.wout + g) * C] = acc[g][r];\n'
     '    }\n  }\n  __syncthreads();\n'
     '  const unsigned b = blockIdx.x + gridDim.x * (blockIdx.y + '
     'gridDim.y * blockIdx.z);\n'
     f'  if (threadIdx.x == 0 && b < {TAPS_STAMPS}) {{\n'
     '    unsigned smid;\n'
     '    asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));\n'
     '    unsigned long long* o = g_taps_stamps + 6 * b;\n'
     '    o[0] = g0; o[1] = gtime(); o[2] = k1 - k0; o[3] = k2 - k1;\n'
     '    o[4] = clock64() - k2; o[5] = smid;\n  }\n}'),
    ('const char* exsr_cuda_error_string(int err) {',
     'int exsr_taps_stamps(void* host, int n) {\n'
     '  return (int)cudaMemcpyFromSymbol(host, g_taps_stamps, '
     '(size_t)n * 6 * 8);\n}\n\n'
     'const char* exsr_cuda_error_string(int err) {'),
]


def build_copy(source, subs, directory, name):
    """Compile ``source`` with ``subs`` applied (``build.build_copy``);
    returns the loaded library with the wrapper's signatures of the
    functions it exports."""
    lib, _ = build.build_copy(source, subs, directory, name)
    sigs = dict(K._SIGNATURES, exsr_cuda_error_string=([ctypes.c_int],
                                                       ctypes.c_char_p))
    for fn, (argtypes, restype) in sigs.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
    return lib


def show(results, **tags):
    for name, rec in results.items():
        print(json.dumps({'name': name, **tags, **rec}), flush=True)


def first_design_taps(lib, y, rows, cols, kind):
    """The first adjoint design's launch on ``lib``: ``sepfilter_taps`` of
    ``y`` on the plain tables (``[entries, n_out]``, -1 after the last
    entry) with that design's fixed tile and staged bounds."""
    th, tw = FIRST_TAPS_TILE[kind]

    def bounds(t, tile):
        # the input samples that each tile of outputs reads, and the most
        n_ent, n_out = t.idx.shape
        tiles = -(-n_out // tile)
        ix = torch.full((n_ent, tiles * tile), -1, dtype=torch.int32,
                        device=t.idx.device)
        ix[:, :n_out] = t.idx
        ix = ix.view(n_ent, tiles, tile)
        live = ix >= 0
        lo = torch.where(live, ix, t.n_in).amin((0, 2))
        hi = torch.where(live, ix, -1).amax((0, 2))
        lo[hi < 0], hi[hi < 0] = 0, 0
        return (lo.int().contiguous(), hi.int().contiguous(),
                int((hi - lo).max()) + 1)
    (rlo, rhi, rspan), (clo, chi, cspan) = bounds(rows, th), bounds(cols, tw)
    n, _, _, ch = y.shape
    out = y.new_empty((n, rows.idx.shape[1], cols.idx.shape[1], ch))

    def launch(y):
        err = lib.exsr_sepfilter_taps(
            y.data_ptr(), out.data_ptr(), rows.idx.data_ptr(),
            rows.w.data_ptr(), cols.idx.data_ptr(), cols.w.data_ptr(),
            rlo.data_ptr(), rhi.data_ptr(), clo.data_ptr(), chi.data_ptr(),
            n, y.shape[1], y.shape[2], ch, out.shape[1], out.shape[2],
            rows.idx.shape[0], cols.idx.shape[0], th, tw, rspan, cspan,
            K._stream(y))
        build.check(lib, err, 'first-design sepfilter_taps')
        return out
    return launch


def taps_baseline(lib, first_design, filt, gen, dev, **tags):
    """One line per adjoint and shape for a baseline build: checked
    against the plain version (1e-5 of the largest output) and timed by
    events and graph replay."""
    for tag, batch, lr in TAPS_SHAPES:
        for kind, (y, rows, cols, _) in taps_inputs(filt, batch, lr, gen,
                                                    dev).items():
            if first_design:
                fn = first_design_taps(lib, y, rows, cols, kind)
            else:
                def fn(y, rows=rows, cols=cols):
                    with build.substitute('sepfilter', lib):
                        return K.sepfilter_taps(y, rows, cols)
            ref = K.sepfilter_taps_plain(y, rows, cols)
            err = ((fn(y) - ref).abs().max() / ref.abs().max()).item()
            if err > 1e-5:
                raise RuntimeError(f'baseline taps[{kind},{tag}] {err}')
            sets = [(y,)] + [(torch.rand(y.shape, generator=gen,
                                         device=dev),) for _ in range(2)]
            print(json.dumps({
                'name': f'sepfilter_taps[{kind},{tag}]', **tags,
                'max_rel_err': err,
                'ms': cuda_ms(fn, sets, 30),
                'graph_ms': graph_ms(fn, sets, 30)}), flush=True)


def taps_phases(lib, filt, gen, dev):
    """One line per adjoint and shape from the stamped copy: blocks, the
    launch's span on the global timer, a block's mean time, how many
    blocks ran at once on average (over the SMs, and on the busiest SM),
    and the mean clocks of the bands' staging, column pass and row
    pass."""
    import numpy as np
    lib.exsr_taps_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.exsr_taps_stamps.restype = ctypes.c_int
    for tag, batch, lr in TAPS_SHAPES:
        for kind, (y, rows, cols, _) in taps_inputs(filt, batch, lr, gen,
                                                    dev).items():
            with build.substitute('sepfilter', lib):
                K.sepfilter_taps(y, rows, cols)
                torch.cuda.synchronize()
                K.sepfilter_taps(y, rows, cols)
                torch.cuda.synchronize()
            n = min(TAPS_STAMPS, y.shape[0] * -(-rows.idx.shape[1] //
                                               rows.tile)
                    * -(-cols.idx.shape[1] // cols.tile))
            st = np.zeros((n, 6), np.uint64)
            build.check(lib, lib.exsr_taps_stamps(st.ctypes.data, n),
                        'stamps')
            st = st.astype(np.float64)
            t0, t1 = st[:, 0].min(), st[:, 1].max()
            dur = st[:, 1] - st[:, 0]
            per_sm = np.bincount(st[:, 5].astype(int), weights=dur)
            print(json.dumps({
                'name': f'sepfilter_taps[{kind},{tag}]', 'variant':
                'taps_phases', 'tile': [rows.tile, cols.tile], 'blocks': n,
                'span_us': (t1 - t0) / 1e3, 'block_us': dur.mean() / 1e3,
                'blocks_at_once_per_sm': dur.sum() / (t1 - t0) / 132,
                'busiest_sm_share': per_sm.max() / (t1 - t0),
                'sms': int((per_sm > 0).sum()),
                'clocks': {'staging': st[:, 2].mean(), 'columns':
                           st[:, 3].mean(), 'rows': st[:, 4].mean()}}),
                flush=True)


def taps_tiles(filt, gen, dev):
    """One line per adjoint, shape and output tile of the kind's list: the
    kernel on tables built for that tile, checked (1e-5 of the largest
    output) and timed by graph replay."""
    for tag, batch, lr in TAPS_SHAPES:
        for kind, (y, rows, cols, _) in taps_inputs(filt, batch, lr, gen,
                                                    dev).items():
            picked = (rows.tile, cols.tile)
            ref = K.sepfilter_taps_plain(y, rows, cols)
            sets = [(y,)] + [(torch.rand(y.shape, generator=gen,
                                         device=dev),) for _ in range(2)]
            for tile in K._ADJ_TILES[kind]:
                r, c = (K.AxisTable.build(t.idx.cpu().numpy(),
                                          t.w.double().cpu().numpy(),
                                          t.n_in, n, dev)
                        for t, n in ((rows, tile[0]), (cols, tile[1])))

                def fn(y, r=r, c=c):
                    return K.sepfilter_taps(y, r, c)
                err = ((fn(y) - ref).abs().max() / ref.abs().max()).item()
                if err > 1e-5:
                    raise RuntimeError(f'taps[{kind},{tag}] at {tile}: {err}')
                print(json.dumps({
                    'name': f'sepfilter_taps[{kind},{tag}]',
                    'variant': 'tiles', 'tile': list(tile),
                    'picked': tile == picked, 'max_rel_err': err,
                    'graph_ms': graph_ms(fn, sets, 30)}), flush=True)


def taps_lines(filt, gen, dev, verify=True, references=True, **tags):
    for tag, batch, lr in TAPS_SHAPES:
        recs = sepfilter_taps_kernels(filt, gen, dev, batch, lr,
                                      verify=verify, references=references)
        show({f'sepfilter_taps[{k},{tag}]': r for k, r in recs.items()},
             **tags)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--variants', nargs='*', metavar='NAME',
                        help='all copies, or those named: ' + ', '.join(
                            [n for n, _ in VARIANTS] + ['taps_phases']))
    parser.add_argument('--baseline', metavar='SEPFILTER_CU')
    parser.add_argument('--tiles', action='store_true')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('sepfilter_probe: CUDA is not available', file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    report = build.build(('sepfilter',))
    for v in report.values():
        for ln in v['ptxas'].splitlines():
            if 'registers' in ln or 'spill' in ln or 'Compiling' in ln:
                print(ln.strip())
    dev = torch.device('cuda', 0)
    filt = CEM.create(CEMConf(scale_factor=SCALE)).device_filters(
        3, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def run(**kw):
        return sepfilter_kernels(filt, gen, dev, BATCH, LR, graph_hr=True,
                                 **kw)
    show(run())
    taps_lines(filt, gen, dev)
    if args.tiles:
        taps_tiles(filt, gen, dev)
    with tempfile.TemporaryDirectory() as tmp:
        if args.baseline:
            with open(args.baseline) as f:
                text = f.read()
            first = ('exsr_sepfilter_taps_smem(int C, int th, int sh, '
                     'int sw)') in text
            old = build_copy(text, (), tmp, 'baseline')
            if first:
                old.exsr_sepfilter_taps.argtypes = (
                    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 12
                    + [ctypes.c_void_p])
            for order in range(4):
                if order in (0, 3):
                    with build.substitute('sepfilter', old):
                        show(run(cases=ENTRY_POINTS, references=False),
                             variant='baseline', order=order)
                    taps_baseline(old, first, filt, gen, dev,
                                  variant='baseline', order=order)
                else:
                    show(run(cases=ENTRY_POINTS, references=False),
                         variant=None, order=order)
                    taps_lines(filt, gen, dev, references=False,
                               variant=None, order=order)
        if args.variants is not None:
            source = (build.CSRC / 'sepfilter.cu').read_text()
            if not args.variants or 'taps_phases' in args.variants:
                taps_phases(build_copy(source, PHASES, tmp, 'taps_phases'),
                            filt, gen, dev)
            for name, subs in VARIANTS:
                if args.variants and name not in args.variants:
                    continue
                with build.substitute('sepfilter', build_copy(
                        source, subs, tmp, name)):
                    # a copy without a pass computes nothing useful
                    verify = '_no_' not in name and '_only' not in name
                    if name.startswith('taps_'):
                        taps_lines(filt, gen, dev, verify=verify,
                                   references=False, variant=name)
                    else:
                        show(run(verify=verify, references=False),
                             variant=name)
    print(json.dumps({'ok': True}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
