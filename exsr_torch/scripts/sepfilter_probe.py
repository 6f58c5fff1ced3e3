"""Probe the CEM filter kernels (``exsr_torch/csrc/sepfilter.cu``) on the GPU.

Needs an NVIDIA H100 and ``nvcc``; run from the repository root::

    python3 exsr_torch/scripts/sepfilter_probe.py                # check, time
    python3 exsr_torch/scripts/sepfilter_probe.py --variants     # and copies
    python3 exsr_torch/scripts/sepfilter_probe.py --baseline OLD/sepfilter.cu

It prints the card's name and power limit, what ptxas reports for each
kernel instance (registers, spills), then one JSON line per entry point at
the main path's shapes (batch 16, x4 bicubic CEM), checked and timed by
``exsr_torch.ops.kernels.measure.sepfilter_kernels``, as ``chip_smoke.py``
phase 3 does, plus the same-size kernel's graph replay at HR.

``--variants`` builds copies of the source with one tiling choice changed
or one pass taken out (by exact text substitution; the script fails if a
pattern no longer matches) and times the entry points with each, in the
same process; a copy without a pass computes nothing useful, so only the
tiling copies are held to the plain versions.

``--baseline`` builds another version of ``sepfilter.cu`` (an older
commit's, with the same C entry points) and times its same-size, down and
up kernels against this one's, by CUDA events and by graph replay, in the
order baseline, this, this, baseline.
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
from exsr_torch.ops.kernels.measure import sepfilter_kernels  # noqa: E402

BATCH, LR, SCALE = 16, 128, 4
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
)


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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--variants', action='store_true')
    parser.add_argument('--baseline', metavar='SEPFILTER_CU')
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
    with tempfile.TemporaryDirectory() as tmp:
        if args.baseline:
            with open(args.baseline) as f:
                old = build_copy(f.read(), (), tmp, 'baseline')
            for order in range(4):
                if order in (0, 3):
                    with build.substitute('sepfilter', old):
                        show(run(cases=ENTRY_POINTS, references=False),
                             variant='baseline', order=order)
                else:
                    show(run(cases=ENTRY_POINTS, references=False),
                         variant=None, order=order)
        if args.variants:
            source = (build.CSRC / 'sepfilter.cu').read_text()
            for name, subs in VARIANTS:
                with build.substitute('sepfilter', build_copy(
                        source, subs, tmp, name)):
                    show(run(verify='_no_' not in name, references=False),
                         variant=name)
    print(json.dumps({'ok': True}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
