"""Probe the stage-4 epilogue kernel (``exsr_torch/csrc/stage4.cu``) on the GPU.

Needs an NVIDIA H100 and ``nvcc``; run from the repository root::

    python3 exsr_torch/scripts/stage4_probe.py            # check and time
    python3 exsr_torch/scripts/stage4_probe.py --ablate   # and what parts cost
    python3 exsr_torch/scripts/stage4_probe.py --baseline OLD/stage4.cu

It prints the card's name and power limit, what ptxas reports for the
kernels (registers, spills, and any ``C75..`` line), the error of both
dtypes against ``stage4_plain`` at the GPU test's shapes and the main shape,
and each dtype's time at the main path's shape (batch 16, 128 x 128, gc 32,
nf 64, P widths 192/160/128/96) by CUDA events on inputs that arrive cold
(two input sets, more than L2 holds), with its bytes per second and its
share of its bound (bytes in bf16, operations in fp32); fp32 also at the
edit crop (batch 1, LR 56).

``--ablate [NAME ...]`` builds copies of the source with one part taken
out each (all of them, or the ones named) and times them at the same
shape.  bf16: ``no_mma`` (the A and B fragments are loaded but not
multiplied), ``no_conv`` (no fragment loads and no products) and
``no_compute`` (neither the conv nor the epilogue: the copies in, the
barriers and the stores out).  fp32: ``fp32_no_conv`` (no shared loads and
no FMAs: the c3 copies, the partial sums, x and the stores),
``fp32_no_part`` (the producers sum no P slices) and ``fp32_hoisted`` (the
FMA loop with its shared loads hoisted out of it: the FMAs alone).  The
copies compute nothing useful; the time each saves says what its part
costs while the rest runs.  Working copies try a lever each:
``three_stages`` (bf16 ring of three stages instead of two),
``mma_not_volatile`` (the compiler may move the products between the
fragment loads), ``fp32_b_reuse`` (fma_conv.cuh's FMAs with a weight
reused across the pixels instead of a pixel across the outputs) and
``fp32_unroll_1`` / ``fp32_unroll_4`` (its channel loop unrolled 1 or 4
steps instead of 2).  A copy is made by exact text substitution and the
script fails if a pattern no longer matches.  ``--keep DIR`` builds the
copies into DIR and leaves them there (for ``cuobjdump -sass``).

``--baseline`` builds another version of ``stage4.cu`` (an older commit's,
with the same C entry points; ``git show <commit>:exsr_torch/csrc/stage4.cu``
into a gitignored directory) and times both dtypes of it against this one
in the same process, in the order baseline, this, this, baseline.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
from exsr_torch.ops.kernels import build  # noqa: E402
from exsr_torch.ops.kernels import stage4 as K  # noqa: E402
from exsr_torch.ops.kernels.measure import (BF16_FLOPS,  # noqa: E402
                                            FP32_FLOPS, HBM_BYTES_PER_S)

MAIN = dict(b=16, h=128, w=128, gc=32, nf=64)
EDIT = dict(MAIN, b=1, h=56, w=56)
# (b, h, w, gc, nf): the GPU test's shapes, then the main shape
SHAPES = ((2, 40, 36, 32, 64), (2, 7, 19, 8, 16), (1, 1, 1, 32, 64),
          (2, 3, 130, 16, 48), (3, 129, 17, 8, 64), (1, 9, 9, 6, 32),
          (1, 56, 56, 32, 64), (16, 128, 128, 32, 64))

ABLATIONS = (
    ('no_mma', [(
        '            mma_bf16(acc[mt][0], a[mt], b[0], b[1]);\n'
        '            mma_bf16(acc[mt][1], a[mt], b[2], b[3]);\n',
        '            acc[mt][0][0] += __uint_as_float(a[mt][0] ^ a[mt][1] ^ '
        'a[mt][2] ^ a[mt][3] ^ b[0] ^ b[1] ^ b[2] ^ b[3]);\n')], ()),
    ('no_conv', [('for (int tap = 0; tap < 9; ++tap) {\n        const uint32_t',
                  'for (int tap = 0; tap < 9 * (a.H < 0); ++tap) {\n'
                  '        const uint32_t')], ()),
    ('no_compute', [('    if (computes) {\n',
                     '    if (computes && a.H < 0) {\n')], ()),
    ('three_stages', [
        ('for (int s = 2; s >= 1; --s)', 'for (int s = 3; s >= 1; --s)'),
        ('    case 2: return launch_mma<NF, 2>(a, stream);\n',
         '    case 3: return launch_mma<NF, 3>(a, stream);\n'
         '    case 2: return launch_mma<NF, 2>(a, stream);\n')], ()),
    ('mma_not_volatile', [('  asm volatile(\n      "mma.sync',
                           '  asm(\n      "mma.sync')], ()),
    ('fp32_no_conv', [('kFN, 32,\n                          kp);',
                       'kFN, 32,\n                          kp * (a.H < 0));')],
     ()),
    ('fp32_no_part', [('      fma_fill_part(a, part, f, tid);\n', '')], ()),
    ('fp32_no_swap', [], [('constexpr bool kSwapPairs = true;',
                           'constexpr bool kSwapPairs = false;')]),
    ('fp32_hoisted', [], [
        ('#pragma unroll 2\n  for (int k = 0; k < k_n; k += 4) {\n'
         '    float4 av[PX];\n',
         '  float4 av[PX];\n  float4 bv[4][NV];\n  {\n    const int k = 0;\n'),
        ('    float4 bv[4][NV];\n', ''),
        ('v * b_next);\n#pragma unroll\n    for (int kk = 0; kk < 4; ++kk) {\n',
         'v * b_next);\n  }\n#pragma unroll 2\n'
         '  for (int k = 0; k < k_n; k += 4) {\n#pragma unroll\n'
         '    for (int kk = 0; kk < 4; ++kk) {\n')]),
    ('fp32_unroll_1', [], [('#pragma unroll 2\n  for (int k = 0;',
                            '#pragma unroll 1\n  for (int k = 0;')]),
    ('fp32_unroll_4', [], [('#pragma unroll 2\n  for (int k = 0;',
                            '#pragma unroll 4\n  for (int k = 0;')]),
)


def inputs(gen, b, h, w, gc, nf, dtype, device):
    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=device).to(dtype)
    c3 = rnd(b, h, w, gc)
    # the trunk's P widths; rounded up to a multiple of 8 channels (which
    # the kernel needs) where gc is not one
    ps = [rnd(b, h, w, nf + k * -(-gc // 8) * 8) for k in (4, 3, 2, 1)]
    x = rnd(b, h, w, nf)
    w4 = (torch.randn(3, 3, gc, nf, generator=gen, device=device) * 0.1
          * (2.0 / (9 * gc)) ** 0.5).to(dtype)
    b4 = torch.randn(nf, generator=gen, device=device) * 0.1
    return (c3, *ps, x, w4, b4)


def shape_bound(shape, dtype):
    """(bytes, bound in us, 'bytes' or 'operations') of one call: c3, the
    four nf-wide P reads, x and out once, w4 and b4; 2 * 9 * gc * nf flops
    a pixel."""
    size = 2 if dtype == torch.bfloat16 else 4
    pix = shape['b'] * shape['h'] * shape['w']
    gc, nf = shape['gc'], shape['nf']
    nbytes = size * (pix * (gc + 6 * nf) + 9 * gc * nf) + 4 * nf
    flops = 2 * 9 * gc * nf * pix
    peak = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return nbytes, 1e6 * max(t_bytes, t_ops), (
        'bytes' if t_bytes >= t_ops else 'operations')


def time_us(fn, sets, iters=40, reps=3):
    for args in sets:
        fn(*args)
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for i in range(iters):
            fn(*sets[i % len(sets)])
        end.record()
        torch.cuda.synchronize()
        out.append(1e3 * start.elapsed_time(end) / iters)
    return out


def ptxas_lines(log, kernel=''):
    """ptxas's entry, register, spill and C75.. lines, of the kernels whose
    mangled name contains ``kernel``."""
    lines, keep = [], True
    for ln in log.splitlines():
        if 'Compiling entry function' in ln:
            keep = kernel in ln
        if keep and any(k in ln for k in ('Compiling entry', 'registers',
                                          'spill', 'C75')):
            lines.append(ln.strip())
    return lines


def load_copy(source, subs, header_subs, directory, name,
              header_dir=None):
    """A copy of the source built by ``build.build_copy``, with the
    wrapper's signatures; returns it and ptxas's report of the main path's
    instantiations (bf16: nf 64, two ring stages; the fp32 kernel)."""
    lib, log = build.build_copy(source, subs, directory, name, header_subs,
                                header_dir)
    sigs = dict(K._SIGNATURES, exsr_cuda_error_string=(
        [ctypes.c_int], ctypes.c_char_p))
    for fn, (argtypes, restype) in sigs.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib, (ptxas_lines(log, 'stage4_kernelILi64ELi2')
                 + ptxas_lines(log, 'stage4_fma_kernel'))


def raw_launcher(lib, out, shape, dtype):
    """The C entry point at ``shape``, without the wrapper's checks."""
    def run(c3, p0, p1, p2, p3, x, w4, b4):
        err = lib.exsr_stage4(
            c3.data_ptr(), p0.data_ptr(), p1.data_ptr(), p2.data_ptr(),
            p3.data_ptr(), x.data_ptr(), w4.data_ptr(), b4.data_ptr(),
            out.data_ptr(), shape['b'], shape['h'], shape['w'], shape['gc'],
            shape['nf'], *(p.shape[-1] for p in (p0, p1, p2, p3)),
            int(dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f'launch failed: CUDA error {err}')
    return run


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--ablate', nargs='*', metavar='NAME',
                        help='all copies, or the ones named')
    parser.add_argument('--keep', metavar='DIR',
                        help='build the copies into DIR and keep them')
    parser.add_argument('--baseline', metavar='STAGE4_CU')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('stage4_probe: CUDA is not available', file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda')
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip())
    report = build.build(('stage4',))
    for ln in ptxas_lines(report.get('stage4', {}).get('ptxas', '')):
        print(ln)
    gen = torch.Generator(device=dev).manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        for b, h, w, gc, nf in SHAPES:
            xs = inputs(gen, b, h, w, gc, nf, dtype, dev)
            out = K.stage4(*xs)
            torch.cuda.synchronize()
            ref = K.stage4_plain(*xs).float()
            diff = (out.float() - ref).abs()
            if dtype == torch.float32:
                excess = diff.max().item() - 1e-5
            else:  # one bf16 ulp
                excess = (diff - 2 ** -7 * (1 + ref.abs())).max().item()
            print(f'{dtype} {b}x{h}x{w} gc {gc} nf {nf}: max err '
                  f'{diff.max().item():.4g}, beyond the tolerance by '
                  f'{excess:.4g} (<= 0 passes), share differing '
                  f'{(diff > 0).float().mean().item():.4g}')
            if excess > 0:
                raise RuntimeError(f'stage4[{dtype}] beyond its tolerance')
            del xs, out, ref, diff

    def show(name, us, shape, dtype, extra=''):
        nbytes, bound_us, by = shape_bound(shape, dtype)
        best = min(us)
        print(f'{name}: us', ' '.join(f'{t:.1f}' for t in us),
              f'| {nbytes / best / 1e3:.0f} GB/s, bound {bound_us:.1f} us '
              f'({by}) = {bound_us / best:.3f} of the time', extra,
              flush=True)

    cases = {}
    for tag, dtype, shape in (('bf16', torch.bfloat16, MAIN),
                              ('fp32', torch.float32, MAIN),
                              ('fp32_edit', torch.float32, EDIT)):
        sets = [inputs(gen, shape['b'], shape['h'], shape['w'], shape['gc'],
                       shape['nf'], dtype, dev) for _ in range(2)]
        cases[tag] = (dtype, shape, sets)
        show(f'stage4[{tag}]', time_us(K.stage4, sets), shape, dtype)
    if args.ablate is None and not args.baseline:
        return 0
    with (contextlib.nullcontext(args.keep) if args.keep
          else tempfile.TemporaryDirectory()) as tmp:
        if args.baseline:
            old, _ = load_copy(Path(args.baseline).read_text(), (), (), tmp,
                               'baseline', Path(args.baseline).parent)
            new, _ = load_copy((build.CSRC / 'stage4.cu').read_text(), (),
                               (), tmp, 'this')
            for tag, (dtype, shape, sets) in cases.items():
                out = torch.empty_like(sets[0][5])
                for order, (name, lib) in enumerate(
                        (('baseline', old), ('this', new), ('this', new),
                         ('baseline', old))):
                    show(f'stage4[{tag}] {name} (order {order})',
                         time_us(raw_launcher(lib, out, shape, dtype), sets),
                         shape, dtype)
                del out
        if args.ablate is not None:
            source = (build.CSRC / 'stage4.cu').read_text()
            for name, subs, hsubs in (('as_is', [], ()), *ABLATIONS):
                if args.ablate and name not in args.ablate:
                    continue
                lib, info = load_copy(source, subs, hsubs, tmp, name)
                for tag in (('fp32',) if name.startswith('fp32')
                            else ('bf16', 'fp32')):
                    dtype, shape, sets = cases[tag]
                    out = torch.empty_like(sets[0][5])
                    show(f'{name} [{tag}]', time_us(
                        raw_launcher(lib, out, shape, dtype), sets), shape,
                        dtype, [ln for ln in info if 'registers' in ln])
                    del out
    return 0


if __name__ == '__main__':
    sys.exit(main())
