"""Probe the stage-4 epilogue kernel (``exsr_torch/csrc/stage4.cu``) on the GPU.

Needs an NVIDIA H100 and ``nvcc``; run from the repository root::

    python3 exsr_torch/scripts/stage4_probe.py            # check and time
    python3 exsr_torch/scripts/stage4_probe.py --ablate   # and what parts cost

It prints the card's name and power limit, what ptxas reports for the
kernels (registers, spills, and any ``C75..`` line), the error of both
dtypes against ``stage4_plain`` at the GPU test's shapes and the main shape,
and the bf16 kernel's time at the main path's shape (batch 16, 128 x 128,
gc 32, nf 64, P widths 192/160/128/96) by CUDA events on inputs that
arrive cold (two input sets of 218 MB each, more than L2 holds), with its
bytes per second and its share of the byte bound.

``--ablate`` builds copies of the source with one part taken out each and
times them at the same shape: ``no_mma`` (the A and B fragments are loaded
but not multiplied), ``no_conv`` (no fragment loads and no products) and
``no_compute`` (neither the conv nor the epilogue: the copies in, the
barriers and the stores out).  The copies compute nothing useful; the time
each saves says what its part costs while the rest runs.  Two working
copies try a lever each: ``three_stages`` (a ring of three stages instead
of two) and ``mma_not_volatile`` (the compiler may move the products
between the fragment loads).  A copy is made by
exact text substitution and the script fails if a pattern no longer
matches.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
from exsr_torch.ops.kernels import build  # noqa: E402
from exsr_torch.ops.kernels import stage4 as K  # noqa: E402

MAIN = dict(b=16, h=128, w=128, gc=32, nf=64)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published rate
# (b, h, w, gc, nf): the GPU test's shapes, then the main shape
SHAPES = ((2, 40, 36, 32, 64), (2, 7, 19, 8, 16), (1, 1, 1, 32, 64),
          (2, 3, 130, 16, 48), (3, 129, 17, 8, 64), (1, 9, 9, 6, 32),
          (16, 128, 128, 32, 64))

ABLATIONS = (
    ('no_mma', [(
        '            mma_bf16(acc[mt][0], a[mt], b[0], b[1]);\n'
        '            mma_bf16(acc[mt][1], a[mt], b[2], b[3]);\n',
        '            acc[mt][0][0] += __uint_as_float(a[mt][0] ^ a[mt][1] ^ '
        'a[mt][2] ^ a[mt][3] ^ b[0] ^ b[1] ^ b[2] ^ b[3]);\n')]),
    ('no_conv', [('for (int tap = 0; tap < 9; ++tap) {',
                  'for (int tap = 0; tap < 9 * (a.H < 0); ++tap) {')]),
    ('no_compute', [('    if (computes) {\n',
                     '    if (computes && a.H < 0) {\n')]),
    ('three_stages', [
        ('for (int s = 2; s >= 1; --s)', 'for (int s = 3; s >= 1; --s)'),
        ('    case 2: return launch_mma<NF, 2>(a, stream);\n',
         '    case 3: return launch_mma<NF, 3>(a, stream);\n'
         '    case 2: return launch_mma<NF, 2>(a, stream);\n')]),
    ('mma_not_volatile', [('  asm volatile(\n      "mma.sync',
                           '  asm(\n      "mma.sync')]),
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


def main_bytes():
    m = MAIN
    return 2 * m['b'] * m['h'] * m['w'] * (m['gc'] + 6 * m['nf']) \
        + 2 * 9 * m['gc'] * m['nf'] + 4 * m['nf']


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


def build_copy(source, subs, directory, name):
    """Compile ``source`` with ``subs`` applied; returns the loaded library
    and ptxas's report."""
    for old, new in subs:
        if source.count(old) != 1:
            raise RuntimeError(f'{name}: pattern matches '
                               f'{source.count(old)} times: {old!r}')
        source = source.replace(old, new)
    cu, so = (os.path.join(directory, name + ext) for ext in ('.cu', '.so'))
    with open(cu, 'w') as f:
        f.write(source)
    done = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, '-o', so,
                           cu], capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f'{name}: nvcc failed\n{done.stdout}{done.stderr}')
    lib = ctypes.CDLL(so)
    for fn, (argtypes, restype) in K._SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    # the main path's instantiation: nf 64, two ring stages
    return lib, ptxas_lines(done.stdout + done.stderr, 'stage4_kernelILi64ELi2')


def raw_launcher(lib, out):
    """The C entry point on the main shape, without the wrapper's checks."""
    m = MAIN

    def run(c3, p0, p1, p2, p3, x, w4, b4):
        err = lib.exsr_stage4(
            c3.data_ptr(), p0.data_ptr(), p1.data_ptr(), p2.data_ptr(),
            p3.data_ptr(), x.data_ptr(), w4.data_ptr(), b4.data_ptr(),
            out.data_ptr(), m['b'], m['h'], m['w'], m['gc'], m['nf'],
            *(p.shape[-1] for p in (p0, p1, p2, p3)), 1,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f'launch failed: CUDA error {err}')
    return run


def main():
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
            args = inputs(gen, b, h, w, gc, nf, dtype, dev)
            out = K.stage4(*args)
            torch.cuda.synchronize()
            ref = K.stage4_plain(*args).float()
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
            del args, out, ref, diff
    m = MAIN
    sets = [inputs(gen, m['b'], m['h'], m['w'], m['gc'], m['nf'],
                   torch.bfloat16, dev) for _ in range(2)]
    nbytes = main_bytes()
    bound_us = 1e6 * nbytes / HBM_BYTES_PER_S

    def show(name, us, extra=''):
        best = min(us)
        print(f'{name}: us', ' '.join(f'{t:.1f}' for t in us),
              f'| {nbytes / best / 1e3:.0f} GB/s, bound {bound_us:.1f} us '
              f'= {bound_us / best:.3f} of the time', extra)

    show('stage4[bf16]', time_us(K.stage4, sets))
    if '--ablate' not in sys.argv[1:]:
        return
    source = (build.CSRC / 'stage4.cu').read_text()
    out = torch.empty_like(sets[0][5])
    with tempfile.TemporaryDirectory() as tmp:
        for name, subs in (('as_is', []), *ABLATIONS):
            lib, info = build_copy(source, subs, tmp, name)
            show(name, time_us(raw_launcher(lib, out), sets), info[1:])


if __name__ == '__main__':
    main()
