"""Probe the fused RDB kernel (``exsr_torch/csrc/rdb.cu``) on the GPU.

Needs an NVIDIA H100 and ``nvcc``; run from the repository root::

    python3 exsr_torch/scripts/rdb_probe.py            # check and time
    python3 exsr_torch/scripts/rdb_probe.py --ablate   # and what each part costs
    python3 exsr_torch/scripts/rdb_probe.py --phases   # and clocks per phase

It prints the card's name and power limit, what ptxas reports for the
kernel (registers, spills, and any "wgmma ... serialized" warning, which is
a fault), the bf16 kernel's error against ``rdb_plain`` at a few shapes, and
its time at the main path's shape (batch 16, 128 x 128, nf 64, gc 32).

``--ablate`` builds copies of the source with one part taken out each (the A
loads, the input staging, the epilogue stores, the weight ring, the wgmmas)
and times them at the same shape.  The copies compute nothing useful; the
time each one saves says what its part costs while everything else runs.
``--phases`` builds a copy that stamps ``clock64`` around each phase in one
block and prints the clocks per conv and warpgroup.  A copy is made by exact
text substitution and the script fails if a pattern no longer matches.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
from exsr_torch.ops.kernels import build  # noqa: E402
from exsr_torch.ops.kernels import rrdb_block as K  # noqa: E402

MAIN = dict(b=16, h=128, w=128, nf=64, gc=32, nz=3)
SHAPES = ((64, 32, 1, 8, 16), (64, 32, 2, 40, 36), (16, 8, 2, 7, 19),
          (32, 16, 3, 9, 70), (64, 32, 2, 3, 5))

# (name, [(old, new), ...]): parts of the bf16 kernel taken out
ABLATIONS = (
    ('no_a_loads', [('      load(Int<q + 2>{});\n    });\n', '    });\n')]),
    ('no_input_staging', [
        ('    load_inputs<TH, TW>(p, feat, ty0, tx0, img);\n'
         '    consumer_sync();', '    consumer_sync();')]),
    ('no_epilogue_stores', [
        ('      if (m >= s.m) continue;\n      const int ry = s.row(m)',
         '      if (m >= s.m || p.H > 0) continue;\n'
         '      const int ry = s.row(m)')]),
    ('no_weight_ring', [
        ('      if (threadIdx.x == kConsumers) produce_weights(p, ring);\n',
         ''),
        ('      if (threadIdx.x >= kConsumers + 32) relay_full(p, ring);\n',
         ''),
        ('    slot_full_wait(wg, r.slot);\n    const uint64_t b',
         '    const uint64_t b'),
        ('      if constexpr (q == 0) mbar_arrive_lane0(release);\n', ''),
        ('  mbar_arrive_lane0(release);\n', '')]),
    ('no_wgmma', [
        ('      Wgmma<N>::run(acc[uu], a[h][uu],\n'
         '                    slot_desc + decltype(sc)::value * '
         '(step_bytes(N) >> 4));',
         '      acc[uu][0] += __uint_as_float(a[h][uu][0] ^ a[h][uu][1] ^ '
         'a[h][uu][2] ^ a[h][uu][3]) + (float)slot_desc;')]),
)

STAMP = ('(blockIdx.x == 3 && blockIdx.y == 5 && blockIdx.z == 2 && '
         '(threadIdx.x & 127) == 0)')
PHASES = [
    ('namespace {\n', 'namespace {\n__device__ long long dbg[64];\n'
     f'#define DBG_ON {STAMP}\n'),
    ('  const uint32_t px_bytes = 2 * p.cs;\n',
     '  const uint32_t px_bytes = 2 * p.cs;\n  long long waited = 0;\n'
     '  if (DBG_ON) dbg[(threadIdx.x >> 7) * 20 + i * 4] = clock64();\n'),
    ('    slot_full_wait(wg, r.slot);\n    const uint64_t b',
     '    const long long c0 = clock64();\n    slot_full_wait(wg, r.slot);\n'
     '    waited += clock64() - c0;\n    const uint64_t b'),
    ('  for (int uu = 0; uu < U; ++uu) keep(acc[uu]);\n',
     '  for (int uu = 0; uu < U; ++uu) keep(acc[uu]);\n'
     '  if (DBG_ON) {\n'
     '    dbg[(threadIdx.x >> 7) * 20 + i * 4 + 1] = clock64();\n'
     '    dbg[(threadIdx.x >> 7) * 20 + i * 4 + 3] = waited;\n  }\n'),
    ('      }\n    }\n  }\n}\n\n// A warpgroup without a unit in conv i',
     '      }\n    }\n  }\n'
     '  if (DBG_ON) dbg[(threadIdx.x >> 7) * 20 + i * 4 + 2] = clock64();\n'
     '}\n\n// A warpgroup without a unit in conv i'),
    ('    load_inputs<TH, TW>(p, feat, ty0, tx0, img);\n'
     '    consumer_sync();',
     '    if (DBG_ON) dbg[40 + (threadIdx.x >> 7)] = clock64();\n'
     '    load_inputs<TH, TW>(p, feat, ty0, tx0, img);\n'
     '    if (DBG_ON) dbg[42 + (threadIdx.x >> 7)] = clock64();\n'
     '    consumer_sync();'),
    ('extern "C" {\n', 'extern "C" {\nint exsr_dbg(long long* dst) {\n'
     '  return (int)cudaMemcpyFromSymbol(dst, dbg, sizeof(dbg));\n}\n'),
]


def weights(gen, nf, gc, nz, dtype, device):
    """Random fp32 RDB parameters (kaiming fan-in x 0.5, nonzero biases),
    packed for ``dtype``."""
    ws, bs = [], []
    for i in range(5):
        cin, cout = nz + nf + i * gc, (gc if i < 4 else nf)
        ws.append(torch.randn(cout, cin, 3, 3, generator=gen, device=device)
                  * 0.5 * (2 / (9 * cin)) ** 0.5)
        bs.append(torch.randn(cout, generator=gen, device=device) * 0.1)
    return K.pack_rdb(ws, bs, dtype)


def inputs(gen, b, h, w, nf, nz, device):
    x = torch.randn(b, h, w, nf, generator=gen, device=device).bfloat16()
    z = (torch.rand(b, h, w, nz, generator=gen, device=device) * 2
         - 1).bfloat16()
    return x, z


def time_us(fn, sets, iters=20, reps=3):
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


def ptxas_lines(log):
    return [ln.strip() for ln in log.splitlines()
            if any(k in ln for k in ('registers', 'spill', 'C75'))]


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
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.exsr_rdb.argtypes = [ptr] * 6 + [i32] * 8 + [ptr]
    lib.exsr_rdb.restype = i32
    return lib, ptxas_lines(done.stdout + done.stderr)


def raw_launcher(lib, wts, out):
    """The C entry point on the main shape, without the wrapper's checks."""
    cs = K.Z_SLOTS + MAIN['nf'] + 4 * wts.gcp + 8

    def run(x, z):
        err = lib.exsr_rdb(
            x.data_ptr(), z.data_ptr(), None, out.data_ptr(),
            wts.packed.data_ptr(), wts.packed_bias.data_ptr(), MAIN['b'],
            MAIN['h'], MAIN['w'], MAIN['nf'], MAIN['nz'], wts.gcp, cs, 1,
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
    report = build.build(('rdb',))
    for ln in ptxas_lines(report.get('rdb', {}).get('ptxas', '')):
        print(ln)
    gen = torch.Generator(device=dev).manual_seed(0)
    for nf, gc, b, h, w in SHAPES:
        wts = weights(gen, nf, gc, 3, torch.bfloat16, dev)
        x, z = inputs(gen, b, h, w, nf, 3, dev)
        out = K.rdb(x, z, wts)
        torch.cuda.synchronize()
        ref = K.rdb_plain(x, z, wts).float()
        diff = (out.float() - ref).abs()
        excess = (diff - (2 ** -7 * ref.abs() + 2 ** -9)).max().item()
        print(f'nf {nf} gc {gc} {b}x{h}x{w}: max err {diff.max().item():.4g}'
              f' beyond 2^-7|ref|+2^-9 by {excess:.4g} (<= 0 passes), '
              f'share differing {(diff > 0).float().mean().item():.4g}')
        if excess > 0:
            raise RuntimeError('rdb[bf16] beyond its tolerance')
    wts = weights(gen, MAIN['nf'], MAIN['gc'], MAIN['nz'], torch.bfloat16,
                  dev)
    sets = [inputs(gen, MAIN['b'], MAIN['h'], MAIN['w'], MAIN['nf'],
                   MAIN['nz'], dev) for _ in range(2)]
    us = time_us(lambda x, z: K.rdb(x, z, wts), sets)
    print('rdb[bf16] us', ' '.join(f'{t:.1f}' for t in us))
    if not {'--ablate', '--phases'} & set(sys.argv[1:]):
        return
    source = (build.CSRC / 'rdb.cu').read_text()
    out = torch.empty_like(sets[0][0])
    with tempfile.TemporaryDirectory() as tmp:
        if '--ablate' in sys.argv[1:]:
            for name, subs in (('as_is', []), *ABLATIONS):
                lib, info = build_copy(source, subs, tmp, name)
                us = time_us(raw_launcher(lib, wts, out), sets, reps=2)
                print(f'{name}: us', ' '.join(f'{t:.1f}' for t in us),
                      [ln for ln in info if 'C75' in ln or 'bfloat' in ln])
        if '--phases' in sys.argv[1:]:
            lib, _ = build_copy(source, PHASES, tmp, 'phases')
            run = raw_launcher(lib, wts, out)
            run(*sets[0])
            torch.cuda.synchronize()
            buf = np.zeros(64, dtype=np.int64)
            lib.exsr_dbg.argtypes = [ctypes.c_void_p]
            if lib.exsr_dbg(buf.ctypes.data):
                raise RuntimeError('reading the stamps failed')
            t0 = buf[40]
            print('clocks in block (3, 5, 2): input staging',
                  buf[42] - buf[40], buf[43] - buf[41])
            for wg in range(2):
                for i in range(5):
                    s0, s1, s2, waited = buf[wg * 20 + i * 4:][:4]
                    print(f'warpgroup {wg} conv {i}: starts at {s0 - t0}, '
                          f'main loop {s1 - s0}, of it waiting for weights '
                          f'{waited}, epilogue {s2 - s1}')


if __name__ == '__main__':
    main()
