"""Probe the fused RDB kernel (``exsr_torch/csrc/rdb.cu``) on the GPU.

Needs an NVIDIA H100 and ``nvcc``; run from the repository root::

    python3 exsr_torch/scripts/rdb_probe.py            # check and time
    python3 exsr_torch/scripts/rdb_probe.py --ablate   # and what each part costs
    python3 exsr_torch/scripts/rdb_probe.py --phases   # and clocks per phase
    python3 exsr_torch/scripts/rdb_probe.py --baseline OLD/rdb.cu

It prints the card's name and power limit, what ptxas reports for the
kernels (registers, spills, and any "wgmma ... serialized" warning, which
is a fault), both dtypes' error against ``rdb_plain`` at a few shapes, and
their time at the main path's shape (batch 16, 128 x 128, nf 64, gc 32)
with the useful and executed TFLOP/s, beside the chain of five cuDNN convs
(``ResidualDenseBlock``, TF32 off) on the same inputs.

``--ablate [NAME ...]`` builds copies of the source with one part taken
out each (all of them, or the ones named) and times them at the same
shape.  bf16: the A loads, the input staging, the epilogue stores, the
weight ring, the wgmmas.  fp32: ``fp32_no_conv`` (no shared loads and no
FMAs: the staging, the weight ring, the epilogues and the halo exchange),
``fp32_no_exchange`` (no strip copies from the other blocks of the
cluster, no waiting for them) and ``fp32_hoisted`` (fma_conv.cuh's loop
with its shared loads hoisted out of it: the FMAs alone).  The copies
compute nothing useful; the time each one saves says what its part costs
while everything else runs.  Working copies try a lever each:
``fp32_b_reuse`` (the FMAs with a weight reused across the pixels instead
of a pixel across the outputs) and ``fp32_unroll_1`` / ``fp32_unroll_4``
(the channel loop unrolled 1 or 4 steps instead of 2).  ``--phases``
builds copies that stamp ``clock64`` around each phase in one block and
prints the clocks: per conv and warpgroup for bf16; per conv (its weight
chunks, the part of them spent waiting for weights, its epilogue and
exchange) and the input staging for fp32.  A copy is made by exact text
substitution and the script fails if a pattern no longer matches.
``--keep DIR`` builds the copies into DIR and leaves them there (for
``cuobjdump -sass``).

``--baseline`` builds another version of ``rdb.cu`` (an older commit's,
with the same C entry points; ``git show <commit>:exsr_torch/csrc/rdb.cu``
into a gitignored directory) and times both dtypes of it against this one
in the same process, in the order baseline, this, this, baseline; the
baseline's fp32 body takes the pixel stride of its own layout.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
from exsr_torch.device import full_fp32  # noqa: E402
from exsr_torch.models.rrdb import ResidualDenseBlock  # noqa: E402
from exsr_torch.ops.kernels import build  # noqa: E402
from exsr_torch.ops.kernels import rrdb_block as K  # noqa: E402
from exsr_torch.ops.kernels.measure import (BF16_FLOPS,  # noqa: E402
                                            FP32_FLOPS)

MAIN = dict(b=16, h=128, w=128, nf=64, gc=32, nz=3)
# (nf, gc, b, h, w): ragged tiles and clusters, images smaller than a tile,
# the edit crops
SHAPES = ((64, 32, 1, 8, 16), (64, 32, 2, 40, 36), (16, 8, 2, 7, 19),
          (32, 16, 3, 9, 70), (64, 32, 2, 3, 5), (64, 32, 1, 56, 56),
          (64, 32, 1, 17, 33))

# (name, [(old, new), ...] in rdb.cu, [...] in fma_conv.cuh)
ABLATIONS = (
    ('no_a_loads', [('      load(Int<q + 2>{});\n    });\n', '    });\n')],
     ()),
    ('no_input_staging', [
        ('    load_inputs<TH, TW>(p, feat, ty0, tx0, img);\n'
         '    consumer_sync();', '    consumer_sync();')], ()),
    ('no_epilogue_stores', [
        ('      if (m >= s.m) continue;\n      const int ry = s.row(m)',
         '      if (m >= s.m || p.H > 0) continue;\n'
         '      const int ry = s.row(m)')], ()),
    ('no_weight_ring', [
        ('      if (threadIdx.x == kConsumers) produce_weights(p, ring);\n',
         ''),
        ('      if (threadIdx.x >= kConsumers + 32) relay_full(p, ring);\n',
         ''),
        ('    slot_full_wait(wg, r.slot);\n    const uint64_t b',
         '    const uint64_t b'),
        ('      if constexpr (q == 0) mbar_arrive_lane0(release);\n', ''),
        ('  mbar_arrive_lane0(release);\n', '')], ()),
    ('no_wgmma', [
        ('      Wgmma<N>::run(acc[uu], a[h][uu],\n'
         '                    slot_desc + decltype(sc)::value * '
         '(step_bytes(N) >> 4));',
         '      acc[uu][0] += __uint_as_float(a[h][uu][0] ^ a[h][uu][1] ^ '
         'a[h][uu][2] ^ a[h][uu][3]) + (float)slot_desc;')], ()),
    ('fp32_no_conv', [('          hn);', '          hn * (p.H < 0));')], ()),
    ('fp32_no_exchange', [
        ('    mbar_wait_cluster(ready + 8 * i);\n', ''),
        ('idx < (2 * wn - 1) * words;', 'idx < (2 * wn - 1) * words * '
         '(p.H < 0);')], ()),
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
    ('      }\n    }\n  }\n}\n\n// A warpgroup\'s share of conv i',
     '      }\n    }\n  }\n'
     '  if (DBG_ON) dbg[(threadIdx.x >> 7) * 20 + i * 4 + 2] = clock64();\n'
     '}\n\n// A warpgroup\'s share of conv i'),
    ('    load_inputs<TH, TW>(p, feat, ty0, tx0, img);\n'
     '    consumer_sync();',
     '    if (DBG_ON) dbg[40 + (threadIdx.x >> 7)] = clock64();\n'
     '    load_inputs<TH, TW>(p, feat, ty0, tx0, img);\n'
     '    if (DBG_ON) dbg[42 + (threadIdx.x >> 7)] = clock64();\n'
     '    consumer_sync();'),
    ('extern "C" {\n', 'extern "C" {\nint exsr_dbg(long long* dst) {\n'
     '  return (int)cudaMemcpyFromSymbol(dst, dbg, sizeof(dbg));\n}\n'),
]



# fp32: clock64 stamps of thread 0 of one block, per conv: its start, the
# end of its chunks, the clocks spent waiting for weights, the end of its
# epilogue and exchange; and the input staging
STAMP32 = '(blockIdx.x == 3 && blockIdx.y == 5 && blockIdx.z == 2 && ' \
    'threadIdx.x == 0)'
PHASES_FP32 = [
    ('namespace {\n', 'namespace {\n__device__ long long dbg[64];\n'
     f'#define DBG_ON {STAMP32}\n'),
    ('  float4 acc[PX][NV] = {};\n  for (int tap = 0; tap < 9; ++tap) {',
     '  float4 acc[PX][NV] = {};\n  long long waited = 0;\n'
     '  if (DBG_ON) dbg[4 * i] = clock64();\n'
     '  for (int tap = 0; tap < 9; ++tap) {'),
    ('      mbar_wait(r.full(r.slot), r.phase);\n      fma_conv',
     '      const long long c0 = clock64();\n'
     '      mbar_wait(r.full(r.slot), r.phase);\n'
     '      waited += clock64() - c0;\n      fma_conv'),
    ('  if (half) {\n#pragma unroll\n    for (int j = 0; j < PX; ++j)',
     '  if (DBG_ON) {\n    dbg[4 * i + 1] = clock64();\n'
     '    dbg[4 * i + 2] = waited;\n  }\n'
     '  if (half) {\n#pragma unroll\n    for (int j = 0; j < PX; ++j)'),
    ('    fp32_consumer_sync();\n  }\n  cluster.sync();\n}',
     '    fp32_consumer_sync();\n    if (DBG_ON) dbg[4 * i + 3] = clock64();\n'
     '  }\n  if (DBG_ON) dbg[19] = clock64();\n  cluster.sync();\n}'),
    ('  // [z | x] on the whole buffer, zero outside the image\n',
     '  if (DBG_ON) dbg[40] = clock64();\n'),
    ('extern "C" {\n', 'extern "C" {\nint exsr_dbg(long long* dst) {\n'
     '  return (int)cudaMemcpyFromSymbol(dst, dbg, sizeof(dbg));\n}\n'),
]


def weights(gen, nf, gc, nz, dtype, device):
    """Random fp32 RDB parameters (kaiming fan-in x 0.5, nonzero biases),
    packed for ``dtype``, and the parameters."""
    ws, bs = [], []
    for i in range(5):
        cin, cout = nz + nf + i * gc, (gc if i < 4 else nf)
        ws.append(torch.randn(cout, cin, 3, 3, generator=gen, device=device)
                  * 0.5 * (2 / (9 * cin)) ** 0.5)
        bs.append(torch.randn(cout, generator=gen, device=device) * 0.1)
    return K.pack_rdb(ws, bs, dtype), (ws, bs)


def inputs(gen, b, h, w, nf, nz, dtype, device):
    x = torch.randn(b, h, w, nf, generator=gen, device=device).to(dtype)
    z = (torch.rand(b, h, w, nz, generator=gen, device=device) * 2
         - 1).to(dtype)
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
            if any(k in ln for k in ('Compiling entry', 'registers', 'spill',
                                     'C75'))]


def load_copy(source, subs, header_subs, directory, name,
              header_dir=None):
    """A copy of the source built by ``build.build_copy``, with the
    wrapper's signatures; returns it and ptxas's report."""
    lib, log = build.build_copy(source, subs, directory, name, header_subs,
                                header_dir)
    sigs = dict(K._SIGNATURES, exsr_cuda_error_string=(
        [ctypes.c_int], ctypes.c_char_p))
    for fn, (argtypes, restype) in sigs.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib, ptxas_lines(log)


def raw_launcher(lib, wts, out, cs):
    """The C entry point on the main shape, without the wrapper's checks,
    at pixel stride ``cs``."""
    is_bf16 = int(wts.dtype == torch.bfloat16)

    def run(x, z):
        err = lib.exsr_rdb(
            x.data_ptr(), z.data_ptr(), None, out.data_ptr(),
            wts.packed.data_ptr(), wts.packed_bias.data_ptr(), MAIN['b'],
            MAIN['h'], MAIN['w'], MAIN['nf'], MAIN['nz'], wts.gcp, cs,
            is_bf16, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f'launch failed: CUDA error {err}')
    return run


def check(out, ref, dtype, what):
    diff = (out.float() - ref.float()).abs()
    if dtype == torch.float32:
        excess = diff.max().item() - 1e-5
    else:
        excess = (diff - (2 ** -7 * ref.float().abs() + 2 ** -9)).max().item()
    print(f'{what}: max err {diff.max().item():.4g}, beyond the tolerance '
          f'by {excess:.4g} (<= 0 passes), share differing '
          f'{(diff > 0).float().mean().item():.4g}', flush=True)
    if excess > 0:
        raise RuntimeError(f'rdb[{dtype}] beyond its tolerance')


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--ablate', nargs='*', metavar='NAME',
                        help='all copies, or the ones named')
    parser.add_argument('--phases', action='store_true')
    parser.add_argument('--keep', metavar='DIR',
                        help='build the copies into DIR and keep them')
    parser.add_argument('--baseline', metavar='RDB_CU')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('rdb_probe: CUDA is not available', file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda')
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip())
    report = build.build(('rdb',))
    for ln in ptxas_lines(report.get('rdb', {}).get('ptxas', '')):
        print(ln)
    gen = torch.Generator(device=dev).manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        for nf, gc, b, h, w in SHAPES:
            wts, _ = weights(gen, nf, gc, 3, dtype, dev)
            x, z = inputs(gen, b, h, w, nf, 3, dtype, dev)
            x0 = torch.randn(x.shape, generator=gen, device=dev).to(dtype)
            out, out_x0 = K.rdb(x, z, wts), K.rdb(x, z, wts, x0=x0)
            torch.cuda.synchronize()
            check(out, K.rdb_plain(x, z, wts), dtype,
                  f'{dtype} nf {nf} gc {gc} {b}x{h}x{w}')
            if not torch.equal(out_x0, K.mul_in_dtype(out, 0.2) + x0):
                raise RuntimeError(f'rdb[{dtype}]: the outer residual '
                                   'differs from the elementwise op')
    m = MAIN
    pix = m['b'] * m['h'] * m['w']
    cins = [m['nz'] + m['nf'] + i * m['gc'] for i in range(5)]
    couts = [m['gc']] * 4 + [m['nf']]
    useful = 2 * 9 * pix * sum(ci * co for ci, co in zip(cins, couts))
    executed = {torch.bfloat16: K.executed_flops_bf16(
        m['b'], m['h'], m['w'], m['nf'], m['gc']),
        torch.float32: K.executed_flops_fp32(
            m['b'], m['h'], m['w'], m['nf'], m['gc'], m['nz'])}
    cases = {}

    def show(name, us, dtype, extra=''):
        best = min(us)
        peak = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
        print(f'{name}: us', ' '.join(f'{t:.1f}' for t in us),
              f'| {useful / best / 1e6:.1f} TFLOP/s useful, '
              f'{executed[dtype] / best / 1e6:.1f} executed; bound '
              f'{1e6 * useful / peak:.1f} us', extra, flush=True)

    for dtype in (torch.bfloat16, torch.float32):
        tag = 'bf16' if dtype == torch.bfloat16 else 'fp32'
        wts, (ws, bs) = weights(gen, m['nf'], m['gc'], m['nz'], dtype, dev)
        sets = [inputs(gen, m['b'], m['h'], m['w'], m['nf'], m['nz'], dtype,
                       dev) for _ in range(2)]
        cases[tag] = (dtype, wts, sets)
        show(f'rdb[{tag}]', time_us(lambda x, z: K.rdb(x, z, wts), sets),
             dtype)
        chain = ResidualDenseBlock(m['nf'], m['gc'], m['nz']).to(dev)
        with torch.no_grad():
            for i in range(5):
                getattr(chain, f'conv{i}').weight.copy_(ws[i])
                getattr(chain, f'conv{i}').bias.copy_(bs[i])
        chain = chain.to(dtype).to(memory_format=torch.channels_last)
        with torch.inference_mode(), full_fp32():
            show(f'cudnn_chain[{tag}]', time_us(chain, [
                (x.permute(0, 3, 1, 2), z.permute(0, 3, 1, 2))
                for x, z in sets]), dtype)
        del chain
    if args.ablate is None and not (args.phases or args.baseline):
        return 0

    def stride(dtype, old=False):
        if old and dtype == torch.float32 and 'rdb_fma_kernel' not in \
                Path(args.baseline).read_text():
            # the first fp32 body's odd stride, z in 16 slots
            return K.Z_SLOTS + m['nf'] + 4 * cases['fp32'][1].gcp + 1
        return K.pixel_stride(m['nf'], m['nz'], -(-m['gc'] // 16) * 16,
                              dtype == torch.bfloat16)

    with (contextlib.nullcontext(args.keep) if args.keep
          else tempfile.TemporaryDirectory()) as tmp:
        if args.baseline:
            old, _ = load_copy(Path(args.baseline).read_text(), (), (), tmp,
                               'baseline', Path(args.baseline).parent)
            new, _ = load_copy((build.CSRC / 'rdb.cu').read_text(), (), (),
                               tmp, 'this')
            for tag, (dtype, wts, sets) in cases.items():
                out = torch.empty_like(sets[0][0])
                for order, (name, lib) in enumerate(
                        (('baseline', old), ('this', new), ('this', new),
                         ('baseline', old))):
                    run = raw_launcher(lib, wts, out,
                                       stride(dtype, name == 'baseline'))
                    run(*sets[0])
                    torch.cuda.synchronize()
                    check(out, K.rdb_plain(*sets[0], wts), dtype,
                          f'rdb[{tag}] {name}')
                    show(f'rdb[{tag}] {name} (order {order})',
                         time_us(run, sets, iters=4 if name == 'baseline'
                                 and tag == 'fp32' else 20), dtype)
                del out
        source = (build.CSRC / 'rdb.cu').read_text()
        if args.ablate is not None:
            for name, subs, hsubs in (('as_is', [], ()), *ABLATIONS):
                if args.ablate and name not in args.ablate:
                    continue
                lib, info = load_copy(source, subs, hsubs, tmp, name)
                for tag in (('fp32',) if name.startswith('fp32')
                            else ('bf16', 'fp32') if name == 'as_is'
                            else ('bf16',)):
                    dtype, wts, sets = cases[tag]
                    out = torch.empty_like(sets[0][0])
                    show(f'{name} [{tag}]', time_us(
                        raw_launcher(lib, wts, out, stride(dtype)), sets,
                        reps=2), dtype,
                        [ln for ln in info if 'C75' in ln or 'registers'
                         in ln])
                    del out
        if args.phases:
            dtype, wts, sets = cases['fp32']
            out = torch.empty_like(sets[0][0])
            lib, _ = load_copy(source, PHASES_FP32, (), tmp, 'phases32')
            run = raw_launcher(lib, wts, out, stride(dtype))
            run(*sets[0])
            torch.cuda.synchronize()
            buf = np.zeros(64, dtype=np.int64)
            lib.exsr_dbg.argtypes = [ctypes.c_void_p]
            if lib.exsr_dbg(buf.ctypes.data):
                raise RuntimeError('reading the stamps failed')
            t0 = buf[40]
            print('fp32 clocks in block (3, 5, 2), thread 0: staging',
                  buf[0] - t0, 'total', buf[19] - t0)
            for i in range(5):
                s0, s1, waited, s3 = buf[4 * i:4 * i + 4]
                s3 = buf[19] if i == 4 else s3
                print(f'fp32 conv {i}: chunks {s1 - s0} (waiting for '
                      f'weights {waited}), epilogue and exchange {s3 - s1}')
            dtype, wts, sets = cases['bf16']
            out = torch.empty_like(sets[0][0])
            lib, _ = load_copy(source, PHASES, (), tmp, 'phases')
            run = raw_launcher(lib, wts, out, stride(dtype))
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
    return 0


if __name__ == '__main__':
    sys.exit(main())
