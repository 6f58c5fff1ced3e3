// One residual dense block of the RRDB trunk as one kernel.
//
// Replaces the TPU kernel body _rrdb_kernel (exsr/ops/pallas/rrdb_block.py)
// behind rdb_pallas, rrdb_block_pallas and rrdb_block_chained.  With
// feats = [z, x] along channels:
//
//   c_i = dtype(leaky_relu(conv3x3_SAME(feats, w_i) + b_i, 0.2)),
//         feats = [feats, c_i]                                  (i = 0..3)
//   out = dtype(0.2 * (conv3x3_SAME(feats, w_4) + b_4) + float(x))
//
// and, when x0 is given (the last RDB of an RRDB), the outer residual
// out = dtype(dtype(out * dtype(0.2)) + x0) in the activation dtype.  Each
// conv's input is zero-padded (SAME), so c_i is zero outside the image.
// bf16 or fp32 activations, fp32 accumulation, fp32 biases.
//
// Bound on the H100: operations.  At nf 64, gc 32 a pixel costs 489,600
// flops against 262 bytes in bf16 (~1,900 flops per byte), far above the
// bf16 tensor-core ridge point.
//
// Design.  The TPU kernel keeps a whole zero-bordered image of all 195
// channels in VMEM; an H100 block has 227 KB.  Here one block computes a
// TH x TW output tile.  It stages [z, x] on the tile plus a 5-pixel halo in
// shared memory, one pixel after another, each pixel's channels in slots
// [z (16, zero-padded) | x (nf) | c0 | c1 | c2 | c3] (each c_i gcp =
// round_up(gc, 16) wide), so the dense-block concat is a channel offset.
// Conv i is computed on the tile grown by 4 - i pixels a side (the halo the
// later convs need) and written into its slot; outside the image it writes
// zeros.  conv 4 adds the residual from the staged x and writes the tile to
// device memory.  Intermediates never leave the SM; the cost is recomputing
// the halo: 1.53x the useful work at 8 x 16 (bf16).  The fp32 body cuts it
// with a thread-block cluster (below).
//
// bf16: 8 x 16 tiles, 202 KB of pixels plus a 27 KB weight ring in shared
// memory, one block per SM: two consumer warpgroups, a producer warp and a
// relay warp.  What held the first (mma.sync) version at 9.3x its bound was
// the feeding of the tensor cores, not their rate: operands crossed shared
// memory once per warp, a third of the warp slots idled in the narrow
// convs, and every weight chunk cost a block barrier.  This version:
//  * Products run on wgmma.mma_async m64nNk16 (bf16 in, fp32 accumulate),
//    N the conv's padded output width (16, 32 or 64).  B, the weights, is
//    read by the tensor cores from the ring through a shared-memory
//    descriptor (no-swizzle K-major core matrices, see kernel_layout in the
//    wrapper), once per 64 pixels.  A, the pixels, comes from registers:
//    ldmatrix.x4 on the pixel-major buffer, each lane giving the address of
//    its own region pixel, so M runs over the conv's exact region and the
//    buffer layout is the plain [pixel][slot] one (the pixel stride is an
//    odd number of 16-byte words, so the 8 rows of an ldmatrix hit distinct
//    banks).  Shared traffic is 3 KB per 32,768 multiply-adds.
//  * A conv is split into units of 64 region pixels x N outputs: 6, 5, 4, 3
//    and 2 (conv 4, N = nf) units.  Warpgroup g takes units g, g + 2, g + 4
//    and holds all of them (up to three accumulators) at once, so a conv's
//    weights stream once per block.  Weighted by each conv's (tap,
//    16-channel) steps the two warpgroups are 91 % busy at nf 64, gc 32.
//  * The producer warp's one elected thread streams all five convs' weights
//    with cp.async.bulk into a ring of 3 slots of 9 KB (9 steps of N 32,
//    so no conv ends in a partial slot).  Each slot has a full and an
//    empty mbarrier.  The producer runs ahead across convs: the first
//    weights arrive while the consumers still stage the inputs, and conv
//    i + 1's while they write c_i.  There is no block barrier per chunk,
//    and none that the producer takes part in.
//  * A warpgroup keeps two wgmma groups in flight and loads the A of two
//    steps ahead meanwhile.  ptxas serializes every wgmma of a kernel that
//    branches between the start of a group and its wait, or that runs
//    short of registers there, so the consumers' loop does not poll: the relay
//    warp polls a slot's full mbarrier and passes it on through a named
//    barrier, which blocks in hardware, and a slot is released by an
//    arrive predicated on lane 0.  The loop also runs few instructions
//    besides ldmatrix and wgmma: with two warps on a scheduler each one
//    costs two scheduler slots a step.
//  * The consumers (256 threads) stage [z | x] by cp.async and meet at a
//    named barrier between convs.  c_i is written and read (ldmatrix) in
//    the generic proxy, so no proxy fence is needed for it; the ring is
//    written and read in the asynchronous proxy and ordered by mbarriers.
// What bounds it now: the main loops take 85 % of a tile's time and run at
// about 60 % of what shared-memory bandwidth allows for their 4.5 MB of
// operand reads a tile (A is read once per N = 32 outputs and per tap; 128
// bytes a clock); deeper pipelines and a deeper ring change nothing.
// Staging (5 %) and the five epilogues (7 %) run with the tensor cores
// idle, and the kernel executes 1.75x the useful work (halo, z padding,
// ragged units).
// fp32: the default dtype of RRDBNet(fused_trunk=True) (rrdb.py), which
// chip_smoke.py's fused fp32 check and the fp32 fused-path tests run.  fp32
// FMA on the CUDA cores (TF32 stays off), bound by operations: 128.3 GFLOP
// at batch 16, LR 128, nf 64, gc 32 is 1.92 ms at 67 TFLOP/s.  The first
// version, a block per 4 x 8 tile with a 5-pixel halo, executed 2.26x the
// useful work, read its weights through L1 and took 29.6 ms; the fp32
// cuDNN chain of five convs takes 6.4 ms.  This one:
//  * A 2 x 2 thread-block cluster of 8 x 8 tiles (rdb_fma_kernel).  Each
//    block holds a 14 x 14 pixel buffer: 5 pixels beyond its tile on its
//    two outer sides (those of the cluster's 16 x 16), 1 on its inner
//    sides.  Conv i runs on the tile grown by 4 - i pixels on the outer
//    sides only; after it, each block tells the other three (a remote
//    mbarrier arrive, cluster scope) and copies the 1-pixel inner strips
//    of c_i from their shared memory (the corner from the diagonal one).
//    The halo is recomputed only on the cluster's edge: 1.44x the useful
//    work (executed_flops_fp32 in the wrapper, the last pixel groups'
//    padding included), 154 KB of buffer at a pixel stride of 196 floats
//    (z in round_up(nz, 4) slots, 4 mod 8 for conflict-free float4 reads).
//  * A producer warp streams the five convs' weights, [tap][K][N] fp32,
//    tap by tap in chunks of K by bulk copies into a ring (3 slots of 16 KB
//    at the main widths) under full / empty mbarriers; z's rows past
//    round_up(nz, 4) are skipped.
//  * The products are fma_conv.cuh's routine: each of two halves of 4
//    consumer warps sums half of every chunk's rows for the same units (9
//    pixels x 4 outputs a thread in conv 0; 4 x 8 in conv 4), and the
//    second half's sums reach the first through shared memory.
// What bounds it: the FMA loops (84 % of a block's clocks) issue an FFMA
// about every 2 clocks (conv 0: 44k clocks for 22k FFMAs a scheduler)
// where ptxas's loop has 1.2 instructions per FFMA: 153 of the 9 x 4
// loop's 288 FFMAs read their two non-reused operands from one register
// bank (register number mod 2), and ptxas chooses the registers.  Shared loads
// cost 16 % on top (a copy with the loads hoisted out of the loop), the
// epilogues and exchanges 11 %, staging 2 % (rdb_probe.py --phases,
// --ablate).  One warp a scheduler with no K split (7.3 ms), 9 x 8 tiles
// in groups of 64 threads (7.6 and 8.3 ms: ptxas caps a 288-thread block
// at 168 registers, and they spill) and unrolls of 1 or 4 did no better.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

#include "fma_conv.cuh"

namespace {

constexpr int kZs = 16;        // channel slots of z (nz <= 16), zero-padded
// bf16: the consumer warpgroups, then the producer warp and the relay warp
constexpr int kWgs = 2;
constexpr int kConsumers = 128 * kWgs;
constexpr int kThreadsMma = kConsumers + 64;
constexpr int kSlotBytes = 9216;  // one ring slot: 9 steps of N 32, 3 of 64
constexpr int kStages = 3;        // ring slots
constexpr int kBufs = 3;          // A fragment register buffers
// slots, a full and an empty mbarrier per slot, and a spare mbarrier
constexpr int kRingBytes = kStages * kSlotBytes + (2 * kStages + 1) * 8;
constexpr int kBarConsumers = 1;  // named barriers: 0 is __syncthreads
// + kStages * warpgroup + slot: the relay's "slot is full" (ids up to 15)
constexpr int kBarSlotFull = 2;
static_assert(kBarSlotFull + kWgs * kStages <= 16, "named barriers");

struct Params {
  const void* x;      // [B,H,W,nf]
  const void* z;      // [B,H,W,nz]
  const void* x0;     // [B,H,W,nf], or null: no outer residual
  void* out;          // [B,H,W,nf]
  const void* w;      // packed weights of the five convs
  const float* bias;  // packed fp32 biases of the five convs
  int H, W, nf, nz, gcp, cs;
  int w_off[5], b_off[5];  // element offsets of conv i in w and bias
  int zs, slots, slot_bytes;  // fp32: z's buffer slots, the weight ring
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float leaky(float v) {
  return v >= 0.f ? v : __fmul_rn(0.2f, v);
}

// The value written to `out` at one pixel and channel: the inner residual
// rounded to T, then (with x0) the outer residual in T arithmetic.  The
// explicit _rn ops keep the compiler from contracting them into an FMA,
// which would round differently from the reference.
template <typename T>
__device__ __forceinline__ T residual(float acc, float x, const T* x0,
                                      size_t idx) {
  T v = from_f<T>(__fadd_rn(__fmul_rn(acc, 0.2f), x));
  if (x0 != nullptr) {
    const float s = to_f(from_f<T>(0.2f));
    v = from_f<T>(__fmul_rn(to_f(v), s));
    v = from_f<T>(__fadd_rn(to_f(v), to_f(x0[idx])));
  }
  return v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// Stage [z | x] of the tile plus its halo; zero outside the image.  bf16:
// 16-byte chunks, x copied by cp.async, the z slot built in registers; run
// by the consumer threads.
template <int TH, int TW>
__device__ __forceinline__ void load_inputs(const Params& p,
                                            __nv_bfloat16* feat, int ty0,
                                            int tx0, size_t img) {
  constexpr int BH = TH + 10, BW = TW + 10;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
  const __nv_bfloat16* z = static_cast<const __nv_bfloat16*>(p.z);
  // the z slots: a pixel's loads are independent, and the x copies below
  // go out while they fly
  constexpr int per_thread = (BH * BW + kConsumers - 1) / kConsumers;
  __align__(16) __nv_bfloat16 zv[per_thread][kZs];
#pragma unroll
  for (int k = 0; k < per_thread; ++k) {
    const int px = threadIdx.x + k * kConsumers;
    const int by = px / BW, bx = px - by * BW;
    const int gy = ty0 + by, gx = tx0 + bx;
    const bool inside = px < BH * BW && gy >= 0 && gy < p.H && gx >= 0 &&
                        gx < p.W;
    const __nv_bfloat16* zp = z + (img + (size_t)gy * p.W + gx) * p.nz;
#pragma unroll
    for (int c = 0; c < kZs; ++c)
      zv[k][c] = inside && c < p.nz ? zp[c] : __float2bfloat16_rn(0.f);
  }
  const int sh = 31 - __clz(p.nf / 8);  // 16-byte chunks of a pixel's x
  for (int idx = threadIdx.x; idx < (BH * BW) << sh; idx += kConsumers) {
    const int px = idx >> sh, u = idx - (px << sh);
    const int by = px / BW, bx = px - by * BW;
    const int gy = ty0 + by, gx = tx0 + bx;
    uint4* dst = reinterpret_cast<uint4*>(feat + px * p.cs + kZs + 8 * u);
    if (gy >= 0 && gy < p.H && gx >= 0 && gx < p.W)
      cp_async16(dst, x + (img + (size_t)gy * p.W + gx) * p.nf + 8 * u);
    else
      *dst = make_uint4(0, 0, 0, 0);
  }
  asm volatile("cp.async.commit_group;\n" ::);
#pragma unroll
  for (int k = 0; k < per_thread; ++k) {
    const int px = threadIdx.x + k * kConsumers;
    if (px < BH * BW) {
      uint4* dst = reinterpret_cast<uint4*>(feat + px * p.cs);
      dst[0] = reinterpret_cast<const uint4*>(zv[k])[0];
      dst[1] = reinterpret_cast<const uint4*>(zv[k])[1];
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Geometry of conv i: its output region is the tile grown by 4 - i pixels
// a side, starting at buffer pixel (o, o); K input slots, N output slots.
struct Stage {
  int o, rw, m, k, n;
  // m / rw for 0 <= m < 2048 without a division (rw <= 32)
  __device__ int row(int m_) const { return (m_ * (65536 / rw + 1)) >> 16; }
  __device__ Stage(const Params& p, int i, int th, int tw)
      : o(i + 1),
        rw(tw + 2 * (4 - i)),
        m((th + 2 * (4 - i)) * (tw + 2 * (4 - i))),
        k(kZs + p.nf + i * p.gcp),
        n(i < 4 ? p.gcp : p.nf) {}
};

// ---- bf16: PTX of the mbarrier ring, ldmatrix and wgmma ----

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Wait until the barrier has left the phase of this parity.  A wait that
// outlasts any possible run is a fault in the ring: trap, do not hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (spins > (1u << 28)) __trap();
  }
}

// Lane 0's arrive for its warp, predicated inside the statement so that
// the compiler sees no branch (see conv_wgmma).
__device__ __forceinline__ void mbar_arrive_lane0(uint32_t bar) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.eq.u32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n"
      "}\n" ::"r"(bar),
      "r"(threadIdx.x & 31)
      : "memory");
}

// 1-D bulk copy global -> shared; its bytes complete on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// barrier of the consumer threads alone
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(kBarConsumers), "n"(kConsumers)
               : "memory");
}
// "slot s is full": the relay warp arrives once the slot's mbarrier has
// completed, the consumers wait.  A named barrier blocks in hardware, so
// the consumers' loop has no polling branch (see conv_wgmma).
// Each warpgroup has its own barrier per slot, so neither waits for the
// other inside a conv.
__device__ __forceinline__ void slot_full_arrive(int wg, int s) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(kBarSlotFull + kStages * wg + s),
               "n"(128 + 32)
               : "memory");
}
__device__ __forceinline__ void slot_full_wait(int wg, int s) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(kBarSlotFull + kStages * wg + s),
               "n"(128 + 32)
               : "memory");
}

// Four 8 x 8 bf16 matrices; lane l gives the address of row l & 7 of
// matrix l >> 3.  With rows 0-7 | 8-15 and k 0-7 | 8-15 as matrices 0..3
// the result is the m16k16 A fragment of mma and wgmma.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int Pending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(Pending)
               : "memory");
}
// wgmma writes D after the instruction has been started: keep the compiler
// from moving reads of the accumulators above the wait.
template <int L>
__device__ __forceinline__ void keep(float (&r)[L]) {
#pragma unroll
  for (int j = 0; j < L; ++j) asm volatile("" : "+f"(r[j])::"memory");
}

// Shared-memory descriptor of one (tap, 16-channel) step of weights: N x 16
// bf16, K-major, no swizzle.  A core matrix is 8 outputs x 8 channels, 128
// contiguous bytes (an output's 8 channels are 16 bytes); the two core
// matrices along K are 128 bytes apart (leading byte offset), the next 8
// outputs 256 bytes on (stride byte offset).  Offsets are in 16-byte units.
__device__ __forceinline__ uint64_t weight_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

// Compile-time indices for loops over register arrays.
template <int V>
using Int = std::integral_constant<int, V>;
template <class F, int... Q>
__device__ __forceinline__ void static_for_impl(
    F&& f, std::integer_sequence<int, Q...>) {
  (f(Int<Q>{}), ...);
}
template <int Count, class F>
__device__ __forceinline__ void static_for(F&& f) {
  static_for_impl(f, std::make_integer_sequence<int, Count>{});
}

// D[64 x N] += A[64 x 16] * B[16 x N]: A from registers, B by descriptor.
// Accumulator register 4j + 2h + e of a lane (g, t) in warp q of the
// warpgroup is row 16q + 8h + g, column 8j + 2t + e, as in mma.
template <int N>
struct Wgmma;
template <>
struct Wgmma<16> {
  __device__ static __forceinline__ void run(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, "
        "p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <>
struct Wgmma<32> {
  __device__ static __forceinline__ void run(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};
template <>
struct Wgmma<64> {
  __device__ static __forceinline__ void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// The weight ring: kStages slots of kSlotBytes, then a full and an empty
// mbarrier per slot.  Producer and consumers walk the slots in the same
// order, each with its own (slot, phase).
struct Ring {
  uint32_t base, bars;
  int slot = 0;
  uint32_t phase = 0;
  __device__ explicit Ring(unsigned char* ring)
      : base(smem_u32(ring)), bars(smem_u32(ring) + kStages * kSlotBytes) {}
  __device__ uint32_t data(int s) const { return base + s * kSlotBytes; }
  __device__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ uint32_t empty(int s) const { return bars + 8 * (kStages + s); }
  __device__ uint32_t spare() const { return bars + 8 * 2 * kStages; }
  __device__ void advance() {
    if (++slot == kStages) {
      slot = 0;
      phase ^= 1;
    }
  }
};

// Bytes of one (tap, 16-channel) step of a conv with N outputs, and the
// steps a ring slot holds.
__host__ __device__ constexpr int step_bytes(int n) { return n * 32; }
// A conv has 9 (taps) x K / 16 steps, so slots of 9 or 3 steps leave no
// partial slot at a conv's end; N 64 takes 3 (6 KB of the slot's 9).
__host__ __device__ constexpr int slot_steps(int n) { return n <= 32 ? 9 : 3; }
static_assert(slot_steps(64) * step_bytes(64) <= kSlotBytes &&
                  slot_steps(32) * step_bytes(32) <= kSlotBytes,
              "a slot's steps fit in it");

// One thread: stream the five convs' weights through the ring, a slot of
// whole steps per bulk copy, waiting only for the slot to be released.
__device__ __forceinline__ void produce_weights(const Params& p, Ring r) {
  const unsigned char* w = static_cast<const unsigned char*>(p.w);
  for (int i = 0; i < 5; ++i) {
    const int k = kZs + p.nf + i * p.gcp, n = i < 4 ? p.gcp : p.nf;
    const int total = 9 * (k / 16) * step_bytes(n);
    const int chunk = slot_steps(n) * step_bytes(n);  // divides total
    const unsigned char* src = w + 2 * (size_t)p.w_off[i];
    for (int off = 0; off < total; off += chunk) {
      mbar_wait(r.empty(r.slot), r.phase ^ 1);
      mbar_expect_tx(r.full(r.slot), chunk);
      bulk_copy(r.data(r.slot), src + off, chunk, r.full(r.slot));
      r.advance();
    }
  }
}

// One warp: tell the consumers of each slot, in ring order, that it is full.
__device__ __forceinline__ void relay_full(const Params& p, Ring r) {
  for (int i = 0; i < 5; ++i) {
    const int k = kZs + p.nf + i * p.gcp, n = i < 4 ? p.gcp : p.nf;
    const int steps = 9 * (k / 16);
    for (int done = 0; done < steps; done += slot_steps(n)) {
      mbar_wait(r.full(r.slot), r.phase);
#pragma unroll
      for (int wg = 0; wg < kWgs; ++wg) slot_full_arrive(wg, r.slot);
      r.advance();
    }
  }
}

// conv i for one consumer warpgroup: its U units of 64 region pixels
// (row-major over the region) x N outputs, all held at once.  Weights:
// [tap][K/16][N/8][k half][n % 8][k % 8] (see weight_desc).
template <int TH, int TW, int N, int U>
__device__ __forceinline__ void conv_wgmma(const Params& p,
                                           __nv_bfloat16* feat, Ring& r,
                                           int i, int ty0, int tx0,
                                           size_t img) {
  constexpr int BW = TW + 10;
  constexpr int spc = slot_steps(N);
  const Stage s(p, i, TH, TW);
  const int kc_n = s.k / 16, iters = 9 * kc_n;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wg = threadIdx.x >> 7, wq = (threadIdx.x >> 5) & 3;
  const float* bias = p.bias + p.b_off[i];
  const uint32_t px_bytes = 2 * p.cs;

  // lane l addresses row l & 15 of the warp's 16 rows, k half l >> 4
  uint32_t abase[U];
#pragma unroll
  for (int uu = 0; uu < U; ++uu) {
    const int m = min((wg + kWgs * uu) * 64 + wq * 16 + (lane & 15), s.m - 1);
    const int ry = s.row(m), rx = m - ry * s.rw;
    abase[uu] = smem_u32(feat) +
                ((s.o - 1 + ry) * BW + (s.o - 1 + rx)) * px_bytes +
                (lane >> 4) * 16;
  }
  float acc[U][N / 2];
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float b0 = bias[8 * j + 2 * t], b1 = bias[8 * j + 2 * t + 1];
#pragma unroll
    for (int uu = 0; uu < U; ++uu) {
      acc[uu][4 * j] = b0;
      acc[uu][4 * j + 1] = b1;
      acc[uu][4 * j + 2] = b0;
      acc[uu][4 * j + 3] = b1;
    }
  }

  // A fragments rotate through kBufs register buffers.  Step q's wgmmas
  // (one group) are started while group q - 1 still runs; once q - 1 is
  // done (wait_group 1) the buffer of step q - 1 is reloaded with the A of
  // step q + 2, so a group never waits for its loads and the tensor cores
  // always have a group queued.  ptxas serializes every wgmma of a kernel
  // that branches between the start of a group and its wait, so nothing in the
  // loop polls: "slot full" is a named barrier, "slot empty" an arrive
  // predicated on lane 0, one slot late (when the last group that read
  // the slot is known to be done), on a spare barrier the first time.
  uint32_t a[kBufs][U][4];
  int kc = 0, tap = 0;
  uint32_t toff = 0;
  auto load = [&](auto hc) {  // the next step's A (after the last: tap 0's)
    constexpr int h = decltype(hc)::value % kBufs;
#pragma unroll
    for (int uu = 0; uu < U; ++uu)
      ldmatrix_x4(a[h][uu], abase[uu] + toff + kc * 32);
    if (++kc == kc_n) {
      kc = 0;
      tap = tap == 8 ? 0 : tap + 1;
      toff = ((tap / 3) * BW + tap % 3) * px_bytes;
    }
  };
  // step sc of the slot at slot_desc, its A in buffer hc
  auto mma = [&](auto sc, auto hc, uint64_t slot_desc) {
    constexpr int h = decltype(hc)::value % kBufs;
    wgmma_fence();
#pragma unroll
    for (int uu = 0; uu < U; ++uu)
      Wgmma<N>::run(acc[uu], a[h][uu],
                    slot_desc + decltype(sc)::value * (step_bytes(N) >> 4));
    wgmma_commit();
  };
  static_assert(spc % kBufs == 0, "a slot starts in A buffer 0");

  load(Int<0>{});
  load(Int<1>{});
  uint32_t release = r.spare();
  for (int done = 0; done < iters; done += spc) {  // spc divides iters
    slot_full_wait(wg, r.slot);
    const uint64_t b = weight_desc(r.data(r.slot));
    static_for<spc>([&](auto qc) {
      constexpr int q = decltype(qc)::value;
      mma(qc, Int<q>{}, b);
      wgmma_wait<1>();
      if constexpr (q == 0) mbar_arrive_lane0(release);
      load(Int<q + 2>{});
    });
    release = r.empty(r.slot);
    r.advance();
  }
  wgmma_wait<0>();
  mbar_arrive_lane0(release);
#pragma unroll
  for (int uu = 0; uu < U; ++uu) keep(acc[uu]);

#pragma unroll
  for (int uu = 0; uu < U; ++uu) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = (wg + kWgs * uu) * 64 + wq * 16 + h * 8 + g;
      if (m >= s.m) continue;
      const int ry = s.row(m), rx = m - ry * s.rw;
      const int bp = (s.o + ry) * BW + (s.o + rx);
      const int gy = ty0 + s.o + ry, gx = tx0 + s.o + rx;
      const bool inside = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
      if (i < 4) {
        // c_i is zero outside the image: the next conv's SAME padding
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          float v0 = leaky(acc[uu][4 * j + 2 * h]);
          float v1 = leaky(acc[uu][4 * j + 2 * h + 1]);
          if (!inside) v0 = v1 = 0.f;
          *reinterpret_cast<__nv_bfloat162*>(feat + bp * p.cs + s.k + 8 * j +
                                             2 * t) =
              __floats2bfloat162_rn(v0, v1);
        }
      } else if (inside) {
        const size_t gp = (img + (size_t)gy * p.W + gx) * p.nf;
        const __nv_bfloat16* x0 = static_cast<const __nv_bfloat16*>(p.x0);
        __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          const int n = 8 * j + 2 * t;
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(feat + bp * p.cs +
                                                       kZs + n));
          __nv_bfloat162 o;
          o.x = residual(acc[uu][4 * j + 2 * h], xv.x, x0, gp + n);
          o.y = residual(acc[uu][4 * j + 2 * h + 1], xv.y, x0, gp + n + 1);
          *reinterpret_cast<__nv_bfloat162*>(out + gp + n) = o;
        }
      }
    }
  }
}

// A warpgroup's share of conv i: units wg, wg + kWgs, ... of ceil(M / 64).
// An 8 x 16 tile gives every warpgroup one to three units in every conv.
template <int TH, int TW, int N>
__device__ __forceinline__ void conv_units(const Params& p,
                                           __nv_bfloat16* feat, Ring& r,
                                           int i, int ty0, int tx0,
                                           size_t img) {
  static_assert((TH * TW + 63) / 64 >= kWgs && (TH + 8) * (TW + 8) <=
                    64 * 3 * kWgs, "one to three units a warpgroup");
  const Stage s(p, i, TH, TW);
  const int wg = threadIdx.x >> 7;
  const int units = ((s.m + 63) / 64 - wg + kWgs - 1) / kWgs;
  if (units == 1) {
    conv_wgmma<TH, TW, N, 1>(p, feat, r, i, ty0, tx0, img);
  } else if constexpr (N <= 32) {  // the narrow convs 0..3
    if (units == 2)
      conv_wgmma<TH, TW, N, 2>(p, feat, r, i, ty0, tx0, img);
    else
      conv_wgmma<TH, TW, N, 3>(p, feat, r, i, ty0, tx0, img);
  }
}

// The consumers' five convs.  Outputs widths: gcp 16 or 32 (convs 0..3),
// nf 16, 32 or 64 (conv 4).
template <int TH, int TW>
__device__ __forceinline__ void convs_bf16(const Params& p,
                                           __nv_bfloat16* feat, Ring& r,
                                           int ty0, int tx0, size_t img) {
  for (int i = 0; i < 4; ++i) {
    // conv i reads slots [0, K_i) and writes [K_i, K_i + gcp): no overlap
    if (p.gcp == 32)
      conv_units<TH, TW, 32>(p, feat, r, i, ty0, tx0, img);
    else
      conv_units<TH, TW, 16>(p, feat, r, i, ty0, tx0, img);
    consumer_sync();
  }
  if (p.nf == 64)
    conv_units<TH, TW, 64>(p, feat, r, 4, ty0, tx0, img);
  else if (p.nf == 32)
    conv_units<TH, TW, 32>(p, feat, r, 4, ty0, tx0, img);
  else
    conv_units<TH, TW, 16>(p, feat, r, 4, ty0, tx0, img);
}

template <typename T>
struct Tile;
template <>
struct Tile<__nv_bfloat16> {
  static constexpr int h = 8, w = 16, threads = kThreadsMma;
};

template <typename T>
__host__ __device__ size_t feat_bytes(int cs) {
  return (size_t)(Tile<T>::h + 10) * (Tile<T>::w + 10) * cs * sizeof(T);
}

template <typename T>
size_t rdb_smem(int cs) {
  return feat_bytes<T>(cs) + kRingBytes;
}

template <typename T>
__global__ void __launch_bounds__(Tile<T>::threads, 1)
    rdb_kernel(const Params p) {
  constexpr int TH = Tile<T>::h, TW = Tile<T>::w;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* feat = reinterpret_cast<T*>(smem_raw);
  // image coordinates of buffer pixel (0, 0)
  const int ty0 = blockIdx.y * TH - 5, tx0 = blockIdx.x * TW - 5;
  const size_t img = (size_t)blockIdx.z * p.H * p.W;
  if constexpr (sizeof(T) == 2) {
    Ring ring(smem_raw + feat_bytes<T>(p.cs));
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) {
        mbar_init(ring.full(s), 1);            // the producer's arrive
        mbar_init(ring.empty(s), kConsumers / 32);  // lane 0 of each warp
      }
      mbar_init(ring.spare(), kConsumers / 32);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x >= kConsumers) {
      // the weights start to arrive while the consumers stage the inputs
      if (threadIdx.x == kConsumers) produce_weights(p, ring);
      if (threadIdx.x >= kConsumers + 32) relay_full(p, ring);
      return;
    }
    load_inputs<TH, TW>(p, feat, ty0, tx0, img);
    consumer_sync();
    convs_bf16<TH, TW>(p, feat, ring, ty0, tx0, img);
  }
}

// ---- fp32: a 2 x 2 thread-block cluster, fp32 FMA (fma_conv.cuh) ----

constexpr int kFT = 8;              // a block's output tile, kFT x kFT
constexpr int kFB = kFT + 6;        // its buffer: 5 outer + 1 inner halo
constexpr int kFC = 256;            // consumer threads: two halves of
constexpr int kFHalf = kFC / 2;     // 4 warps, each half a chunk's K
constexpr int kFThreads = kFC + 32; // and one producer warp
constexpr int kFMaxSlots = 4;       // weight ring slots
constexpr int kFSlotBytes = 16384;
constexpr int kFMaxPx = 9;          // pixels a thread's register tile holds
// full and empty mbarriers per slot, one "c_i is written" per conv 0..3
constexpr int kFBarBytes = 128;
static_assert(8 * (2 * kFMaxSlots + 4) <= kFBarBytes, "barriers fit");
constexpr int kMaxSmem = 232448;    // dynamic shared memory a block may use

// z's slots in the fp32 buffer: nz rounded up to 4 (the packed weights
// keep 16 rows for z; the rows past zs are zero and are not copied)
__host__ __device__ constexpr int fp32_zs(int nz) { return (nz + 3) / 4 * 4; }

__host__ __device__ inline size_t fp32_feat_bytes(int cs) {
  return (size_t)kFB * kFB * cs * 4;
}

// The second half's partial sums, [acc index][thread]: 4 NV PX floats of
// each of kFHalf threads, the most any conv of (nf, gcp) needs.
__host__ __device__ inline size_t fp32_scratch_bytes(int nf, int gcp);

// The weight ring: up to kFMaxSlots slots of 16 KB in what the buffer
// and the scratch leave, at least two (smaller if need be); (0, 0) when
// not even two slots of 1 KB fit.
struct RingShape {
  int slots, bytes;
};
__host__ __device__ inline RingShape fp32_ring(int cs, int nf, int gcp) {
  const long free_ = (long)kMaxSmem - kFBarBytes -
                     (long)fp32_feat_bytes(cs) -
                     (long)fp32_scratch_bytes(nf, gcp);
  if (free_ >= 2L * kFSlotBytes) {
    const long s = free_ / kFSlotBytes;
    return {int(s < kFMaxSlots ? s : kFMaxSlots), kFSlotBytes};
  }
  const int bytes = int(free_ / 2) / 16 * 16;
  return bytes >= 1024 ? RingShape{2, bytes} : RingShape{0, 0};
}

size_t fp32_smem(int cs, int nf, int gcp) {
  const RingShape r = fp32_ring(cs, nf, gcp);
  return kFBarBytes + fp32_feat_bytes(cs) + fp32_scratch_bytes(nf, gcp) +
         (size_t)(r.slots ? r.slots : 2) * (r.bytes ? r.bytes : 1024);
}

// A conv's thread mapping: NV float4s of outputs (2 when N > 32), cgs
// channel groups, pgs pixel groups of px pixels each (pixel j of group g is
// region pixel j * pgs + g, so a warp's lanes read consecutive pixels).
struct Units {
  int nv, cgs, pgs, px;
};
__host__ __device__ inline Units fp32_units(int m, int n) {
  Units u;
  u.nv = n > 32 ? 2 : 1;
  u.cgs = n / (4 * u.nv);
  u.pgs = kFHalf / u.cgs;
  u.px = (m + u.pgs - 1) / u.pgs;
  return u;
}

__host__ __device__ inline size_t fp32_scratch_bytes(int nf, int gcp) {
  size_t most = 0;
  for (int i = 0; i < 5; ++i) {
    const int side = kFT + 4 - i;
    const Units u = fp32_units(side * side, i < 4 ? gcp : nf);
    const size_t b = (size_t)4 * u.nv * u.px * kFHalf * 4;
    most = b > most ? b : most;
  }
  return most;
}

// Rows of K a ring slot holds for N outputs (a multiple of 4).
__host__ __device__ inline int fp32_chunk_rows(int slot_bytes, int n) {
  return slot_bytes / (4 * n) / 4 * 4;
}

struct FRing {
  uint32_t data, bars;  // shared addresses of slot 0 and the barriers
  const float* ptr;     // slot 0, generic
  int slots, bytes, slot = 0;
  uint32_t phase = 0;
  __device__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ uint32_t empty(int s) const {
    return bars + 8 * (kFMaxSlots + s);
  }
  __device__ void advance() {
    if (++slot == slots) {
      slot = 0;
      phase ^= 1;
    }
  }
};

// barrier of the consumer threads alone
__device__ __forceinline__ void fp32_consumer_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(kBarConsumers), "n"(kFC)
               : "memory");
}

// One thread: stream the five convs' weights, tap by tap and chunk by
// chunk of K, in the order the consumers read them.  A chunk is one or two
// bulk copies: buffer slot r < zs is packed row r, slot r >= zs packed row
// r + 16 - zs.
__device__ __forceinline__ void produce_fp32(const Params& p, FRing r) {
  const float* w = static_cast<const float*>(p.w);
  for (int i = 0; i < 5; ++i) {
    const int k = p.zs + p.nf + i * p.gcp, kg = kZs + p.nf + i * p.gcp;
    const int n = i < 4 ? p.gcp : p.nf;
    const int rows = fp32_chunk_rows(r.bytes, n);
    for (int tap = 0; tap < 9; ++tap) {
      const float* wt = w + p.w_off[i] + (size_t)tap * kg * n;
      for (int r0 = 0; r0 < k; r0 += rows) {
        const int r1 = min(k, r0 + rows);
        mbar_wait(r.empty(r.slot), r.phase ^ 1);
        mbar_expect_tx(r.full(r.slot), (r1 - r0) * n * 4);
        const uint32_t dst = r.data + r.slot * r.bytes;
        if (r0 < p.zs)
          bulk_copy(dst, wt + (size_t)r0 * n, (min(r1, p.zs) - r0) * n * 4,
                    r.full(r.slot));
        const int s0 = max(r0, p.zs);
        if (s0 < r1)
          bulk_copy(dst + (s0 - r0) * n * 4,
                    wt + (size_t)(s0 + kZs - p.zs) * n, (r1 - s0) * n * 4,
                    r.full(r.slot));
        r.advance();
      }
    }
  }
}

// conv i for one consumer thread, PX pixels x 4 NV outputs of its units:
// the ring's chunks through fma_conv::mac, the first half of each chunk's
// rows by threads [0, kFHalf), the rest by [kFHalf, kFC) on the same units;
// the second half's sums through `scratch` into the first's, which runs
// the epilogue (c_i into the buffer, zero outside the image; conv 4: the
// residual to `out`).
template <int PX, int NV>
__device__ __forceinline__ void conv_fp32(const Params& p, float* feat,
                                          float* scratch, FRing& r, int i,
                                          const Units& u, int ry0, int rx0,
                                          int oy, int ox, size_t img) {
  const int side = kFT + 4 - i, m = side * side;
  const int k = p.zs + p.nf + i * p.gcp, n = i < 4 ? p.gcp : p.nf;
  const int rows = fp32_chunk_rows(r.bytes, n);
  const int half = threadIdx.x / kFHalf, t = threadIdx.x % kFHalf;
  const int cg = t % u.cgs;
  int pg = t / u.cgs;
  const bool active = pg < u.pgs;
  if (!active) pg = 0;  // computes a duplicate, stores nothing
  int bp[PX];           // buffer pixel of each region pixel
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    const int mm = min(j * u.pgs + pg, m - 1);
    const int ry = mm / side;
    bp[j] = (ry0 + ry) * kFB + rx0 + mm - ry * side;
  }
  float4 acc[PX][NV] = {};
  for (int tap = 0; tap < 9; ++tap) {
    const int toff = (tap / 3 - 1) * kFB + tap % 3 - 1;
    for (int r0 = 0; r0 < k; r0 += rows) {
      // this half's rows of the chunk: the first ceil(steps / 2) steps of
      // 4, or the rest
      const int nr = min(rows, k - r0), split = (nr / 4 + 1) / 2 * 4;
      const int h0 = half ? split : 0, hn = half ? nr - split : split;
      const float* a[PX];
#pragma unroll
      for (int j = 0; j < PX; ++j)
        a[j] = feat + (bp[j] + toff) * p.cs + r0 + h0;
      mbar_wait(r.full(r.slot), r.phase);
      fma_conv::mac<PX, NV>(
          acc, a, r.ptr + r.slot * (r.bytes / 4) + h0 * n + 4 * cg, n, n / 2,
          hn);
      __syncwarp();
      mbar_arrive_lane0(r.empty(r.slot));
      r.advance();
    }
  }
  float4* part = reinterpret_cast<float4*>(scratch);
  if (half) {
#pragma unroll
    for (int j = 0; j < PX; ++j)
#pragma unroll
      for (int v = 0; v < NV; ++v) part[(j * NV + v) * kFHalf + t] = acc[j][v];
  }
  fp32_consumer_sync();
  if (half) return;
#pragma unroll
  for (int j = 0; j < PX; ++j) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const float4 o = part[(j * NV + v) * kFHalf + t];
      acc[j][v].x += o.x;
      acc[j][v].y += o.y;
      acc[j][v].z += o.z;
      acc[j][v].w += o.w;
    }
  }
  if (!active) return;
  const float* bias = p.bias + p.b_off[i];
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    if (j * u.pgs + pg >= m) continue;
    const int by = bp[j] / kFB, bx = bp[j] - by * kFB;
    const int gy = oy + by, gx = ox + bx;
    const bool inside = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c = 4 * cg + v * (n / 2);
      const float4 s = fma_conv::channels(acc[j][v]);
      const float sum[4] = {s.x, s.y, s.z, s.w};
      float o[4];
      if (i < 4) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[e] = inside ? leaky(__fadd_rn(sum[e], bias[c + e])) : 0.f;
        *reinterpret_cast<float4*>(feat + bp[j] * p.cs + k + c) =
            make_float4(o[0], o[1], o[2], o[3]);
      } else if (inside) {
        const size_t gp = (img + (size_t)gy * p.W + gx) * p.nf + c;
        const float* x0 = static_cast<const float*>(p.x0);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[e] = residual(__fadd_rn(sum[e], bias[c + e]),
                          feat[bp[j] * p.cs + p.zs + c + e], x0, gp + e);
        *reinterpret_cast<float4*>(static_cast<float*>(p.out) + gp) =
            make_float4(o[0], o[1], o[2], o[3]);
      }
    }
  }
}

template <int NV, int PX = 1>
__device__ __forceinline__ void conv_fp32_px(const Params& p, float* feat,
                                             float* scratch, FRing& r, int i,
                                             const Units& u, int ry0,
                                             int rx0, int oy, int ox,
                                             size_t img) {
  if constexpr (PX < kFMaxPx) {
    if (u.px > PX)
      return conv_fp32_px<NV, PX + 1>(p, feat, scratch, r, i, u, ry0, rx0,
                                      oy, ox, img);
  }
  conv_fp32<PX, NV>(p, feat, scratch, r, i, u, ry0, rx0, oy, ox, img);
}

__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// Wait, with cluster-scope acquire, for the barrier to leave phase 0.
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "0;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar)
        : "memory");
    if (spins > (1u << 28)) __trap();
  }
}

// A block of the 2 x 2 cluster (cx, cy) owns the output tile at (8 by,
// 8 bx) and a 14 x 14 buffer: 5 pixels beyond the tile on its outer sides
// (those of the cluster's 16 x 16), 1 on its inner sides.  Conv i runs on
// the tile grown by 4 - i pixels on the outer sides only; the 1-pixel
// strip of c_i its inner sides need comes from the other three blocks'
// shared memory once they have written it.
__global__ void __cluster_dims__(2, 2, 1) __launch_bounds__(kFThreads, 1)
    rdb_fma_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  namespace cgp = cooperative_groups;
  cgp::cluster_group cluster = cgp::this_cluster();
  const uint32_t bars = smem_u32(smem_raw);
  float* feat = reinterpret_cast<float*>(smem_raw + kFBarBytes);
  float* scratch = feat + fp32_feat_bytes(p.cs) / 4;
  const size_t ring_off = kFBarBytes + fp32_feat_bytes(p.cs) +
                          fp32_scratch_bytes(p.nf, p.gcp);
  FRing ring;
  ring.data = bars + (uint32_t)ring_off;
  ring.ptr = reinterpret_cast<const float*>(smem_raw + ring_off);
  ring.bars = bars;
  ring.slots = p.slots;
  ring.bytes = p.slot_bytes;
  const uint32_t ready = bars + 8 * 2 * kFMaxSlots;  // + 8 i: c_i written
  const int cx = blockIdx.x & 1, cy = blockIdx.y & 1;
  // image coordinates of buffer pixel (0, 0)
  const int oy = blockIdx.y * kFT - (cy ? 1 : 5);
  const int ox = blockIdx.x * kFT - (cx ? 1 : 5);
  const size_t img = (size_t)blockIdx.z * p.H * p.W;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ring.slots; ++s) {
      mbar_init(ring.full(s), 1);
      mbar_init(ring.empty(s), kFC / 32);
    }
    for (int i = 0; i < 4; ++i) mbar_init(ready + 8 * i, 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every block's barriers exist before any block arrives on them
  cluster.sync();

  if (threadIdx.x >= kFC) {
    if (threadIdx.x == kFC) produce_fp32(p, ring);
    __syncwarp();
    cluster.sync();  // no block leaves while another reads its memory
    return;
  }

  // [z | x] on the whole buffer, zero outside the image
  const float* x = static_cast<const float*>(p.x);
  const float* z = static_cast<const float*>(p.z);
  const int xw = p.nf / 4;
  for (int idx = threadIdx.x; idx < kFB * kFB * xw; idx += kFC) {
    const int px = idx / xw, u = idx - px * xw;
    const int gy = oy + px / kFB, gx = ox + px % kFB;
    float* dst = feat + px * p.cs + p.zs + 4 * u;
    if (gy >= 0 && gy < p.H && gx >= 0 && gx < p.W)
      cp_async16(dst, x + (img + (size_t)gy * p.W + gx) * p.nf + 4 * u);
    else
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  for (int idx = threadIdx.x; idx < kFB * kFB * p.zs; idx += kFC) {
    const int px = idx / p.zs, c = idx - px * p.zs;
    const int gy = oy + px / kFB, gx = ox + px % kFB;
    float v = 0.f;
    if (c < p.nz && gy >= 0 && gy < p.H && gx >= 0 && gx < p.W)
      v = z[(img + (size_t)gy * p.W + gx) * p.nz + c];
    feat[px * p.cs + c] = v;
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  fp32_consumer_sync();

  for (int i = 0; i < 5; ++i) {
    const int side = kFT + 4 - i, n = i < 4 ? p.gcp : p.nf;
    const Units u = fp32_units(side * side, n);
    // the region's first buffer pixel: outer sides grow by 4 - i
    const int ry0 = cy ? 1 : 1 + i, rx0 = cx ? 1 : 1 + i;
    if (u.nv == 2)
      conv_fp32_px<2>(p, feat, scratch, ring, i, u, ry0, rx0, oy, ox, img);
    else
      conv_fp32_px<1>(p, feat, scratch, ring, i, u, ry0, rx0, oy, ox, img);
    if (i == 4) break;
    // c_i is written in this block: tell the cluster, wait for the others
    fp32_consumer_sync();
    if (threadIdx.x == 0) {
      asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
      for (int rank = 0; rank < 4; ++rank)
        asm volatile(
            "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
            ::"r"(mapa(ready + 8 * i, rank))
            : "memory");
    }
    mbar_wait_cluster(ready + 8 * i);
    // the inner strips of conv i + 1's input window: the inner row and
    // column, each as long as the window, from the block that computed
    // them (the corner from the diagonal one)
    const int in_r = cy ? 0 : kFB - 1, in_c = cx ? 0 : kFB - 1;
    const int w0 = cy ? 0 : i + 1, wn = kFB - 1 - i;  // window rows
    const int v0 = cx ? 0 : i + 1;                     // window columns
    const int slot = p.zs + p.nf + i * p.gcp, words = p.gcp / 4;
    for (int idx = threadIdx.x; idx < (2 * wn - 1) * words; idx += kFC) {
      const int e = idx / words, wd = idx - e * words;
      const int rr = e < wn ? in_r : (cy ? 1 : w0) + e - wn;
      const int cc = e < wn ? v0 + e : in_c;
      const int dy = rr == in_r, dx = cc == in_c;  // 1: the other block
      const int rank = (cx ^ dx) + 2 * (cy ^ dy);
      const int sy = dy ? (cy ? 12 : -12) : 0, sx = dx ? (cx ? 12 : -12) : 0;
      const float* src = cluster.map_shared_rank(feat, rank) +
                         ((rr + sy) * kFB + cc + sx) * p.cs + slot + 4 * wd;
      *reinterpret_cast<float4*>(feat + (rr * kFB + cc) * p.cs + slot +
                                 4 * wd) =
          *reinterpret_cast<const float4*>(src);
    }
    fp32_consumer_sync();
  }
  cluster.sync();
}

template <typename T>
int set_smem(T* kernel, size_t smem, size_t (&allowed)[64]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (smem > allowed[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    allowed[dev] = smem;
  }
  return 0;
}

void set_offsets(Params& p) {
  int wo = 0, bo = 0;
  for (int i = 0; i < 5; ++i) {
    const int k = kZs + p.nf + i * p.gcp, n = i < 4 ? p.gcp : p.nf;
    p.w_off[i] = wo;
    p.b_off[i] = bo;
    wo += 9 * k * n;
    bo += n;
  }
}

int launch_bf16(Params p, int B, cudaStream_t stream) {
  using T = __nv_bfloat16;
  const size_t smem = rdb_smem<T>(p.cs);
  // the attribute holds per device: raise it when a launch needs more
  static size_t allowed[64] = {};
  const int e = set_smem(rdb_kernel<T>, smem, allowed);
  if (e) return e;
  set_offsets(p);
  dim3 grid((p.W + Tile<T>::w - 1) / Tile<T>::w,
            (p.H + Tile<T>::h - 1) / Tile<T>::h, B);
  rdb_kernel<T><<<grid, Tile<T>::threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

int launch_fp32(Params p, int B, cudaStream_t stream) {
  p.zs = fp32_zs(p.nz);
  const RingShape rs = fp32_ring(p.cs, p.nf, p.gcp);
  p.slots = rs.slots;
  p.slot_bytes = rs.bytes;
  if (p.slots == 0 ||
      p.cs < p.zs + p.nf + 4 * p.gcp || p.cs % 4 ||
      fp32_chunk_rows(p.slot_bytes, p.nf > p.gcp ? p.nf : p.gcp) < 4)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 5; ++i) {
    const int side = kFT + 4 - i, n = i < 4 ? p.gcp : p.nf;
    const Units u = fp32_units(side * side, n);
    if (n % (4 * u.nv) || u.px > kFMaxPx) return (int)cudaErrorInvalidValue;
  }
  const size_t smem = kFBarBytes + fp32_feat_bytes(p.cs) +
                      fp32_scratch_bytes(p.nf, p.gcp) +
                      (size_t)p.slots * p.slot_bytes;
  static size_t allowed[64] = {};
  const int e = set_smem(rdb_fma_kernel, smem, allowed);
  if (e) return e;
  set_offsets(p);
  // whole clusters of 2 x 2 blocks over the image; blocks outside it
  // compute zeros and store nothing
  dim3 grid(2 * ((p.W + 2 * kFT - 1) / (2 * kFT)),
            2 * ((p.H + 2 * kFT - 1) / (2 * kFT)), B);
  rdb_fma_kernel<<<grid, kFThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory a launch needs, in bytes, for a pixel stride of
// `cs` elements (more than a block has when the widths do not fit).
size_t exsr_rdb_smem(int nf, int gcp, int cs, int is_bf16) {
  return is_bf16 ? rdb_smem<__nv_bfloat16>(cs) : fp32_smem(cs, nf, gcp);
}

// Launches on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for widths the kernel is not built for.  The caller
// guarantees nf % 16 == 0, 1 <= nz <= 16, gcp % 16 == 0 (bf16: gcp 16 or 32
// and nf 16, 32 or 64, the widths wgmma is instantiated for), the packed
// layouts above, 16-byte aligned pointers, and cs = 16 + nf + 4 gcp + 8
// (bf16) or round_up(nz, 4) + nf + 4 gcp, plus 4 when that is a multiple
// of 8 (fp32).  x0 may be null.
int exsr_rdb(const void* x, const void* z, const void* x0, void* out,
             const void* w, const void* bias, int B, int H, int W, int nf,
             int nz, int gcp, int cs, int is_bf16, void* stream) {
  Params p;
  p.x = x;
  p.z = z;
  p.x0 = x0;
  p.out = out;
  p.w = w;
  p.bias = static_cast<const float*>(bias);
  p.H = H;
  p.W = W;
  p.nf = nf;
  p.nz = nz;
  p.gcp = gcp;
  p.cs = cs;
  if (is_bf16) return launch_bf16(p, B, (cudaStream_t)stream);
  if (B == 0 || H == 0 || W == 0) return 0;
  return launch_fp32(p, B, (cudaStream_t)stream);
}

const char* exsr_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
