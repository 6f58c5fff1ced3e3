// The RDB stage-4 epilogue of the grouped RRDB trunk as one kernel.
//
// Replaces the TPU kernels stage4_pallas and stage4_pallas_chunked
// (exsr/ops/pallas/stage4.py, _kernel / _kernel_prepad / _stage4_core):
//
//   out = cast(0.2 * ((conv3x3_SAME(c3, w4) + b4) + sum_{g<4} P_g[..., :nf]))
//         + x
//
// with c3 [B,H,W,gc], P_g [B,H,W,cp_g] of which only the leading nf channels
// are read (s4-first packing), x and out [B,H,W,nf], w4 HWIO [3,3,gc,nf] in
// the activation dtype and b4 fp32 [nf].  bf16 or fp32 activations, fp32
// accumulation; the rounding order follows stage4.py:72-78: the scaled sum
// is cast to the dtype first, then x is added.  The row chunking of the TPU
// version existed only for a Mosaic compile limit; one kernel serves both
// entry points here.
//
// Bound on the H100: bytes.  In bf16 the function moves 832 bytes per pixel
// (c3, four nf-wide partial reads, x, out) against 2*9*gc*nf = 36,864 flops,
// about 44 flops per byte, far under the bf16 tensor-core ridge point
// (~295).  The design keeps the byte stream going and the arithmetic off its
// path:
//
// bf16: persistent blocks, one per SM, walking over 8 x 8 output tiles with
// a stride of gridDim.x.  Each tile's inputs (c3 with its 1-pixel halo, the
// four nf-wide P slices and x) arrive by cp.async 16-byte copies into a ring
// of two stages in shared memory; the zero-fill form (source size 0) gives
// SAME padding and the ragged edge without a branch.  Four producer warps
// do nothing but copy: they fill a stage as soon as the consumers release
// it and signal it full through an mbarrier (cp.async.mbarrier.arrive), so
// the next tile's bytes are in flight while the consumers compute.  (With
// every warp copying at the top of its own tile and computing after, copies
// issued ahead stopped while the warps computed: 130 against 109-110 us at
// batch 16, 128 x 128, gc 32, nf 64 on an H100 80GB HBM3 at 700 W.)
// Eight consumer warps stage w4 once (per tap and 16-channel step, each
// output channel's 16 inputs as two 16-byte halves, swapped on every other
// group of four channels so that ldmatrix reads are free of bank
// conflicts), then per tile run the conv on the tensor cores, mma.sync
// m16n8k16 (bf16 in, fp32 accumulate), A by ldmatrix.x4 straight from the
// c3 halo tile (each lane's row address shifted by the tap, no im2col), B by
// ldmatrix.x4 from w4; a warp computes 32 pixels x 16 channels.  Pixel
// strides in shared memory are an odd number of 16-byte words, so the 8
// rows of an ldmatrix and the epilogue's fragment-layout reads fall in
// distinct banks.  The epilogue reads the partials and x from the stage in
// the accumulators' layout and writes the result over x; after a barrier of
// the consumers they store the tile with 16-byte stores and release the
// stage.  Nothing of a tile is read twice from device memory.
//
// fp32: the default dtype of build_model (the eval_sr CLI), of EditSession
// (edit_dtype=None with its grouped trunk) and so of the server's SR mode:
// 69 launches a forward there.  fp32 FMA on the CUDA cores (TF32 stays
// off).  Bound on the H100 almost equally by operations (144 us at
// batch 16, LR 128, gc 32, nf 64: 2 * 9 * 32 * 64 flops a pixel at 67
// TFLOP/s) and by bytes (436 MB at 3.35 TB/s, 130 us), so the bytes have to
// stream under the FMAs.  A warp's 16-byte shared load delivers 512
// bytes, four of the SM's 128 a clock, whatever lanes share an address, so
// a thread should do 4 FMAs per float it loads (fma_conv.cuh): 8 pixels x
// 8 outputs a thread (8 + 8 loads of 16 bytes per 256 FMAs), and 16 x 16
// output tiles for 256 consumer threads.  Persistent blocks, one
// per SM; w4 (73.7 KB at gc 32) staged once per block as [tap][k][64
// outputs], zero-padded.  Four producer warps bring each tile's c3 halo
// (18 x 18 pixels) by cp.async and, while the consumers run the conv, sum
// the four P slices, ((P0 + P1) + P2) + P3 as stage4_plain does, into a
// shared `part` tile (64 KB); x is prefetched into L2 when the tile starts
// and read in the epilogue.  Two more c3 stages or a second part tile do
// not fit beside w4, so each is single: c3 of tile n + 1 is copied while
// the consumers run tile n's epilogue, its partial sums while they run
// its conv (full / empty mbarrier pairs).  A first version, 4 pixels x 8
// outputs a thread with P and x streamed into registers under the taps,
// took 340 us: 12 loads per 128 FMAs.  The one before it (a block per
// 16 x 16 tile, all of w4 copied again by each block, the FMAs after the
// staging) took 671 us.  What bounds this one (~295 us): the conv.  The
// byte stream alone runs in 161 us (2.7 TB/s; stage4_probe.py --ablate
// fp32_no_conv), and the FMA loop issues an FFMA about every 2 clocks
// where it has 1.13 instructions per FFMA: 202 of its 512 FFMAs read
// their two non-reused operands from one register bank, and ptxas chooses
// the registers; hoisting the shared loads out of the loop saves only 8 %.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fma_conv.cuh"

namespace {

// ------------------------------------------------------------------ bf16

constexpr int kT = 8;             // output tile is kT x kT pixels
constexpr int kTP = kT * kT;      // pixels per tile
constexpr int kHT = kT + 2;       // c3 tile with its halo, per side
constexpr int kMT = 2;            // m16 tiles (16 pixels each) per warp
constexpr int kMG = kTP / 16 / kMT;  // warps along the tile's pixels
// consumers: kMG warps along the pixels x 4 along nf 64 (16 channels
// each); they compute and store.  Producers: 4 warps that only copy.
constexpr int kConsumers = 32 * kMG * 4;
constexpr int kProducers = 128;
constexpr int kThreads = kConsumers + kProducers;
constexpr int kBarConsumers = 1;  // named barrier of the consumers
constexpr int kBarBytes = 64;     // full and empty mbarriers, <= 4 stages
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may use

struct Args {
  const __nv_bfloat16* c3;
  const __nv_bfloat16* p[4];
  const __nv_bfloat16* x;
  const __nv_bfloat16* w4;
  const float* b4;
  __nv_bfloat16* out;
  int H, W, gc, gcp, tiles_x, tiles_y, tiles;
  int cp[4];
};

// Shared-memory geometry in bytes: c3 and P/x pixel strides are the
// channels plus one 16-byte word (an odd number of words), one ring stage
// holds the c3 halo tile and the five nf-wide slices (P0..P3, x).
__host__ __device__ constexpr int c3_stride(int gcp) { return 2 * (gcp + 8); }
__host__ __device__ constexpr int px_stride(int nf) { return 2 * (nf + 8); }
__host__ __device__ constexpr int stage_bytes(int gcp, int nf) {
  return kHT * kHT * c3_stride(gcp) + 5 * kTP * px_stride(nf);
}
__host__ __device__ constexpr int w4_bytes(int gcp, int nf) {
  return 9 * gcp * nf * 2;
}
size_t mma_smem(int gcp, int nf, int stages) {
  return kBarBytes + (size_t)w4_bytes(gcp, nf) +
         (size_t)stages * stage_bytes(gcp, nf);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes from global to shared memory, asynchronously; `n` bytes
// are read and the rest of the destination is zero-filled (n = 0: zeros).
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp4(uint32_t dst, const void* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}
// The barrier at `bar` counts an arrive of this thread once all of its
// earlier cp.async copies have landed.
__device__ __forceinline__ void cp_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
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

// named barrier of the N consumer threads
template <int N>
__device__ __forceinline__ void consumer_sync_n() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(kBarConsumers), "n"(N)
               : "memory");
}
__device__ __forceinline__ void consumer_sync() {
  consumer_sync_n<kConsumers>();
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of w4[tap][k][n] in shared memory: [tap][k/16][n][two
// 16-byte halves of k%16], the halves swapped when bit 2 of n is set.
template <int NF>
__device__ __forceinline__ int w4_offset(int tap, int k, int n, int kc_n) {
  const int half = ((k >> 3) & 1) ^ ((n >> 2) & 1);
  return ((tap * kc_n + (k >> 4)) * NF + n) * 32 + half * 16 + (k & 7) * 2;
}

// w4 HWIO into shared memory once per block, by the consumers, zero for k
// in [gc, gcp).  Rows of 8 output channels are read as 16-byte words, four
// at a time.
template <int NF>
__device__ __forceinline__ void stage_w4(const Args& a, unsigned char* w_s) {
  constexpr int kRow = NF / 8;  // 16-byte words per (tap, k)
  const int kc_n = a.gcp / 16;
  const int words = 9 * a.gcp * kRow;
  for (int i0 = threadIdx.x; i0 < words; i0 += 4 * kConsumers) {
    uint4 v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = i0 + j * kConsumers;
      const int tk = i / kRow, k = tk % a.gcp, tap = tk / a.gcp;
      v[j] = make_uint4(0, 0, 0, 0);
      if (i < words && k < a.gc)
        v[j] = *reinterpret_cast<const uint4*>(
            a.w4 + (size_t)(tap * a.gc + k) * NF + (i % kRow) * 8);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = i0 + j * kConsumers;
      if (i >= words) break;
      const int tk = i / kRow, k = tk % a.gcp, tap = tk / a.gcp;
      const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v[j]);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int n = (i % kRow) * 8 + e;
        *reinterpret_cast<__nv_bfloat16*>(
            w_s + w4_offset<NF>(tap, k, n, kc_n)) = h[e];
      }
    }
  }
}

// Producer thread `tid`'s share of the copies of tile `t` into the ring
// stage at `st` (shared address); zeros outside the image.
template <int NF>
__device__ __forceinline__ void issue_tile(const Args& a, uint32_t st, int t,
                                           int tid) {
  const int per_img = a.tiles_y * a.tiles_x;
  const int b = t / per_img, r = t - b * per_img;
  const int ty = r / a.tiles_x;
  const int y0 = ty * kT, x0 = (r - ty * a.tiles_x) * kT;
  const size_t img = (size_t)b * a.H * a.W;
  const int c3s = c3_stride(a.gcp);
  if (a.gc % 8 == 0) {  // 16-byte words of c3
    const int wpp = a.gcp / 8;
    for (int i = tid; i < kHT * kHT * wpp; i += kProducers) {
      const int hp = i / wpp, w = i - hp * wpp;
      const int hy = hp / kHT, gy = y0 - 1 + hy, gx = x0 - 1 + hp - hy * kHT;
      const bool ok = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W &&
                      8 * w < a.gc;
      const __nv_bfloat16* src =
          ok ? a.c3 + (img + (size_t)gy * a.W + gx) * a.gc + 8 * w : a.c3;
      cp16(st + hp * c3s + 16 * w, src, ok ? 16 : 0);
    }
  } else {  // channel pairs (gc even, pixel rows 4-byte aligned)
    const int wpp = a.gcp / 2;
    for (int i = tid; i < kHT * kHT * wpp; i += kProducers) {
      const int hp = i / wpp, w = i - hp * wpp;
      const int hy = hp / kHT, gy = y0 - 1 + hy, gx = x0 - 1 + hp - hy * kHT;
      const bool ok = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W &&
                      2 * w < a.gc;
      const __nv_bfloat16* src =
          ok ? a.c3 + (img + (size_t)gy * a.W + gx) * a.gc + 2 * w : a.c3;
      cp4(st + hp * c3s + 4 * w, src, ok ? 4 : 0);
    }
  }
  constexpr int kWords = NF / 8, ps = px_stride(NF);
  const uint32_t sp = st + kHT * kHT * c3s;  // P0..P3, x: kTP * ps each
  for (int i = tid; i < kTP * kWords; i += kProducers) {
    const int p = i / kWords, w = i - p * kWords;
    const int gy = y0 + p / kT, gx = x0 + p % kT;
    const bool ok = gy < a.H && gx < a.W;
    const size_t pix = img + (size_t)gy * a.W + gx;
    const uint32_t d = sp + p * ps + 16 * w;
#pragma unroll
    for (int g = 0; g < 4; ++g)
      cp16(d + g * kTP * ps, ok ? a.p[g] + pix * a.cp[g] + 8 * w : a.p[g],
           ok ? 16 : 0);
    cp16(d + 4 * kTP * ps, ok ? a.x + pix * NF + 8 * w : a.x, ok ? 16 : 0);
  }
}

template <int NF, int S>
__global__ void __launch_bounds__(kThreads, 1) stage4_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int ps = px_stride(NF);
  const int kc_n = a.gcp / 16, c3s = c3_stride(a.gcp);
  const int sbytes = stage_bytes(a.gcp, NF);
  unsigned char* w_s = smem + kBarBytes;
  unsigned char* ring = w_s + w4_bytes(a.gcp, NF);
  const uint32_t w_sa = smem_addr(w_s), ring_sa = smem_addr(ring);
  // stage s: full[s] completes when the producers' copies have landed,
  // empty[s] when every consumer warp is done with it
  const uint32_t full = smem_addr(smem), empty = full + 8 * S;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, kProducers);
      mbar_init(empty + 8 * s, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // producers: fill each stage once the consumers have released it, so
    // that copies stay in flight while the consumers compute
    const int tid = threadIdx.x - kConsumers;
    int it = 0;
    for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x, ++it) {
      const int s = it % S;
      if (it >= S) mbar_wait(empty + 8 * s, ((it / S) & 1) ^ 1);
      issue_tile<NF>(a, ring_sa + s * sbytes, tile, tid);
      cp_arrive(full + 8 * s);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  stage_w4<NF>(a, w_s);
  consumer_sync();

  // warp unit: m16 tiles [kMT mg, kMT mg + kMT) of the tile (two tile rows
  // each), output channels [16 ng, 16 ng + 16)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool computes = warp < kMG * (NF / 16);
  const int mg = warp % kMG, ng = warp / kMG;
  const int q = lane >> 3, r8 = lane & 7, g = lane >> 2, t4 = lane & 3;
  // ldmatrix row addresses: A rows are pixels (m16 tile = two tile rows),
  // columns k; B rows are output channels n, columns k
  const int a_off =
      ((2 * kMT * mg + (q & 1)) * kHT + r8) * c3s + (q >> 1) * 16;
  const int bn = 16 * ng + 8 * (q >> 1) + r8;
  const int b_off = bn * 32 + (((q & 1) ^ ((bn >> 2) & 1)) << 4);
  float bias[2][2];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int n = computes ? 16 * ng + 8 * nt + 2 * t4 : 0;
    bias[nt][0] = a.b4[n];
    bias[nt][1] = a.b4[n + 1];
  }

  int it = 0;
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x, ++it) {
    const int slot = it % S;
    mbar_wait(full + 8 * slot, (it / S) & 1);
    unsigned char* st = ring + slot * sbytes;
    unsigned char* sx = st + kHT * kHT * c3s + 4 * kTP * ps;

    if (computes) {
      float acc[kMT][2][4] = {};
      const uint32_t a_base = ring_sa + slot * sbytes + a_off;
      const uint32_t b_base = w_sa + b_off;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const uint32_t a_tap = a_base + ((tap / 3) * kHT + tap % 3) * c3s;
        for (int kc = 0; kc < kc_n; ++kc) {
          uint32_t a[kMT][4], b[4];
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt)
            ldsm4(a[mt], a_tap + 2 * mt * kHT * c3s + kc * 32);
          ldsm4(b, b_base + (tap * kc_n + kc) * NF * 32);
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            mma_bf16(acc[mt][0], a[mt], b[0], b[1]);
            mma_bf16(acc[mt][1], a[mt], b[2], b[3]);
          }
        }
      }
      // accumulator (mt, nt, 2h + j): pixel 16 (kMT mg + mt) + 8 h + g,
      // channel 16 ng + 8 nt + 2 t4 + j
      const unsigned char* sp = st + kHT * kHT * c3s;
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = 16 * (kMT * mg + mt) + 8 * h + g;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int off = p * ps + 2 * (16 * ng + 8 * nt + 2 * t4);
            float2 part = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(sp + off));
#pragma unroll
            for (int gi = 1; gi < 4; ++gi) {
              const float2 v = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(
                      sp + gi * kTP * ps + off));
              part.x += v.x;
              part.y += v.y;
            }
            __nv_bfloat162* xo = reinterpret_cast<__nv_bfloat162*>(sx + off);
            const float2 xv = __bfloat1622float2(*xo);
            const float c0 = acc[mt][nt][2 * h] + bias[nt][0];
            const float c1 = acc[mt][nt][2 * h + 1] + bias[nt][1];
            const float2 s = __bfloat1622float2(
                __floats2bfloat162_rn((c0 + part.x) * 0.2f,
                                      (c1 + part.y) * 0.2f));
            *xo = __floats2bfloat162_rn(s.x + xv.x, s.y + xv.y);
          }
        }
      }
    }
    consumer_sync();  // the tile's result is in the x slice of the stage
    const int per_img = a.tiles_y * a.tiles_x;
    const int b = tile / per_img, rr = tile - b * per_img;
    const int ty = rr / a.tiles_x;
    const int y0 = ty * kT, x0 = (rr - ty * a.tiles_x) * kT;
    constexpr int kWords = NF / 8;
    for (int i = threadIdx.x; i < kTP * kWords; i += kConsumers) {
      const int p = i / kWords, w = i - p * kWords;
      const int gy = y0 + p / kT, gx = x0 + p % kT;
      if (gy < a.H && gx < a.W)
        *reinterpret_cast<uint4*>(
            a.out + ((size_t)b * a.H * a.W + (size_t)gy * a.W + gx) * NF +
            8 * w) = *reinterpret_cast<const uint4*>(sx + p * ps + 16 * w);
    }
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty + 8 * slot);
  }
}

// Ring stages for (gc, nf): 2 (a third measured no faster), or 1 where
// shared memory is short (gc > 80 at nf 64); 0 when not even one fits.
int ring_stages(int gcp, int nf) {
  for (int s = 2; s >= 1; --s)
    if (mma_smem(gcp, nf, s) <= (size_t)kMaxSmem) return s;
  return 0;
}

template <int NF, int S>
int launch_mma(const Args& a, cudaStream_t stream) {
  const size_t smem = mma_smem(a.gcp, NF, S);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  // per device: the SM count, and the shared memory the attribute allows
  static int sms[64] = {};
  static size_t allowed[64] = {};
  if (sms[dev] == 0) {
    e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    if (e != cudaSuccess) return (int)e;
  }
  if (smem > allowed[dev]) {
    e = cudaFuncSetAttribute(stage4_kernel<NF, S>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    allowed[dev] = smem;
  }
  const int grid = a.tiles < sms[dev] ? a.tiles : sms[dev];
  stage4_kernel<NF, S><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int NF>
int launch_nf(const Args& a, int stages, cudaStream_t stream) {
  switch (stages) {
    case 2: return launch_mma<NF, 2>(a, stream);
    case 1: return launch_mma<NF, 1>(a, stream);
  }
  return (int)cudaErrorInvalidValue;
}

int launch_bf16(const void* c3, const void* const (&p)[4], const void* x,
                const void* w4, const void* b4, void* out, int B, int H,
                int W, int gc, int nf, const int (&cp)[4],
                cudaStream_t stream) {
  Args a;
  a.c3 = static_cast<const __nv_bfloat16*>(c3);
  for (int g = 0; g < 4; ++g) {
    a.p[g] = static_cast<const __nv_bfloat16*>(p[g]);
    a.cp[g] = cp[g];
  }
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w4 = static_cast<const __nv_bfloat16*>(w4);
  a.b4 = static_cast<const float*>(b4);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.H = H;
  a.W = W;
  a.gc = gc;
  a.gcp = (gc + 15) / 16 * 16;
  a.tiles_x = (W + kT - 1) / kT;
  a.tiles_y = (H + kT - 1) / kT;
  a.tiles = B * a.tiles_x * a.tiles_y;
  if (a.tiles == 0) return 0;
  const int stages = ring_stages(a.gcp, nf);
  switch (nf) {
    case 16: return launch_nf<16>(a, stages, stream);
    case 32: return launch_nf<32>(a, stages, stream);
    case 48: return launch_nf<48>(a, stages, stream);
    case 64: return launch_nf<64>(a, stages, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------------------------------ fp32

// Output tile kFT x kFT pixels, its c3 halo tile (kFT + 2)^2; eight
// consumer warps, four producer warps.
constexpr int kFT = 16;
constexpr int kFHaloW = kFT + 2, kFHaloPx = kFHaloW * kFHaloW;
constexpr int kFConsumers = 256;
constexpr int kFProducers = 128;
constexpr int kFThreads = kFConsumers + kFProducers;
constexpr int kFN = 64;      // w4 columns in shared memory: nf padded to 64
constexpr int kFPartS = 68;  // part's pixel stride: 4 (mod 8) floats
constexpr int kFItems = 8;   // P items a producer thread has in flight

// c3's channels padded to a multiple of 4 (zeros; so is w4's K), and the
// pixel stride in floats: 4 (mod 8), so that 8 consecutive pixels' float4s
// fall in distinct banks (fma_conv.cuh).
__host__ __device__ constexpr int fma_k(int gc) { return (gc + 3) / 4 * 4; }
__host__ __device__ constexpr int fma_stride(int gc) {
  return fma_k(gc) % 8 == 4 ? fma_k(gc) : fma_k(gc) + 4;
}
__host__ __device__ constexpr int fma_c3_bytes(int gc) {
  return kFHaloPx * fma_stride(gc) * 4;
}
__host__ __device__ constexpr int fma_w4_bytes(int gc) {
  return 9 * fma_k(gc) * kFN * 4;
}
constexpr int kFPartBytes = kFT * kFT * kFPartS * 4;
size_t fma_smem(int gc) {
  return kBarBytes + (size_t)fma_w4_bytes(gc) + fma_c3_bytes(gc) +
         kFPartBytes;
}

struct FArgs {
  const float* c3;
  const float* p[4];
  const float* x;
  const float* w4;
  const float* b4;
  float* out;
  int H, W, gc, nf, tiles_x, tiles_y, tiles;
  int cp[4];
};

__device__ __forceinline__ void cp8(uint32_t dst, const void* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void prefetch_l2(const float* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// Tile t's origin and image.
struct FTile {
  int y0, x0;
  size_t img;
  __device__ FTile(const FArgs& a, int t) {
    const int per_img = a.tiles_y * a.tiles_x;
    const int b = t / per_img, r = t - b * per_img;
    const int ty = r / a.tiles_x;
    y0 = ty * kFT;
    x0 = (r - ty * a.tiles_x) * kFT;
    img = (size_t)b * a.H * a.W;
  }
};

// The producers' share of tile t's c3 halo into `st` (shared address):
// 16-byte copies, or 8-byte ones when gc is not a multiple of 4 (gc is
// even); zeros outside the image and for k >= gc.
__device__ __forceinline__ void fma_issue_c3(const FArgs& a, uint32_t st,
                                             const FTile& f, int tid) {
  const int ps = 4 * fma_stride(a.gc);
  const int wide = a.gc % 4 == 0, wbytes = wide ? 16 : 8;
  const int wpp = fma_k(a.gc) * 4 / wbytes;  // words a pixel
  for (int i = tid; i < kFHaloPx * wpp; i += kFProducers) {
    const int hp = i / wpp, w = i - hp * wpp;
    const int hy = hp / kFHaloW;
    const int gy = f.y0 - 1 + hy, gx = f.x0 - 1 + hp - hy * kFHaloW;
    const int k = w * wbytes / 4;
    const bool ok = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W && k < a.gc;
    const float* src =
        ok ? a.c3 + (f.img + (size_t)gy * a.W + gx) * a.gc + k : a.c3;
    if (wide)
      cp16(st + hp * ps + 16 * w, src, ok ? 16 : 0);
    else
      cp8(st + hp * ps + 8 * w, src, ok ? 8 : 0);
  }
}

// The producers' share of tile t's partial sum ((P0 + P1) + P2) + P3 on
// the nf channels into `part` ([pixel][kFPartS]), kFItems float4s of each
// slice in flight a thread; pixels outside the image are left as they are.
__device__ __forceinline__ void fma_fill_part(const FArgs& a, float* part,
                                              const FTile& f, int tid) {
  const int quads = a.nf / 4, items = kFT * kFT * quads;
  for (int i0 = tid; i0 < items; i0 += kFItems * kFProducers) {
    float4 v[kFItems][4];
    size_t pix[kFItems];
    bool ok[kFItems];
#pragma unroll
    for (int j = 0; j < kFItems; ++j) {
      const int i = i0 + j * kFProducers, m = i / quads;
      const int gy = f.y0 + m / kFT, gx = f.x0 + m % kFT;
      ok[j] = i < items && gy < a.H && gx < a.W;
      pix[j] = ok[j] ? f.img + (size_t)gy * a.W + gx : 0;
      const int c = 4 * (i - m * quads);
#pragma unroll
      for (int g = 0; g < 4; ++g)
        v[j][g] = ok[j] ? __ldcs(reinterpret_cast<const float4*>(
                              a.p[g] + pix[j] * a.cp[g] + c))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < kFItems; ++j) {
      const int i = i0 + j * kFProducers, m = i / quads;
      if (!ok[j]) continue;
      float4 s = v[j][0];
#pragma unroll
      for (int g = 1; g < 4; ++g) {
        s.x += v[j][g].x;
        s.y += v[j][g].y;
        s.z += v[j][g].z;
        s.w += v[j][g].w;
      }
      *reinterpret_cast<float4*>(part + m * kFPartS + 4 * (i - m * quads)) =
          s;
    }
  }
}

__device__ __forceinline__ float4 ld_stream(const float* p, bool ok) {
  return ok ? __ldcs(reinterpret_cast<const float4*>(p))
            : make_float4(0.f, 0.f, 0.f, 0.f);
}

// One output: ((conv + b4) + partial) * 0.2 + x, each op rounded in
// stage4_plain's order (no contraction into an FMA).
__device__ __forceinline__ float fma_out(float acc, float b, float part,
                                         float x) {
  return __fadd_rn(__fmul_rn(__fadd_rn(__fadd_rn(acc, b), part), 0.2f), x);
}

__global__ void __launch_bounds__(kFThreads, 1)
    stage4_fma_kernel(const FArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* w_s = reinterpret_cast<float*>(smem + kBarBytes);  // [9][kp][64]
  float* c3_s = reinterpret_cast<float*>(smem + kBarBytes +
                                         fma_w4_bytes(a.gc));
  float* part = c3_s + fma_c3_bytes(a.gc) / 4;
  const int kp = fma_k(a.gc), ps = fma_stride(a.gc);
  // c3 full / empty, part full / empty
  const uint32_t bars = smem_addr(smem);
  const uint32_t c3_full = bars, c3_empty = bars + 8;
  const uint32_t part_full = bars + 16, part_empty = bars + 24;
  if (threadIdx.x == 0) {
    mbar_init(c3_full, kFProducers);
    mbar_init(c3_empty, kFConsumers / 32);
    mbar_init(part_full, kFProducers);
    mbar_init(part_empty, kFConsumers / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kFConsumers) {
    // producers: tile n's c3 once the consumers' conv of tile n - 1 is
    // done, its partial sums once their epilogue of n - 1 is
    const int tid = threadIdx.x - kFConsumers;
    int it = 0;
    for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x, ++it) {
      const FTile f(a, tile);
      if (it > 0) mbar_wait(c3_empty, (it - 1) & 1);
      fma_issue_c3(a, smem_addr(c3_s), f, tid);
      cp_arrive(c3_full);
      if (it > 0) mbar_wait(part_empty, (it - 1) & 1);
      fma_fill_part(a, part, f, tid);
      mbar_arrive(part_full);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // w4 once per block: [tap][k][n] as HWIO, zeros for k >= gc, n >= nf;
  // all of it in flight at once
  for (int i = threadIdx.x; i < 9 * kp * (kFN / 4); i += kFConsumers) {
    const int n = 4 * (i % (kFN / 4)), tk = i / (kFN / 4);
    const int k = tk % kp, tap = tk / kp;
    const bool ok = k < a.gc && n < a.nf;
    cp16(smem_addr(w_s) + 16 * i,
         ok ? a.w4 + (size_t)(tap * a.gc + k) * a.nf + n : a.w4,
         ok ? 16 : 0);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  consumer_sync_n<kFConsumers>();

  // lane (q, cg) of warp w: pixel group g = 4 w + q, its pixels 32 j + g
  // (rows 2 j + g / 16, column g % 16: a warp's lanes read 4 consecutive
  // pixels), output channels [4 cg, 4 cg + 4) and [32 + 4 cg, 32 + 4 cg + 4)
  const int lane = threadIdx.x & 31, cg = lane & 7;
  const int g = 4 * (threadIdx.x >> 5) + (lane >> 3);
  const int row0 = g / kFT, col = g % kFT;
  const int ch[2] = {4 * cg, 32 + 4 * cg};
  const bool chok[2] = {ch[0] < a.nf, ch[1] < a.nf};
  float bias[2][4];
#pragma unroll
  for (int v = 0; v < 2; ++v)
#pragma unroll
    for (int e = 0; e < 4; ++e) bias[v][e] = chok[v] ? a.b4[ch[v] + e] : 0.f;

  int it = 0;
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x, ++it) {
    const FTile f(a, tile);
    const int gx = f.x0 + col;
    // x into L2 now, for the epilogue
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gy = f.y0 + 2 * j + row0;
      if (gy < a.H && gx < a.W)
#pragma unroll
        for (int v = 0; v < 2; ++v)
          if (chok[v])
            prefetch_l2(a.x + (f.img + (size_t)gy * a.W + gx) * a.nf +
                        ch[v]);
    }
    mbar_wait(c3_full, it & 1);
    float4 acc[8][2] = {};
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const float* at =
          c3_s + ((row0 + tap / 3) * kFHaloW + col + tap % 3) * ps;
      const float* ap[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) ap[j] = at + j * 2 * kFHaloW * ps;
      fma_conv::mac<8, 2>(acc, ap, w_s + tap * kp * kFN + ch[0], kFN, 32,
                          kp);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(c3_empty);

    // the epilogue: every x load in flight at once, then the partial sums
    bool ok[8];
    size_t pix[8];
    float4 xs[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gy = f.y0 + 2 * j + row0;
      ok[j] = gy < a.H && gx < a.W;
      pix[j] = ok[j] ? f.img + (size_t)gy * a.W + gx : 0;
#pragma unroll
      for (int v = 0; v < 2; ++v)
        xs[j][v] = ld_stream(a.x + pix[j] * a.nf + ch[v], ok[j] && chok[v]);
    }
    mbar_wait(part_full, it & 1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        if (!ok[j] || !chok[v]) continue;
        const float4 pp = *reinterpret_cast<const float4*>(
            part + (32 * j + g) * kFPartS + ch[v]);
        const float4 xv = xs[j][v];
        const float4 c = fma_conv::channels(acc[j][v]);
        const float4 o = make_float4(fma_out(c.x, bias[v][0], pp.x, xv.x),
                                     fma_out(c.y, bias[v][1], pp.y, xv.y),
                                     fma_out(c.z, bias[v][2], pp.z, xv.z),
                                     fma_out(c.w, bias[v][3], pp.w, xv.w));
        __stcs(reinterpret_cast<float4*>(a.out + pix[j] * a.nf + ch[v]), o);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(part_empty);
  }
}

int launch_fp32(const void* c3, const void* const (&p)[4], const void* x,
                const void* w4, const void* b4, void* out, int B, int H,
                int W, int gc, int nf, const int (&cp)[4],
                cudaStream_t stream) {
  FArgs a;
  a.c3 = static_cast<const float*>(c3);
  for (int g = 0; g < 4; ++g) {
    a.p[g] = static_cast<const float*>(p[g]);
    a.cp[g] = cp[g];
  }
  a.x = static_cast<const float*>(x);
  a.w4 = static_cast<const float*>(w4);
  a.b4 = static_cast<const float*>(b4);
  a.out = static_cast<float*>(out);
  a.H = H;
  a.W = W;
  a.gc = gc;
  a.nf = nf;
  a.tiles_x = (W + kFT - 1) / kFT;
  a.tiles_y = (H + kFT - 1) / kFT;
  a.tiles = B * a.tiles_x * a.tiles_y;
  const size_t smem = fma_smem(gc);
  if (smem > (size_t)kMaxSmem || nf > kFN) return (int)cudaErrorInvalidValue;
  if (a.tiles == 0) return 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  static int sms[64] = {};
  static size_t allowed[64] = {};
  if (sms[dev] == 0) {
    e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    if (e != cudaSuccess) return (int)e;
  }
  if (smem > allowed[dev]) {
    e = cudaFuncSetAttribute(stage4_fma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    allowed[dev] = smem;
  }
  const int grid = a.tiles < sms[dev] ? a.tiles : sms[dev];
  stage4_fma_kernel<<<grid, kFThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}
}  // namespace

extern "C" {

// Dynamic shared memory a launch needs, in bytes (bf16: with the ring
// stages that fit, or one stage when none does).
size_t exsr_stage4_smem(int gc, int nf, int is_bf16) {
  if (!is_bf16) return fma_smem(gc);
  const int gcp = (gc + 15) / 16 * 16, stages = ring_stages(gcp, nf);
  return mma_smem(gcp, nf, stages ? stages : 1);
}

// Launches on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for widths the kernel is not built for.  The caller
// guarantees nf in (16, 32, 48, 64), even gc, cp_g % 8 == 0, 16-byte
// aligned pointers, and (bf16) that at least one ring stage fits in shared
// memory, as exsr_torch/ops/kernels/stage4.py checks.
int exsr_stage4(const void* c3, const void* p0, const void* p1,
                const void* p2, const void* p3, const void* x, const void* w4,
                const void* b4, void* out, int B, int H, int W, int gc, int nf,
                int cp0, int cp1, int cp2, int cp3, int is_bf16,
                void* stream) {
  const void* const p[4] = {p0, p1, p2, p3};
  const int cp[4] = {cp0, cp1, cp2, cp3};
  if (is_bf16)
    return launch_bf16(c3, p, x, w4, b4, out, B, H, W, gc, nf, cp,
                       (cudaStream_t)stream);
  return launch_fp32(c3, p, x, w4, b4, out, B, H, W, gc, nf, cp,
                     (cudaStream_t)stream);
}

const char* exsr_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
