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
// the halo: 1.53x the useful work at 8 x 16 (bf16), 2.26x at 4 x 8 (fp32).
//
// bf16: 8 x 16 tiles, 202 KB of pixels plus 24 KB of weights in shared
// memory, one block of 12 warps per SM.  The products run on the tensor
// cores with mma.sync m16n8k16 (bf16 in, fp32 accumulate).  A warp takes 32
// pixels x 32 (or 16) output channels per step; A fragments are 32-bit
// shared loads (the pixel stride is 4 words off a multiple of 8, so a
// warp's 8 rows hit distinct banks).  An RDB's weights (490 KB) do not fit
// on chip: the wrapper stores them in B-fragment order and the block
// streams them through a two-buffer cp.async ring in chunks of 6 (tap,
// 16-channel) steps of conv 4 (12 of the narrower convs), so each weight
// crosses from L2 once per block instead of once per warp.  The inputs
// arrive by cp.async too.  Each chunk costs a block barrier, which is why
// the chunks are as large as shared memory allows.
// fp32: 4 x 8 tiles and fp32 FMA, 4 pixels x 8 channels per thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kZs = 16;        // channel slots of z (nz <= 16), zero-padded
constexpr int kThreads = 384;  // 12 warps
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 6;      // (tap, 16-channel) steps per weight chunk
constexpr int kStages = 2;     // shared weight buffers in the ring

struct Params {
  const void* x;      // [B,H,W,nf]
  const void* z;      // [B,H,W,nz]
  const void* x0;     // [B,H,W,nf], or null: no outer residual
  void* out;          // [B,H,W,nf]
  const void* w;      // packed weights of the five convs
  const float* bias;  // packed fp32 biases of the five convs
  int H, W, nf, nz, gcp, cs;
  int w_off[5], b_off[5];  // element offsets of conv i in w and bias
  int wbuf_len;            // uint2 per shared weight buffer (bf16)
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
// 16-byte chunks, x copied by cp.async, the z slot built in registers.
template <int TH, int TW>
__device__ __forceinline__ void load_inputs(const Params& p,
                                            __nv_bfloat16* feat, int ty0,
                                            int tx0, size_t img) {
  constexpr int BH = TH + 10, BW = TW + 10;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
  const __nv_bfloat16* z = static_cast<const __nv_bfloat16*>(p.z);
  const int chunks = kZs / 8 + p.nf / 8;  // chunk u holds slots 8u..8u+7
  for (int idx = threadIdx.x; idx < BH * BW * chunks; idx += kThreads) {
    const int px = idx / chunks, u = idx - px * chunks;
    const int by = px / BW, bx = px - by * BW;
    const int gy = ty0 + by, gx = tx0 + bx;
    const bool inside = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
    const size_t g = img + (size_t)gy * p.W + gx;
    uint4* dst = reinterpret_cast<uint4*>(feat + px * p.cs + 8 * u);
    if (u >= kZs / 8 && inside) {
      cp_async16(dst, x + g * p.nf + 8 * u - kZs);
    } else {
      __align__(16) __nv_bfloat16 v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * u + j;
        v[j] = __float2bfloat16_rn(0.f);
        if (inside && c < p.nz) v[j] = z[g * p.nz + c];
      }
      *dst = *reinterpret_cast<const uint4*>(v);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// fp32: one element at a time (the fp32 pixel stride is odd)
template <typename T, int TH, int TW>
__device__ __forceinline__ void load_inputs(const Params& p, T* feat,
                                            int ty0, int tx0, size_t img) {
  constexpr int BH = TH + 10, BW = TW + 10;
  const T* x = static_cast<const T*>(p.x);
  const T* z = static_cast<const T*>(p.z);
  const int c0 = kZs + p.nf;
  for (int idx = threadIdx.x; idx < BH * BW * c0; idx += kThreads) {
    const int px = idx / c0, c = idx - px * c0;
    const int by = px / BW, bx = px - by * BW;
    const int gy = ty0 + by, gx = tx0 + bx;
    T v = from_f<T>(0.f);
    if (gy >= 0 && gy < p.H && gx >= 0 && gx < p.W) {
      const size_t g = img + (size_t)gy * p.W + gx;
      if (c >= kZs)
        v = x[g * p.nf + (c - kZs)];
      else if (c < p.nz)
        v = z[g * p.nz + c];
    }
    feat[px * p.cs + c] = v;
  }
}

// Geometry of conv i: its output region is the tile grown by 4 - i pixels
// a side, starting at buffer pixel (o, o); K input slots, N output slots.
struct Stage {
  int o, rw, m, k, n;
  __device__ Stage(const Params& p, int i, int th, int tw)
      : o(i + 1),
        rw(tw + 2 * (4 - i)),
        m((th + 2 * (4 - i)) * (tw + 2 * (4 - i))),
        k(kZs + p.nf + i * p.gcp),
        n(i < 4 ? p.gcp : p.nf) {}
};

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy the fragments of steps [it0, it1) of one conv (nt_n * 32 uint2
// each) into a shared buffer, as one cp.async group.
__device__ __forceinline__ void stage_weights(uint2* dst, const uint2* src,
                                              int it0, int it1, int nt_n) {
  const uint4* s = reinterpret_cast<const uint4*>(src + it0 * nt_n * 32);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (int j = threadIdx.x; j < (it1 - it0) * nt_n * 16; j += kThreads)
    cp_async16(d + j, s + j);
  asm volatile("cp.async.commit_group;\n" ::);
}

// conv i on the tensor cores.  A warp step covers two m16 tiles of the
// region's pixels (row-major over the region) and NTU n8 tiles of outputs.
// Weights: [tap][K/16][N/8][lane] of uint2, lane (g, t) holding
// (w[k0+2t][n], w[k0+2t+1][n]) and (w[k0+2t+8][n], w[k0+2t+9][n]), n = n0+g.
// The (tap, K/16) steps are walked in chunks: the block copies
// chunk c + 1 into one of two shared buffers while its warps multiply with
// chunk c from the other, so each weight crosses from L2 once per block.
template <int TH, int TW, int NTU>
__device__ __forceinline__ void conv_mma(const Params& p, __nv_bfloat16* feat,
                                         uint2* wbuf, int i, int ty0, int tx0,
                                         size_t img) {
  constexpr int BW = TW + 10;
  const Stage s(p, i, TH, TW);
  const int kc_n = s.k / 16, nt_n = s.n / 8;
  const int groups = nt_n / NTU;
  const int steps = (s.m + 31) / 32 * groups;
  // a buffer holds kChunk steps of the widest conv, more of a narrower one
  const int chunk = p.wbuf_len / (nt_n * 32);
  const int iters = 9 * kc_n, chunks = (iters + chunk - 1) / chunk;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int csw = p.cs / 2;  // pixel stride in 32-bit words
  const uint32_t* fw = reinterpret_cast<const uint32_t*>(feat);
  const uint2* wsrc = reinterpret_cast<const uint2*>(
      static_cast<const __nv_bfloat16*>(p.w) + p.w_off[i]);
  const float* bias = p.bias + p.b_off[i];

  for (int u0 = 0; u0 < steps; u0 += kWarps) {
    const int u = u0 + (threadIdx.x >> 5);
    const bool active = u < steps;
    const int mp = u / groups, ng = u - mp * groups;
    int base[4];  // rows g and g + 8 of both m16 tiles (tap 0, word t)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int m = min(mp * 32 + r * 8 + g, s.m - 1);
      const int ry = m / s.rw, rx = m - ry * s.rw;
      base[r] = ((s.o - 1 + ry) * BW + (s.o - 1 + rx)) * csw + t;
    }
    float acc[2][NTU][4];
#pragma unroll
    for (int nt = 0; nt < NTU; ++nt) {
      const int n = (ng * NTU + nt) * 8 + 2 * t;
      const float b0 = bias[n], b1 = bias[n + 1];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        acc[mt][nt][0] = b0;
        acc[mt][nt][1] = b1;
        acc[mt][nt][2] = b0;
        acc[mt][nt][3] = b1;
      }
    }
    // chunks 0 .. kStages - 2 in flight; one cp.async group per chunk
    for (int c = 0; c < kStages - 1; ++c)
      stage_weights(wbuf + c * p.wbuf_len, wsrc, min(iters, c * chunk),
                    min(iters, (c + 1) * chunk), nt_n);
    int kc = 0, tap = 0, toff = 0;
    for (int c = 0; c < chunks; ++c) {
      const int it0 = c * chunk, it1 = min(iters, it0 + chunk);
      // chunk c has landed, and every warp is done with chunk c - 1,
      // whose buffer the copy of chunk c + kStages - 1 reuses
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2)
                   : "memory");
      __syncthreads();
      const int cn = c + kStages - 1;
      stage_weights(wbuf + (cn % kStages) * p.wbuf_len, wsrc,
                    min(iters, cn * chunk), min(iters, (cn + 1) * chunk),
                    nt_n);
      if (!active) continue;
      const uint2* wb =
          wbuf + (c % kStages) * p.wbuf_len + ng * NTU * 32 + lane;
      for (int it = it0; it < it1; ++it) {
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int r0 = base[2 * mt] + toff + kc * 8;
          const int r1 = base[2 * mt + 1] + toff + kc * 8;
          a[mt][0] = fw[r0];
          a[mt][1] = fw[r1];
          a[mt][2] = fw[r0 + 4];
          a[mt][3] = fw[r1 + 4];
        }
#pragma unroll
        for (int nt = 0; nt < NTU; ++nt) {
          const uint2 b = wb[((it - it0) * nt_n + nt) * 32];
          mma_bf16(acc[0][nt], a[0], b.x, b.y);
          mma_bf16(acc[1][nt], a[1], b.x, b.y);
        }
        if (++kc == kc_n) {
          kc = 0;
          ++tap;
          toff = ((tap / 3) * BW + tap % 3) * csw;
        }
      }
    }
    // the next pass restages the buffers: wait for every warp to leave
    // them (the groups still pending are empty)
    if (u0 + kWarps < steps) __syncthreads();
    if (!active) continue;

    // accumulator (mt, nt, 2h + j) is pixel mp*32 + mt*16 + h*8 + g,
    // channel (ng*NTU + nt)*8 + 2t + j
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int mt = r >> 1, h = r & 1;
      const int m = mp * 32 + r * 8 + g;
      if (m >= s.m) continue;
      const int ry = m / s.rw, rx = m - ry * s.rw;
      const int bp = (s.o + ry) * BW + (s.o + rx);
      const int gy = ty0 + s.o + ry, gx = tx0 + s.o + rx;
      const bool inside = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
      if (i < 4) {
#pragma unroll
        for (int nt = 0; nt < NTU; ++nt) {
          const int n = (ng * NTU + nt) * 8 + 2 * t;
          float v0 = leaky(acc[mt][nt][2 * h]);
          float v1 = leaky(acc[mt][nt][2 * h + 1]);
          if (!inside) v0 = v1 = 0.f;
          *reinterpret_cast<__nv_bfloat162*>(feat + bp * p.cs + s.k + n) =
              __floats2bfloat162_rn(v0, v1);
        }
      } else if (inside) {
        const size_t gp = (img + (size_t)gy * p.W + gx) * p.nf;
        const __nv_bfloat16* x0 = static_cast<const __nv_bfloat16*>(p.x0);
        __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
        for (int nt = 0; nt < NTU; ++nt) {
          const int n = (ng * NTU + nt) * 8 + 2 * t;
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(feat + bp * p.cs +
                                                       kZs + n));
          __nv_bfloat162 o;
          o.x = residual(acc[mt][nt][2 * h], xv.x, x0, gp + n);
          o.y = residual(acc[mt][nt][2 * h + 1], xv.y, x0, gp + n + 1);
          *reinterpret_cast<__nv_bfloat162*>(out + gp + n) = o;
        }
      }
    }
  }
}

// conv i on fp32 FMA: a thread step covers 4 region pixels x 8 outputs.
// Weights: [tap][K][N] fp32.
template <int TH, int TW>
__device__ __forceinline__ void conv_fma(const Params& p, float* feat, int i,
                                         int ty0, int tx0, size_t img) {
  constexpr int BW = TW + 10;
  const Stage s(p, i, TH, TW);
  const int groups = s.n / 8;
  const int steps = (s.m + 3) / 4 * groups;
  const float* wk = static_cast<const float*>(p.w) + p.w_off[i];
  const float* bias = p.bias + p.b_off[i];

  for (int u = threadIdx.x; u < steps; u += kThreads) {
    const int pg = u / groups, n0 = (u - pg * groups) * 8;
    int base[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = min(pg * 4 + j, s.m - 1);
      const int ry = m / s.rw, rx = m - ry * s.rw;
      base[j] = ((s.o - 1 + ry) * BW + (s.o - 1 + rx)) * p.cs;
    }
    float acc[4][8];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[j][c] = bias[n0 + c];
    for (int tap = 0; tap < 9; ++tap) {
      const int toff = ((tap / 3) * BW + tap % 3) * p.cs;
      const float* wt = wk + (size_t)tap * s.k * s.n + n0;
#pragma unroll 4
      for (int k = 0; k < s.k; ++k) {
        float a[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) a[j] = feat[base[j] + toff + k];
        const float4 w0 = __ldg(reinterpret_cast<const float4*>(wt + k * s.n));
        const float4 w1 =
            __ldg(reinterpret_cast<const float4*>(wt + k * s.n + 4));
        const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[j][c] = fmaf(a[j], w[c], acc[j][c]);
      }
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = pg * 4 + j;
      if (m >= s.m) continue;
      const int ry = m / s.rw, rx = m - ry * s.rw;
      const int bp = (s.o + ry) * BW + (s.o + rx);
      const int gy = ty0 + s.o + ry, gx = tx0 + s.o + rx;
      const bool inside = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
      if (i < 4) {
#pragma unroll
        for (int c = 0; c < 8; ++c)
          feat[bp * p.cs + s.k + n0 + c] = inside ? leaky(acc[j][c]) : 0.f;
      } else if (inside) {
        const size_t gp = (img + (size_t)gy * p.W + gx) * p.nf;
        const float* x0 = static_cast<const float*>(p.x0);
        float* out = static_cast<float*>(p.out);
#pragma unroll
        for (int c = 0; c < 8; ++c)
          out[gp + n0 + c] = residual(
              acc[j][c], feat[bp * p.cs + kZs + n0 + c], x0, gp + n0 + c);
      }
    }
  }
}

template <typename T>
struct Tile;
template <>
struct Tile<__nv_bfloat16> {
  static constexpr int h = 8, w = 16;
};
template <>
struct Tile<float> {
  static constexpr int h = 4, w = 8;
};

template <typename T>
__host__ __device__ size_t feat_bytes(int cs) {
  return (size_t)(Tile<T>::h + 10) * (Tile<T>::w + 10) * cs * sizeof(T);
}

// uint2 per shared weight buffer: kChunk steps of the widest conv (bf16)
int wbuf_len(int nf, int gcp) { return kChunk * (nf > gcp ? nf : gcp) * 4; }

template <typename T>
size_t rdb_smem(int nf, int gcp, int cs) {
  const size_t w =
      sizeof(T) == 2 ? kStages * sizeof(uint2) * wbuf_len(nf, gcp) : 0;
  return feat_bytes<T>(cs) + w;
}

template <int TH, int TW>
__device__ __forceinline__ void conv(const Params& p, __nv_bfloat16* feat,
                                     uint2* wbuf, int i, int ty0, int tx0,
                                     size_t img) {
  const int n = i < 4 ? p.gcp : p.nf;
  if (n % 32 == 0)
    conv_mma<TH, TW, 4>(p, feat, wbuf, i, ty0, tx0, img);
  else
    conv_mma<TH, TW, 2>(p, feat, wbuf, i, ty0, tx0, img);
}

template <int TH, int TW>
__device__ __forceinline__ void conv(const Params& p, float* feat, uint2*,
                                     int i, int ty0, int tx0, size_t img) {
  conv_fma<TH, TW>(p, feat, i, ty0, tx0, img);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) rdb_kernel(const Params p) {
  constexpr int TH = Tile<T>::h, TW = Tile<T>::w;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* feat = reinterpret_cast<T*>(smem_raw);
  uint2* wbuf = reinterpret_cast<uint2*>(smem_raw + feat_bytes<T>(p.cs));
  // image coordinates of buffer pixel (0, 0)
  const int ty0 = blockIdx.y * TH - 5, tx0 = blockIdx.x * TW - 5;
  const size_t img = (size_t)blockIdx.z * p.H * p.W;
  if constexpr (sizeof(T) == 2)
    load_inputs<TH, TW>(p, feat, ty0, tx0, img);
  else
    load_inputs<T, TH, TW>(p, feat, ty0, tx0, img);
  __syncthreads();
  for (int i = 0; i < 5; ++i) {
    // conv i reads slots [0, K_i) and writes [K_i, K_i + gcp): no overlap
    conv<TH, TW>(p, feat, wbuf, i, ty0, tx0, img);
    __syncthreads();
  }
}

template <typename T>
int launch(Params p, int B, cudaStream_t stream) {
  p.wbuf_len = wbuf_len(p.nf, p.gcp);
  const size_t smem = rdb_smem<T>(p.nf, p.gcp, p.cs);
  cudaError_t e = cudaFuncSetAttribute(
      rdb_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int wo = 0, bo = 0;
  for (int i = 0; i < 5; ++i) {
    const int k = kZs + p.nf + i * p.gcp, n = i < 4 ? p.gcp : p.nf;
    p.w_off[i] = wo;
    p.b_off[i] = bo;
    wo += 9 * k * n;
    bo += n;
  }
  dim3 grid((p.W + Tile<T>::w - 1) / Tile<T>::w,
            (p.H + Tile<T>::h - 1) / Tile<T>::h, B);
  rdb_kernel<T><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory a launch needs, in bytes, for a pixel stride of
// `cs` elements.
size_t exsr_rdb_smem(int nf, int gcp, int cs, int is_bf16) {
  return is_bf16 ? rdb_smem<__nv_bfloat16>(nf, gcp, cs)
                 : rdb_smem<float>(nf, gcp, cs);
}

// Launches on `stream`; returns cudaGetLastError().  The caller guarantees
// nf % 16 == 0, 1 <= nz <= 16, gcp % 16 == 0, the packed layouts above,
// 16-byte aligned pointers, and cs = 16 + nf + 4 gcp + 8 (bf16) or + 1
// (fp32).  x0 may be null.
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
  if (is_bf16) return launch<__nv_bfloat16>(p, B, (cudaStream_t)stream);
  return launch<float>(p, B, (cudaStream_t)stream);
}

const char* exsr_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
