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
// version existed only for a Mosaic compile limit; one tiled kernel serves
// both entry points here.
//
// Bound on the H100: bytes.  In bf16 the function moves 832 bytes per pixel
// (c3, four nf-wide partial reads, x, out) against 2*9*gc*nf = 36,864 flops,
// about 44 flops per byte, under the bf16 tensor-core ridge point.  This
// first version runs the conv on fp32 FMA (no tensor cores yet), which puts
// its own arithmetic above the byte time; mma.sync/wgmma and TMA come later.
// Design: one block per (image, 16x16 output tile).  The c3 tile with a
// 1-pixel zero halo and the whole w4 sit in shared memory; each thread
// accumulates 4 pixels x 16 output channels in registers, then reads its
// four partials and x once and writes out once in the epilogue, so the
// partial buffers are never re-read.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;  // output tile is kTile x kTile pixels
constexpr int kPx = 4;     // pixels per thread, along W
constexpr int kCh = 16;    // output channels per thread
constexpr int kPxGroups = kTile * kTile / kPx;
constexpr int kMaxThreads = 256;  // nf <= 64

__device__ __forceinline__ void load16(const float* p, float (&v)[kCh]) {
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 a = q[i];
    v[4 * i] = a.x;
    v[4 * i + 1] = a.y;
    v[4 * i + 2] = a.z;
    v[4 * i + 3] = a.w;
  }
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&v)[kCh]) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 a = q[i];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[8 * i + 2 * j] = f.x;
      v[8 * i + 2 * j + 1] = f.y;
    }
  }
}

__device__ __forceinline__ void store16(float* p, const float (&v)[kCh]) {
  float4* q = reinterpret_cast<float4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    q[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* p,
                                        const float (&v)[kCh]) {
  uint4* q = reinterpret_cast<uint4*>(p);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    uint4 a;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&a);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      h[j] = __floats2bfloat162_rn(v[8 * i + 2 * j], v[8 * i + 2 * j + 1]);
    q[i] = a;
  }
}

// two consecutive channels of the shared c3 tile
__device__ __forceinline__ float2 load2(const float* p) {
  return make_float2(p[0], p[1]);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// round a float to the activation dtype (and back)
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// c3 pixel stride in shared memory: gc plus one 4-byte word, so that the
// pixels a warp reads fall in distinct banks
template <typename T>
__host__ __device__ constexpr int pixel_stride(int gc) {
  return gc + 4 / (int)sizeof(T);
}

template <typename T>
size_t stage4_smem(int gc, int nf) {
  return (size_t)(9 * gc * nf + (kTile + 2) * (kTile + 2) *
                                    pixel_stride<T>(gc)) * sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
stage4_kernel(const T* __restrict__ c3, const T* __restrict__ p0,
              const T* __restrict__ p1, const T* __restrict__ p2,
              const T* __restrict__ p3, const T* __restrict__ x,
              const T* __restrict__ w4, const float* __restrict__ b4,
              T* __restrict__ out, int H, int W, int gc, int nf, int cp0,
              int cp1, int cp2, int cp3) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_w = reinterpret_cast<T*>(smem_raw);  // [3][3][gc][nf]
  T* s_c = s_w + 9 * gc * nf;               // [kTile+2][kTile+2][ps]
  const int ps = pixel_stride<T>(gc);
  const int tw = kTile + 2;
  const int y0 = blockIdx.y * kTile, x0 = blockIdx.x * kTile;
  const size_t img = (size_t)blockIdx.z * H * W;

  {
    const int n16 = 9 * gc * nf * (int)sizeof(T) / 16;
    const uint4* src = reinterpret_cast<const uint4*>(w4);
    uint4* dst = reinterpret_cast<uint4*>(s_w);
    for (int i = threadIdx.x; i < n16; i += blockDim.x) dst[i] = src[i];
  }
  for (int idx = threadIdx.x; idx < tw * tw * gc; idx += blockDim.x) {
    const int p = idx / gc;
    const int k = idx - p * gc;
    const int ty = p / tw;
    const int gy = y0 - 1 + ty, gx = x0 - 1 + (p - ty * tw);
    T v = T(0.f);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = c3[(img + (size_t)gy * W + gx) * gc + k];
    s_c[p * ps + k] = v;
  }
  __syncthreads();

  const int groups = nf / kCh;
  const int cg = threadIdx.x % groups;
  const int pg = threadIdx.x / groups;
  const int r = pg / (kTile / kPx);
  const int c0 = (pg % (kTile / kPx)) * kPx;
  float acc[kPx][kCh] = {};
  for (int ky = 0; ky < 3; ++ky) {
    for (int kx = 0; kx < 3; ++kx) {
      const T* wrow = s_w + (ky * 3 + kx) * gc * nf + cg * kCh;
      const T* crow = s_c + ((r + ky) * tw + c0 + kx) * ps;
      for (int k = 0; k < gc; k += 2) {
        float a0[kPx], a1[kPx];
#pragma unroll
        for (int i = 0; i < kPx; ++i) {
          const float2 f = load2(crow + i * ps + k);
          a0[i] = f.x;
          a1[i] = f.y;
        }
        float w0[kCh], w1[kCh];
        load16(wrow + k * nf, w0);
        load16(wrow + (k + 1) * nf, w1);
#pragma unroll
        for (int i = 0; i < kPx; ++i) {
#pragma unroll
          for (int j = 0; j < kCh; ++j) {
            acc[i][j] = fmaf(a0[i], w0[j], acc[i][j]);
            acc[i][j] = fmaf(a1[i], w1[j], acc[i][j]);
          }
        }
      }
    }
  }

  const int ch = cg * kCh;
  const int gy = y0 + r;
  if (gy >= H) return;
#pragma unroll
  for (int i = 0; i < kPx; ++i) {
    const int gx = x0 + c0 + i;
    if (gx >= W) break;
    const size_t pix = img + (size_t)gy * W + gx;
    float part[kCh], t[kCh], o[kCh];
    load16(p0 + pix * cp0 + ch, part);
    load16(p1 + pix * cp1 + ch, t);
#pragma unroll
    for (int j = 0; j < kCh; ++j) part[j] += t[j];
    load16(p2 + pix * cp2 + ch, t);
#pragma unroll
    for (int j = 0; j < kCh; ++j) part[j] += t[j];
    load16(p3 + pix * cp3 + ch, t);
#pragma unroll
    for (int j = 0; j < kCh; ++j) part[j] += t[j];
    load16(x + pix * nf + ch, t);
#pragma unroll
    for (int j = 0; j < kCh; ++j) {
      const float conv = acc[i][j] + b4[ch + j];
      const float v = round_to((conv + part[j]) * 0.2f, out);
      o[j] = v + t[j];
    }
    store16(out + pix * nf + ch, o);
  }
}

template <typename T>
int launch(const void* c3, const void* p0, const void* p1, const void* p2,
           const void* p3, const void* x, const void* w4, const void* b4,
           void* out, int B, int H, int W, int gc, int nf, int cp0, int cp1,
           int cp2, int cp3, cudaStream_t stream) {
  const size_t smem = stage4_smem<T>(gc, nf);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        stage4_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
  stage4_kernel<T><<<grid, kPxGroups * (nf / kCh), smem, stream>>>(
      (const T*)c3, (const T*)p0, (const T*)p1, (const T*)p2, (const T*)p3,
      (const T*)x, (const T*)w4, (const float*)b4, (T*)out, H, W, gc, nf,
      cp0, cp1, cp2, cp3);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory a launch needs, in bytes.
size_t exsr_stage4_smem(int gc, int nf, int is_bf16) {
  return is_bf16 ? stage4_smem<__nv_bfloat16>(gc, nf)
                 : stage4_smem<float>(gc, nf);
}

// Launches on `stream`; returns cudaGetLastError().  The caller guarantees
// nf % 16 == 0, nf <= 64, even gc, cp_g % 8 == 0 and 16-byte aligned
// pointers.
int exsr_stage4(const void* c3, const void* p0, const void* p1,
                const void* p2, const void* p3, const void* x, const void* w4,
                const void* b4, void* out, int B, int H, int W, int gc, int nf,
                int cp0, int cp1, int cp2, int cp3, int is_bf16,
                void* stream) {
  if (is_bf16)
    return launch<__nv_bfloat16>(c3, p0, p1, p2, p3, x, w4, b4, out, B, H, W,
                                 gc, nf, cp0, cp1, cp2, cp3,
                                 (cudaStream_t)stream);
  return launch<float>(c3, p0, p1, p2, p3, x, w4, b4, out, B, H, W, gc, nf,
                       cp0, cp1, cp2, cp3, (cudaStream_t)stream);
}

const char* exsr_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
