// Separable edge-clamped depthwise correlation for the CEM filter chain.
//
// Replaces the TPU kernel sepfilter_edge_pallas (exsr/ops/pallas/sepfilter.py,
// _sepfilter_kernel): out = rowpass(colpass(x)) on fp32 NHWC [B, H, W, C],
// where the column pass correlates along H with kcol and the row pass along
// W with krow, both with replicate (edge-clamped) borders and odd tap counts.
//
// Bound on the H100: bytes.  At the main path's HR shape (C = 3, 17 + 17
// taps) it does 2 * 34 = 68 flops per 8 bytes of device traffic, far below
// the card's fp32 ridge point.  The design therefore reads x once and writes
// out once: one block per (image, 16-row x 64-column output tile) loads its
// tile plus a halo of kh/2 rows and kw/2 columns (clamped at the image edge)
// into shared memory, runs the column pass into a second shared tile, then
// the row pass straight to device memory.  This is what the TPU kernel bought
// with its VMEM scratch.  Arithmetic is fp32 FMA, no tensor cores and no
// TF32: the CEM chain never drops precision.  Taps arrive as device tensors,
// not baked-in constants.
#include <cuda_runtime.h>

namespace {

constexpr int kTileH = 16;
constexpr int kTileW = 64;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
sepfilter_edge_kernel(const float* __restrict__ x, float* __restrict__ out,
                      const float* __restrict__ kcol,
                      const float* __restrict__ krow,
                      int H, int W, int C, int kh, int kw) {
  extern __shared__ float smem[];
  const int rh = kh / 2, rw = kw / 2;
  const int i0 = blockIdx.y * kTileH;
  const int j0 = blockIdx.x * kTileW;
  const size_t image = (size_t)blockIdx.z * H * W * C;
  const int xrows = kTileH + 2 * rh;
  const int rowlen = (kTileW + 2 * rw) * C;  // floats in one tile row

  float* s_taps = smem;                    // kcol then krow
  float* s_x = s_taps + kh + kw;           // [xrows][rowlen]
  float* s_y = s_x + xrows * rowlen;       // [kTileH][rowlen]

  for (int t = threadIdx.x; t < kh + kw; t += blockDim.x)
    s_taps[t] = t < kh ? kcol[t] : krow[t - kh];
  // input tile + halo; neighbouring threads read neighbouring floats
  for (int idx = threadIdx.x; idx < xrows * rowlen; idx += blockDim.x) {
    const int r = idx / rowlen;
    const int q = idx - r * rowlen;
    const int col = q / C;
    const int c = q - col * C;
    const int gi = min(max(i0 - rh + r, 0), H - 1);
    const int gj = min(max(j0 - rw + col, 0), W - 1);
    s_x[idx] = x[image + ((size_t)gi * W + gj) * C + c];
  }
  __syncthreads();

  // column pass over every tile column, halo columns included
  for (int idx = threadIdx.x; idx < kTileH * rowlen; idx += blockDim.x) {
    const int r = idx / rowlen;
    const int q = idx - r * rowlen;
    const float* p = s_x + r * rowlen + q;
    float acc = 0.f;
    for (int t = 0; t < kh; ++t) acc = fmaf(s_taps[t], p[t * rowlen], acc);
    s_y[idx] = acc;
  }
  __syncthreads();

  // row pass, straight to device memory
  const int outlen = kTileW * C;
  for (int idx = threadIdx.x; idx < kTileH * outlen; idx += blockDim.x) {
    const int r = idx / outlen;
    const int q = idx - r * outlen;
    const int col = q / C;
    const int c = q - col * C;
    const int gi = i0 + r, gj = j0 + col;
    if (gi >= H || gj >= W) continue;
    const float* p = s_y + r * rowlen + col * C + c;
    float acc = 0.f;
    for (int t = 0; t < kw; ++t) acc = fmaf(s_taps[kh + t], p[t * C], acc);
    out[image + ((size_t)gi * W + gj) * C + c] = acc;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory a launch needs, in bytes.
size_t exsr_sepfilter_edge_smem(int C, int kh, int kw) {
  const size_t rowlen = (size_t)(kTileW + 2 * (kw / 2)) * C;
  const size_t xrows = kTileH + 2 * (kh / 2);
  return (kh + kw + (xrows + kTileH) * rowlen) * sizeof(float);
}

// Launches on `stream`; returns cudaGetLastError().
int exsr_sepfilter_edge(const void* x, void* out, const void* kcol,
                        const void* krow, int B, int H, int W, int C, int kh,
                        int kw, void* stream) {
  const size_t smem = exsr_sepfilter_edge_smem(C, kh, kw);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sepfilter_edge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  sepfilter_edge_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, (const float*)kcol, (const float*)krow,
      H, W, C, kh, kw);
  return (int)cudaGetLastError();
}

const char* exsr_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
