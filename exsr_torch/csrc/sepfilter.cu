// Separable edge-clamped depthwise correlation for the CEM filter chain,
// and its two polyphase forms.
//
// Replaces the TPU kernel sepfilter_edge_pallas (exsr/ops/pallas/sepfilter.py,
// _sepfilter_kernel): y = rowpass(colpass(x)) on fp32 NHWC [B, H, W, C],
// where the column pass correlates along H with kcol and the row pass along
// W with krow, both with replicate (edge-clamped) borders and odd tap counts.
// Three entry points:
//
//   sepfilter_edge  y, same size (the TPU kernel's own function);
//   sepfilter_down  y sampled at rows sf*I + pre0 and columns sf*J + pre1:
//                   the CEM's downscale, HR in, LR out;
//   sepfilter_up    the same filter applied to the zero-stuffed image of a
//                   (a[I, J] at HR row sf*I + pre0, column sf*J + pre1,
//                   zeros elsewhere): the CEM's upscale, LR in, HR out.
//                   Its combine mode writes U(a) + (g - U(b)), the CEM's
//                   ortho + ns, in exactly that order.
//
// Bound on the H100: bytes.  Every entry point reads its inputs once and
// writes its output once; arithmetic is fp32 FMA, no tensor cores and no
// TF32 (the CEM chain never drops precision).  Each block stages one tile
// plus its clamped halo with cp.async (no registers held, the whole tile
// in flight at once) and several blocks share an SM, so one block's copies
// overlap the others' arithmetic.  (Persistent blocks with a two-stage
// ring measured slower: the ring halves the blocks an SM holds, and the
// passes, not the copies, set the time.)  C is a template parameter (1, 3,
// or 0 for any C), so no loop divides by C at run time; a flat NHWC row is
// one run of floats whose row-pass taps are C floats apart.
//
// Exactness: every output takes its taps in ascending order, column pass
// then row pass, each sum starting from 0.f.  The down kernel computes only
// the outputs the subsample keeps, by the same operations, so it equals
// aliased_subsample(sepfilter_edge(x)) bit for bit.  The up kernel skips
// the products whose input is a stuffed zero: fmaf(k, 0, acc) == acc, so it
// equals sepfilter_edge(zero_stuff(a)) bit for bit (up to the sign of a
// zero).  Which taps meet a data row near a clamped edge depends on sf
// and pre (at sf 2, pre 0 the top edge repeats data row 0 up to kh/2 + 1
// times), so the host builds the tap lists of every HR row and column and
// passes them in.
//
// A fourth entry point serves the gradients, and replaces no TPU kernel
// (exsr differentiates the XLA path that its Pallas kernel stands in for):
//
//   sepfilter_taps  out[n,i,j,c] = sum_e wr[e,i] sum_f wc[f,j]
//                                  x[n, ir[e,i], ic[f,j], c],
//                   from host-built tables (index -1 after the last entry).
//                   With the transposed 1-D matrices of the three maps
//                   above it computes their adjoints E^T, D^T and U^T: a
//                   clamped tap folds back onto the edge sample, so the
//                   adjoint is no clamped correlation, and the host sums
//                   the folded weights.
//
// It is bound by bytes too, and written simply: one block per output tile
// stages the input rows and columns the tile's tables reach (the host
// passes each tile's range), runs the column pass (each output row at
// every staged flat column) into shared memory and the row pass into the
// output, fp32 FMA, entries in ascending order, each sum from 0.f.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kR = 8;            // outputs per thread in a sliding window
constexpr int kEdgeTileH = 16;   // same-size tile, rows
constexpr int kEdgeTileW = 64;   // same-size tile, pixels
constexpr int kDownTileH = kR;   // LR rows per down tile
constexpr int kUpTileH = 32;     // HR rows per up tile
constexpr int kUpTileW = 64;     // HR columns per up tile

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__device__ __forceinline__ int floordiv(int a, int b) {
  return a >= 0 ? a / b : -((b - 1 - a) / b);
}

// Copy rows [row0, row0 + nrows) (clamped to [0, H)) and pixels
// [col0, col0 + npix) (clamped to [0, W)) of one image into s (row stride
// ld floats), one warp per row.  The pixels inside the image are one run
// of floats in device memory and in s, copied with neighbouring lanes on
// neighbouring floats; only the clamped pixels beyond an edge need a
// pixel and channel index.
template <int C_>
__device__ __forceinline__ void stage_clamped(
    float* s, int ld, const float* __restrict__ img, int H, int W, int Crt,
    int row0, int nrows, int col0, int npix) {
  const int C = C_ ? C_ : Crt;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int in0 = max(col0, 0), in1 = min(col0 + npix, W);
  const int nin = (in1 - in0) * C;
  const int left = (in0 - col0) * C;            // floats before the run
  const int right = (col0 + npix - in1) * C;    // floats after it
  for (int r = warp; r < nrows; r += kWarps) {
    const float* src = img + (size_t)clampi(row0 + r, 0, H - 1) * W * C;
    float* dst = s + r * ld;
    for (int f = lane; f < nin; f += 32)
      cp_async4(dst + left + f, src + in0 * C + f);
    for (int f = lane; f < left; f += 32)
      cp_async4(dst + f, src + f % C);
    for (int f = lane; f < right; f += 32)
      cp_async4(dst + left + nin + f, src + (W - 1) * C + f % C);
  }
}

// acc[o] = sum_{r < n} k[r] * p[(o + r) * stride] for o < kR, r ascending,
// each sum from 0.f.  The inputs stay in a ring of kR registers: slot s
// holds input r0 + s until step s of the round that starts at r0 has used
// it, then input r0 + s + kR.  Each input and tap is read once from shared
// memory per kR products.
__device__ __forceinline__ void fir_window(const float* __restrict__ p,
                                           int stride,
                                           const float* __restrict__ k,
                                           int n, float (&acc)[kR]) {
  float w[kR];
#pragma unroll
  for (int o = 0; o < kR; ++o) {
    acc[o] = 0.f;
    w[o] = p[o * stride];
  }
  for (int r0 = 0; r0 < n; r0 += kR) {
#pragma unroll
    for (int u = 0; u < kR; ++u) {
      if (r0 + u < n) {
        const float kr = k[r0 + u];
#pragma unroll
        for (int o = 0; o < kR; ++o)
          acc[o] = fmaf(kr, w[(o + u) % kR], acc[o]);
        if (r0 + u + 1 < n) w[u] = p[(r0 + u + kR) * stride];
      }
    }
  }
}

// ---------------------------------------------------------------- same size
// One block per 16 x 64 output tile of one image.  It stages the tile plus
// a halo of kh/2 rows and kw/2 pixels (clamped), runs the column pass
// (each thread one flat column, kR rows from a register window) into a
// second tile and the row pass (each thread kR pixels of one channel, lanes
// on rows so the odd row stride spreads the banks) into the first, then
// copies the output out row by row.
template <int C_>
__global__ void __launch_bounds__(kThreads)
sepfilter_edge_kernel(const float* __restrict__ x, float* __restrict__ out,
                      const float* __restrict__ kcol,
                      const float* __restrict__ krow, int H, int W, int Crt,
                      int kh, int kw) {
  constexpr int TH = kEdgeTileH;
  const int C = C_ ? C_ : Crt;
  extern __shared__ float smem[];
  const int rh = kh / 2, rw = kw / 2;
  const int i0 = blockIdx.y * TH, j0 = blockIdx.x * kEdgeTileW;
  const size_t image = (size_t)blockIdx.z * H * W * C;
  const int xrows = TH + kh - 1;
  const int lx = (kEdgeTileW + kw - 1) * C;  // floats used in a tile row
  const int ld = lx | 1;                      // odd: lanes on rows spread
  float* s_k = smem;                          // kcol then krow
  float* s_x = s_k + kh + kw;                 // [xrows][ld]; later output
  float* s_t = s_x + xrows * ld;              // [TH][ld]

  stage_clamped<C_>(s_x, ld, x + image, H, W, Crt, i0 - rh, xrows, j0 - rw,
                    kEdgeTileW + kw - 1);
  for (int t = threadIdx.x; t < kh + kw; t += kThreads)
    s_k[t] = t < kh ? kcol[t] : krow[t - kh];
  cp_async_wait_all();
  __syncthreads();

  // column pass: flat column q, rows ch*kR .. ch*kR + kR - 1
  for (int q = threadIdx.x, ch = 0;; q += kThreads) {
    while (q >= lx) {
      q -= lx;
      ++ch;
    }
    if (ch >= TH / kR) break;
    float acc[kR];
    fir_window(s_x + ch * kR * ld + q, ld, s_k, kh, acc);
#pragma unroll
    for (int o = 0; o < kR; ++o) s_t[(ch * kR + o) * ld + q] = acc[o];
  }
  __syncthreads();

  // row pass: row (lanes), channel c, pixels m*kR .. m*kR + kR - 1
  float* s_o = s_x;
  const int lo = (kEdgeTileW * C) | 1;
  const int items = TH * C * (kEdgeTileW / kR);
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int row = it % TH;
    const int rest = it / TH;
    const int m = rest / C;
    const int c = rest - m * C;
    float acc[kR];
    fir_window(s_t + row * ld + m * kR * C + c, C, s_k + kh, kw, acc);
#pragma unroll
    for (int o = 0; o < kR; ++o) s_o[row * lo + (m * kR + o) * C + c] = acc[o];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nf = min(kEdgeTileW, W - j0) * C;
  for (int r = warp; r < TH && i0 + r < H; r += kWarps) {
    float* dst = out + image + ((size_t)(i0 + r) * W + j0) * C;
    for (int f = lane; f < nf; f += 32) dst[f] = s_o[r * lo + f];
  }
}

// --------------------------------------------------------------------- down
// One block per 8 x tw LR output tile of one image.  It stages the HR rows
// sf*I + pre0 - kh/2 .. + kh/2 and pixels sf*J + pre1 - kw/2 .. + kw/2 of
// its outputs (clamped), runs the column pass only at the kept rows (each
// thread one flat column, all 8 rows) and the row pass only at the kept
// columns.
template <int C_>
__global__ void __launch_bounds__(kThreads)
sepfilter_down_kernel(const float* __restrict__ x, float* __restrict__ out,
                      const float* __restrict__ kcol,
                      const float* __restrict__ krow, int H, int W, int Crt,
                      int kh, int kw, int sf, int pre0, int pre1, int Ho,
                      int Wo, int tw) {
  const int C = C_ ? C_ : Crt;
  extern __shared__ float smem[];
  const int rh = kh / 2, rw = kw / 2;
  const int I0 = blockIdx.y * kDownTileH, J0 = blockIdx.x * tw;
  const int xrows = sf * (kDownTileH - 1) + kh;
  const int xpix = sf * (tw - 1) + kw;
  const int lx = xpix * C;
  const int ld = lx | 1;
  float* s_k = smem;
  float* s_x = s_k + kh + kw;       // [xrows][ld]
  float* s_t = s_x + xrows * ld;    // [8][ld]

  stage_clamped<C_>(s_x, ld, x + (size_t)blockIdx.z * H * W * C, H, W, Crt,
                    sf * I0 + pre0 - rh, xrows, sf * J0 + pre1 - rw, xpix);
  for (int t = threadIdx.x; t < kh + kw; t += kThreads)
    s_k[t] = t < kh ? kcol[t] : krow[t - kh];
  cp_async_wait_all();
  __syncthreads();

  for (int q = threadIdx.x; q < lx; q += kThreads) {
    float acc[kDownTileH];
#pragma unroll
    for (int o = 0; o < kDownTileH; ++o) acc[o] = 0.f;
    for (int r = 0; r < kh; ++r) {
      const float kr = s_k[r];
#pragma unroll
      for (int o = 0; o < kDownTileH; ++o)
        acc[o] = fmaf(kr, s_x[(sf * o + r) * ld + q], acc[o]);
    }
#pragma unroll
    for (int o = 0; o < kDownTileH; ++o) s_t[o * ld + q] = acc[o];
  }
  __syncthreads();

  const int nf = tw * C;
  float* dst = out + (size_t)blockIdx.z * Ho * Wo * C;
  for (int f = threadIdx.x, o = 0;; f += kThreads) {
    while (f >= nf) {
      f -= nf;
      ++o;
    }
    if (o >= kDownTileH || I0 + o >= Ho) break;
    const int J = f / C;
    const int c = f - J * C;
    if (J0 + J >= Wo) continue;
    const float* p = s_t + o * ld + sf * J * C + c;
    float acc = 0.f;
    for (int s = 0; s < kw; ++s) acc = fmaf(s_k[kh + s], p[s * C], acc);
    dst[((size_t)(I0 + o) * Wo + J0 + J) * C + c] = acc;
  }
}

// ----------------------------------------------------------------------- up
// One block per 32 x 64 HR output tile of one image.  It stages the LR
// rows and columns its tap lists reach (of a, and of b in combine mode)
// and the tap lists of its rows and columns (entry (I << 8) | r, -1 after
// the last).  Column pass: each HR row at every staged LR column, over that
// row's list (the same for a warp's lanes).  Row pass: each thread takes
// one flat HR column (its list held in registers, kUpChunk entries at a
// time) at kUpRows rows, then the combine with g, read straight from
// device memory (staging it in shared memory measured slower: it halves
// the blocks an SM holds), and a coalesced store.
constexpr int kUpGroups = 8;                    // row groups of a tile
constexpr int kUpRows = kUpTileH / kUpGroups;   // rows per thread
constexpr int kUpChunk = 8;                     // list entries in registers

struct UpArgs {
  const float* a;
  const float* b;
  const float* g;
  float* out;
  const float* kcol;
  const float* krow;
  const int* rtab;
  const int* ctab;
  int h, w, C, kh, kw, sf, pre0, pre1, maxr, maxc, nc;
};

// The most LR samples the clamped taps of `tile` HR samples reach along
// one axis: the floordiv bounds below span at most this many.
__host__ __device__ constexpr int lr_span(int tile, int k, int sf) {
  return (tile - 1 + 2 * (k / 2) + sf - 1) / sf + 1;
}

template <int C_, bool kCombine>
__global__ void __launch_bounds__(kThreads) sepfilter_up_kernel(UpArgs p) {
  const int C = C_ ? C_ : p.C;
  extern __shared__ float smem[];
  const int h = p.h, w = p.w, sf = p.sf, kh = p.kh, kw = p.kw;
  const int H = h * sf, W = w * sf;
  const int rh = kh / 2, rw = kw / 2;
  const int maxr = p.maxr, maxc = p.maxc;
  const int i0 = blockIdx.y * kUpTileH, j0 = blockIdx.x * kUpTileW;
  const int th = min(kUpTileH, H - i0), tw = min(kUpTileW, W - j0);
  // the LR rows and columns that the tile's clamped taps reach
  const int r_lo = max(0, floordiv(i0 - rh - p.pre0, sf));
  const int r_hi = min(h - 1, floordiv(i0 + th - 1 + rh - p.pre0, sf));
  const int c_lo = max(0, floordiv(j0 - rw - p.pre1, sf));
  const int c_hi = min(w - 1, floordiv(j0 + tw - 1 + rw - p.pre1, sf));
  const int ld = p.nc * C;  // LR tile row stride, floats
  const int lq = (c_hi - c_lo + 1) * C;
  const int nr = lr_span(kUpTileH, kh, sf);

  float* s_k = smem;                                  // kcol then krow
  int* s_rt = reinterpret_cast<int*>(s_k + kh + kw);  // [maxr][32]
  int* s_ct = s_rt + maxr * kUpTileH;                 // [maxc][64]
  float* s_a = reinterpret_cast<float*>(s_ct + maxc * kUpTileW);
  float* s_b = s_a + nr * ld;                         // combine only
  float* s_ta = s_b + (kCombine ? nr * ld : 0);       // [32][ld]
  float* s_tb = s_ta + kUpTileH * ld;                 // combine only

  const size_t lr_image = (size_t)blockIdx.z * h * w * C;
  const size_t hr_image = (size_t)blockIdx.z * H * W * C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nf = tw * C;
  for (int r = warp; r <= r_hi - r_lo; r += kWarps) {
    const size_t off = lr_image + ((size_t)(r_lo + r) * w + c_lo) * C;
    for (int f = lane; f < lq; f += 32) {
      cp_async4(s_a + r * ld + f, p.a + off + f);
      if (kCombine) cp_async4(s_b + r * ld + f, p.b + off + f);
    }
  }
  for (int t = threadIdx.x; t < kh + kw; t += kThreads)
    s_k[t] = t < kh ? p.kcol[t] : p.krow[t - kh];
  for (int t = threadIdx.x; t < maxr * kUpTileH; t += kThreads) {
    const int e = t / kUpTileH, i = t % kUpTileH;
    const int v = i < th ? p.rtab[e * H + i0 + i] : -1;
    s_rt[t] = v < 0 ? -1 : v - (r_lo << 8);
  }
  for (int t = threadIdx.x; t < maxc * kUpTileW; t += kThreads) {
    const int e = t / kUpTileW, j = t % kUpTileW;
    const int v = j < tw ? p.ctab[e * W + j0 + j] : -1;
    s_ct[t] = v < 0 ? -1 : v - (c_lo << 8);
  }
  cp_async_wait_all();
  __syncthreads();

  // column pass: HR row i of the tile at flat LR column q
  for (int q = threadIdx.x, i = 0;; q += kThreads) {
    while (q >= lq) {
      q -= lq;
      ++i;
    }
    if (i >= th) break;
    float acc_a = 0.f, acc_b = 0.f;
    for (int e = 0; e < maxr; ++e) {
      const int v = s_rt[e * kUpTileH + i];
      if (v < 0) break;
      const float k = s_k[v & 255];
      const int src = (v >> 8) * ld + q;
      acc_a = fmaf(k, s_a[src], acc_a);
      if (kCombine) acc_b = fmaf(k, s_b[src], acc_b);
    }
    s_ta[i * ld + q] = acc_a;
    if (kCombine) s_tb[i * ld + q] = acc_b;
  }
  __syncthreads();

  // row pass, combine and store: flat HR column f of the tile at rows
  // grp, grp + 8, grp + 16, grp + 24
  for (int f = threadIdx.x, grp = 0;; f += kThreads) {
    while (f >= nf) {
      f -= nf;
      ++grp;
    }
    if (grp >= kUpGroups) break;
    const int j = f / C;
    const int c = f - j * C;
    const size_t at = hr_image + ((size_t)(i0 + grp) * W + j0) * C + f;
    // g read straight from device memory, its loads issued before the
    // products so that they land while the row pass runs
    float gv[kUpRows], ua[kUpRows], ub[kUpRows];
#pragma unroll
    for (int m = 0; m < kUpRows; ++m) {
      ua[m] = ub[m] = 0.f;
      const bool in = kCombine && grp + kUpGroups * m < th;
      gv[m] = in ? __ldg(p.g + at + (size_t)kUpGroups * m * W * C) : 0.f;
    }
    for (int e0 = 0; e0 < maxc; e0 += kUpChunk) {
      float k[kUpChunk];
      int src[kUpChunk];
      int n = 0;
#pragma unroll
      for (int e = 0; e < kUpChunk; ++e) {
        const int v = e0 + e < maxc ? s_ct[(e0 + e) * kUpTileW + j] : -1;
        n += v >= 0;
        k[e] = v >= 0 ? s_k[kh + (v & 255)] : 0.f;
        src[e] = (v >> 8) * C + c;
      }
#pragma unroll
      for (int m = 0; m < kUpRows; ++m) {
        const int i = grp + kUpGroups * m;
        if (i >= th) break;
        const float* ta = s_ta + i * ld;
        const float* tb = s_tb + i * ld;
#pragma unroll
        for (int e = 0; e < kUpChunk; ++e) {
          if (e >= n) break;
          ua[m] = fmaf(k[e], ta[src[e]], ua[m]);
          if (kCombine) ub[m] = fmaf(k[e], tb[src[e]], ub[m]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < kUpRows; ++m) {
      const int i = grp + kUpGroups * m;
      if (i >= th) break;
      float y = ua[m];
      if (kCombine) {
        const float ns = gv[m] - ub[m];
        y = ua[m] + ns;
      }
      p.out[at + (size_t)kUpGroups * m * W * C] = y;
    }
  }
}

// ---------------------------------------------------------------- adjoints
struct TapsArgs {
  const float* x;
  float* out;
  const int* ridx;    // [er][hout]
  const float* rw;
  const int* cidx;    // [ec][wout]
  const float* cw;
  const int* rlo;     // staged input rows of row tile t: [rlo[t], rhi[t]]
  const int* rhi;
  const int* clo;     // staged input columns of column tile t
  const int* chi;
  int hin, win, C, hout, wout, er, ec, th, tw, sh, ld;
};

__global__ void __launch_bounds__(kThreads) sepfilter_taps_kernel(TapsArgs p) {
  extern __shared__ float smem[];
  const int C = p.C, ld = p.ld;
  const int i0 = blockIdx.y * p.th, j0 = blockIdx.x * p.tw;
  const int th = min(p.th, p.hout - i0), tw = min(p.tw, p.wout - j0);
  const int r0 = p.rlo[blockIdx.y], nr = p.rhi[blockIdx.y] - r0 + 1;
  const int c0 = p.clo[blockIdx.x];
  const int nq = (p.chi[blockIdx.x] - c0 + 1) * C;  // staged floats a row
  float* s_x = smem;              // [sh][ld] staged input
  float* s_t = smem + p.sh * ld;  // [th][ld] column pass
  const float* x = p.x + (size_t)blockIdx.z * p.hin * p.win * C;
  float* out = p.out + (size_t)blockIdx.z * p.hout * p.wout * C;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < nr; r += kWarps) {
    const float* src = x + ((size_t)(r0 + r) * p.win + c0) * C;
    for (int f = lane; f < nq; f += 32) cp_async4(s_x + r * ld + f, src + f);
  }
  cp_async_wait_all();
  __syncthreads();

  for (int t = threadIdx.x; t < th * nq; t += kThreads) {
    const int i = t / nq, q = t - i * nq;
    float acc = 0.f;
    for (int e = 0; e < p.er; ++e) {
      const int at = e * p.hout + i0 + i;
      const int v = __ldg(p.ridx + at);
      if (v < 0) break;
      acc = fmaf(__ldg(p.rw + at), s_x[(v - r0) * ld + q], acc);
    }
    s_t[i * ld + q] = acc;
  }
  __syncthreads();

  const int nf = tw * C;
  for (int t = threadIdx.x; t < th * nf; t += kThreads) {
    const int i = t / nf, f = t - i * nf;
    const int j = f / C, c = f - j * C;
    float acc = 0.f;
    for (int e = 0; e < p.ec; ++e) {
      const int at = e * p.wout + j0 + j;
      const int v = __ldg(p.cidx + at);
      if (v < 0) break;
      acc = fmaf(__ldg(p.cw + at), s_t[i * ld + (v - c0) * C + c], acc);
    }
    out[((size_t)(i0 + i) * p.wout + j0) * C + f] = acc;
  }
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

int down_tile_cols(int sf) { return sf >= 64 ? 1 : 64 / sf; }

template <int C_>
int launch_edge(const float* x, float* out, const float* kcol,
                const float* krow, int B, int H, int W, int C, int kh,
                int kw, size_t smem, cudaStream_t stream) {
  auto kernel = sepfilter_edge_kernel<C_>;
  if (int e = prepare(kernel, smem)) return e;
  dim3 grid((W + kEdgeTileW - 1) / kEdgeTileW,
            (H + kEdgeTileH - 1) / kEdgeTileH, B);
  kernel<<<grid, kThreads, smem, stream>>>(x, out, kcol, krow, H, W, C, kh,
                                           kw);
  return (int)cudaGetLastError();
}

template <int C_>
int launch_down(const float* x, float* out, const float* kcol,
                const float* krow, int B, int H, int W, int C, int kh,
                int kw, int sf, int pre0, int pre1, int Ho, int Wo,
                size_t smem, cudaStream_t stream) {
  auto kernel = sepfilter_down_kernel<C_>;
  if (int e = prepare(kernel, smem)) return e;
  const int tw = down_tile_cols(sf);
  dim3 grid((Wo + tw - 1) / tw, (Ho + kDownTileH - 1) / kDownTileH, B);
  kernel<<<grid, kThreads, smem, stream>>>(x, out, kcol, krow, H, W, C, kh,
                                           kw, sf, pre0, pre1, Ho, Wo, tw);
  return (int)cudaGetLastError();
}

template <int C_, bool kCombine>
int launch_up(const UpArgs& args, int B, size_t smem, cudaStream_t stream) {
  auto kernel = sepfilter_up_kernel<C_, kCombine>;
  if (int e = prepare(kernel, smem)) return e;
  dim3 grid((args.w * args.sf + kUpTileW - 1) / kUpTileW,
            (args.h * args.sf + kUpTileH - 1) / kUpTileH, B);
  kernel<<<grid, kThreads, smem, stream>>>(args);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of a same-size launch, in bytes.
size_t exsr_sepfilter_edge_smem(int C, int kh, int kw) {
  const size_t ld = ((size_t)(kEdgeTileW + kw - 1) * C) | 1;
  const size_t xrows = kEdgeTileH + kh - 1;
  return (kh + kw + (xrows + kEdgeTileH) * ld) * sizeof(float);
}

// Launches on `stream`; returns cudaGetLastError().
int exsr_sepfilter_edge(const void* x, void* out, const void* kcol,
                        const void* krow, int B, int H, int W, int C, int kh,
                        int kw, void* stream) {
  const size_t smem = exsr_sepfilter_edge_smem(C, kh, kw);
  auto s = (cudaStream_t)stream;
  auto xs = (const float*)x;
  auto o = (float*)out;
  auto kc = (const float*)kcol, kr = (const float*)krow;
  switch (C) {
    case 1: return launch_edge<1>(xs, o, kc, kr, B, H, W, C, kh, kw, smem, s);
    case 3: return launch_edge<3>(xs, o, kc, kr, B, H, W, C, kh, kw, smem, s);
    default:
      return launch_edge<0>(xs, o, kc, kr, B, H, W, C, kh, kw, smem, s);
  }
}

size_t exsr_sepfilter_down_smem(int C, int kh, int kw, int sf) {
  const size_t xrows = sf * (kDownTileH - 1) + kh;
  const size_t ld = ((size_t)(sf * (down_tile_cols(sf) - 1) + kw) * C) | 1;
  return (kh + kw + (xrows + kDownTileH) * ld) * sizeof(float);
}

int exsr_sepfilter_down(const void* x, void* out, const void* kcol,
                        const void* krow, int B, int H, int W, int C, int kh,
                        int kw, int sf, int pre0, int pre1, int Ho, int Wo,
                        void* stream) {
  const size_t smem = exsr_sepfilter_down_smem(C, kh, kw, sf);
  auto s = (cudaStream_t)stream;
  auto xs = (const float*)x;
  auto o = (float*)out;
  auto kc = (const float*)kcol, kr = (const float*)krow;
  switch (C) {
    case 1: return launch_down<1>(xs, o, kc, kr, B, H, W, C, kh, kw, sf, pre0,
                                  pre1, Ho, Wo, smem, s);
    case 3: return launch_down<3>(xs, o, kc, kr, B, H, W, C, kh, kw, sf, pre0,
                                  pre1, Ho, Wo, smem, s);
    default: return launch_down<0>(xs, o, kc, kr, B, H, W, C, kh, kw, sf,
                                   pre0, pre1, Ho, Wo, smem, s);
  }
}

size_t exsr_sepfilter_up_smem(int C, int kh, int kw, int sf, int maxr,
                              int maxc, int combine) {
  const size_t nr = lr_span(kUpTileH, kh, sf);
  const size_t ld = (size_t)lr_span(kUpTileW, kw, sf) * C;
  const size_t k = combine ? 2 : 1;
  return (kh + kw + maxr * kUpTileH + maxc * kUpTileW + k * (nr + kUpTileH) *
          ld) * sizeof(float);
}

// b and g null: out = U(a); else out = U(a) + (g - U(b)).
int exsr_sepfilter_up(const void* a, const void* b, const void* g, void* out,
                      const void* kcol, const void* krow, const void* rtab,
                      const void* ctab, int B, int h, int w, int C, int kh,
                      int kw, int sf, int pre0, int pre1, int maxr, int maxc,
                      void* stream) {
  const bool combine = b != nullptr;
  const size_t smem =
      exsr_sepfilter_up_smem(C, kh, kw, sf, maxr, maxc, combine);
  const UpArgs args{(const float*)a, (const float*)b, (const float*)g,
                    (float*)out, (const float*)kcol, (const float*)krow,
                    (const int*)rtab, (const int*)ctab, h, w, C, kh, kw,
                    sf, pre0, pre1, maxr, maxc, lr_span(kUpTileW, kw, sf)};
  auto s = (cudaStream_t)stream;
  switch (C) {
    case 1: return combine ? launch_up<1, true>(args, B, smem, s)
                           : launch_up<1, false>(args, B, smem, s);
    case 3: return combine ? launch_up<3, true>(args, B, smem, s)
                           : launch_up<3, false>(args, B, smem, s);
    default: return combine ? launch_up<0, true>(args, B, smem, s)
                            : launch_up<0, false>(args, B, smem, s);
  }
}

// Dynamic shared memory of a taps launch, in bytes: the staged input
// (sh rows of sw pixels) and the column pass (th rows).
size_t exsr_sepfilter_taps_smem(int C, int th, int sh, int sw) {
  const size_t ld = ((size_t)sw * C) | 1;
  return (size_t)(sh + th) * ld * sizeof(float);
}

int exsr_sepfilter_taps(const void* x, void* out, const void* ridx,
                        const void* rw, const void* cidx, const void* cw,
                        const void* rlo, const void* rhi, const void* clo,
                        const void* chi, int B, int hin, int win, int C,
                        int hout, int wout, int er, int ec, int th, int tw,
                        int sh, int sw, void* stream) {
  const size_t smem = exsr_sepfilter_taps_smem(C, th, sh, sw);
  const TapsArgs args{(const float*)x, (float*)out, (const int*)ridx,
                      (const float*)rw, (const int*)cidx, (const float*)cw,
                      (const int*)rlo, (const int*)rhi, (const int*)clo,
                      (const int*)chi, hin, win, C, hout, wout, er, ec, th,
                      tw, sh, (sw * C) | 1};
  if (int e = prepare(sepfilter_taps_kernel, smem)) return e;
  dim3 grid((wout + tw - 1) / tw, (hout + th - 1) / th, B);
  sepfilter_taps_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}

const char* exsr_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
