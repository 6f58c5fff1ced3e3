// Separable filtering and integer-factor resampling of float64 HWC
// images on the host: the fast path of exsr_torch.ops.resize.imresize,
// through which the training loaders synthesise every LR sample.
//
// C ABI (bound with ctypes by exsr_torch/native/separable.py):
//   exsr_torch_sepconv_edge(img, H, W, C, kcol, kc, krow, kr, out)
//       out = correlate(edge_pad(img), kcol x krow), same H, W
//   exsr_torch_downscale(img, H, W, C, kcol, kc, krow, kr, f, pre_y,
//                        pre_x, out)
//       out = subsample(correlate(edge_pad(img), k), f, pre)
//   exsr_torch_upscale(img, H, W, C, kcol, kc, krow, kr, f, pre_y,
//                      pre_x, out)
//       out = correlate(edge_pad(zero_stuff(img, f, pre)), k)
//
// Edge padding by k // 2 on each side and 'valid' correlation, the
// column taps (along H) first, then the row taps (along W), each sum in
// tap order: the numpy path's numbers to rounding.  The downscale filters
// the kept pixels only (the kept rows in the column pass, the kept
// columns in the row pass), each with the same arithmetic as the full
// filter's pixel there.

#include <cstddef>
#include <cstdint>
#include <vector>

namespace {

inline int64_t clampi(int64_t v, int64_t lo, int64_t hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// Column pass at output row y of an H x (W * C) image: orow = sum_t
// k[t] * img[clamp(y + t - r)].
void col_row(const double* img, int64_t H, int64_t WC, const double* k,
             int64_t klen, int64_t y, double* orow) {
    const int64_t r = klen / 2;
    for (int64_t t = 0; t < klen; ++t) {
        const double* irow = img + clampi(y + t - r, 0, H - 1) * WC;
        const double kv = k[t];
        if (t == 0) {
            for (int64_t i = 0; i < WC; ++i) orow[i] = kv * irow[i];
        } else {
            for (int64_t i = 0; i < WC; ++i) orow[i] += kv * irow[i];
        }
    }
}

// Row pass at output column x of one W x C row.
inline void row_pixel(const double* row, int64_t W, int64_t C,
                      const double* k, int64_t klen, int64_t x,
                      double* out) {
    const int64_t r = klen / 2;
    for (int64_t c = 0; c < C; ++c) {
        double acc = 0.0;
        for (int64_t t = 0; t < klen; ++t)
            acc += k[t] * row[clampi(x + t - r, 0, W - 1) * C + c];
        out[c] = acc;
    }
}

}  // namespace

extern "C" {

void exsr_torch_sepconv_edge(const double* img, int64_t H, int64_t W,
                             int64_t C, const double* kcol, int64_t kc,
                             const double* krow, int64_t kr, double* out) {
    std::vector<double> tmp((size_t)(W * C));
    for (int64_t y = 0; y < H; ++y) {
        col_row(img, H, W * C, kcol, kc, y, tmp.data());
        for (int64_t x = 0; x < W; ++x)
            row_pixel(tmp.data(), W, C, krow, kr, x, out + (y * W + x) * C);
    }
}

void exsr_torch_downscale(const double* img, int64_t H, int64_t W,
                          int64_t C, const double* kcol, int64_t kc,
                          const double* krow, int64_t kr, int64_t f,
                          int64_t pre_y, int64_t pre_x, double* out) {
    const int64_t Ho = H / f, Wo = W / f;
    std::vector<double> tmp((size_t)(W * C));
    for (int64_t y = 0; y < Ho; ++y) {
        col_row(img, H, W * C, kcol, kc, y * f + pre_y, tmp.data());
        for (int64_t x = 0; x < Wo; ++x)
            row_pixel(tmp.data(), W, C, krow, kr, x * f + pre_x,
                      out + (y * Wo + x) * C);
    }
}

void exsr_torch_upscale(const double* img, int64_t H, int64_t W, int64_t C,
                        const double* kcol, int64_t kc, const double* krow,
                        int64_t kr, int64_t f, int64_t pre_y, int64_t pre_x,
                        double* out) {
    const int64_t Ho = H * f, Wo = W * f;
    std::vector<double> stuffed((size_t)(Ho * Wo * C), 0.0);
    for (int64_t y = 0; y < H; ++y)
        for (int64_t x = 0; x < W; ++x)
            for (int64_t c = 0; c < C; ++c)
                stuffed[((y * f + pre_y) * Wo + (x * f + pre_x)) * C + c] =
                    img[(y * W + x) * C + c];
    exsr_torch_sepconv_edge(stuffed.data(), Ho, Wo, C, kcol, kc, krow, kr,
                            out);
}

}  // extern "C"
