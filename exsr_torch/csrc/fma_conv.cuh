// The inner routine of the port's fp32 3x3 convolutions: one thread's
// register tile of PX pixels x 4 NV output channels, accumulated on fp32
// FMA (CUDA cores; no TF32, no tensor cores) from a channels-last pixel
// tile and a [k][n] weight block, both in shared memory.
//
// Used by the fp32 bodies of stage4.cu (the stage-4 epilogue's conv over
// c3) and rdb.cu (the five convs of a residual dense block).  A 3x3 conv
// is nine calls, one per tap: the caller shifts each pixel's pointer by the
// tap and points b at the tap's weights.
//
// What bounds a conv on fp32 FMA is issue: each SM sub-partition issues
// one warp instruction a clock, so every shared load or address add is an
// FMA not issued, and a warp's 16-byte shared load takes four of the SM's
// shared-memory clocks (512 bytes at 128 a clock) whatever lanes share an
// address.  A step of 4 input channels costs PX + 4 NV 16-byte shared
// loads (a float4 of 4 channels per pixel, a float4 of 4 outputs per
// channel) for 16 PX NV FMAs: 16 FMAs a load at stage 4's 8 x 8, 11 at the
// RDB's 9 x 4 and 4 x 8.  Bank conflicts: a pixel stride of 4 (mod 8)
// floats puts 8 consecutive pixels' float4s in distinct banks, and a
// warp's lanes read consecutive pixels (the callers interleave their pixel
// groups); a float4 of weights is shared by the lanes of one channel
// group, and 8 channel groups read 128 contiguous bytes.  Measured on an
// H100, the loops ptxas makes of this issue an FFMA about every 2 clocks:
// 40-55 % of the FFMAs read their two non-reused register operands from
// one register bank (exsr_torch/scripts/sass_loops.py), and CUDA C does
// not choose the registers (stage4.cu and rdb.cu say what else each
// kernel spends).
#pragma once

namespace fma_conv {

// A float4 accumulator's component e holds output channel channel_of(e)
// of its four: its pair partner (e ^ 1), or e without kSwapPairs.  ptxas
// tends to give an accumulator's components registers of the banks the
// weights' float4 components have; pairing each with the other bank's
// weight cut stage 4's same-bank FFMAs from 237 to 202 of 512 and its
// time 4 % (stage4_probe.py --ablate fp32_no_swap).
constexpr bool kSwapPairs = true;
__host__ __device__ constexpr int channel_of(int e) {
  return kSwapPairs ? e ^ 1 : e;
}

template <int E>
__device__ __forceinline__ float& comp(float4& v) {
  return E == 0 ? v.x : E == 1 ? v.y : E == 2 ? v.z : v.w;
}
template <int E>
__device__ __forceinline__ float comp(const float4& v) {
  return E == 0 ? v.x : E == 1 ? v.y : E == 2 ? v.z : v.w;
}

// The four outputs of an accumulator, in channel order.
__device__ __forceinline__ float4 channels(const float4& acc) {
  return make_float4(comp<channel_of(0)>(acc), comp<channel_of(1)>(acc),
                     comp<channel_of(2)>(acc), comp<channel_of(3)>(acc));
}

// For p < PX, v < NV and output channel c of acc[p][v]'s four:
// acc[p][v] (channel c) += sum_{k < k_n} a[p][k] * b[k * b_row + v * b_next
// + c].  a[p] and b are shared-memory pointers, 16-byte aligned, as are
// b_row and b_next (in floats); k_n is a multiple of 4.
template <int PX, int NV>
__device__ __forceinline__ void mac(float4 (&acc)[PX][NV],
                                    const float* const (&a)[PX],
                                    const float* b, int b_row, int b_next,
                                    int k_n) {
#pragma unroll 2
  for (int k = 0; k < k_n; k += 4) {
    float4 av[PX];
#pragma unroll
    for (int p = 0; p < PX; ++p)
      av[p] = *reinterpret_cast<const float4*>(a[p] + k);
    float4 bv[4][NV];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int v = 0; v < NV; ++v)
        bv[kk][v] = *reinterpret_cast<const float4*>(b + (k + kk) * b_row +
                                                     v * b_next);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int p = 0; p < PX; ++p) {
        const float x = kk == 0   ? av[p].x
                        : kk == 1 ? av[p].y
                        : kk == 2 ? av[p].z
                                  : av[p].w;
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const float4 w = bv[kk][v];
          float4& c = acc[p][v];
          comp<0>(c) = fmaf(x, comp<channel_of(0)>(w), comp<0>(c));
          comp<1>(c) = fmaf(x, comp<channel_of(1)>(w), comp<1>(c));
          comp<2>(c) = fmaf(x, comp<channel_of(2)>(w), comp<2>(c));
          comp<3>(c) = fmaf(x, comp<channel_of(3)>(w), comp<3>(c));
        }
      }
    }
  }
}

}  // namespace fma_conv
