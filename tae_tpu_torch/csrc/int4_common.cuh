// Device code shared by the int4 (w4a8) serving kernels: K12
// int4_matmul_fused (int4_matmul.cu) and K13 int4_mlp (int4_block.cu). Both
// run int8_common.cuh's gemm_mainloop with a packed int4 B operand
// (RowsI4): the weight is staged into shared memory still packed, read by
// ldmatrix and decoded in registers, and a fold after every scale group
// turns the group's int32 sums into fp32.
//
// The byte layout ("k32-twos", ops/cuda/int4_matmul.py): within every run
// of 32 consecutive K values, byte j holds element j in its low nibble and
// element 16 + j in its high nibble, two's complement. The B operand of
// m16n8k32 is, per thread, bytes 4t..4t+3 and 16+4t..16+4t+3 of one output
// channel: one 32-bit word w of this layout. (w << 4) & 0xF0F0F0F0 and
// w & 0xF0F0F0F0 are those two registers with every byte 16 times its code;
// the int32 sum of a group is a multiple of 16 and is shifted back by 4
// exactly (|sum| <= G * 127 * 7 * 16, far below 2^31).
//
// Numerics shared with the plain PyTorch versions: the groups are added in
// ascending K order, acc = acc + float(ig_g) * s_g, every product and sum
// rounded separately (__fmul_rn / __fadd_rn).
#pragma once

#include "int8_common.cuh"

namespace tae {
namespace i4 {

using i8::Acc;

// The scales of one group for this lane's accumulator columns of tile S: s
// at the block tile's first column; columns at or beyond cols read 0. A
// fold's caller loads the next group's scales right after the fold, so the
// loads have a whole group of products to land in.
template <class S>
__device__ __forceinline__ void load_scales(float2 (&sc)[S::NI], const float* __restrict__ s,
                                            int cols) {
  const int lane = threadIdx.x % 32, wn = (threadIdx.x / 32) % S::WARPS_N;
#pragma unroll
  for (int ni = 0; ni < S::NI; ++ni) {
    const int col = wn * S::WN + ni * 8 + 2 * (lane % 4);
    sc[ni] = col < cols ? *reinterpret_cast<const float2*>(s + col) : make_float2(0.f, 0.f);
  }
}

// The fold of one scale group: accf += float(c >> 4) * sc, c = 0, for this
// lane's accumulators of tile S; sc from load_scales. float() rounds the
// group's exact sum to nearest, as the plain version's cast of its float64
// sum does.
template <class S>
__device__ __forceinline__ void fold_group(Acc<S>& c, float (&accf)[S::MI][S::NI][4],
                                           const float2 (&sc)[S::NI]) {
#pragma unroll
  for (int ni = 0; ni < S::NI; ++ni)
#pragma unroll
    for (int mi = 0; mi < S::MI; ++mi)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float ig = __int2float_rn(c[mi][ni][e] >> 4);
        accf[mi][ni][e] = __fadd_rn(accf[mi][ni][e], __fmul_rn(ig, e % 2 ? sc[ni].y : sc[ni].x));
        c[mi][ni][e] = 0;
      }
}

template <class S>
__device__ __forceinline__ void zero(float (&v)[S::MI][S::NI][4]) {
#pragma unroll
  for (int mi = 0; mi < S::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < S::NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) v[mi][ni][e] = 0.f;
}

}  // namespace i4
}  // namespace tae
