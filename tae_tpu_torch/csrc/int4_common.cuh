// Device code shared by the int4 (w4a8) serving kernels: K12
// int4_matmul_fused (int4_matmul.cu) and K13 int4_mlp (int4_block.cu), on
// top of the int8 helpers of int8_common.cuh.
//
//   * w4_gemm: one (BM x BN) tile of sum_g float(A_g . W_g^T) * s_g, the
//     K range walked one scale group at a time. A is int8, K-contiguous,
//     from device memory through a cp.async ring or resident in shared
//     memory; W is the packed int4 weight, (N, K/2) bytes, K-contiguous per
//     output channel, streamed through the ring still packed. The product
//     is mma.sync.m16n8k32 (int8 x int8 -> int32), whose register layout is
//     documented, so each thread scales its own int32 sums by the group's
//     per-column fp32 scale and keeps the fp32 tile in registers: nothing
//     passes through shared memory between the groups.
//   * The byte layout ("k32-twos", ops/cuda/int4_matmul.py): within every
//     run of 32 consecutive K values, byte j holds element j in its low
//     nibble and element 16 + j in its high nibble, two's complement. The B
//     operand of m16n8k32 is, per thread, bytes 4t..4t+3 and 16+4t..16+4t+3
//     of one output channel: one 32-bit word w of this layout. (w << 4) &
//     0xF0F0F0F0 and w & 0xF0F0F0F0 are those two registers with every byte
//     16 times its code; the int32 sum of a group is a multiple of 16 and
//     is shifted back by 4 exactly (|sum| <= 256 * 127 * 7 * 16 < 2^22).
//
// Numerics shared with the plain PyTorch versions: the groups are added in
// ascending K order, acc = acc + float(ig_g) * s_g, every product and sum
// rounded separately (__fmul_rn / __fadd_rn).
#pragma once

#include "int8_common.cuh"

namespace tae {
namespace i4 {

constexpr int kBK = 64;                 // K values per pipeline step
constexpr int kStages = 4;              // stages of the operand ring
constexpr int kLdA = kBK + 16;          // shared row stride of an A tile (bytes)
constexpr int kLdW = kBK / 2 + 16;      // ... of a packed W tile

__host__ __device__ constexpr int w4_ring_bytes(int bm, int bn, bool a_shared) {
  return kStages * ((a_shared ? 0 : bm * kLdA) + bn * kLdW);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy step kt of an operand into its ring slot: `rows` rows of BYTES bytes
// (64 for A, 32 for packed W) from src (row stride ld), rows at or beyond
// valid_rows zero-filled so a ragged edge adds nothing to the product.
template <int NT, int BYTES, int LD>
__device__ __forceinline__ void stage_rows(unsigned char* dst, const unsigned char* __restrict__ src,
                                           long ld, int rows, int valid_rows, int kt) {
  constexpr int kParts = BYTES / 16;
  for (int c = threadIdx.x; c < rows * kParts; c += NT) {
    const int r = c / kParts, part = c % kParts;
    unsigned char* d = dst + r * LD + part * 16;
    if (r < valid_rows) {
      __pipeline_memcpy_async(d, src + r * ld + static_cast<long>(kt) * BYTES + part * 16, 16);
    } else {
      *reinterpret_cast<int4*>(d) = make_int4(0, 0, 0, 0);
    }
  }
}

// The part of a (BM x BN) tile one thread holds after w4_gemm, in the
// accumulator layout of mma.m16n8k32: warp (wm, wn) of WARPS_M x WARPS_N
// owns rows wm * WM .. and columns wn * WN ..; element [mi][ni][e] is row
// wm * WM + mi * 16 + lane / 4 + 8 * (e / 2), column wn * WN + ni * 8 +
// 2 * (lane % 4) + e % 2.
template <int NT, int BM, int BN, int WARPS_M>
struct W4Tile {
  static constexpr int kWarpsN = NT / 32 / WARPS_M;
  static constexpr int kWM = BM / WARPS_M, kWN = BN / kWarpsN;
  static constexpr int kMI = kWM / 16, kNI = kWN / 8;
  static_assert(kWM % 16 == 0 && kWN % 8 == 0, "warp tile must hold 16 x 8 fragments");
  __device__ __forceinline__ static int row(int mi, int e) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    return (warp / kWarpsN) * kWM + mi * 16 + lane / 4 + 8 * (e / 2);
  }
  __device__ __forceinline__ static int col(int ni, int e) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    return (warp % kWarpsN) * kWN + ni * 8 + 2 * (lane % 4) + e % 2;
  }
};

// accf[mi][ni][e] += sum over n_groups groups of float(A_g . W_g^T) * s_g
// for the block's NT threads, layout W4Tile<NT, BM, BN, WARPS_M>.
//   a: first row of the A tile at the first K value of the range.
//      A_SHARED = false: device memory, row stride lda bytes, a_rows valid
//      rows. A_SHARED = true: shared memory holding all BM rows of the
//      whole range, row stride lda (a multiple of 4).
//   w: first row (output channel) of the W tile at the range's first packed
//      byte, row stride ldw bytes, w_rows valid rows (a multiple of 2).
//   scale: the first group's scale of the tile's first column; lds floats
//      from one group to the next.
//   group: K values per group, a multiple of kBK.
//   ring: w4_ring_bytes(BM, BN, A_SHARED) bytes of staging.
// Ends with a block barrier: the ring is free for the next call.
template <int NT, int BM, int BN, int WARPS_M, bool A_SHARED>
__device__ __forceinline__ void w4_gemm(
    const int8_t* a, long lda, int a_rows, const uint8_t* __restrict__ w, long ldw, int w_rows,
    const float* __restrict__ scale, long lds, int n_groups, int group, unsigned char* ring,
    float (&accf)[W4Tile<NT, BM, BN, WARPS_M>::kMI][W4Tile<NT, BM, BN, WARPS_M>::kNI][4]) {
  using T = W4Tile<NT, BM, BN, WARPS_M>;
  constexpr int MI = T::kMI, NI = T::kNI;
  constexpr int kSlotA = A_SHARED ? 0 : BM * kLdA;
  constexpr int kSlot = kSlotA + BN * kLdW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / T::kWarpsN, wn = warp % T::kWarpsN;
  const int g = lane / 4, t = lane % 4;
  const int spg = group / kBK;            // pipeline steps per group
  const int nk = n_groups * spg;

  auto stage = [&](int kt) {
    unsigned char* slot = ring + (kt % kStages) * kSlot;
    if (!A_SHARED) {
      stage_rows<NT, kBK, kLdA>(slot, reinterpret_cast<const unsigned char*>(a), lda, BM, a_rows,
                                kt);
    }
    stage_rows<NT, kBK / 2, kLdW>(slot + kSlotA, w, ldw, BN, w_rows, kt);
  };

  int c[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[mi][ni][e] = 0;

  // one commit per slot whether or not it loads, so group kt is step kt
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) stage(s);
    __pipeline_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    __pipeline_wait_prior(kStages - 2);   // this thread's copies of step kt landed
    __syncthreads();                      // everyone's did; step kt - 1 is computed
    if (kt + kStages - 1 < nk) stage(kt + kStages - 1);
    __pipeline_commit();

    const unsigned char* slot = ring + (kt % kStages) * kSlot;
    const unsigned char* at =
        A_SHARED ? reinterpret_cast<const unsigned char*>(a) + static_cast<long>(kt) * kBK : slot;
    const int a_ld = A_SHARED ? static_cast<int>(lda) : kLdA;
    const unsigned char* wt = slot + kSlotA;
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk) {
      unsigned fa[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const unsigned char* ap = at + (wm * T::kWM + mi * 16 + g) * a_ld + kk * 32 + 4 * t;
        fa[mi][0] = *reinterpret_cast<const unsigned*>(ap);
        fa[mi][1] = *reinterpret_cast<const unsigned*>(ap + 8 * a_ld);
        fa[mi][2] = *reinterpret_cast<const unsigned*>(ap + 16);
        fa[mi][3] = *reinterpret_cast<const unsigned*>(ap + 8 * a_ld + 16);
      }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const unsigned wv = *reinterpret_cast<const unsigned*>(
            wt + (wn * T::kWN + ni * 8 + g) * kLdW + kk * 16 + 4 * t);
        const unsigned b0 = (wv << 4) & 0xF0F0F0F0u, b1 = wv & 0xF0F0F0F0u;
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) mma_s8(c[mi][ni], fa[mi], b0, b1);
      }
    }

    if ((kt + 1) % spg == 0) {
      // the group's int32 sums (16 x the codes' product) meet its scales
      const float* sg = scale + static_cast<long>(kt / spg) * lds;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int col = T::col(ni, 0);
        const float2 s = col < w_rows ? *reinterpret_cast<const float2*>(sg + col)
                                      : make_float2(0.f, 0.f);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float ig = __int2float_rn(c[mi][ni][e] >> 4);
            accf[mi][ni][e] = __fadd_rn(accf[mi][ni][e], __fmul_rn(ig, e % 2 ? s.y : s.x));
            c[mi][ni][e] = 0;
          }
      }
    }
  }
  __syncthreads();   // every warp has left the ring
}

// Two consecutive elements of a float32 / bfloat16 array as fp32 (idx even).
__device__ __forceinline__ float2 load2(const void* p, long idx, int dtype) {
  if (dtype == kBFloat16) {
    return __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(static_cast<const __nv_bfloat16*>(p) + idx));
  }
  return *reinterpret_cast<const float2*>(static_cast<const float*>(p) + idx);
}

__device__ __forceinline__ void store2_as(void* p, long idx, int dtype, float a, float b) {
  if (dtype == kBFloat16) {
    store2(static_cast<__nv_bfloat16*>(p) + idx, a, b);
  } else {
    store2(static_cast<float*>(p) + idx, a, b);
  }
}

}  // namespace i4
}  // namespace tae
