// Device code shared by the int8 (w8a8) serving kernels: K3 ln_quant and
// K5 int8_mlp (int8_block.cu), K4 int8_matmul_fused (int8_matmul.cu) and
// the int8-output attention (flash_attention.cu, wide_attention.cu).
//
//   * ln_quant_row: LayerNorm of one row with fp32 statistics followed by
//     per-row symmetric int8 quantization, one warp per row. It is the body
//     of K3 and of the finish passes of K4 (ln_out) and K5 (ln_next); the
//     row comes from device memory through a loader functor.
//   * gemm_mainloop: one block's (BM x BN) int32 tile of an int8 x int8
//     product, both operands K-contiguous ((M, K) and (N, K)), over a range
//     of K. mma.sync.m16n8k32 (tae::mma_s8) with the accumulators in
//     registers; both operands read from shared memory by ldmatrix on the
//     b16 view of 16-byte rows; a cp.async ring of STAGES slots of 128
//     values of K each (one block barrier per 128), A rows padded to 144
//     bytes so that the eight rows an ldmatrix reads fall in eight
//     different bank groups. A fold functor runs after every group of K
//     steps (K5's fc2 folds each hidden block's int32 sums into fp32). The
//     B operand is int8 rows (RowsI8) or, for the w4a8 kernels K12 and K13,
//     packed int4 rows (RowsI4, int4_common.cuh's layout): 64 bytes of a row
//     a stage on an 80-byte stride, one ldmatrix.x4 a stage and n8 tile,
//     each of its four words decoded in registers into one k32 step's B
//     registers.
//   * transpose_rows8 / for_rows8: the accumulator tile handed to an
//     epilogue as 8 consecutive columns of one row per lane, turned from the
//     C fragments by quad transposes (tae::quad_transpose), so epilogues
//     read and write 16 bytes a lane without passing through shared memory.
//   * store_c_codes: the int8 codes of an attention warp's fp32 m16n8 C
//     fragments, 16 bytes a lane: the row epilogue of the int8-output
//     attention bodies (K7 / K8 in flash_attention.cu, K9 in
//     wide_attention.cu).
//
// Numerics shared with the plain PyTorch versions: int32 sums are exact in
// any order; rounding is half-even (rintf), the quantize step multiplies by
// an exact reciprocal 1.0f / s, the scale is max(amax / 127, 1e-12),
// LayerNorm statistics are two-pass fp32 with rsqrtf, and every epilogue
// product and sum is rounded separately (__fmul_rn / __fadd_rn keep the
// compiler from contracting them into fused multiply-adds the plain
// versions do not use).
#pragma once

#include <cuda_pipeline.h>
#include <stdint.h>

#include "common.cuh"

namespace tae {
namespace i8 {

constexpr int kBK = 128;               // bytes of K per pipeline stage
constexpr int kLd = kBK + 16;          // shared row stride of an operand tile
constexpr int kSmemLimit = 232448;     // dynamic shared memory of one block

// 8 consecutive elements of a float32 / bfloat16 array (dtype codes of
// common.cuh) as fp32; idx must be a multiple of 8 and p 16-byte aligned.
__device__ __forceinline__ void load8(const void* p, long idx, int dtype, float* v) {
  if (dtype == kBFloat16) {
    load_vec(static_cast<const __nv_bfloat16*>(p) + idx, v);
  } else {
    load_vec(static_cast<const float*>(p) + idx, v);
    load_vec(static_cast<const float*>(p) + idx + 4, v + 4);
  }
}

__device__ __forceinline__ void store8(void* p, long idx, int dtype, const float* v) {
  if (dtype == kBFloat16) {
    store_vec(static_cast<__nv_bfloat16*>(p) + idx, v);
  } else {
    store_vec(static_cast<float*>(p) + idx, v);
    store_vec(static_cast<float*>(p) + idx + 4, v + 4);
  }
}

__device__ __forceinline__ float quant_scale(float amax) {
  return fmaxf(amax / 127.0f, 1e-12f);
}

// clip(round_half_even(y * inv), -127, 127)
__device__ __forceinline__ int quantize1(float y, float inv) {
  return __float2int_rn(fminf(fmaxf(rintf(__fmul_rn(y, inv)), -127.0f), 127.0f));
}

// 8 int8 codes of y[0..7] * inv, packed for one 8-byte store.
__device__ __forceinline__ uint2 quantize8(const float* y, float inv) {
  unsigned w[2] = {0u, 0u};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const unsigned q = static_cast<unsigned>(quantize1(y[k], inv)) & 0xffu;
    w[k / 4] |= q << (8 * (k % 4));
  }
  return make_uint2(w[0], w[1]);
}

// tanh-form GELU in fp32: x * (0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 x^3))))
__device__ __forceinline__ float gelu_tanh(float x) {
  const float x3 = __fmul_rn(__fmul_rn(x, x), x);
  const float inner = __fmul_rn(0.7978845608028654f, __fadd_rn(x, __fmul_rn(0.044715f, x3)));
  return __fmul_rn(x, __fmul_rn(0.5f, __fadd_rn(1.0f, tanhf(inner))));
}

// LayerNorm + per-row int8 quantization of one row by one warp.
// load(i, v) reads the row's columns i..i+7 as fp32 (i a multiple of 8);
// cols is a multiple of 8; gamma / beta have dtype w_dtype. Writes cols
// int8 codes to q (8-byte aligned) and the row's scale to *s_out.
template <typename Load>
__device__ __forceinline__ void ln_quant_row(Load load, int cols, const void* gamma,
                                             const void* beta, int w_dtype, float eps,
                                             int8_t* q, float* s_out, int lane) {
  float v[8], g[8], b[8];

  float sum = 0.f;
  for (int i = lane * 8; i < cols; i += 256) {
    load(i, v);
#pragma unroll
    for (int k = 0; k < 8; ++k) sum += v[k];
  }
  const float mean = warp_sum(sum) / cols;

  float sq = 0.f;
  for (int i = lane * 8; i < cols; i += 256) {
    load(i, v);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float d = v[k] - mean;
      sq += d * d;
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / cols + eps);

  float amax = 0.f;
  for (int i = lane * 8; i < cols; i += 256) {
    load(i, v);
    load8(gamma, i, w_dtype, g);
    load8(beta, i, w_dtype, b);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float y = __fadd_rn(__fmul_rn(__fmul_rn(v[k] - mean, rstd), g[k]), b[k]);
      amax = fmaxf(amax, fabsf(y));
    }
  }
  const float s = quant_scale(warp_max(amax));
  const float inv = 1.0f / s;

  for (int i = lane * 8; i < cols; i += 256) {
    load(i, v);
    load8(gamma, i, w_dtype, g);
    load8(beta, i, w_dtype, b);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      v[k] = __fadd_rn(__fmul_rn(__fmul_rn(v[k] - mean, rstd), g[k]), b[k]);
    }
    *reinterpret_cast<uint2*>(q + i) = quantize8(v, inv);
  }
  if (lane == 0) *s_out = s;
}

// Loader of ln_quant_row for an fp32 row in shared (or device) memory.
struct RowF32 {
  const float* row;
  __device__ __forceinline__ void operator()(int i, float* v) const {
    load_vec(row + i, v);
    load_vec(row + i + 4, v + 4);
  }
};

// The int8 codes of a warp's 16 x DH fp32 tile c (the m16n8 C fragments of
// o, rows g and g + 8), clip(rint(c * inv[half]), +-127), handed over 16
// bytes a lane: store(half, ch, codes) for the codes of columns 16 ch ..
// 16 ch + 15 of row g + 8 * half, ch < DH / 16. Lane t packs the codes of
// d-tiles 2 ch, 2 ch + 1 into word ch % 4 (two bytes each), the quad
// transpose hands lane t word t of every lane, and byte permutes put them
// in column order.
template <int DH, typename Store>
__device__ __forceinline__ void store_c_codes(const float (&c)[DH / 8][4], const float (&inv)[2],
                                              Store store) {
  constexpr int CH = DH / 16, QG = (CH + 3) / 4;
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int q = 0; q < QG; ++q) {
      unsigned w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ch = 4 * q + i;
        w[i] = 0u;
        if (ch < CH) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float y = c[2 * ch + k / 2][2 * half + k % 2];
            const unsigned code = static_cast<unsigned>(quantize1(y, inv[half])) & 0xffu;
            w[i] |= code << (8 * k);
          }
        }
      }
      quad_transpose(w);
      const int ch = 4 * q + t;
      if (ch < CH)
        store(half, ch, make_uint4(__byte_perm(w[0], w[1], 0x5410), __byte_perm(w[2], w[3], 0x5410),
                                   __byte_perm(w[0], w[1], 0x7632), __byte_perm(w[2], w[3], 0x7632)));
    }
  }
}

// 8 int32 as fp32 (round to nearest even; exact below 2^24).
__device__ __forceinline__ void to_float8(const int* v, float* y) {
#pragma unroll
  for (int j = 0; j < 8; ++j) y[j] = __int2float_rn(v[j]);
}

// A block's tiling: BM x BN outputs, WARPS_M x WARPS_N warps of WM x WN
// each, STAGES ring slots, MINB blocks an SM (__launch_bounds__' second
// argument). A warp holds MI x NI m16n8 accumulator tiles.
template <int BM_, int BN_, int WARPS_M_, int WARPS_N_, int STAGES_, int MINB_ = 1>
struct Tiles {
  static constexpr int BM = BM_, BN = BN_, WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int STAGES = STAGES_, MINB = MINB_;
  static constexpr int NT = 32 * WARPS_M * WARPS_N;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  static constexpr int MI = WM / 16, NI = WN / 8;
  static constexpr int kStage = (BM + BN) * kLd;   // bytes of one ring slot
  static constexpr int kSmem = STAGES * kStage;    // bytes of the ring
  static_assert(WM % 16 == 0 && WN % 32 == 0, "warp tile: 16-row, 32-column multiples");
  static_assert(STAGES >= 2, "the ring needs two slots");
};

template <class S> using Acc = int[S::MI][S::NI][4];

// Let a kernel take `bytes` of dynamic shared memory and ask for the
// largest shared-memory carveout, so that MINB blocks fit an SM.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes) {
  cudaError_t rc =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc != cudaSuccess) return rc;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// 16 bytes from device memory to shared memory (a 32-bit shared address)
// by cp.async.cg, in this thread's current commit group; with valid false
// the 16 bytes are zero-filled and src is not read.
__device__ __forceinline__ void cp_async16_zfill(unsigned dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(dst), "l"(src), "r"(valid ? 16 : 0));
}

// Copy bytes [k, k + BYTES) of ROWS operand rows (row stride ld bytes, from
// src) into a ring slot (32-bit shared address dst, row stride LD), 16
// bytes a cp.async: thread t copies chunk t % (BYTES / 16) of rows
// t / (BYTES / 16), ... Rows at or beyond valid_rows and bytes at or beyond
// k_end are zero-filled, so ragged edges add nothing to the product.
template <int NT, int ROWS, int BYTES = kBK, int LD = kLd>
__device__ __forceinline__ void stage_k_tile(unsigned dst, const int8_t* __restrict__ src, long ld,
                                             int valid_rows, int k, int k_end) {
  constexpr int kChunks = BYTES / 16, kStep = NT / kChunks;
  static_assert(NT % kChunks == 0, "whole rows per pass");
  const int ch = (threadIdx.x % kChunks) * 16, r0 = threadIdx.x / kChunks;
  const bool in_k = k + ch < k_end;
  const int8_t* s = src + r0 * ld + k + ch;
  const unsigned d = dst + r0 * LD + ch;
#pragma unroll
  for (int i = 0; i < (ROWS + kStep - 1) / kStep; ++i) {
    const int r = r0 + i * kStep;
    if (ROWS % kStep != 0 && r >= ROWS) break;
    const bool valid = in_k && r < valid_rows;
    cp_async16_zfill(d + i * kStep * LD, valid ? s + i * kStep * ld : src, valid);
  }
}

// The B operand of gemm_mainloop. RowsI8: int8 rows, kBK bytes a stage on
// the A operand's 144-byte stride. RowsI4<FOLD_K>: packed int4 rows
// (int4_common.cuh), kBK / 2 bytes a stage on an 80-byte stride: the eight
// 16-byte rows an ldmatrix reads start at 80 r bytes, r = 0..7, which fall
// in the 16-byte bank groups 0, 5, 2, 7, 4, 1, 6, 3 of a 128-byte bank
// line, all different. FOLD_K is the K of a fold unit: kBK (a fold after
// every group of whole stages) or 64 (groups of 64-value units, a fold
// possible after every two k32 steps).
struct RowsI8 {
  static constexpr bool kPacked = false;
  static constexpr int kLdB = kLd;
};
template <int FOLD_K>
struct RowsI4 {
  static constexpr bool kPacked = true;
  static constexpr int kBytes = kBK / 2, kLdB = kBK / 2 + 16, kFoldK = FOLD_K;
  static_assert(FOLD_K == kBK || FOLD_K == 64, "fold after a stage or a half stage");
};

// Bytes of S's operand ring with a B operand of form B.
template <class S, class B>
__host__ __device__ constexpr int ring_bytes() {
  return S::STAGES * (S::BM * kLd + S::BN * B::kLdB);
}

struct NoFold {
  template <class A> __device__ __forceinline__ void operator()(A&, int) const {}
};

// acc = A[a_rows][k0:k1] x B[b_rows][k0:k1]^T for one block tile.
//   a, b: the tile's first row in device memory (row stride lda / ldb
//     bytes); rows beyond a_rows / b_rows read as zero. B of form B (an
//     int8 row, or a packed int4 row holding K / 2 bytes).
//   k0, k1: the K range in values (A's bytes), multiples of 16 (of 32 for
//     packed rows); k0 a multiple of kBK.
//   fold(acc, i) runs after the i-th group of group_steps fold units (K
//     steps of kBK, or of B::kFoldK values; it may use and clear acc); the
//     last group may be partial only when fold does nothing. Packed int4
//     sums are 16 times the codes' product (int4_common.cuh).
//   smem: ring_bytes<S, B>() bytes, 16-byte aligned.
// No barrier at the end: the caller syncs before reusing smem.
template <class S, class B = RowsI8, class Fold>
__device__ __forceinline__ void gemm_mainloop(Acc<S>& acc, const int8_t* __restrict__ a, long lda,
                                              int a_rows, const int8_t* __restrict__ b, long ldb,
                                              int b_rows, int k0, int k1, int group_steps,
                                              int8_t* smem, Fold fold) {
#pragma unroll
  for (int mi = 0; mi < S::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < S::NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  constexpr int kStage = S::BM * kLd + S::BN * B::kLdB;   // bytes of one ring slot
  const int nk = k1 > k0 ? (k1 - k0 + kBK - 1) / kBK : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / S::WARPS_N, wn = warp % S::WARPS_N;
  // ldmatrix row addresses. A (x4): matrices (rows 0-7 | 8-15) x (bytes
  // 0-15 | 16-31) give a0..a3. int8 B (x4): two n8 tiles, matrices (n 0-7,
  // bytes 0-15), (n 0-7, 16-31), (n 8-15, 0-15), (n 8-15, 16-31) give
  // b0, b1 of the first and of the second. Packed B (x4): one n8 tile,
  // matrix j the 16 bytes of k32 step j, whose word (row g, t) is that
  // step's b0 and b1 still packed.
  const unsigned base = smem_addr(smem);
  const unsigned a_off = (wm * S::WM + (lane & 15)) * kLd + (lane >> 4) * 16;
  const unsigned b_off =
      B::kPacked ? S::BM * kLd + (wn * S::WN + (lane & 7)) * B::kLdB + (lane >> 3) * 16
                 : S::BM * kLd + (wn * S::WN + (lane & 7) + ((lane >> 4) << 3)) * kLd +
                       ((lane >> 3) & 1) * 16;

  auto stage = [&](int kt) {
    const unsigned slot = base + (kt % S::STAGES) * kStage;
    const int k = k0 + kt * kBK;
    stage_k_tile<S::NT, S::BM>(slot, a, lda, a_rows, k, k1);
    if constexpr (B::kPacked) {
      stage_k_tile<S::NT, S::BN, B::kBytes, B::kLdB>(slot + S::BM * kLd, b, ldb, b_rows, k / 2,
                                                     k1 / 2);
    } else {
      stage_k_tile<S::NT, S::BN>(slot + S::BM * kLd, b, ldb, b_rows, k, k1);
    }
  };

  // one commit per slot whether or not it loads, so group kt is step kt
#pragma unroll
  for (int s = 0; s < S::STAGES - 1; ++s) {
    if (s < nk) stage(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    __pipeline_wait_prior(S::STAGES - 2);   // this thread's copies of step kt landed
    __syncthreads();                         // everyone's did; step kt - 1 is computed
    if (kt + S::STAGES - 1 < nk) stage(kt + S::STAGES - 1);
    cp_async_commit();

    const unsigned slot = base + (kt % S::STAGES) * kStage;
    if constexpr (B::kPacked) {
      unsigned bw[S::NI][4];
#pragma unroll
      for (int ni = 0; ni < S::NI; ++ni) ldmatrix_x4_at(bw[ni], slot + b_off + ni * 8 * B::kLdB);
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk) {
        unsigned af[S::MI][4];
#pragma unroll
        for (int mi = 0; mi < S::MI; ++mi)
          ldmatrix_x4_at(af[mi], slot + a_off + mi * 16 * kLd + kk * 32);
#pragma unroll
        for (int ni = 0; ni < S::NI; ++ni) {
          // each byte of b0, b1: 16 times its code (int4_common.cuh)
          const unsigned b0 = (bw[ni][kk] << 4) & 0xF0F0F0F0u, b1 = bw[ni][kk] & 0xF0F0F0F0u;
#pragma unroll
          for (int mi = 0; mi < S::MI; ++mi) mma_s8(acc[mi][ni], af[mi], b0, b1);
        }
        if constexpr (B::kFoldK < kBK) {
          const int u = 2 * kt + kk / 2;   // the 64-value unit this step ends
          if (kk % 2 == 1 && (u + 1) % group_steps == 0 && (u + 1) * 64 <= k1 - k0)
            fold(acc, u / group_steps);
        }
      }
      if constexpr (B::kFoldK == kBK) {
        if ((kt + 1) % group_steps == 0) fold(acc, kt / group_steps);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk) {
        unsigned af[S::MI][4], bf[S::NI][2];
#pragma unroll
        for (int mi = 0; mi < S::MI; ++mi)
          ldmatrix_x4_at(af[mi], slot + a_off + mi * 16 * kLd + kk * 32);
#pragma unroll
        for (int nj = 0; nj < S::NI / 2; ++nj) {
          unsigned r[4];
          ldmatrix_x4_at(r, slot + b_off + nj * 16 * kLd + kk * 32);
          bf[2 * nj][0] = r[0];
          bf[2 * nj][1] = r[1];
          bf[2 * nj + 1][0] = r[2];
          bf[2 * nj + 1][1] = r[3];
        }
#pragma unroll
        for (int mi = 0; mi < S::MI; ++mi)
#pragma unroll
          for (int ni = 0; ni < S::NI; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
      }
      if ((kt + 1) % group_steps == 0) fold(acc, kt / group_steps);
    }
  }
}

// The row of the block tile that accumulator element [mi][.][e] of this
// lane belongs to (e / 2 is the row half).
template <class S> __device__ __forceinline__ int acc_row(int mi, int half) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return (warp / S::WARPS_N) * S::WM + mi * 16 + lane / 4 + 8 * half;
}

// Turn the accumulator tile, in place, from the m16n8 C layout (lane t
// holds columns 2t, 2t + 1 of every 8) into rows of 8: for each (mi, row
// half h, group q of four n8 tiles), lane t then holds the 8 consecutive
// columns 32q + 8t .. 32q + 8t + 7 of the warp tile's row acc_row(mi, h), as
// element j at acc[mi][4q + j / 2][2h + j % 2]. Two quad transposes per
// (mi, h, q), on the 32-bit patterns: int32 or fp32 alike.
__device__ __forceinline__ unsigned to_bits(int v) { return static_cast<unsigned>(v); }
__device__ __forceinline__ unsigned to_bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ void from_bits(unsigned u, int& v) { v = static_cast<int>(u); }
__device__ __forceinline__ void from_bits(unsigned u, float& v) { v = __uint_as_float(u); }

template <class S, class T>
__device__ __forceinline__ void transpose_rows8(T (&acc)[S::MI][S::NI][4]) {
#pragma unroll
  for (int mi = 0; mi < S::MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < S::NI / 4; ++q) {
        unsigned ev[4], od[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ev[i] = to_bits(acc[mi][4 * q + i][2 * h]);
          od[i] = to_bits(acc[mi][4 * q + i][2 * h + 1]);
        }
        quad_transpose(ev);
        quad_transpose(od);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          from_bits(ev[i], acc[mi][4 * q + i][2 * h]);
          from_bits(od[i], acc[mi][4 * q + i][2 * h + 1]);
        }
      }
}

// The column (within the block tile) of lane t's 8 after transpose_rows8.
template <class S> __device__ __forceinline__ int rows8_col(int q) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return (warp % S::WARPS_N) * S::WN + 32 * q + 8 * (lane % 4);
}

// transpose_rows8, then fn(r, c, v) for each of this lane's rows of 8: r,
// c the row and first column within the block tile, v[8] the values.
template <class S, class T, class Fn>
__device__ __forceinline__ void for_rows8(T (&acc)[S::MI][S::NI][4], Fn fn) {
  transpose_rows8<S>(acc);
#pragma unroll
  for (int mi = 0; mi < S::MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < S::NI / 4; ++q) {
        T v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = acc[mi][4 * q + j / 2][2 * h + j % 2];
        fn(acc_row<S>(mi, h), rows8_col<S>(q), v);
      }
}

}  // namespace i8
}  // namespace tae
