// Device code shared by the int8 (w8a8) serving kernels: K3 ln_quant and
// K5 int8_mlp (int8_block.cu) and K4 int8_matmul_fused (int8_matmul.cu).
//
//   * ln_quant_row: LayerNorm of one row with fp32 statistics followed by
//     per-row symmetric int8 quantization, one warp per row. It is the body
//     of K3 and the chained epilogue of K4 (ln_out) and K5 (ln_next); the
//     row comes from device memory (K3) or from an fp32 row in shared
//     memory (the epilogues), through a loader functor.
//   * gemm_tile: one (BM x BN) int32 tile of an int8 x int8 product on the
//     tensor cores (nvcuda::wmma, signed char 16x16x16 -> int), both
//     operands K-contiguous, operand tiles staged through shared memory by
//     a three-stage cp.async ring with one block barrier per step, the
//     result stored to shared memory (it may overlay the ring) where the
//     caller's epilogue reads it with a known layout.
//
// Numerics shared with the plain PyTorch versions: rounding is half-even
// (rintf), the quantize step multiplies by an exact reciprocal 1.0f / s,
// the scale is max(amax / 127, 1e-12), LayerNorm statistics are two-pass
// fp32 with rsqrtf, and every epilogue product and sum is rounded
// separately (__fmul_rn / __fadd_rn keep the compiler from contracting
// them into fused multiply-adds the plain versions do not use).
#pragma once

#include <cuda_pipeline.h>
#include <mma.h>
#include <stdint.h>

#include "common.cuh"

namespace tae {
namespace i8 {

constexpr int kBK = 64;                // bytes of K per pipeline stage
constexpr int kStages = 3;             // stages of the operand ring
constexpr int kLdT = kBK + 16;         // shared row stride of an operand tile
constexpr int kSmemLimit = 232448;     // dynamic shared memory of one block

// Row stride (ints) of a BN-wide result tile, and the bytes of the operand
// ring and of a result tile; a result tile may overlay the ring.
__host__ __device__ constexpr int tile_ld(int bn) { return bn + 4; }
__host__ __device__ constexpr int ring_bytes(int bm, int bn) {
  return kStages * (bm + bn) * kLdT;
}
__host__ __device__ constexpr int tile_bytes(int bm, int bn) { return bm * tile_ld(bn) * 4; }
__host__ __device__ constexpr int max_int(int a, int b) { return a > b ? a : b; }

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

// 8 consecutive int32 of a result tile in shared memory, as fp32.
__device__ __forceinline__ void load8_i32(const int* p, float* v) {
  const int4 a = *reinterpret_cast<const int4*>(p);
  const int4 b = *reinterpret_cast<const int4*>(p + 4);
  v[0] = __int2float_rn(a.x); v[1] = __int2float_rn(a.y);
  v[2] = __int2float_rn(a.z); v[3] = __int2float_rn(a.w);
  v[4] = __int2float_rn(b.x); v[5] = __int2float_rn(b.y);
  v[6] = __int2float_rn(b.z); v[7] = __int2float_rn(b.w);
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

// Copy one operand tile (rows x kBK bytes) of pipeline step kt into shared
// memory. src points at the tile's first row and the product's first K
// byte; rows at or beyond valid_rows and K bytes at or beyond klen are
// zero-filled, so ragged edges add nothing to the product.
template <int NT>
__device__ __forceinline__ void stage_tile(int8_t* dst, const int8_t* __restrict__ src,
                                           long ld, int rows, int valid_rows, int klen,
                                           int kt) {
  const int kbase = kt * kBK;
  for (int c = threadIdx.x; c < rows * 4; c += NT) {
    const int r = c >> 2, kc = kbase + (c & 3) * 16;
    int8_t* d = dst + r * kLdT + (c & 3) * 16;
    if (r < valid_rows && kc < klen) {
      __pipeline_memcpy_async(d, src + r * ld + kc, 16);
    } else {
      *reinterpret_cast<int4*>(d) = make_int4(0, 0, 0, 0);
    }
  }
}

// out[BM][BN] (int32, row stride ldo, shared memory) = A[BM][klen] x
// B[BN][klen]^T for the block's NT threads.
//   a: first row of the A tile. A_SHARED = false: device memory, row stride
//      lda bytes, a_rows valid rows from there. A_SHARED = true: shared
//      memory holding all BM rows and klen bytes (klen a multiple of kBK).
//   b: first row of the B tile in device memory ((N, K) layout, row stride
//      ldb bytes), b_rows valid rows from there.
//   klen: K bytes, a multiple of 16; a, b and the strides 16-byte aligned.
//   ring: ring_bytes(BM, BN) bytes of staging, kStages A tiles (unused
//      when A_SHARED) then kStages B tiles.
//   out may overlay the ring: every warp has left the ring when it is
//      written.
// WARPS_M x (NT / 32 / WARPS_M) warps tile the output. Ends with the stores to
// out unsynchronised: the caller syncs before reading them, and again
// before the next gemm_tile if out overlays the ring.
template <int NT, int BM, int BN, int WARPS_M, bool A_SHARED>
__device__ __forceinline__ void gemm_tile(const int8_t* a, long lda, int a_rows,
                                          const int8_t* __restrict__ b, long ldb,
                                          int b_rows, int klen, int8_t* ring, int* out,
                                          int ldo) {
  using namespace nvcuda;
  constexpr int WARPS_N = NT / 32 / WARPS_M;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  constexpr int FM = WM / 16, FN = WN / 16;
  static_assert(WM % 16 == 0 && WN % 16 == 0, "warp tile must hold 16x16 fragments");
  const int warp = threadIdx.x / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  int8_t* as = ring;
  int8_t* bs = ring + kStages * BM * kLdT;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0);

  const int nk = (klen + kBK - 1) / kBK;
  // one commit per slot whether or not it loads, so group kt is step kt
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) {
      if (!A_SHARED) stage_tile<NT>(as + s * BM * kLdT, a, lda, BM, a_rows, klen, s);
      stage_tile<NT>(bs + s * BN * kLdT, b, ldb, BN, b_rows, klen, s);
    }
    __pipeline_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    __pipeline_wait_prior(kStages - 2);   // this thread's copies of step kt landed
    __syncthreads();                      // everyone's did; step kt - 1 is computed
    const int nxt = kt + kStages - 1;     // refill the slot step kt - 1 used
    if (nxt < nk) {
      const int slot = nxt % kStages;
      if (!A_SHARED) stage_tile<NT>(as + slot * BM * kLdT, a, lda, BM, a_rows, klen, nxt);
      stage_tile<NT>(bs + slot * BN * kLdT, b, ldb, BN, b_rows, klen, nxt);
    }
    __pipeline_commit();

    const int cur = kt % kStages;
    const int8_t* at = A_SHARED ? a + kt * kBK : as + cur * BM * kLdT;
    const unsigned a_ld = A_SHARED ? static_cast<unsigned>(lda) : kLdT;
    const int8_t* bt = bs + cur * BN * kLdT;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        wmma::load_matrix_sync(
            fa[i], reinterpret_cast<const signed char*>(at + (wm * WM + i * 16) * a_ld + kk),
            a_ld);
      }
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        wmma::load_matrix_sync(
            fb[j], reinterpret_cast<const signed char*>(bt + (wn * WN + j * 16) * kLdT + kk),
            kLdT);
      }
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  __syncthreads();   // the ring is free: out may overlay it, the next call may refill it

#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(out + (wm * WM + i * 16) * ldo + wn * WN + j * 16, acc[i][j],
                              ldo, wmma::mem_row_major);
    }
}

// The part of a (BM x BN) tile one of NT threads handles in an epilogue:
// BN / 8 threads per row, 8 consecutive columns each, rows tile_row0(),
// tile_row0() + tile_rows(), ...
template <int BN> __device__ __forceinline__ int tile_col() {
  return (threadIdx.x % (BN / 8)) * 8;
}
template <int BN> __device__ __forceinline__ int tile_row0() { return threadIdx.x / (BN / 8); }
template <int NT, int BN> __host__ __device__ constexpr int tile_rows() {
  return NT / (BN / 8);
}

}  // namespace i8
}  // namespace tae
