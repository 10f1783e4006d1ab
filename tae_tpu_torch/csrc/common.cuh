// Shared device helpers for the tae_tpu_torch kernels: dtype conversion,
// 16-byte vector loads and stores, warp reductions, the bf16 tensor-core
// product and its shared-memory fragment loads.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tae {

// dtype codes shared with ops/cuda/build.py::dtype_code
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
// round to nearest even, as jnp.astype and torch.Tensor.to round
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back: the value a T-typed operand carries.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// Elements of T in one 16-byte vector.
template <typename T> struct Vec { static constexpr int kN = 16 / sizeof(T); };

// Load / store Vec<T>::kN consecutive elements (16-byte aligned) as fp32.
__device__ __forceinline__ void load_vec(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* o) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    o[2 * k] = f.x; o[2 * k + 1] = f.y;
  }
}
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// Store two consecutive elements (aligned to two elements).
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Where the token rows of one (image, head) of an attention operand lie:
// element offsets between images, between heads and between rows; a row's
// dh columns are contiguous. Packed qkv (B, N, 3C) is {N * 3C, dh, 3C} from
// its q, k or v column block; an unpacked (B, H, N, dh) tensor its strides.
struct HeadLayout {
  long long image, head, row;
  __host__ __device__ long long at(int b, int h) const {
    return b * image + h * head;
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// c += a * b on the tensor cores for one warp (mma.sync.m16n8k16, bf16 in,
// fp32 accumulate). Lane (g, t) = (lane / 4, lane % 4) holds, in the PTX
// ISA's fragment layouts: a, the 16 x 16 A tile, as (row g, columns 2t,
// 2t + 1), (row g + 8, the same), (row g, columns 2t + 8, 2t + 9), (row
// g + 8, the same), two bf16 to a register, the lower column in the low
// half; b0, b1, the 16 x 8 B tile, as (rows 2t, 2t + 1 | 2t + 8, 2t + 9,
// column g); c, the 16 x 8 fp32 tile, as (row g, columns 2t, 2t + 1), (row
// g + 8, the same).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 matrices of 16-bit elements from shared memory, one warp:
// lanes 8m .. 8m + 7 give the addresses of matrix m's eight rows (16 bytes
// each, 16-byte aligned); r[m] of lane (g, t) receives matrix m's (row g,
// columns 2t, 2t + 1). The .trans form receives (rows 2t, 2t + 1, column
// g): a row-major tile read as the column-major B fragment of mma_bf16.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// Two floats as one register of two bf16 (round to nearest even), a in the
// low half: the A-fragment element order of mma_bf16.
__device__ __forceinline__ unsigned pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}

}  // namespace tae
