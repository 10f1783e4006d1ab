// Shared device helpers for the tae_tpu_torch kernels: dtype conversion,
// 16-byte vector loads and stores, warp reductions, the bf16 tensor-core
// product, its shared-memory fragment loads, and the cp.async staging and
// quad transposes around it that the attention bodies share.
#pragma once

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
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

// c += a * b for one warp on mma.sync.m16n8k32 (int8 in, int32 accumulate;
// every sum exact). Lane (g, t) holds, in the PTX ISA's layouts: a, the
// 16 x 32 A tile, as (row g, bytes 4t .. 4t + 3), (row g + 8, the same),
// (row g, bytes 16 + 4t ..), (row g + 8, the same); b0, b1, the 32 x 8 B
// tile, as (bytes 4t .. 4t + 3 | 16 + 4t .., column g); c as mma_bf16's. In
// the b16 view of 16-byte rows these are mma_bf16's A and B fragments, so
// ldmatrix_x4 reads both operands from K-contiguous rows.
__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 matrices of 16-bit elements from shared memory, one warp:
// lanes 8m .. 8m + 7 give the addresses of matrix m's eight rows (16 bytes
// each, 16-byte aligned); r[m] of lane (g, t) receives matrix m's (row g,
// columns 2t, 2t + 1). The .trans form receives (rows 2t, 2t + 1, column
// g): a row-major tile read as the column-major B fragment of mma_bf16.
// The _at forms take the row's 32-bit shared-memory address (smem_addr),
// one register where a generic pointer takes two.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldmatrix_x4_at(unsigned (&r)[4], unsigned a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans_at(unsigned (&r)[4], unsigned a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* row) {
  ldmatrix_x4_at(r, smem_addr(row));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* row) {
  ldmatrix_x4_trans_at(r, smem_addr(row));
}

// Two floats as one register of two bf16 (round to nearest even), a in the
// low half: the A-fragment element order of mma_bf16.
__device__ __forceinline__ unsigned pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}

// 16 bytes from device memory (16-byte aligned) to shared memory by
// cp.async, in this thread's current commit group.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  __pipeline_memcpy_async(dst, src, 16);
}
__device__ __forceinline__ void cp_async_commit() { __pipeline_commit(); }

// Wait until at most `pending` of this thread's newest cp.async groups are
// still in flight (the instruction takes an immediate).
__device__ __forceinline__ void wait_pending(int pending) {
  switch (pending) {
    case 0: __pipeline_wait_prior(0); break;
    case 1: __pipeline_wait_prior(1); break;
    case 2: __pipeline_wait_prior(2); break;
    default: __pipeline_wait_prior(3); break;
  }
}

__device__ __forceinline__ unsigned pick4(const unsigned (&w)[4], int i) {
  return i == 0 ? w[0] : i == 1 ? w[1] : i == 2 ? w[2] : w[3];
}

// A 4 x 4 transpose of 32-bit words inside each quad of lanes: lane t's
// w[i] becomes lane i's w[t]. Between one 16-byte load or store per lane
// and the fragment layout, where lane t holds columns 2t, 2t + 1 of each
// 8-column group.
__device__ __forceinline__ void quad_transpose(unsigned (&w)[4]) {
  const int lane = threadIdx.x & 31, t = lane & 3;
  unsigned o[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int src = (t - k) & 3;  // lane src sends its word t
    const unsigned send = pick4(w, (t + k) & 3);
    const unsigned got = k == 0 ? send : __shfl_sync(0xffffffffu, send, (lane & ~3) | src);
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = src == i ? got : o[i];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = o[i];
}

// The A fragments of mma_bf16 for a 16 x DH bf16 tile of rows, read once
// from device memory: load(half, ch) returns the 16-byte chunk ch of row
// g + 8 * half (lane (g, t) asks for chunks t, t + 4, ...; ch < DH / 8), and
// the quad transposes them into word t of each fragment.
template <int DH, typename Load>
__device__ __forceinline__ void a_fragments(unsigned (&a)[DH / 16][4], Load load) {
  constexpr int CH = DH / 8, QG = (CH + 3) / 4;
  const int t = threadIdx.x & 3;
  unsigned rw[2][CH];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int q = 0; q < QG; ++q) {
      const int ch = 4 * q + t;
      const uint4 v = ch < CH ? load(half, ch) : make_uint4(0u, 0u, 0u, 0u);
      unsigned w[4] = {v.x, v.y, v.z, v.w};
      quad_transpose(w);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (4 * q + i < CH) rw[half][4 * q + i] = w[i];
    }
  }
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    a[kk][0] = rw[0][2 * kk];
    a[kk][1] = rw[1][2 * kk];
    a[kk][2] = rw[0][2 * kk + 1];
    a[kk][3] = rw[1][2 * kk + 1];
  }
}

// The inverse for an fp32 accumulator tile: c[d] is the m16n8 C fragment of
// columns 8d .. 8d + 7. Rounds rows g and g + 8 to bf16 and hands lane t the
// 16-byte chunks t, t + 4, ... of each: store(half, ch, chunk) for ch < DH / 8.
template <int DH, typename Store>
__device__ __forceinline__ void store_c_rows(const float (&c)[DH / 8][4], Store store) {
  constexpr int CH = DH / 8, QG = (CH + 3) / 4;
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int q = 0; q < QG; ++q) {
      unsigned w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = 4 * q + i;
        w[i] = d < CH ? pack_bf16(c[d][2 * half], c[d][2 * half + 1]) : 0u;
      }
      quad_transpose(w);
      const int ch = 4 * q + t;
      if (ch < CH) store(half, ch, make_uint4(w[0], w[1], w[2], w[3]));
    }
  }
}

}  // namespace tae
