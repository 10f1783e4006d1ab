// Shared device helpers for the tae_tpu_torch kernels: dtype conversion,
// 16-byte vector loads and stores, warp reductions, the bf16 tensor-core
// product, its shared-memory fragment loads, and the cp.async staging and
// quad transposes around it that the attention bodies share; and Hopper's
// asynchronous machinery (namespace tae::sm90): mbarriers, TMA tile loads
// (with cluster multicast) from a tensor map the host encodes, bulk
// copies, thread-block cluster barriers and the warpgroup product wgmma
// on 128-byte-swizzled shared-memory operands.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

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


// ------------------------------------------------------------------ sm_90a
// Hopper's asynchronous copies and products, as the codebook search (K14)
// uses them; written for the attention and int8 bodies to take up too.
namespace sm90 {

// Shared-memory mbarriers. A phase completes when its expected arrivals
// have arrived and the bytes announced by expect_tx have landed (TMA and
// bulk copies count them down); wait(parity) returns once the phase of
// that parity has completed (a fresh barrier is in phase 0, so waiting on
// parity 1 passes at once: how a producer's first pass over an empty ring
// goes through).
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// Makes the initialised barriers visible to the cluster (and to TMA).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}
// Arrive on the barrier at the same shared-memory offset in block `cta` of
// this thread's cluster (its own included). The default (CTA-scope)
// semantics: the .release.cluster form puts a device-wide memory fence in
// front of every arrive, which made the codebook search's clustered ring
// 2.7x slower; what the arrive publishes is that wgmma (whose reads have
// completed at its wait) is done with a slot.
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, unsigned cta) {
  asm volatile(
      "{\n.reg .b32 remote;\nmapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}" ::"r"(smem_addr(bar)),
      "r"(cta)
      : "memory");
}
// The retry loop stays inside the asm block (its labels are local to the
// braces): a loop in C++ would put the code after it on a path the compiler
// takes for divergent, where it serializes wgmma.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// A 2-D tile of the tensor map (in its .param space: a __grid_constant__
// kernel parameter) at coordinates (c0 innermost, c1) into shared memory,
// its bytes counted down on bar. The multicast form writes the same tile
// to every block of `mask` in the cluster, at the same offset, and counts
// it down on each block's barrier at bar's offset.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_2d_multicast(void* dst, const CUtensorMap* map,
                                                      uint64_t* bar, int c0, int c1,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "h"(mask), "r"(c0), "r"(c1)
      : "memory");
}
// `bytes` (a multiple of 16) of contiguous device memory (16-byte aligned)
// into shared memory, counted down on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Thread-block clusters: this block's rank, and a barrier over every
// thread of every block of the cluster (release / acquire).
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;" ::: "memory");
}
// A barrier over `threads` threads (a multiple of 32) by hardware barrier
// `id` (0 is __syncthreads').
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// The wgmma descriptor of a K-major bf16 operand whose rows are 128 bytes
// (64 values) in shared memory as a 128-byte-swizzled TMA load leaves them:
// 8-row groups 1024 bytes apart (SBO), the start 1024-byte aligned. Adding
// 2 to it steps 16 values (32 bytes) along K.
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// d (+)= A B for one warpgroup: wgmma.mma_async m64nNk16, bf16 in, fp32
// accumulate, A (64 x 16) and B (N x 16) both K-major in shared memory
// (descriptors a, b); scale_d 0 overwrites d. Thread (warp w of the
// warpgroup, lane 4 g + t) holds d[4 j + 2 h + e] = D[16 w + g + 8 h][8 j +
// 2 t + e]: mma_sync's C layout for each 8 columns. N is 128 (K14's code
// tiles) or 256 (bench/ceilings.cu's rate, bench/vq_body.py's bn256).
template <int N> __device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t a,
                                                            uint64_t b, int scale_d);
template <> __device__ __forceinline__ void wgmma_bf16<128>(float (&d)[64], uint64_t a,
                                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <> __device__ __forceinline__ void wgmma_bf16<256>(float (&d)[128], uint64_t a,
                                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(scale_d));
}

}  // namespace sm90

// The host side of a TMA load: a 2-D bf16 tensor map of an (outer, inner)
// row-major array with `row_bytes` between rows, boxes of (box_outer,
// box_inner) values, 128-byte swizzle (box_inner * 2 must be 128), zeros
// outside the array. cuTensorMapEncodeTiled is reached through the runtime
// (no libcuda link). Returns a cudaError_t.
inline int tensor_map_bf16_2d(CUtensorMap* map, const void* base, uint64_t inner, uint64_t outer,
                              uint64_t row_bytes, uint32_t box_inner, uint32_t box_outer) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess) return static_cast<int>(e);
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return static_cast<int>(cudaErrorNotSupported);
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tae
