// K2, K15, K16 — attention forward, one device body with three sources.
//
// Replaces:
//   K2  tae_tpu/ops/pallas/flash_attention.py::fused_qkv_attention
//       (forward: _packed_fwd_call -> _packed_fwd_kernel_stacked, and its
//       LSE-saving form, _packed_vjp_fwd: the exact softmax that also writes
//       lse = rowmax + log(rowsum), fp32 (B, H, N), which the backward in
//       flash_attention_bwd.cu reads). qkv (B, N, 3C) holds [q | k | v] along
//       the last axis with heads as contiguous dh-column slices; the output
//       (B, N, C) is written with the heads merged, so no (B, H, N, dh)
//       transpose ever reaches device memory.
//   K16 flash_attention.py::flash_attention (_fwd_kernel, _fwd_call, and
//       _flash_fwd's LSE form): unpacked q, k, v (B, H, N, dh) -> o
//       (B, H, N, dh), always the exact softmax; the qk_norm attention's
//       kernel. Each operand comes with its own (image, head, row) strides
//       (a view of the qkv projection's output is read where it lies).
//   K15 flash_attention.py::fused_qkv_attention_i8
//       (_packed_fwd_kernel_stacked_i8): packed int8 qkv (B, N, 3C) with one
//       fp32 scale per (row, block of bn columns), laid out (N / bn, B * N),
//       the q8_out output of K4. Each head's q, k and v columns are
//       dequantized on their way into shared memory, code * scale in fp32
//       rounded to bfloat16, then the serving softmax; output (B, N, C) bf16.
// Numerics, as the Pallas bodies: fp32 scores s = (q . k) * scale; serving
//   form p = exp(clip(s, -60, 45)) with no row max, exact form p = exp(s -
//   rowmax); the row sum l takes the fp32 p, the P.V product takes p rounded
//   to the input dtype, fp32 accumulation, o = (P.V) * (1 / l), one rounding
//   at the end (flash_attention's o / l differs from it by an ulp of fp32).
// What bounds it on the H100: at TAE shapes (N <= 256, dh 64 or 80) one
//   head's K and V are at most 90 KB in bf16 and the scores never need device
//   memory, so the kernel reads its operands once and writes the output once;
//   the 4*N*N*dh flops per (image, head) are the work, and with tensor cores
//   the bound is how many warps a block's shared memory lets an SM run, and
//   how much of their time goes to shared-memory round trips of the scores.
//   K15 reads half of K2's bytes (int8 qkv) and pays a multiply and a
//   rounding per element on the way in.
// What the design does about it:
//   * bfloat16 (and K15): the two products run on the tensor cores (WMMA
//     16x16x16, bf16 in, fp32 accumulate). A block takes one (image, head)
//     and up to 8 warps of 16 query rows; it stages the head's K and V once
//     in shared memory (16-byte stores, rows padded by 8 elements against
//     bank conflicts, zero rows up to a multiple of 16 tokens). Scores go
//     through a 16 x 64 fp32 region per warp, one 64-key chunk at a time, so
//     a block needs 109 KB at N = 256 and two blocks share an SM. The serving
//     form needs no row max, so one pass per chunk turns scores into p (a
//     lane pair per row: fp32 into the row sum, bf16 written over the scores
//     in place) and accumulates P.V in registers; the exact form first finds
//     each row's max in a pass over the chunks. The region also holds the
//     warp's Q tile before and its output tile after. The source (packed or
//     unpacked bf16, int8 with scales) is a template parameter that yields
//     16 bytes of bf16 per load; nothing else differs.
//   * float32: tensor cores would round to TF32, so the products run on the
//     CUDA cores in fp32: one block per (64 query rows, head, image), K, V
//     and its Q rows staged as fp32 (rows padded to dh+4 so 16-byte loads of
//     32 different key rows hit distinct banks), one warp per query row,
//     each lane scoring N/32 keys against the broadcast q row, then the P.V
//     loop with float2 output columns per lane. Shared-memory bandwidth
//     bounds this path.
//   wgmma, TMA, register-resident scores and a deeper pipeline are later
//   work; so is folding qk_norm's LayerNorm into K16's load.
#include <mma.h>
#include <stdint.h>

#include "common.cuh"

namespace {

namespace wm = nvcuda::wmma;
using bf16 = __nv_bfloat16;
using tae::HeadLayout;

constexpr int kBQ = 64;     // query rows per block of the float32 path
constexpr int kMaxN = 256;  // tokens supported (N/32 scores per lane in registers)
constexpr int kKeysPerLane = kMaxN / 32;
constexpr float kClipLo = -60.f, kClipHi = 45.f;  // _SOFTMAX_CLIP

__device__ __forceinline__ float softmax_p(float s, float mx, bool serving) {
  return serving ? expf(fminf(fmaxf(s, kClipLo), kClipHi)) : expf(s - mx);
}

// ------------------------------------------------------------------ sources

// The q (0), k (1) and v (2) rows of one (image, head) of dtype T.
template <typename T>
struct Rows {
  const T* p[3];
  long long row[3];
  __device__ __forceinline__ const T* at(int which, int r) const {
    return p[which] + r * row[which];
  }
};

// q, k, v of dtype T, each with its own layout.
template <typename T>
struct PlainSrc {
  const T* p[3];
  HeadLayout l[3];
  __device__ __forceinline__ Rows<T> rows(int b, int h) const {
    Rows<T> r;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      r.p[i] = p[i] + l[i].at(b, h);
      r.row[i] = l[i].row;
    }
    return r;
  }
};

// 16 bytes (8 elements, column chunk ch) of row r of operand `which`, bf16.
__device__ __forceinline__ uint4 load16(const Rows<bf16>& rw, int which, int r, int ch) {
  return *reinterpret_cast<const uint4*>(rw.at(which, r) + ch * 8);
}

// K15's rows: int8 codes and the scale of each row's column block.
struct I8Rows {
  const int8_t* p[3];
  const float* s[3];
  long long row;
};

// Packed int8 qkv (B, N, 3C) and its scales (3C / bn, B * N).
struct I8Src {
  const int8_t* qkv;
  const float* scales;
  long long m;  // B * N
  int n, c, dh, bn;
  __device__ __forceinline__ I8Rows rows(int b, int h) const {
    I8Rows r;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int col = i * c + h * dh;
      r.p[i] = qkv + static_cast<long long>(b) * n * 3 * c + col;
      r.s[i] = scales + static_cast<long long>(col / bn) * m + static_cast<long long>(b) * n;
    }
    r.row = 3LL * c;
    return r;
  }
};

// 8 codes dequantized: bf16(float(code) * scale), as _packed_fwd_kernel_stacked_i8.
__device__ __forceinline__ uint4 load16(const I8Rows& rw, int which, int r, int ch) {
  const uint2 w = *reinterpret_cast<const uint2*>(rw.p[which] + r * rw.row + ch * 8);
  const float s = rw.s[which][r];
  const unsigned words[2] = {w.x, w.y};
  float f[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int code = static_cast<signed char>((words[j / 4] >> (8 * (j % 4))) & 0xffu);
    f[j] = __fmul_rn(static_cast<float>(code), s);
  }
  uint4 u;
  __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) h2[k] = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
  return u;
}

// ---------------------------------------------------------------- bfloat16

constexpr int kTcMaxWarps = 8;  // a block takes up to 8 query tiles of 16 rows
constexpr int kKC = 64;         // keys per chunk of scores

using QFrag = wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major>;
using Acc = wm::fragment<wm::accumulator, 16, 16, 16, float>;

__host__ __device__ constexpr int tc_pad16(int n) { return (n + 15) / 16 * 16; }
template <int DH> __host__ __device__ constexpr int tc_kv_ld() { return DH + 8; }
// floats per row of a warp's region: a chunk of scores or a row of outputs
template <int DH> __host__ __device__ constexpr int tc_region_ld() {
  return (kKC > DH ? kKC : DH) + 4;
}

int tc_warps(int n) { return tc_pad16(n) / 16 < kTcMaxWarps ? tc_pad16(n) / 16 : kTcMaxWarps; }

template <int DH>
size_t tc_smem_bytes(int n) {
  return sizeof(bf16) * 2 * static_cast<size_t>(tc_pad16(n)) * tc_kv_ld<DH>() +
         sizeof(float) * tc_warps(n) * 16 * static_cast<size_t>(tc_region_ld<DH>() + 1);
}

// Scores of the warp's 16 query rows against keys [c0, c0 + kc), fp32, into
// the warp's region (row stride RW floats).
template <int DH>
__device__ __forceinline__ void score_chunk(const QFrag (&qa)[DH / 16], const bf16* ks,
                                            int c0, int kc, float* region) {
  constexpr int LDK = tc_kv_ld<DH>();
  for (int jt = 0; jt < kc / 16; ++jt) {
    Acc sacc;
    wm::fill_fragment(sacc, 0.f);
#pragma unroll
    for (int kt = 0; kt < DH / 16; ++kt) {
      wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::col_major> kb;
      wm::load_matrix_sync(kb, ks + (c0 + jt * 16) * LDK + kt * 16, LDK);
      wm::mma_sync(sacc, qa[kt], kb, sacc);
    }
    wm::store_matrix_sync(region + jt * 16, sacc, tc_region_ld<DH>(), wm::mem_row_major);
  }
  __syncwarp();
}

template <int DH, bool SERVING, typename Src>
__global__ void __launch_bounds__(kTcMaxWarps * 32, 2)
attention_fwd_bf16(const Src src, bf16* __restrict__ out, const HeadLayout ol,
                   float* __restrict__ lse, int n, int heads, float scale) {
  constexpr int LDK = tc_kv_ld<DH>();
  constexpr int RW = tc_region_ld<DH>();
  constexpr int LDB = 2 * RW;  // the region's row stride in bf16 elements
  constexpr int CH = DH / 8;   // 16-byte chunks per head row
  const int np = tc_pad16(n);
  const int warps = blockDim.x / 32;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);               // (np, LDK)
  bf16* vs = ks + np * LDK;                                    // (np, LDK)
  float* regions = reinterpret_cast<float*>(vs + np * LDK);   // warps x (16, RW)
  float* linv_all = regions + warps * 16 * RW;                 // warps x 16

  const int b = blockIdx.z, h = blockIdx.y;
  const auto rows = src.rows(b, h);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int idx = threadIdx.x; idx < np * CH; idx += blockDim.x) {
    const int r = idx / CH, ch = idx - r * CH;
    uint4 kq = zero, vq = zero;
    if (r < n) {
      kq = load16(rows, 1, r, ch);
      vq = load16(rows, 2, r, ch);
    }
    *reinterpret_cast<uint4*>(ks + r * LDK + ch * 8) = kq;
    *reinterpret_cast<uint4*>(vs + r * LDK + ch * 8) = vq;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = (blockIdx.x * warps + warp) * 16;  // this warp's first query row
  float* region = regions + warp * 16 * RW;
  float* linv = linv_all + warp * 16;
  bf16* rb = reinterpret_cast<bf16*>(region);
  for (int idx = lane; idx < 16 * CH; idx += 32) {
    const int r = idx / CH, ch = idx - r * CH;
    uint4 qq = zero;
    if (q0 + r < n) qq = load16(rows, 0, q0 + r, ch);
    *reinterpret_cast<uint4*>(rb + r * LDB + ch * 8) = qq;
  }
  __syncthreads();  // the only block-wide barrier: K, V and every Q tile staged
  if (q0 >= n) return;

  QFrag qa[DH / 16];
#pragma unroll
  for (int kt = 0; kt < DH / 16; ++kt) wm::load_matrix_sync(qa[kt], rb + kt * 16, LDB);
  __syncwarp();  // Q now lives in registers; the region takes the scores

  // Softmax layout over a 16 x kKC chunk: lane -> row sr, the 32 columns
  // from sc, so a row's max and sum need one shuffle with the lane's pair.
  const int sr = lane >> 1, sc = (lane & 1) * 32;
  float* srow = region + sr * RW + sc;
  float s[32];

  // exact form: a first pass over the key chunks finds each row's max
  float mx = -INFINITY;
  if (!SERVING) {
    for (int c0 = 0; c0 < np; c0 += kKC) {
      const int kc = min(kKC, np - c0);
      score_chunk<DH>(qa, ks, c0, kc, region);
#pragma unroll
      for (int k = 0; k < 32; k += 4) tae::load_vec(srow + k, s + k);
#pragma unroll
      for (int k = 0; k < 32; ++k)
        if (sc + k < kc && c0 + sc + k < n) mx = fmaxf(mx, s[k] * scale);
      __syncwarp();
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  }

  // scores -> p (fp32 into the row sum, bf16 over the scores) -> O += P V
  float lsum = 0.f;
  Acc oacc[DH / 16];
#pragma unroll
  for (int dt = 0; dt < DH / 16; ++dt) wm::fill_fragment(oacc[dt], 0.f);
  for (int c0 = 0; c0 < np; c0 += kKC) {
    const int kc = min(kKC, np - c0);
    score_chunk<DH>(qa, ks, c0, kc, region);
#pragma unroll
    for (int k = 0; k < 32; k += 4) tae::load_vec(srow + k, s + k);
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      s[k] = sc + k < kc && c0 + sc + k < n ? softmax_p(s[k] * scale, mx, SERVING) : 0.f;
      lsum += s[k];
    }
    __syncwarp();  // every score of the chunk is read before p overwrites them
    if (sc < kc) {
#pragma unroll
      for (int k = 0; k < 32; k += 8) tae::store_vec(rb + sr * LDB + sc + k, s + k);
    }
    __syncwarp();
    for (int kt = 0; kt < kc / 16; ++kt) {
      QFrag pa;
      wm::load_matrix_sync(pa, rb + kt * 16, LDB);
#pragma unroll
      for (int dt = 0; dt < DH / 16; ++dt) {
        wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major> vb;
        wm::load_matrix_sync(vb, vs + (c0 + kt * 16) * LDK + dt * 16, LDK);
        wm::mma_sync(oacc[dt], pa, vb, oacc[dt]);
      }
    }
    __syncwarp();  // P is consumed before the next chunk's scores land
  }
  lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
  if (sc == 0) linv[sr] = 1.f / lsum;
  if (!SERVING && lse != nullptr && sc == 0 && q0 + sr < n)
    lse[(static_cast<long>(b) * heads + h) * n + q0 + sr] = mx + logf(lsum);
#pragma unroll
  for (int dt = 0; dt < DH / 16; ++dt)
    wm::store_matrix_sync(region + dt * 16, oacc[dt], RW, wm::mem_row_major);
  __syncwarp();

  bf16* obase = out + ol.at(b, h);
  const int nrows = min(16, n - q0);
  for (int idx = lane; idx < nrows * (DH / 2); idx += 32) {
    const int r = idx / (DH / 2), c2 = idx - r * (DH / 2);
    const float* o = region + r * RW + 2 * c2;
    const float inv = linv[r];
    tae::store2(obase + (q0 + r) * ol.row + 2 * c2, o[0] * inv, o[1] * inv);
  }
}

// ----------------------------------------------------------------- float32

constexpr int kF32Warps = 8;  // each takes every kF32Warps-th query row

template <int DH> __host__ __device__ constexpr int f32_ld() { return DH + 4; }

template <int DH>
size_t f32_smem_bytes(int n) {
  return sizeof(float) *
         (static_cast<size_t>(2 * n + kBQ) * f32_ld<DH>() + kF32Warps * n);
}

template <int DH, bool SERVING>
__global__ void __launch_bounds__(kF32Warps * 32)
attention_fwd_f32(const PlainSrc<float> src, float* __restrict__ out, const HeadLayout ol,
                  float* __restrict__ lse, int n, int heads, float scale) {
  constexpr int LD = f32_ld<DH>();
  constexpr int C2 = DH / 2;  // float2 output columns
  constexpr int C2_PER_LANE = (C2 + 31) / 32;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;           // (n, LD)
  float* vs = ks + n * LD;    // (n, LD)
  float* qs = vs + n * LD;    // (kBQ, LD)
  float* ps = qs + kBQ * LD;  // (kF32Warps, n): one p row per warp

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const Rows<float> rows = src.rows(b, h);
  const int nq = min(kBQ, n - q0);

  for (int idx = threadIdx.x; idx < n * DH; idx += blockDim.x) {
    const int r = idx / DH, col = idx - r * DH;
    ks[r * LD + col] = rows.at(1, r)[col];
    vs[r * LD + col] = rows.at(2, r)[col];
  }
  for (int idx = threadIdx.x; idx < nq * DH; idx += blockDim.x) {
    const int r = idx / DH, col = idx - r * DH;
    qs[r * LD + col] = rows.at(0, q0 + r)[col];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* pw = ps + warp * n;
  const float2* v2 = reinterpret_cast<const float2*>(vs);

  for (int r = warp; r < nq; r += kF32Warps) {
    const float4* q4 = reinterpret_cast<const float4*>(qs + r * LD);
    float s[kKeysPerLane];
    float mx = -INFINITY;
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) {
      const int j = lane + 32 * t;
      s[t] = -INFINITY;
      if (j < n) {
        const float4* k4 = reinterpret_cast<const float4*>(ks + j * LD);
        float acc = 0.f;
#pragma unroll
        for (int d = 0; d < DH / 4; ++d) {
          const float4 a = q4[d], kk = k4[d];
          acc = fmaf(a.x, kk.x, acc);
          acc = fmaf(a.y, kk.y, acc);
          acc = fmaf(a.z, kk.z, acc);
          acc = fmaf(a.w, kk.w, acc);
        }
        s[t] = acc * scale;
        mx = fmaxf(mx, s[t]);
      }
    }
    if (!SERVING) mx = tae::warp_max(mx);

    float l = 0.f;
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) {
      const int j = lane + 32 * t;
      if (j < n) {
        const float p = softmax_p(s[t], mx, SERVING);
        l += p;
        pw[j] = p;  // fp32 input: rounding p to the input dtype is exact
      }
    }
    l = tae::warp_sum(l);
    const float inv = 1.f / l;
    if (!SERVING && lse != nullptr && lane == 0)
      lse[(static_cast<long>(b) * heads + h) * n + q0 + r] = mx + logf(l);
    __syncwarp();

    float2 acc[C2_PER_LANE];
#pragma unroll
    for (int k = 0; k < C2_PER_LANE; ++k) acc[k] = make_float2(0.f, 0.f);
    for (int j = 0; j < n; ++j) {
      const float p = pw[j];
#pragma unroll
      for (int k = 0; k < C2_PER_LANE; ++k) {
        const int cc = lane + 32 * k;
        if (cc < C2) {
          const float2 vv = v2[j * (LD / 2) + cc];
          acc[k].x = fmaf(p, vv.x, acc[k].x);
          acc[k].y = fmaf(p, vv.y, acc[k].y);
        }
      }
    }
    float* orow = out + ol.at(b, h) + (q0 + r) * ol.row;
#pragma unroll
    for (int k = 0; k < C2_PER_LANE; ++k) {
      const int cc = lane + 32 * k;
      if (cc < C2) tae::store2(orow + 2 * cc, acc[k].x * inv, acc[k].y * inv);
    }
    __syncwarp();  // every lane is done with pw before the next row rewrites it
  }
}

// ---------------------------------------------------------------- launchers

// smem_allowed: the kernel's dynamic shared-memory limit as last raised (one
// per instantiation); cudaFuncSetAttribute costs microseconds of host time,
// so it runs only when a launch needs more than that.
template <typename Src, typename T>
int launch(void (*kernel)(const Src, T*, const HeadLayout, float*, int, int, float),
           size_t smem, size_t& smem_allowed, int threads, int rows_per_block,
           const Src& src, void* out, const HeadLayout& ol, void* lse, int batch, int n,
           int heads, float scale, cudaStream_t stream) {
  if (smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_allowed = smem;
  }
  const dim3 grid((n + rows_per_block - 1) / rows_per_block, heads, batch);
  kernel<<<grid, threads, smem, stream>>>(src, static_cast<T*>(out), ol,
                                           static_cast<float*>(lse), n, heads, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DH, bool SERVING, typename Src>
int launch_bf16(const Src& src, void* out, const HeadLayout& ol, void* lse, int batch, int n,
                int heads, float scale, cudaStream_t stream) {
  static size_t smem_allowed = 0;  // one per kernel instantiation
  return launch(attention_fwd_bf16<DH, SERVING, Src>, tc_smem_bytes<DH>(n), smem_allowed,
                tc_warps(n) * 32, tc_warps(n) * 16, src, out, ol, lse, batch, n, heads, scale,
                stream);
}

template <int DH, bool SERVING>
int launch_dtype(const void* const (&qkv)[3], const HeadLayout (&il)[3], void* out,
                 const HeadLayout& ol, void* lse, int batch, int n, int heads, float scale,
                 int dtype, cudaStream_t stream) {
  if (dtype == tae::kBFloat16) {
    PlainSrc<bf16> src;
    for (int i = 0; i < 3; ++i) {
      src.p[i] = static_cast<const bf16*>(qkv[i]);
      src.l[i] = il[i];
    }
    return launch_bf16<DH, SERVING>(src, out, ol, lse, batch, n, heads, scale, stream);
  }
  if (dtype == tae::kFloat32) {
    PlainSrc<float> src;
    for (int i = 0; i < 3; ++i) {
      src.p[i] = static_cast<const float*>(qkv[i]);
      src.l[i] = il[i];
    }
    static size_t smem_allowed = 0;
    return launch(attention_fwd_f32<DH, SERVING>, f32_smem_bytes<DH>(n), smem_allowed,
                  kF32Warps * 32, kBQ, src, out, ol, lse, batch, n, heads, scale, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int DH>
int launch_mode(const void* const (&qkv)[3], const HeadLayout (&il)[3], void* out,
                const HeadLayout& ol, void* lse, int batch, int n, int heads, float scale,
                bool serving, int dtype, cudaStream_t stream) {
  return serving ? launch_dtype<DH, true>(qkv, il, out, ol, lse, batch, n, heads, scale,
                                          dtype, stream)
                 : launch_dtype<DH, false>(qkv, il, out, ol, lse, batch, n, heads, scale,
                                           dtype, stream);
}

int launch_dh(int dh, const void* const (&qkv)[3], const HeadLayout (&il)[3], void* out,
              const HeadLayout& ol, void* lse, int batch, int n, int heads, float scale,
              bool serving, int dtype, void* stream) {
  if (batch < 1 || batch > 65535 || heads < 1 || heads > 65535 || n < 1 || n > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh == 64)
    return launch_mode<64>(qkv, il, out, ol, lse, batch, n, heads, scale, serving, dtype, s);
  if (dh == 80)
    return launch_mode<80>(qkv, il, out, ol, lse, batch, n, heads, scale, serving, dtype, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K2's operands: q, k, v as column blocks of the packed qkv, the merged output.
int launch_packed(const void* qkv, void* out, void* lse, int batch, int n, int heads, int dh,
                  float scale, bool serving, int dtype, void* stream) {
  const long long c = static_cast<long long>(heads) * dh;
  const size_t el = dtype == tae::kBFloat16 ? 2 : 4;
  const char* base = static_cast<const char*>(qkv);
  const void* const ptrs[3] = {base, base + c * el, base + 2 * c * el};
  const HeadLayout in = {n * 3 * c, dh, 3 * c};
  const HeadLayout il[3] = {in, in, in};
  const HeadLayout ol = {n * c, dh, c};
  return launch_dh(dh, ptrs, il, out, ol, lse, batch, n, heads, scale, serving, dtype, stream);
}

}  // namespace

// K2. qkv: (batch, n, 3 * heads * dh) contiguous; out: (batch, n, heads * dh).
extern "C" int tae_packed_attention_fwd(const void* qkv, void* out, int batch, int n,
                                        int heads, int dh, float scale, int serving,
                                        int dtype, void* stream) {
  return launch_packed(qkv, out, nullptr, batch, n, heads, dh, scale, serving != 0, dtype,
                       stream);
}

// K2's exact-softmax forward that also writes lse: (batch, heads, n) fp32.
extern "C" int tae_packed_attention_fwd_lse(const void* qkv, void* out, void* lse,
                                            int batch, int n, int heads, int dh,
                                            float scale, int dtype, void* stream) {
  if (lse == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_packed(qkv, out, lse, batch, n, heads, dh, scale, false, dtype, stream);
}

// K16. q, k, v, out: (batch, heads, n, dh) with the element strides
// strides[3 * i .. 3 * i + 2] = (image, head, row) of operand i (q, k, v,
// out); the last axis contiguous, rows 16-byte aligned. lse: null, or
// (batch, heads, n) fp32, contiguous. Always the exact softmax.
extern "C" int tae_flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                       void* lse, const long long* strides, int batch, int n,
                                       int heads, int dh, float scale, int dtype,
                                       void* stream) {
  const void* const ptrs[3] = {q, k, v};
  HeadLayout il[3];
  for (int i = 0; i < 3; ++i) il[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const HeadLayout ol = {strides[9], strides[10], strides[11]};
  return launch_dh(dh, ptrs, il, out, ol, lse, batch, n, heads, scale, false, dtype, stream);
}

// K15. qkv: (batch, n, 3 * heads * dh) int8 contiguous; scales: (3 * heads *
// dh / bn, batch * n) fp32 contiguous, the scale of row r's columns [j * bn,
// (j + 1) * bn) at scales[j * batch * n + r]; bn a multiple of dh. out:
// (batch, n, heads * dh) bf16. The serving softmax.
extern "C" int tae_qkv_i8_attention_fwd(const void* qkv, const void* scales, void* out,
                                        int batch, int n, int heads, int dh, int bn,
                                        float scale, void* stream) {
  if (batch < 1 || batch > 65535 || heads < 1 || heads > 65535 || n < 1 || n > kMaxN ||
      bn < dh || bn % dh != 0 || (3 * heads * dh) % bn != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  I8Src src;
  src.qkv = static_cast<const int8_t*>(qkv);
  src.scales = static_cast<const float*>(scales);
  src.m = static_cast<long long>(batch) * n;
  src.n = n;
  src.c = heads * dh;
  src.dh = dh;
  src.bn = bn;
  const long long c = static_cast<long long>(heads) * dh;
  const HeadLayout ol = {n * c, dh, c};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh == 64) return launch_bf16<64, true>(src, out, ol, nullptr, batch, n, heads, scale, s);
  if (dh == 80) return launch_bf16<80, true>(src, out, ol, nullptr, batch, n, heads, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
