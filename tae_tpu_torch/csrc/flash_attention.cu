// K2 — packed-qkv attention forward.
//
// Replaces: tae_tpu/ops/pallas/flash_attention.py::fused_qkv_attention
//   (forward: _packed_fwd_call -> _packed_fwd_kernel_stacked, and its
//   LSE-saving form, _packed_vjp_fwd: the exact softmax that also writes
//   lse = rowmax + log(rowsum), fp32 (B, H, N), which the backward in
//   flash_attention_bwd.cu reads). qkv (B, N, 3C)
//   holds [q | k | v] along the last axis with heads as contiguous dh-column
//   slices; the output (B, N, C) is written with the heads merged, so no
//   (B, H, N, dh) transpose ever reaches device memory.
// Numerics, as the Pallas body: fp32 scores s = (q . k) * scale; serving form
//   p = exp(clip(s, -60, 45)) with no row max, exact form p = exp(s - rowmax);
//   the row sum l takes the fp32 p, the P.V product takes p rounded to the
//   input dtype, fp32 accumulation, o = (P.V) * (1 / l), one rounding at the
//   end.
// What bounds it on the H100: at TAE shapes (N <= 256, dh 64 or 80) one
//   head's K and V are at most 90 KB in bf16 and the scores never need device
//   memory, so the kernel reads qkv once and writes the output once; the
//   4*N*N*dh flops per (image, head) are the work, and with tensor cores the
//   bound is how many warps a block's shared memory lets an SM run, and how
//   much of their time goes to shared-memory round trips of the scores.
// What the design does about it:
//   * bfloat16 (the serving path): the two products run on the tensor cores
//     (WMMA 16x16x16, bf16 in, fp32 accumulate). A block takes one (image,
//     head) and up to 8 warps of 16 query rows; it stages the head's K and V
//     once in shared memory (16-byte loads, rows padded by 8 elements
//     against bank conflicts, zero rows up to a multiple of 16 tokens).
//     Scores go through a 16 x 64 fp32 region per warp, one 64-key chunk at
//     a time, so a block needs 109 KB at N = 256 and two blocks share an SM.
//     The serving form needs no row max, so one pass per chunk turns scores
//     into p (a lane pair per row: fp32 into the row sum, bf16 written over
//     the scores in place) and accumulates P.V in registers; the exact form
//     first finds each row's max in a pass over the chunks. The region also
//     holds the warp's Q tile before and its output tile after.
//   * float32: tensor cores would round to TF32, so the products run on the
//     CUDA cores in fp32: one block per (64 query rows, head, image), K, V
//     and its Q rows staged as fp32 (rows padded to dh+4 so 16-byte loads of
//     32 different key rows hit distinct banks), one warp per query row,
//     each lane scoring N/32 keys against the broadcast q row, then the P.V
//     loop with float2 output columns per lane. Shared-memory bandwidth
//     bounds this path.
//   wgmma, TMA, register-resident scores and a deeper pipeline are later
//   work.
#include <mma.h>

#include "common.cuh"

namespace {

namespace wm = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;     // query rows per block of the float32 path
constexpr int kMaxN = 256;  // tokens supported (N/32 scores per lane in registers)
constexpr int kKeysPerLane = kMaxN / 32;
constexpr float kClipLo = -60.f, kClipHi = 45.f;  // _SOFTMAX_CLIP

__device__ __forceinline__ float softmax_p(float s, float mx, bool serving) {
  return serving ? expf(fminf(fmaxf(s, kClipLo), kClipHi)) : expf(s - mx);
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

template <int DH, bool SERVING>
__global__ void __launch_bounds__(kTcMaxWarps * 32, 2)
packed_attention_fwd_bf16(const bf16* __restrict__ qkv, bf16* __restrict__ out,
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
  const int c = heads * DH;
  const long row_stride = 3L * c;
  const bf16* base = qkv + static_cast<long>(b) * n * row_stride + h * DH;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int idx = threadIdx.x; idx < np * CH; idx += blockDim.x) {
    const int r = idx / CH, ch = idx - r * CH;
    uint4 kq = zero, vq = zero;
    if (r < n) {
      const bf16* src = base + r * row_stride + ch * 8;
      kq = *reinterpret_cast<const uint4*>(src + c);
      vq = *reinterpret_cast<const uint4*>(src + 2 * c);
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
    if (q0 + r < n) qq = *reinterpret_cast<const uint4*>(base + (q0 + r) * row_stride + ch * 8);
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

  const int rows = min(16, n - q0);
  for (int idx = lane; idx < rows * (DH / 2); idx += 32) {
    const int r = idx / (DH / 2), c2 = idx - r * (DH / 2);
    const float* o = region + r * RW + 2 * c2;
    const float inv = linv[r];
    tae::store2(out + (static_cast<long>(b) * n + q0 + r) * c + h * DH + 2 * c2,
                o[0] * inv, o[1] * inv);
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
packed_attention_fwd_f32(const float* __restrict__ qkv, float* __restrict__ out,
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
  const int c = heads * DH;
  const long row_stride = 3L * c;
  const float* base = qkv + static_cast<long>(b) * n * row_stride + h * DH;
  const int nq = min(kBQ, n - q0);

  for (int idx = threadIdx.x; idx < n * DH; idx += blockDim.x) {
    const int r = idx / DH, col = idx - r * DH;
    const float* src = base + r * row_stride + col;
    ks[r * LD + col] = src[c];
    vs[r * LD + col] = src[2 * c];
  }
  for (int idx = threadIdx.x; idx < nq * DH; idx += blockDim.x) {
    const int r = idx / DH, col = idx - r * DH;
    qs[r * LD + col] = base[(q0 + r) * row_stride + col];
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
    float* orow = out + (static_cast<long>(b) * n + q0 + r) * c + h * DH;
#pragma unroll
    for (int k = 0; k < C2_PER_LANE; ++k) {
      const int cc = lane + 32 * k;
      if (cc < C2) tae::store2(orow + 2 * cc, acc[k].x * inv, acc[k].y * inv);
    }
    __syncwarp();  // every lane is done with pw before the next row rewrites it
  }
}

// ---------------------------------------------------------------- launchers

// smem_allowed: the kernel's dynamic shared-memory limit as last raised;
// cudaFuncSetAttribute costs microseconds of host time, so it runs only when
// a launch needs more than that.
template <typename T>
int launch(void (*kernel)(const T*, T*, float*, int, int, float), size_t smem,
           size_t& smem_allowed, int threads, int rows_per_block, const void* qkv,
           void* out, void* lse, int batch, int n, int heads, float scale,
           cudaStream_t stream) {
  if (smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_allowed = smem;
  }
  const dim3 grid((n + rows_per_block - 1) / rows_per_block, heads, batch);
  kernel<<<grid, threads, smem, stream>>>(static_cast<const T*>(qkv),
                                           static_cast<T*>(out),
                                           static_cast<float*>(lse), n, heads, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DH, bool SERVING>
int launch_dtype(const void* qkv, void* out, void* lse, int batch, int n, int heads,
                 float scale, int dtype, cudaStream_t stream) {
  if (dtype == tae::kBFloat16) {
    static size_t smem_allowed = 0;  // one per kernel instantiation
    return launch(packed_attention_fwd_bf16<DH, SERVING>, tc_smem_bytes<DH>(n),
                  smem_allowed, tc_warps(n) * 32, tc_warps(n) * 16, qkv, out, lse, batch,
                  n, heads, scale, stream);
  }
  if (dtype == tae::kFloat32) {
    static size_t smem_allowed = 0;
    return launch(packed_attention_fwd_f32<DH, SERVING>, f32_smem_bytes<DH>(n),
                  smem_allowed, kF32Warps * 32, kBQ, qkv, out, lse, batch, n, heads,
                  scale, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int DH>
int launch_mode(const void* qkv, void* out, int batch, int n, int heads, float scale,
                int serving, int dtype, cudaStream_t stream) {
  return serving
             ? launch_dtype<DH, true>(qkv, out, nullptr, batch, n, heads, scale, dtype, stream)
             : launch_dtype<DH, false>(qkv, out, nullptr, batch, n, heads, scale, dtype,
                                       stream);
}

}  // namespace

// qkv: (batch, n, 3 * heads * dh) contiguous; out: (batch, n, heads * dh).
extern "C" int tae_packed_attention_fwd(const void* qkv, void* out, int batch, int n,
                                        int heads, int dh, float scale, int serving,
                                        int dtype, void* stream) {
  if (batch < 1 || batch > 65535 || heads < 1 || heads > 65535 || n < 1 || n > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh == 64) return launch_mode<64>(qkv, out, batch, n, heads, scale, serving, dtype, s);
  if (dh == 80) return launch_mode<80>(qkv, out, batch, n, heads, scale, serving, dtype, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The exact-softmax forward that also writes lse: (batch, heads, n) fp32.
extern "C" int tae_packed_attention_fwd_lse(const void* qkv, void* out, void* lse,
                                            int batch, int n, int heads, int dh,
                                            float scale, int dtype, void* stream) {
  if (batch < 1 || batch > 65535 || heads < 1 || heads > 65535 || n < 1 || n > kMaxN ||
      lse == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh == 64)
    return launch_dtype<64, false>(qkv, out, lse, batch, n, heads, scale, dtype, s);
  if (dh == 80)
    return launch_dtype<80, false>(qkv, out, lse, batch, n, heads, scale, dtype, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
