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
//   rowmax) with the row's global max; the row sum l takes the fp32 p, the
//   P.V product takes p rounded to the input dtype, fp32 accumulation, o =
//   (P.V) * (1 / l), one rounding at the end (flash_attention's o / l
//   differs from it by an ulp of fp32). No online rescaling: it would change
//   which bf16 p enters P.V.
// What bounds it on the H100: bytes. At the main path's shape (B 64, N 256,
//   16 heads of 64) the kernel must read qkv (100.7 MB in bf16) and write
//   the output (33.6 MB): 0.040 ms at 3.35 TB/s, where the 17.2 GFLOP of the
//   two products take 0.017 ms at the dense bf16 rate (the exact form scores
//   twice: 25.8 GFLOP, 0.026 ms). K15 reads half of K2's bytes (int8 qkv),
//   0.025 ms, and pays a multiply and a rounding per element on the way in.
//   The scores never need device memory: one head's K and V are at most
//   90 KB in bf16.
// What the design does about it:
//   * bfloat16 (and K15): a block takes one (image, head) and up to kWarps
//     (8) warps of 16 query rows. It keeps all of the head's K and V resident
//     in shared memory (rows padded by 8 elements, so that ldmatrix of 8
//     rows hits 8 distinct 16-byte bank groups; zero rows up to a multiple
//     of 16 tokens). bf16 sources arrive by 16-byte cp.async, one commit
//     group per 64-key chunk, so chunk 0's scores start while later chunks
//     land; K15's int8 source dequantizes through registers into the same
//     layout (the overload of stage16 chooses). Each warp's Q rows are read
//     once, straight from device memory, into the A fragments of
//     mma.sync.m16n8k16 and stay in registers. S = Q.K^T of 64 keys at a
//     time (32 at dh 80, where O takes 40 registers a lane) is a row of
//     fp32 m16n8 tiles in registers (K's B fragments by ldmatrix; a tile
//     whose keys all lie below n takes a path with no mask or guard); the
//     C fragments of two such tiles are, once p is packed to bf16, the A
//     fragment of the P.V product, whose B fragments come by ldmatrix.trans
//     of V, and O accumulates in registers (dh / 8 m16n8 tiles). A row's
//     max and sum are reduced across the 4 lanes of its quad. The serving
//     form takes one pass over the chunks; the exact and LSE forms take a
//     first pass that only keeps each row's running max (recomputing S is
//     cheaper than keeping 256 scores a row) and a second as the serving
//     form with exp(s - max). The output is scaled by 1 / l, rounded, and
//     transposed inside each quad so that each lane stores 16 bytes. At
//     128 registers a thread (no spills) two blocks of 8 warps share an SM.
//     What holds it back from its byte bound, measured (PERF.md section 6):
//     each warp reads all of K and V from shared memory for its 16 rows, so
//     the ldmatrix traffic (256 bytes per mma) outruns both the SM's 128
//     bytes a clock of shared memory and the mma.sync rate, and the
//     accurate expf costs about 12 instructions a score.
//   * float32: tensor cores would round to TF32, so the products run on the
//     CUDA cores in fp32: one block per (64 query rows, head, image), K, V
//     and its Q rows staged as fp32 (rows padded to dh+4 so 16-byte loads of
//     32 different key rows hit distinct banks), one warp per query row,
//     each lane scoring N/32 keys against the broadcast q row, then the P.V
//     loop with float2 output columns per lane. Shared-memory bandwidth
//     bounds this path.
//   The bf16 body stops short of half its bound. What would move it: more
//   query rows per warp, so that each K and V fragment feeds two row tiles,
//   or wgmma, whose 64-row tiles read K and V from shared memory once per 64
//   rows; later work, as is folding qk_norm's LayerNorm into K16's load.
#include <stdint.h>

#include "common.cuh"

namespace {

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

// Warps, each a query tile of 16 rows, per block: 8 ran 10-41% faster than
// 4 at the main path's shape (bench/attention_body.py, PERF.md section 6);
// the launcher takes fewer where N needs fewer.
constexpr int kWarps = 8;
constexpr int kKC = 64;  // keys per chunk: one cp.async group
// keys per S tile in registers: 64 (32 fp32 a lane) at dh 64; 32 at dh 80,
// where O takes 40 registers a lane and 64 keys would spill
template <int DH> __host__ __device__ constexpr int tc_tile_keys() { return DH > 64 ? 32 : 64; }

__host__ __device__ constexpr int tc_pad16(int n) { return (n + 15) / 16 * 16; }
template <int DH> __host__ __device__ constexpr int tc_kv_ld() { return DH + 8; }

int tc_warps(int n) { return tc_pad16(n) / 16 < kWarps ? tc_pad16(n) / 16 : kWarps; }

template <int DH>
size_t tc_smem_bytes(int n) {
  return sizeof(bf16) * 2 * static_cast<size_t>(tc_pad16(n)) * tc_kv_ld<DH>();
}

// 16 bytes of row r of operand `which` into shared memory: bf16 sources by
// cp.async (waited for per chunk), int8 sources dequantized through
// registers.
__device__ __forceinline__ void stage16(const Rows<bf16>& rw, int which, int r, int ch,
                                        bf16* dst) {
  tae::cp_async16(dst, rw.at(which, r) + ch * 8);
}
__device__ __forceinline__ void stage16(const I8Rows& rw, int which, int r, int ch,
                                        bf16* dst) {
  *reinterpret_cast<uint4*>(dst) = load16(rw, which, r, ch);
}

// S = Q K^T for the warp's 16 rows and the KT keys [c0, c0 + KT): n-tile
// j holds keys c0 + 8j + 2t, +1 of rows g (s[j][0], s[j][1]) and g + 8
// (s[j][2], s[j][3]). Unless FULL (every key of the tile below n), only the
// kc keys that exist in shared memory are scored (kc a multiple of 16), the
// rest stay 0. Each k-step feeds all KT / 8 accumulators, which are
// independent.
template <int DH, bool FULL, int KT = tc_tile_keys<DH>()>
__device__ __forceinline__ void score_tile(float (&s)[KT / 8][4], const unsigned (&qa)[DH / 16][4],
                                          const bf16* ks, int c0, int kc) {
  constexpr int LDK = tc_kv_ld<DH>();
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < KT / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  // lane l addresses row l % 8 of matrix m = l / 8: keys + 8 (m / 2),
  // columns + 8 (m % 2): b[0..1] for n-tile 2jp, b[2..3] for 2jp + 1
  const bf16* kl = ks + (c0 + (lane & 7) + ((lane >> 4) << 3)) * LDK + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
    for (int jp = 0; jp < KT / 16; ++jp) {
      if (FULL || jp * 16 < kc) {
        unsigned b[4];
        tae::ldmatrix_x4(b, kl + jp * 16 * LDK + kk * 16);
        tae::mma_bf16(s[2 * jp], qa[kk], b[0], b[1]);
        tae::mma_bf16(s[2 * jp + 1], qa[kk], b[2], b[3]);
      }
    }
  }
}

// The scores of one tile used: PASS 0 folds them into the rows' running
// max; PASS 1 turns them into p (fp32 into the row sum, bf16 into P's A
// fragments) and accumulates O += P V. Keys at or beyond n (zero rows,
// n-tiles past kc) enter neither the max nor the sum, and their p is 0.
// FULL: nothing is masked or skipped, and the compiler sees straight-line
// code.
template <int DH, bool SERVING, int PASS, bool FULL, int KT = tc_tile_keys<DH>()>
__device__ __forceinline__ void use_tile(float (&s)[KT / 8][4], float (&o)[DH / 8][4],
                                         float (&mx)[2], float (&lsum)[2], const bf16* vl, int c0,
                                         int kc, int n, float scale) {
  constexpr int LDK = tc_kv_ld<DH>();
  const int key0 = c0 + 2 * (threadIdx.x & 3);  // the key of s[0][0]
  if (PASS == 0) {
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (FULL || key0 + 8 * j + (e & 1) < n) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e] * scale);
    return;
  }
#pragma unroll
  for (int j = 0; j < KT / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = softmax_p(s[j][e] * scale, mx[e >> 1], SERVING);
      if (!FULL) p = key0 + 8 * j + (e & 1) < n ? p : 0.f;
      lsum[e >> 1] += p;
      s[j][e] = p;
    }
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk) {
    if (FULL || kk * 16 < kc) {
      const unsigned pa[4] = {tae::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              tae::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              tae::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              tae::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {
        unsigned bv[4];
        tae::ldmatrix_x4_trans(bv, vl + (c0 + kk * 16) * LDK + dp * 16);
        tae::mma_bf16(o[2 * dp], pa, bv[0], bv[1]);
        tae::mma_bf16(o[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
  }
}

// The warp's sweep over its key tiles in pass PASS. WAIT: the block's first
// pass, which waits for each 64-key chunk before its first product; the
// block's only barriers are there, so warps whose rows all lie beyond n
// (inactive) take part in them and skip the work.
template <int DH, bool SERVING, int PASS, bool WAIT>
__device__ __forceinline__ void sweep(const unsigned (&qa)[DH / 16][4], float (&o)[DH / 8][4],
                                      float (&mx)[2], float (&lsum)[2], const bf16* ks,
                                      const bf16* vl, int n, int np, float scale, bool active) {
  constexpr int KT = tc_tile_keys<DH>();
  const int chunks = (np + kKC - 1) / kKC, tiles = (np + KT - 1) / KT;
  for (int i = 0; i < tiles; ++i) {
    if (WAIT && i * KT % kKC == 0) {
      tae::wait_pending(chunks - 1 - i * KT / kKC);
      __syncthreads();
    }
    if (!active) continue;
    const int c0 = i * KT;  // the tile's first key
    float s[KT / 8][4];
    if (c0 + KT <= n) {
      score_tile<DH, true>(s, qa, ks, c0, KT);
      use_tile<DH, SERVING, PASS, true>(s, o, mx, lsum, vl, c0, KT, n, scale);
    } else {
      const int kc = min(KT, np - c0);
      score_tile<DH, false>(s, qa, ks, c0, kc);
      use_tile<DH, SERVING, PASS, false>(s, o, mx, lsum, vl, c0, kc, n, scale);
    }
  }
}

template <int DH, bool SERVING, typename Src>
__global__ void __launch_bounds__(kWarps * 32, 16 / kWarps)
attention_fwd_bf16(const Src src, bf16* __restrict__ out, const HeadLayout ol,
                   float* __restrict__ lse, int n, int heads, float scale) {
  constexpr int LDK = tc_kv_ld<DH>();
  constexpr int CH = DH / 8;  // 16-byte chunks per head row
  const int np = tc_pad16(n);
  const int chunks = (np + kKC - 1) / kKC;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // (np, LDK)
  bf16* vs = ks + np * LDK;                       // (np, LDK)

  const int b = blockIdx.z, h = blockIdx.y;
  const auto rows = src.rows(b, h);

  // every chunk's K and V rows, one commit group per chunk; zero rows pad
  // the last chunk to a multiple of 16 keys
  for (int c = 0; c < chunks; ++c) {
    const int r0 = c * kKC, nr = min(kKC, np - r0);
    for (int idx = threadIdx.x; idx < nr * CH; idx += blockDim.x) {
      const int r = r0 + idx / CH, ch = idx % CH;
      bf16* kd = ks + r * LDK + ch * 8;
      bf16* vd = vs + r * LDK + ch * 8;
      if (r < n) {
        stage16(rows, 1, r, ch, kd);
        stage16(rows, 2, r, ch, vd);
      } else {
        *reinterpret_cast<uint4*>(kd) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(vd) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    tae::cp_async_commit();
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (blockIdx.x * (blockDim.x / 32) + warp) * 16;  // the warp's first row
  const bool active = q0 < n;

  // Q's A fragments, read once (tae::a_fragments)
  unsigned qa[DH / 16][4];
  tae::a_fragments<DH>(qa, [&](int half, int ch) {
    const int r = q0 + g + 8 * half;
    return active && r < n ? load16(rows, 0, r, ch) : make_uint4(0u, 0u, 0u, 0u);
  });

  float mx[2] = {-INFINITY, -INFINITY};  // rows g, g + 8
  float lsum[2] = {0.f, 0.f};
  float o[DH / 8][4];
#pragma unroll
  for (int d = 0; d < DH / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  // lane l addresses row l % 8 of matrix m = l / 8: keys + 8 (m % 2),
  // columns + 8 (m / 2): b[0..1] for d-tile 2dp, b[2..3] for 2dp + 1
  const bf16* vl = vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * LDK + (lane >> 4) * 8;

  // the serving form takes one pass; the exact and LSE forms first find
  // each row's max in a pass of their own (reduced across the row's quad)
  if (SERVING) {
    sweep<DH, SERVING, 1, true>(qa, o, mx, lsum, ks, vl, n, np, scale, active);
    if (!active) return;
  } else {
    sweep<DH, SERVING, 0, true>(qa, o, mx, lsum, ks, vl, n, np, scale, active);
    if (!active) return;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    sweep<DH, SERVING, 1, false>(qa, o, mx, lsum, ks, vl, n, np, scale, active);
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lsum[i] += __shfl_xor_sync(0xffffffffu, lsum[i], 1);
    lsum[i] += __shfl_xor_sync(0xffffffffu, lsum[i], 2);
    inv[i] = 1.f / lsum[i];
    const int r = q0 + g + 8 * i;
    if (!SERVING && lse != nullptr && t == 0 && r < n)
      lse[(static_cast<long>(b) * heads + h) * n + r] = mx[i] + logf(lsum[i]);
  }

  // o * (1 / l) rounded to bf16, 16 bytes a lane (tae::store_c_rows)
#pragma unroll
  for (int d = 0; d < DH / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] *= inv[e >> 1];
  bf16* obase = out + ol.at(b, h);
  tae::store_c_rows<DH>(o, [&](int half, int ch, uint4 w) {
    const int r = q0 + g + 8 * half;
    if (r < n) *reinterpret_cast<uint4*>(obase + r * ol.row + ch * 8) = w;
  });
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
  auto* kernel = attention_fwd_bf16<DH, SERVING, Src>;
  static size_t smem_allowed = 0;  // one per kernel instantiation
  static bool carved = false;
  if (!carved) {
    // all of the SM's unified memory as shared memory, so that as many
    // blocks fit as the registers allow
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    carved = true;
  }
  return launch(kernel, tc_smem_bytes<DH>(n), smem_allowed, tc_warps(n) * 32, tc_warps(n) * 16,
                src, out, ol, lse, batch, n, heads, scale, stream);
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
