// K2, K15, K16 — attention forward, one device body with three sources —
// and its int8-output form behind K7 / K8.
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
//   K7  flash_attention.py::fused_qkv_attention_q8
//       (_packed_fwd_kernel_stacked_q8) and K8 fused_qkv_attention_wide_q8
//       (_packed_wide_fwd_kernel_stacked_q8) in bf16 from 16 tokens (the C
//       entries are in wide_attention.cu, which keeps the other shapes):
//       K2's serving pass, then per flat row over all heads s = max(max|o| /
//       127, 1e-12) and codes clip(rint(o * (1 / s)), +-127) from the fp32 o
//       (int8_common.cuh's quant_scale / quantize1); outputs int8 (B, N, C)
//       and fp32 (B, N, 1). Up to o *= 1 / l it executes K2's instructions,
//       so its fp32 o is K2's before rounding.
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
//     CUDA cores in fp32 (67 TFLOP/s: 0.256 ms at the main path's shape,
//     where the bytes take 0.080). From 33 tokens (kF32TiledMinTokens) the
//     register-tiled body (attention_fwd_f32_tiled, described at it): a
//     block of 256 threads per (64 query rows, head, image), 4 x 4 register
//     tiles of (row, key) and (row, column), K and V through a two-slot
//     cp.async ring, every score of the head kept in registers. Below, the
//     first design (attention_fwd_f32): one warp per query row, each lane
//     scoring N/32 keys against the broadcast q row from shared memory, then
//     the P.V loop with float2 output columns per lane. Both compute the
//     same products, sums and p in the same order, so their outputs are
//     equal bit for bit (bench/attention_body.py's f32_first / f32_tiled).
//     What bounds the tiled body: one 16-byte shared load per 8 FMAs in
//     both products, where the card sustains about 70% of its FMA rate
//     (bench/ceilings); it runs at 44% of the operations bound (PERF.md
//     section 6). K7 / K8 in float32 from 33 tokens run the same tiles,
//     products and sums in the serving form, streamed a key chunk at a time,
//     with the int8 row epilogue shared over a thread-block cluster
//     (attention_q8_f32_tiled; plan tae::q8::plan_f32).
//   * int8 output (K7, K8): a row's scale needs every head, and the heads
//     of one row tile sit in different blocks. Those blocks form a
//     thread-block cluster (two heads a block, up to 16 blocks); each
//     publishes its rows' partial max |o| in shared memory and reads the
//     others' through distributed shared memory between two cluster
//     barriers, so no fp32 o reaches device memory and the output is int8
//     (half of K2's bytes written). A cluster is placed whole on one GPC, so
//     fewer blocks are resident than K2's (240 of 264 at p16), which is most
//     of what it loses to K2 (PERF.md section 6).
//   The bf16 body stops short of half its bound. What would move it: more
//   query rows per warp, so that each K and V fragment feeds two row tiles,
//   or wgmma, whose 64-row tiles read K and V from shared memory once per 64
//   rows; later work, as is folding qk_norm's LayerNorm into K16's load.
#include <cooperative_groups.h>
#include <stdint.h>

#include "attention_q8.cuh"
#include "common.cuh"
#include "int8_common.cuh"

namespace {

namespace cg = cooperative_groups;
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

// One (image, head) for the warp's 16 query rows from q0: the block's warps
// stage every chunk of the head's K and V into ks / vs (one commit group per
// chunk; zero rows pad the last chunk to a multiple of 16 keys), the warp
// reads its Q rows into A fragments, sweeps the key tiles and leaves o =
// (P.V) * (1 / l) in registers, with l in lsum and (exact form) the row max
// in mx, both reduced over the quad. Returns false for a warp whose rows all
// lie at or beyond n: it has taken part in the block's barriers, and its o
// is 0.
template <int DH, bool SERVING, typename R>
__device__ __forceinline__ bool attend_head(const R& rows, int n, int q0, float scale, bf16* ks,
                                            bf16* vs, float (&o)[DH / 8][4], float (&mx)[2],
                                            float (&lsum)[2]) {
  constexpr int LDK = tc_kv_ld<DH>();
  constexpr int CH = DH / 8;  // 16-byte chunks per head row
  const int np = tc_pad16(n);
  const int chunks = (np + kKC - 1) / kKC;
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

  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const bool active = q0 < n;

  // Q's A fragments, read once (tae::a_fragments)
  unsigned qa[DH / 16][4];
  tae::a_fragments<DH>(qa, [&](int half, int ch) {
    const int r = q0 + g + 8 * half;
    return active && r < n ? load16(rows, 0, r, ch) : make_uint4(0u, 0u, 0u, 0u);
  });

  mx[0] = mx[1] = -INFINITY;  // rows g, g + 8
  lsum[0] = lsum[1] = 0.f;
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
    if (!active) return false;
  } else {
    sweep<DH, SERVING, 0, true>(qa, o, mx, lsum, ks, vl, n, np, scale, active);
    if (!active) return false;
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
  }
#pragma unroll
  for (int d = 0; d < DH / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] *= inv[e >> 1];
  return true;
}

template <int DH, bool SERVING, typename Src>
__global__ void __launch_bounds__(kWarps * 32, 16 / kWarps)
attention_fwd_bf16(const Src src, bf16* __restrict__ out, const HeadLayout ol,
                   float* __restrict__ lse, int n, int heads, float scale) {
  constexpr int LDK = tc_kv_ld<DH>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // (np, LDK)
  bf16* vs = ks + tc_pad16(n) * LDK;              // (np, LDK)

  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (blockIdx.x * (blockDim.x / 32) + warp) * 16;  // the warp's first row

  float o[DH / 8][4], mx[2], lsum[2];
  if (!attend_head<DH, SERVING>(src.rows(b, h), n, q0, scale, ks, vs, o, mx, lsum)) return;
  if (!SERVING && lse != nullptr && t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = q0 + g + 8 * i;
      if (r < n) lse[(static_cast<long>(b) * heads + h) * n + r] = mx[i] + logf(lsum[i]);
    }
  }

  // o rounded to bf16, 16 bytes a lane (tae::store_c_rows)
  bf16* obase = out + ol.at(b, h);
  tae::store_c_rows<DH>(o, [&](int half, int ch, uint4 w) {
    const int r = q0 + g + 8 * half;
    if (r < n) *reinterpret_cast<uint4*>(obase + r * ol.row + ch * 8) = w;
  });
}

// ------------------------------------------------------- int8 output (K7, K8)

// K7 and K8 in bf16: the serving form of the body above with the int8
// output of _packed_fwd_kernel_stacked_q8, one scale per row over all heads.
// A block runs up to tae::q8::kHeadsPerBlock heads of one (image, 16 *
// warps-row tile) in turn, the last in registers and the others' o in
// shared memory (fp32, the lane's own positions, so no barrier guards
// them); the head loop is unrolled, which keeps the sweeps' code as tight
// as K2's (a runtime loop cost it 6-17%, PERF.md). The blocks that cover a
// row tile's heads form a thread-block cluster along grid.y (grid: row
// tiles, cluster, images). Each block reduces |o| of its heads to one
// partial max per row, the cluster barrier publishes them, each block takes
// the max over every rank's through distributed shared memory (exact, so
// the scale does not depend on the cluster size), scales and codes its own
// columns from registers; rank 0 writes the scales. A second cluster
// barrier keeps every block's shared memory alive until all have read it.
template <int DH>
__global__ void __launch_bounds__(kWarps * 32, 16 / kWarps)
attention_q8_bf16(const PlainSrc<bf16> src, int8_t* __restrict__ out_q, float* __restrict__ out_s,
                  int n, int heads, int heads_per_block, float scale) {
  constexpr int LDK = tc_kv_ld<DH>();
  constexpr int LDO = DH + 8;  // fp32 row stride of a buffered head: float2 stores without conflicts
  cg::cluster_group cluster = cg::this_cluster();
  const int np = tc_pad16(n), rows = blockDim.x / 2;  // 16 query rows a warp
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);               // (np, LDK)
  bf16* vs = ks + np * LDK;                                    // (np, LDK)
  float* obuf = reinterpret_cast<float*>(vs + np * LDK);       // (kHeadsPerBlock - 1, rows, LDO)
  float* pmax = obuf + (tae::q8::kHeadsPerBlock - 1) * rows * LDO;  // (rows)

  // grid.y is the cluster: blockIdx.y is the block's rank
  const int b = blockIdx.z, rank = blockIdx.y, ranks = gridDim.y;
  const int h0 = rank * heads_per_block, nh = min(heads_per_block, heads - h0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (blockIdx.x * (blockDim.x / 32) + warp) * 16;
  const int c = heads * DH;

  float o[DH / 8][4], mx[2], lsum[2];
  float amax[2] = {0.f, 0.f};  // rows g, g + 8 over the block's heads
#pragma unroll
  for (int j = 0; j < tae::q8::kHeadsPerBlock; ++j) {
    if (j >= nh) break;
    if (j > 0) __syncthreads();  // every warp is done with the last head's K and V
    attend_head<DH, true>(src.rows(b, h0 + j), n, q0, scale, ks, vs, o, mx, lsum);
#pragma unroll
    for (int d = 0; d < DH / 8; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) amax[e >> 1] = fmaxf(amax[e >> 1], fabsf(o[d][e]));
    if (j + 1 < nh) {
      float* ob = obuf + (j * rows + warp * 16 + g) * LDO + 2 * t;
#pragma unroll
      for (int d = 0; d < DH / 8; ++d) {
        tae::store2(ob + 8 * d, o[d][0], o[d][1]);
        tae::store2(ob + 8 * LDO + 8 * d, o[d][2], o[d][3]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    amax[i] = fmaxf(amax[i], __shfl_xor_sync(0xffffffffu, amax[i], 1));
    amax[i] = fmaxf(amax[i], __shfl_xor_sync(0xffffffffu, amax[i], 2));
  }
  if (t == 0) {
    pmax[warp * 16 + g] = amax[0];
    pmax[warp * 16 + g + 8] = amax[1];
  }
  cluster.sync();  // every rank's partial maxima are in its shared memory

  // the rows' maxima over every rank's heads: lane t reads ranks t, t + 4, ...
  float m[2] = {0.f, 0.f};
  for (int r = t; r < ranks; r += 4) {
    const float* pm = cluster.map_shared_rank(pmax, r);
    m[0] = fmaxf(m[0], pm[warp * 16 + g]);
    m[1] = fmaxf(m[1], pm[warp * 16 + g + 8]);
  }
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
    m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 2));
    const float s = tae::i8::quant_scale(m[i]);
    inv[i] = 1.0f / s;
    const int r = q0 + g + 8 * i;
    if (rank == 0 && t == 0 && r < n) out_s[static_cast<long>(b) * n + r] = s;
  }

  // the codes: the last head's from registers, then the buffered heads'
  int8_t* qbase = out_q + static_cast<long>(b) * n * c;
#pragma unroll
  for (int j = tae::q8::kHeadsPerBlock - 1; j >= 0; --j) {
    if (j >= nh) continue;
    if (j + 1 < nh) {
      const float* ob = obuf + (j * rows + warp * 16 + g) * LDO + 2 * t;
#pragma unroll
      for (int d = 0; d < DH / 8; ++d) {
        const float2 lo = *reinterpret_cast<const float2*>(ob + 8 * d);
        const float2 hi = *reinterpret_cast<const float2*>(ob + 8 * LDO + 8 * d);
        o[d][0] = lo.x;
        o[d][1] = lo.y;
        o[d][2] = hi.x;
        o[d][3] = hi.y;
      }
    }
    int8_t* hbase = qbase + (h0 + j) * DH;
    tae::i8::store_c_codes<DH>(o, inv, [&](int half, int ch, uint4 w) {
      const int r = q0 + g + 8 * half;
      if (r < n) *reinterpret_cast<uint4*>(hbase + static_cast<long>(r) * c + ch * 16) = w;
    });
  }
  cluster.sync();  // no block's shared memory goes away while another block reads it
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

// The register-tiled fp32 body, from kF32TiledMinTokens tokens. A block
// takes kTR query rows of one (image, head) with kTThreads threads on a
// 16 x 16 grid: thread (rg, cg) scores rows rg + 16 i against keys
// cg + 16 j of each 64-key chunk (i, j < 4: four float4s of q, then one of
// k at a time, feed 64 FMAs), keeps all of its up to 4 x 16 scores of the
// head in registers (so the exact form's row max needs no second pass; the
// max itself stays in shared memory), and for P.V owns rows 4 rg .. 4 rg +
// 3 and columns 4 cg .. 4 cg + 3 (and 64 + cg at dh 80): per key one float4
// of p and one of v feed 16 FMAs. K and then V arrive in 64-key chunks by
// 16-byte cp.async through a ring of two slots, chunk i + 1 landing while
// chunk i is used; Q is staged once with chunk 0; p goes to two tiles in
// turn, so a V chunk takes one barrier. Every product, p and sum is the
// first design's: s sums fmaf(q_d, k_d) over d ascending and is scaled
// once; P.V sums fmaf(p_j, v_j) over j ascending; l takes each row's p in
// the first design's order (lane partials over keys lane + 32 t, then
// tae::warp_sum's butterfly), read back from the p tile by a warp of 32
// lanes per 8 rows. So o and lse equal attention_fwd_f32's bit for bit.
//   Measured on an H100 80GB HBM3 at 700 W (bench/attention_body.py, in
// turns with the variants named): at (64, 256, 3072) h16 0.583 ms serving,
// 0.590 exact; the Q.K^T products cost 0.20 of it and the P.V products 0.22
// (f32_no_qk, f32_no_pv), the exp 0.03 (f32_no_exp); a third ring slot
// spilled and ran 1-3% slower (f32_slots3), the P.V loop unrolled by 8 ran
// 1.5% slower than by 16, q loaded a step ahead (f32_qk_prefetch) and the
// column loop unrolled by 8 moved nothing, unrolled whole ran 22% slower,
// one block an SM with 255 registers 35% slower in the exact form. The
// first design keeps 32 tokens and fewer: at 32 tokens both took 0.038 ms
// at (64, 32, 3072) h16, at 40 the first design 0.070 against 0.044, at 16
// and 4 tokens (dh 80, h32) 0.044 / 0.011 against 0.072 / 0.064.
constexpr int kTR = 64;              // query rows a block
constexpr int kTK = 64;              // keys a chunk: one cp.async group
constexpr int kTThreads = 256;       // 16 row groups x 16 key / column groups
constexpr int kTChunks = kMaxN / kTK;
constexpr int kTLdP = kTR + 4;       // the p tile, [key][row]
// tokens from which the tiled body runs (below: attention_fwd_f32)
constexpr int kF32TiledMinTokens = 33;

// ring slots: chunk i + 1 lands while chunk i is used (three spilled at dh
// 64 and ran 1-3% slower, and leave room for one block an SM at dh 80)
constexpr int kTSlots = 2;

template <int DH> __host__ __device__ constexpr int t_ld() { return DH + 4; }

// qs (kTR rows), the ring's slots (kTK rows each) of DH + 4 floats, two p
// tiles (chunks in turn), two halves of the row maxima and the row sums
template <int DH>
__host__ __device__ constexpr size_t tiled_smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kTR + kTSlots * kTK) * t_ld<DH>() +
                          2 * kTK * kTLdP + 3 * kTR);
}

template <int DH, bool SERVING>
__global__ void __launch_bounds__(kTThreads, 2)
attention_fwd_f32_tiled(const PlainSrc<float> src, float* __restrict__ out,
                        const HeadLayout ol, float* __restrict__ lse, int n, int heads,
                        float scale) {
  constexpr int LD = t_ld<DH>(), S = kTSlots;
  constexpr int CW = DH == 80 ? 5 : 4;  // output columns a thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                   // [kTR][LD]
  float* ring = qs + kTR * LD;        // [S][kTK][LD]
  float* ps = ring + S * kTK * LD;    // [2][kTK][kTLdP]
  float* mxs = ps + 2 * kTK * kTLdP;  // [2][kTR]
  float* ls = mxs + 2 * kTR;          // [kTR]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kTR;
  const Rows<float> rows = src.rows(b, h);
  const int nq = min(kTR, n - q0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cg = (warp & 1) * 8 + (lane & 7);  // key group, then column group
  const int rg = (warp >> 1) * 4 + (lane >> 3);  // row group
  const int nc = (n + kTK - 1) / kTK, items = 2 * nc;  // K chunks, then V chunks

  // item i: K chunk i, or V chunk i - nc, into ring slot i % S; rows past
  // n zero-filled; nothing past the last item
  auto issue = [&](int i) {
    if (i >= items) return;
    const int c = i < nc ? i : i - nc;
    // k's or v's rows, chosen without indexing rows' arrays at run time
    // (which would put them in local memory)
    const float* src = i < nc ? rows.p[1] : rows.p[2];
    const long long stride = i < nc ? rows.row[1] : rows.row[2];
    float* dst = ring + (i % S) * kTK * LD;
    for (int idx = tid; idx < kTK * (DH / 4); idx += kTThreads) {
      const int r = idx / (DH / 4), col = (idx - r * (DH / 4)) * 4;
      const int key = c * kTK + r;
      if (key < n)
        tae::cp_async16(dst + r * LD + col, src + key * stride + col);
      else
        *reinterpret_cast<float4*>(dst + r * LD + col) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    tae::cp_async_commit();
  };
  for (int idx = tid; idx < kTR * (DH / 4); idx += kTThreads) {
    const int r = idx / (DH / 4), col = (idx - r * (DH / 4)) * 4;
    if (r < nq)
      tae::cp_async16(qs + r * LD + col, rows.at(0, q0 + r) + col);
    else
      *reinterpret_cast<float4*>(qs + r * LD + col) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int i = 0; i < S - 1; ++i) issue(i);  // Q rides with item 0

  // ---- S = Q K^T, every chunk's scores kept: s[c][i][j] is row rg + 16 i,
  //      key 64 c + cg + 16 j
  float s[kTChunks][4][4];
#pragma unroll
  for (int c = 0; c < kTChunks; ++c) {
    if (c < nc) {
      // K chunk c (and Q) landed: S - 2 newer chunks may still fly
      tae::wait_pending(c + 1 < items ? S - 2 : 0);
      __syncthreads();  // ... for every thread; slot (c - 1) % S is free
      issue(c + S - 1);
      const float* ks = ring + (c % S) * kTK * LD;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[c][i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < DH; d += 4) {
        float4 qv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qv[i] = *reinterpret_cast<const float4*>(qs + (rg + 16 * i) * LD + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 kv = *reinterpret_cast<const float4*>(ks + (cg + 16 * j) * LD + d);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float acc = s[c][i][j];
            acc = fmaf(qv[i].x, kv.x, acc);
            acc = fmaf(qv[i].y, kv.y, acc);
            acc = fmaf(qv[i].z, kv.z, acc);
            acc = fmaf(qv[i].w, kv.w, acc);
            s[c][i][j] = acc;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[c][i][j] *= scale;
    }
  }

  // ---- the exact forms' row max: the thread's keys, its 8 lanes of the
  //      row group (lane bits 0-2), then the two warps of the row group,
  //      whose halves stay in shared memory (registers are what the P.V
  //      loop's unrolling needs)
  if (!SERVING) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float m = -INFINITY;
#pragma unroll
      for (int c = 0; c < kTChunks; ++c)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c * kTK + cg + 16 * j < n) m = fmaxf(m, s[c][i][j]);
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      if ((lane & 7) == 0) mxs[(warp & 1) * kTR + rg + 16 * i] = m;
    }
    __syncthreads();
  }

  // ---- p, l and P.V chunk by chunk
  float o[4][CW], lp[8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int e = 0; e < CW; ++e) o[r][e] = 0.f;
#pragma unroll
  for (int r = 0; r < 8; ++r) lp[r] = 0.f;
#pragma unroll
  for (int c = 0; c < kTChunks; ++c) {
    if (c < nc) {
      const int i = nc + c;
      // p of chunk c into its half of the p tile, last read for chunk c - 2
      float* pc = ps + (c & 1) * kTK * kTLdP;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float mx = SERVING ? 0.f : fmaxf(mxs[rg + 16 * r], mxs[kTR + rg + 16 * r]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = c * kTK + cg + 16 * j;
          pc[(cg + 16 * j) * kTLdP + rg + 16 * r] =
              key < n ? softmax_p(s[c][r][j], mx, SERVING) : 0.f;
        }
      }
      tae::wait_pending(i + 1 < items ? S - 2 : 0);  // V chunk c; the last waits for all
      __syncthreads();  // V chunk c and its p visible to all; chunk c - 1 done with
      issue(i + S - 1);
      // warp w's rows 8 w .. 8 w + 7: lane l adds keys l, then l + 32
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int key = c * kTK + lane + 32 * t;
        if (key < n) {
          const float* pr = pc + (lane + 32 * t) * kTLdP + 8 * warp;
          const float4 a = *reinterpret_cast<const float4*>(pr);
          const float4 e = *reinterpret_cast<const float4*>(pr + 4);
          lp[0] += a.x;
          lp[1] += a.y;
          lp[2] += a.z;
          lp[3] += a.w;
          lp[4] += e.x;
          lp[5] += e.y;
          lp[6] += e.z;
          lp[7] += e.w;
        }
      }
      const float* vs = ring + (i % S) * kTK * LD;
      const int kc = min(kTK, n - c * kTK);
#pragma unroll 16
      for (int j = 0; j < kc; ++j) {
        const float4 pv = *reinterpret_cast<const float4*>(pc + j * kTLdP + 4 * rg);
        const float4 vv = *reinterpret_cast<const float4*>(vs + j * LD + 4 * cg);
        const float p4[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          o[r][0] = fmaf(p4[r], vv.x, o[r][0]);
          o[r][1] = fmaf(p4[r], vv.y, o[r][1]);
          o[r][2] = fmaf(p4[r], vv.z, o[r][2]);
          o[r][3] = fmaf(p4[r], vv.w, o[r][3]);
        }
        if (CW == 5) {
          const float v5 = vs[j * LD + 64 + cg];
#pragma unroll
          for (int r = 0; r < 4; ++r) o[r][CW - 1] = fmaf(p4[r], v5, o[r][CW - 1]);
        }
      }
    }
  }

  // ---- l (and lse) per row, then o * (1 / l)
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float l = tae::warp_sum(lp[r]);
    const int row = 8 * warp + r;
    if (lane == r) {
      ls[row] = l;
      if (!SERVING && lse != nullptr && row < nq)
        lse[(static_cast<long>(b) * heads + h) * n + q0 + row] =
            fmaxf(mxs[row], mxs[kTR + row]) + logf(l);
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = 4 * rg + r;
    if (row < nq) {
      const float inv = 1.f / ls[row];
      float* orow = out + ol.at(b, h) + (q0 + row) * ol.row;
      *reinterpret_cast<float4*>(orow + 4 * cg) =
          make_float4(o[r][0] * inv, o[r][1] * inv, o[r][2] * inv, o[r][3] * inv);
      if (CW == 5) orow[64 + cg] = o[r][CW - 1] * inv;
    }
  }
}

// The tiled body's serving form for one head of the int8 form
// (attention_q8_f32_tiled): rows [q0, q0 + 64) of the head whose q, k, v
// rows are `rows`. The serving softmax needs no row max, so each 64-key
// chunk's scores are used as soon as they are formed: K chunk c and V chunk
// c take the ring's two slots in turn (K, V, K, ...), and a thread holds
// one chunk's 4 x 4 scores instead of the whole head's (the exact form's
// reason to keep them all), which leaves its head loop room in 128
// registers. Tiles, products, p, l and the P.V sums are
// attention_fwd_f32_tiled's, in the same order: o (the thread's P.V sums,
// rows 4 rg + r, columns 4 cg .. 4 cg + 3 and 64 + cg at dh 80) and the row
// sums l (in shared memory after a block barrier, q8_tiled_ls) equal that
// kernel's serving form bit for bit.
template <int DH>
__device__ __forceinline__ void q8_tiled_head(const Rows<float> rows, int n, int q0, float scale,
                                              float* smem, float (&o)[4][DH == 80 ? 5 : 4]) {
  constexpr int LD = t_ld<DH>();
  constexpr int CW = DH == 80 ? 5 : 4;  // output columns a thread
  float* qs = smem;                     // [kTR][LD]
  float* ring = qs + kTR * LD;          // [2][kTK][LD]: K chunk c, then V chunk c
  float* ps = ring + 2 * kTK * LD;      // [2][kTK][kTLdP]
  float* ls = ps + 2 * kTK * kTLdP + 2 * kTR;  // [kTR], past the forward's row maxima

  const int nq = min(kTR, n - q0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cg = (warp & 1) * 8 + (lane & 7);  // key group, then column group
  const int rg = (warp >> 1) * 4 + (lane >> 3);  // row group
  const int nc = (n + kTK - 1) / kTK;

  // K (which 0) or V (which 1) chunk c into slot `which`; rows past n zero
  auto issue = [&](int c, int which) {
    const float* src = which ? rows.p[2] : rows.p[1];
    const long long stride = which ? rows.row[2] : rows.row[1];
    float* dst = ring + which * kTK * LD;
    for (int idx = tid; idx < kTK * (DH / 4); idx += kTThreads) {
      const int r = idx / (DH / 4), col = (idx - r * (DH / 4)) * 4;
      const int key = c * kTK + r;
      if (key < n)
        tae::cp_async16(dst + r * LD + col, src + key * stride + col);
      else
        *reinterpret_cast<float4*>(dst + r * LD + col) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    tae::cp_async_commit();
  };
  for (int idx = tid; idx < kTR * (DH / 4); idx += kTThreads) {
    const int r = idx / (DH / 4), col = (idx - r * (DH / 4)) * 4;
    if (r < nq)
      tae::cp_async16(qs + r * LD + col, rows.at(0, q0 + r) + col);
    else
      *reinterpret_cast<float4*>(qs + r * LD + col) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  issue(0, 0);  // Q rides with K chunk 0

  float lp[8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int e = 0; e < CW; ++e) o[r][e] = 0.f;
#pragma unroll
  for (int r = 0; r < 8; ++r) lp[r] = 0.f;
#pragma unroll 1
  for (int c = 0; c < nc; ++c) {
    tae::wait_pending(0);  // K chunk c (and Q) landed
    __syncthreads();       // ... for every thread; V chunk c - 1 is done with
    issue(c, 1);
    // S = Q K^T of chunk c: row rg + 16 i, key 64 c + cg + 16 j
    const float* ks = ring;
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < DH; dd += 4) {
      float4 qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (rg + 16 * i) * LD + dd);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(ks + (cg + 16 * j) * LD + dd);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float acc = sc[i][j];
          acc = fmaf(qv[i].x, kv.x, acc);
          acc = fmaf(qv[i].y, kv.y, acc);
          acc = fmaf(qv[i].z, kv.z, acc);
          acc = fmaf(qv[i].w, kv.w, acc);
          sc[i][j] = acc;
        }
      }
    }
    // p of chunk c into its half of the p tile, last read for chunk c - 2
    float* pc = ps + (c & 1) * kTK * kTLdP;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = c * kTK + cg + 16 * j;
        pc[(cg + 16 * j) * kTLdP + rg + 16 * r] =
            key < n ? softmax_p(sc[r][j] * scale, 0.f, true) : 0.f;
      }
    tae::wait_pending(0);  // V chunk c landed
    __syncthreads();       // ... and chunk c's p, for every thread; K chunk c is done with
    if (c + 1 < nc) issue(c + 1, 0);
    // warp w's rows 8 w .. 8 w + 7: lane l adds keys l, then l + 32
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int key = c * kTK + lane + 32 * t;
      if (key < n) {
        const float* pr = pc + (lane + 32 * t) * kTLdP + 8 * warp;
        const float4 a = *reinterpret_cast<const float4*>(pr);
        const float4 e = *reinterpret_cast<const float4*>(pr + 4);
        lp[0] += a.x;
        lp[1] += a.y;
        lp[2] += a.z;
        lp[3] += a.w;
        lp[4] += e.x;
        lp[5] += e.y;
        lp[6] += e.z;
        lp[7] += e.w;
      }
    }
    const float* vs = ring + kTK * LD;
    const int keys = min(kTK, n - c * kTK);
#pragma unroll 16
    for (int j = 0; j < keys; ++j) {
      const float4 pv = *reinterpret_cast<const float4*>(pc + j * kTLdP + 4 * rg);
      const float4 vv = *reinterpret_cast<const float4*>(vs + j * LD + 4 * cg);
      const float p4[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        o[r][0] = fmaf(p4[r], vv.x, o[r][0]);
        o[r][1] = fmaf(p4[r], vv.y, o[r][1]);
        o[r][2] = fmaf(p4[r], vv.z, o[r][2]);
        o[r][3] = fmaf(p4[r], vv.w, o[r][3]);
      }
      if (CW == 5) {
        const float v5 = vs[j * LD + 64 + cg];
#pragma unroll
        for (int r = 0; r < 4; ++r) o[r][CW - 1] = fmaf(p4[r], v5, o[r][CW - 1]);
      }
    }
  }

  // ---- l per row
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float l = tae::warp_sum(lp[r]);
    if (lane == r) ls[8 * warp + r] = l;
  }
  __syncthreads();
}

// the row sums q8_tiled_head leaves in a block's shared memory
template <int DH>
__device__ __forceinline__ const float* q8_tiled_ls(const float* smem) {
  return smem + (kTR + kTSlots * kTK) * t_ld<DH>() + 2 * kTK * kTLdP + 2 * kTR;
}

// K7 and K8 in float32 from kF32TiledMinTokens tokens: the tiled body's
// serving form with the int8 output, one scale per row over all heads, as
// attention_q8_bf16 does for bf16. A block runs heads_per_block heads of one
// (image, 64-row tile) in turn and keeps each head's o * (1 / l) in shared
// memory at the thread's own positions (so no barrier guards them): the
// last head's in the Q tile's rows, which its body no longer reads, the
// others' in a buffer of their own. Nothing but the head index lives
// across a head's body: the body is at 128 registers in K2's serving form,
// and each value held across it spilled. TWO: up to 2 heads a block (32
// heads), two blocks an SM; else one block an SM at up to 255 registers.
// The blocks that cover a row tile's heads form a thread-block cluster
// along grid.y; the 16 threads of a row group reduce |o| to a partial max
// per row (shuffles, then the row group's two warps in shared memory), the
// cluster barrier publishes each block's, a thread per row takes the max
// over every rank's through distributed shared memory, and each thread
// codes its own positions. o is the tiled body's, which equals the first
// design's, so the codes and scales equal those of the flat-row form at
// the same tokens (K9) and follow the plain version's arithmetic.
template <int DH, bool TWO>
__global__ void __launch_bounds__(kTThreads, TWO ? 2 : 1)
attention_q8_f32_tiled(const PlainSrc<float> src, int8_t* __restrict__ out_q,
                       float* __restrict__ out_s, int n, int heads, int heads_per_block,
                       float scale) {
  constexpr int CW = DH == 80 ? 5 : 4, LDO = DH + 4;
  static_assert(LDO == t_ld<DH>(), "the last head's o takes the Q tile's rows");
  extern __shared__ __align__(16) float smem[];
  // grid.y is the cluster: blockIdx.y is the block's rank
#pragma unroll 1
  for (int j = 0; j < min(heads_per_block, heads - static_cast<int>(blockIdx.y) * heads_per_block);
       ++j) {
    float o[4][CW];
    const int h = blockIdx.y * heads_per_block + j;
    q8_tiled_head<DH>(src.rows(blockIdx.z, h), n, blockIdx.x * kTR, scale, smem, o);
    const float* ls = q8_tiled_ls<DH>(smem);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int col = (warp & 1) * 8 + (lane & 7), rg = (warp >> 1) * 4 + (lane >> 3);
    // head j's o: the last one's in the Q tile's rows
    const int hb = min(heads_per_block, heads - static_cast<int>(blockIdx.y) * heads_per_block);
    float* base = j + 1 < hb ? smem + tiled_smem_bytes<DH>() / sizeof(float) + j * kTR * LDO
                             : smem;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float inv = 1.f / ls[4 * rg + r];
      float* ob = base + (4 * rg + r) * LDO;
      *reinterpret_cast<float4*>(ob + 4 * col) =
          make_float4(o[r][0] * inv, o[r][1] * inv, o[r][2] * inv, o[r][3] * inv);
      if (CW == 5) ob[64 + col] = o[r][CW - 1] * inv;
    }
  }

  cg::cluster_group cluster = cg::this_cluster();
  float* obuf = smem + tiled_smem_bytes<DH>() / sizeof(float);  // (heads_per_block - 1, kTR, LDO)
  float* pm = obuf + (heads_per_block - 1) * kTR * LDO;  // [2][kTR]: a row group's two warps
  float* bm = pm + 2 * kTR;                               // [kTR]: the block's row maxima
  float* gi = bm + kTR;                                   // [kTR]: 1 / scale of each row
  const int b = blockIdx.z, rank = blockIdx.y, ranks = gridDim.y, q0 = blockIdx.x * kTR;
  const int h0 = rank * heads_per_block, nh = min(heads_per_block, heads - h0);
  // head j's o: the last one's in the Q tile's rows
  auto slot = [obuf, nh](int j) { return j + 1 < nh ? obuf + j * kTR * LDO : smem; };
  const int nq = min(kTR, n - q0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int col = (warp & 1) * 8 + (lane & 7), rg = (warp >> 1) * 4 + (lane >> 3);
  const int c = heads * DH;

  // each row's max |o| over the block's heads (rows past nq, finite values
  // of zero query rows, do not count)
  float amax[4] = {0.f, 0.f, 0.f, 0.f};
  for (int j = 0; j < nh; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float* ob = slot(j) + (4 * rg + r) * LDO;
      const float4 v = *reinterpret_cast<const float4*>(ob + 4 * col);
      amax[r] = fmaxf(amax[r], fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w))));
      if (CW == 5) amax[r] = fmaxf(amax[r], fabsf(ob[64 + col]));
    }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float m = 4 * rg + r < nq ? amax[r] : 0.f;
#pragma unroll
    for (int x = 1; x < 8; x <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, x));
    if ((lane & 7) == 0) pm[(warp & 1) * kTR + 4 * rg + r] = m;
  }
  __syncthreads();
  if (tid < kTR) bm[tid] = fmaxf(pm[tid], pm[kTR + tid]);
  cluster.sync();  // every rank's row maxima are in its shared memory
  if (tid < kTR) {
    float m = 0.f;
    for (int r = 0; r < ranks; ++r) m = fmaxf(m, cluster.map_shared_rank(bm, r)[tid]);
    const float sc = tae::i8::quant_scale(m);
    gi[tid] = 1.0f / sc;
    if (rank == 0 && tid < nq) out_s[static_cast<long>(b) * n + q0 + tid] = sc;
  }
  // done with the others' shared memory: arrive now, wait before exiting
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  __syncthreads();
  int8_t* qbase = out_q + (static_cast<long>(b) * n + q0) * c;
  for (int j = 0; j < nh; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = 4 * rg + r;
      if (row < nq) {
        const float* ob = slot(j) + row * LDO;
        const float4 v = *reinterpret_cast<const float4*>(ob + 4 * col);
        const float inv = gi[row];
        int8_t* qrow = qbase + static_cast<long>(row) * c + (h0 + j) * DH;
        const unsigned w = (static_cast<unsigned>(tae::i8::quantize1(v.x, inv)) & 0xffu) |
                           (static_cast<unsigned>(tae::i8::quantize1(v.y, inv)) & 0xffu) << 8 |
                           (static_cast<unsigned>(tae::i8::quantize1(v.z, inv)) & 0xffu) << 16 |
                           (static_cast<unsigned>(tae::i8::quantize1(v.w, inv)) & 0xffu) << 24;
        *reinterpret_cast<unsigned*>(qrow + 4 * col) = w;
        if (CW == 5) qrow[64 + col] = static_cast<int8_t>(tae::i8::quantize1(ob[64 + col], inv));
      }
    }
  // no block's shared memory goes away while another block reads it
  __syncwarp();
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
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
    // the shape rule: the first design up to 32 tokens, where it is as fast
    // or faster (0.038 against 0.038 ms at 32 tokens, 0.044 against 0.072 at
    // 16; the tiled body 0.044 against 0.070 at 40: attention_fwd_f32_tiled's
    // note); no fallback on failure
    if (n < kF32TiledMinTokens) {
      static size_t smem_allowed = 0;
      return launch(attention_fwd_f32<DH, SERVING>, f32_smem_bytes<DH>(n), smem_allowed,
                    kF32Warps * 32, kBQ, src, out, ol, lse, batch, n, heads, scale, stream);
    }
    auto* kernel = attention_fwd_f32_tiled<DH, SERVING>;
    static size_t smem_allowed = 0;
    static bool carved = false;
    if (!carved) {
      // two blocks an SM need more than the default carveout's shared memory
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
      if (err != cudaSuccess) return static_cast<int>(err);
      carved = true;
    }
    return launch(kernel, tiled_smem_bytes<DH>(), smem_allowed, kTThreads, kTR, src, out, ol,
                  lse, batch, n, heads, scale, stream);
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

// attention_q8_bf16<DH> with p's shape: the attributes it needs set once per
// instantiation (the shared-memory limit raised as launches need), and the
// launch configuration with its cluster dimension.
template <int DH>
cudaError_t q8_config(const tae::q8::Plan& p, int batch, int n, cudaStream_t stream,
                      cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr) {
  auto* kernel = attention_q8_bf16<DH>;
  static bool prepared = false;
  static int smem_allowed = 0;
  if (!prepared) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                           cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    prepared = true;
  }
  if (p.smem > smem_allowed) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return err;
    smem_allowed = p.smem;
  }
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3((n + 16 * p.warps - 1) / (16 * p.warps), p.cluster, batch);
  cfg.blockDim = dim3(32 * p.warps);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = p.cluster;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <int DH>
int launch_q8(const tae::q8::Plan& p, const PlainSrc<bf16>& src, void* out_q, void* out_s,
              int batch, int n, int heads, float scale, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = q8_config<DH>(p, batch, n, stream, cfg, attr);
  if (err == cudaSuccess)
    err = cudaLaunchKernelEx(&cfg, attention_q8_bf16<DH>, src, static_cast<int8_t*>(out_q),
                             static_cast<float*>(out_s), n, heads, p.heads_per_block, scale);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// How many clusters of p's shape the card holds at once (0: none fits).
template <int DH>
int q8_active_clusters(const tae::q8::Plan& p, int n, int& clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = q8_config<DH>(p, 1, n, nullptr, cfg, attr);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&clusters, attention_q8_bf16<DH>, &cfg);
  return static_cast<int>(err);
}

// attention_q8_f32_tiled<DH, TWO> with p's shape, as q8_config: TWO where a
// block takes up to two heads.
template <int DH, bool TWO>
cudaError_t q8_f32_config(const tae::q8::Plan& p, int batch, int n, cudaStream_t stream,
                          cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr) {
  auto* kernel = attention_q8_f32_tiled<DH, TWO>;
  static bool prepared = false;
  static int smem_allowed = 0;
  if (!prepared) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                           cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    prepared = true;
  }
  if (p.smem > smem_allowed) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return err;
    smem_allowed = p.smem;
  }
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3((n + kTR - 1) / kTR, p.cluster, batch);
  cfg.blockDim = dim3(kTThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = static_cast<unsigned>(p.cluster);
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <int DH, bool TWO>
int launch_q8_f32_two(const tae::q8::Plan& p, const PlainSrc<float>& src, void* out_q,
                      void* out_s, int batch, int n, int heads, float scale,
                      cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = q8_f32_config<DH, TWO>(p, batch, n, stream, cfg, attr);
  if (err == cudaSuccess)
    err = cudaLaunchKernelEx(&cfg, attention_q8_f32_tiled<DH, TWO>, src,
                             static_cast<int8_t*>(out_q), static_cast<float*>(out_s), n, heads,
                             p.heads_per_block, scale);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <int DH>
int launch_q8_f32(const tae::q8::Plan& p, const PlainSrc<float>& src, void* out_q, void* out_s,
                  int batch, int n, int heads, float scale, cudaStream_t stream) {
  if (p.heads_per_block <= 2)
    return launch_q8_f32_two<DH, true>(p, src, out_q, out_s, batch, n, heads, scale, stream);
  return launch_q8_f32_two<DH, false>(p, src, out_q, out_s, batch, n, heads, scale, stream);
}

template <int DH, bool TWO>
int q8_f32_clusters(const tae::q8::Plan& p, int n, int& clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = q8_f32_config<DH, TWO>(p, 1, n, nullptr, cfg, attr);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&clusters, attention_q8_f32_tiled<DH, TWO>, &cfg);
  return static_cast<int>(err);
}

template <int DH>
int q8_f32_active_clusters(const tae::q8::Plan& p, int n, int& clusters) {
  return p.heads_per_block <= 2 ? q8_f32_clusters<DH, true>(p, n, clusters)
                                : q8_f32_clusters<DH, false>(p, n, clusters);
}

}  // namespace

namespace tae {
namespace q8 {

bool plan_f32(int n, int heads, int dh, Plan& p) {
  if (n < kF32TiledMinTokens || n > kMaxN || heads < 1 || heads > 65535 ||
      (dh != 64 && dh != 80))
    return false;
  p.heads_per_block = (heads + kF32MaxCluster - 1) / kF32MaxCluster;
  p.cluster = (heads + p.heads_per_block - 1) / p.heads_per_block;
  p.warps = kTThreads / 32;
  const long long smem =
      static_cast<long long>(dh == 64 ? tiled_smem_bytes<64>() : tiled_smem_bytes<80>()) +
      4LL * (p.heads_per_block - 1) * kTR * (dh + 4)  // o of every head but the last, fp32
      + 4LL * 4 * kTR;  // row maxima, block maxima, 1 / scale
  p.smem = static_cast<int>(smem);
  return smem <= tae::i8::kSmemLimit;
}

int launch_f32(const Plan& p, const void* qkv, void* out_q, void* out_s, int batch, int n,
               int heads, int dh, float scale, void* stream) {
  if (batch < 1 || batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const long long c = static_cast<long long>(heads) * dh;
  const float* base = static_cast<const float*>(qkv);
  const HeadLayout in = {n * 3 * c, dh, 3 * c};
  PlainSrc<float> src;
  for (int i = 0; i < 3; ++i) {
    src.p[i] = base + i * c;
    src.l[i] = in;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh == 64) return launch_q8_f32<64>(p, src, out_q, out_s, batch, n, heads, scale, s);
  if (dh == 80) return launch_q8_f32<80>(p, src, out_q, out_s, batch, n, heads, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}


bool plan(int n, int heads, int dh, Plan& p) {
  if (n < kMinTokens || n > kMaxN || heads < 1 || heads > kHeadsPerBlock * kMaxCluster ||
      (dh != 64 && dh != 80))
    return false;
  p.heads_per_block = heads < kHeadsPerBlock ? heads : kHeadsPerBlock;
  p.cluster = (heads + p.heads_per_block - 1) / p.heads_per_block;
  p.warps = tc_warps(n);
  const long long rows = 16LL * p.warps;
  const long long smem = 4LL * tc_pad16(n) * (dh + 8)                      // K and V, bf16
                         + 4LL * (kHeadsPerBlock - 1) * rows * (dh + 8)     // buffered o, fp32
                         + 4LL * rows;                                      // partial maxima
  p.smem = static_cast<int>(smem);
  return smem <= tae::i8::kSmemLimit;
}

int launch(const Plan& p, const void* qkv, void* out_q, void* out_s, int batch, int n, int heads,
           int dh, float scale, void* stream) {
  if (batch < 1 || batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const long long c = static_cast<long long>(heads) * dh;
  const bf16* base = static_cast<const bf16*>(qkv);
  const HeadLayout in = {n * 3 * c, dh, 3 * c};
  PlainSrc<bf16> src;
  for (int i = 0; i < 3; ++i) {
    src.p[i] = base + i * c;
    src.l[i] = in;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh == 64) return launch_q8<64>(p, src, out_q, out_s, batch, n, heads, scale, s);
  if (dh == 80) return launch_q8<80>(p, src, out_q, out_s, batch, n, heads, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace q8
}  // namespace tae

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

// The plan of K7 / K8 in float32 on the tiled body (attention_q8_f32_tiled),
// as tae_attention_q8_plan: out[0] 1 where it takes the shape, out[1..4]
// cluster, heads per block, warps, shared memory bytes, out[5] the clusters
// the card holds at once.
extern "C" int tae_attention_q8_f32_plan(int n, int heads, int dh, int* out) {
  tae::q8::Plan p;
  out[0] = tae::q8::plan_f32(n, heads, dh, p) ? 1 : 0;
  if (!out[0]) return 0;
  out[1] = p.cluster;
  out[2] = p.heads_per_block;
  out[3] = p.warps;
  out[4] = p.smem;
  return dh == 64 ? q8_f32_active_clusters<64>(p, n, out[5])
                  : q8_f32_active_clusters<80>(p, n, out[5]);
}

// The plan of K7 / K8 on the forward body for (n, heads, dh) in bf16: out[0]
// 1 where the body takes the shape (else 0, and nothing more is written),
// out[1..4] cluster, heads per block, warps, shared memory bytes, out[5] the
// clusters the card holds at once (cudaOccupancyMaxActiveClusters).
extern "C" int tae_attention_q8_plan(int n, int heads, int dh, int* out) {
  tae::q8::Plan p;
  out[0] = tae::q8::plan(n, heads, dh, p) ? 1 : 0;
  if (!out[0]) return 0;
  out[1] = p.cluster;
  out[2] = p.heads_per_block;
  out[3] = p.warps;
  out[4] = p.smem;
  return dh == 64 ? q8_active_clusters<64>(p, n, out[5]) : q8_active_clusters<80>(p, n, out[5]);
}
