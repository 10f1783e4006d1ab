// K6-K9 — packed-qkv attention over flat token rows: the tiny-N ("wide")
// form and the forms with int8 output.
//
// Replaces, in tae_tpu/ops/pallas/flash_attention.py:
//   K6 fused_qkv_attention_wide        (_packed_wide_fwd_kernel_stacked,
//                                       _serving_softmax)
//   K7 fused_qkv_attention_q8          (_packed_fwd_kernel_stacked_q8)
//   K8 fused_qkv_attention_wide_q8     (_packed_wide_fwd_kernel_stacked_q8)
//   K9 fused_qkv_attention_wide_q8_2d  (_packed_wide_fwd_kernel_stacked_q8_2d,
//                                       _block_diag_mask, _masked_serving_softmax)
// This file holds the C entries of all four. A block here owns 16
// consecutive rows of the flat (B*N, 3C) token axis, whatever images they
// belong to; qkv (B, N, 3C) and its (B*N, 3C) view are the same bytes. K6
// and K9 run here; K7 and K8 in bf16 from 16 tokens (tae::q8::kMinTokens)
// and up to 32 heads run on K2's body (flash_attention.cu,
// attention_q8.cuh), and here otherwise (fewer tokens, more heads,
// float32), where K8 and K9 are bit-identical.
//
// Numerics, as the Pallas bodies: fp32 scores s = (q . k) * scale; serving
//   form p = exp(clip(s, -60, 45)), exact form (K6 only) p = exp(s - rowmax)
//   with the max over the row's own image; a key of another image in the same
//   tile gets p = 0 exactly (the multiplicative 0/1 mask after the exp), so
//   p, the row sums and o equal the per-image computation; l sums the fp32 p,
//   the P.V product takes p rounded to the input dtype, o = (P.V) * (1 / l)
//   in fp32. int8 output: the fp32 o of all heads of a row, never rounded to
//   the input dtype, s = max(max|o| / 127, 1e-12), codes
//   clip(rint(o * (1 / s)), +-127) with an exact reciprocal and a separately
//   rounded product (int8_common.cuh).
// What bounds it on the H100: bytes, far off. 4*N*dh flops per (row, head)
//   against 3*dh*2 bytes read put every shape here below the tensor cores'
//   ridge (N <= 256), so the least time is qkv read once and the output
//   written once: 0.0014 ms at p128's (256, 7680). A tile of 16 rows is
//   little work per head, so what the kernel waits for is latency: one
//   memory round trip, a short chain of products, and (int8) one exchange.
// What the design does about it (bfloat16, rows_attention_bf16; its plan in
// rows_attention.cuh):
//   * enough blocks: a block takes 16 flat rows (16/N whole images at N | 16
//     under the block-diagonal mask, so the 16-row MMA tiles are full) and
//     a few heads along grid.y (4 at 32 heads), one warp a head: 128 blocks
//     at p128's 256 rows, 8 at 4 rows;
//   * one memory round trip a head: the warp stages its head's Q tile and
//     the tile's keys' K and V ([first image's first row, last image's last
//     row), 16 keys at N = 4) by cp.async in one group into its own shared
//     memory, and never waits for another warp;
//   * everything in registers: Q by ldmatrix into mma.sync.m16n8k16 A
//     fragments, S = Q.K^T 16 keys at a time (K by ldmatrix), the mask and
//     the softmax on the accumulators, p packed to bf16 as the A fragment of
//     P.V (V by ldmatrix.trans), o accumulated in registers and written 16
//     bytes a lane. A row's sum is folded in ascending key order (the
//     first design's order: one fp32 sum over each chunk's first 32 keys,
//     one over the rest, added at the end) from its quad's registers by
//     shuffles, so the outputs equal the first design's bit for bit;
//   * int8 output: a row's scale needs every head, and the head groups of
//     one row tile are blocks of a thread-block cluster along grid.y (up to
//     16 blocks; more heads a block where 16 blocks of 2 do not cover
//     them). The warps' row maxima of |o| meet in shared memory, one warp
//     reduces them to the block's, a cluster barrier, each block reads
//     every rank's through distributed shared memory (exact: the scale does
//     not depend on the grouping), codes its own columns from registers;
//     rank 0 writes the scales. The
//     block arrives at a second cluster barrier once it has read the
//     others' maxima and waits on it after its stores, so that no block's
//     shared memory goes away while another reads it.
//   Above 16 tokens the tile's keys come in chunks of up to 64, staged one
//   at a time (the exact form stages K alone for its max pass); that is K7
//   and K8 past 32 heads, off the serving paths.
// float32: tensor cores would round to TF32, so the products run on the
//   CUDA cores (67 TFLOP/s). K7 and K8 from 33 tokens run on the fp32
//   attention forward's register-tiled body (flash_attention.cu,
//   attention_q8_f32_tiled) with the int8 row epilogue over a thread-block
//   cluster, as in bf16; the rest (K6, K9, K7 / K8 below 33 tokens) on
//   rows_attention_f32 here: the bf16 plan's tiles and head groups, a warp
//   a head staging its Q tile and the tile's keys by cp.async, scores and
//   P.V on register tiles (described at it). Both keep the first design's
//   order of every sum (a warp per (row, head) reading keys from device
//   memory), so their outputs equal it bit for bit; K8 at 33 tokens and
//   more and K9 at the same shape are therefore bit-identical too.
#include <cooperative_groups.h>
#include <stdint.h>

#include "attention_q8.cuh"
#include "common.cuh"
#include "int8_common.cuh"
#include "rows_attention.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int kTile = tae::rows::kTile;  // flat query rows of one block
constexpr int kMaxN = tae::rows::kMaxTokens;  // tokens per image (K7)
constexpr float kClipLo = -60.f, kClipHi = 45.f;  // _SOFTMAX_CLIP

// what a kernel instantiation computes
constexpr int kExact = 0;    // exact softmax, output of the input dtype
constexpr int kServing = 1;  // clamped softmax, output of the input dtype
constexpr int kQ8 = 2;       // clamped softmax, int8 output + per-row scales

template <int MODE>
__device__ __forceinline__ float softmax_p(float s, float mx) {
  return MODE == kExact ? expf(s - mx) : expf(fminf(fmaxf(s, kClipLo), kClipHi));
}

__host__ __device__ constexpr int pad16(int n) { return (n + 15) / 16 * 16; }

// ---------------------------------------------------------------- bfloat16

// Head rows [j0, j0 + nr) of one operand (src: its column block of the
// head) into rows of DH + 8 elements of dst, by 16-byte cp.async in the
// lane's current group; rows at or beyond `end` are zero.
template <int DH>
__device__ __forceinline__ void stage_rows(const bf16* __restrict__ src, long row_stride, int j0,
                                           int nr, int end, bf16* dst, int lane) {
  constexpr int LD = DH + 8, CH = DH / 8;  // CH: 16-byte pieces of a head row
  for (int idx = lane; idx < nr * CH; idx += 32) {
    const int rr = idx / CH, ch = idx - rr * CH;
    bf16* d = dst + rr * LD + ch * 8;
    if (j0 + rr < end)
      tae::cp_async16(d, src + (j0 + rr) * row_stride + ch * 8);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// S = Q K^T of the warp's 16 rows and the 16 staged keys at kl's rows:
// n-tile j holds keys 8j + 2t, +1 of rows g (s[j][0], s[j][1]) and g + 8
// (s[j][2], s[j][3]); the k-steps over dh in ascending order.
template <int DH>
__device__ __forceinline__ void score16(float (&s)[2][4], const unsigned (&qa)[DH / 16][4],
                                        const bf16* kl) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    unsigned b[4];
    tae::ldmatrix_x4(b, kl + kk * 16);
    tae::mma_bf16(s[0], qa[kk], b[0], b[1]);
    tae::mma_bf16(s[1], qa[kk], b[2], b[3]);
  }
}

// The warp's head for the block's 16 rows from r0 (keys [k_lo, k_hi) of
// the tile's images, `chunk` at a time): o = (P.V) * (1 / l) of rows g and
// g + 8 in the m16n8 C fragments, o[d] the columns 8d .. 8d + 7. head: the
// head's q columns in row 0; qs, ks, vs: the warp's shared memory.
template <int DH, int MODE>
__device__ __forceinline__ void attend_rows(const bf16* __restrict__ head, long row_stride, int c,
                                            int rows, int n, int r0, int k_lo, int k_hi,
                                            int chunk, float scale, bf16* qs, bf16* ks, bf16* vs,
                                            float (&o)[DH / 8][4]) {
  constexpr int LD = DH + 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool single = k_hi - k_lo <= chunk;  // every key staged once, with Q

  stage_rows<DH>(head, row_stride, r0, kTile, rows, qs, lane);
  if (single) {
    stage_rows<DH>(head + c, row_stride, k_lo, pad16(k_hi - k_lo), k_hi, ks, lane);
    stage_rows<DH>(head + 2 * c, row_stride, k_lo, pad16(k_hi - k_lo), k_hi, vs, lane);
  }
  tae::cp_async_commit();
  tae::wait_pending(0);
  __syncwarp();

  // Q's A fragments: lanes 8m .. 8m + 7 address matrix m's rows, (rows + 8
  // (m % 2), columns + 8 (m / 2)) of each 16-column step
  unsigned qa[DH / 16][4];
  const bf16* ql = qs + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) tae::ldmatrix_x4(qa[kk], ql + kk * 16);
  // K's B fragments (keys + 8 (m / 2), columns + 8 (m % 2)) and V's by
  // ldmatrix.trans (keys + 8 (m % 2), columns + 8 (m / 2)), as K2's
  const bf16* kl = ks + ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
  const bf16* vl = vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;

  // the keys of rows g, g + 8 are their own image's; a row past the end
  // keeps the tile's range (finite numbers, never written)
  int own_lo[2], own_hi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + g + 8 * i;
    own_lo[i] = r < rows ? r / n * n : k_lo;
    own_hi[i] = r < rows ? own_lo[i] + n : k_hi;
  }
  auto own = [&](int j, int i) { return j >= own_lo[i] && j < own_hi[i]; };
  // chunk c0's next K (and V) rows, where the tile's keys take more than one
  auto stage_chunk = [&](int c0, int kc, bool with_v) {
    __syncwarp();  // every lane has read the chunk staged before
    stage_rows<DH>(head + c, row_stride, c0, kc, k_hi, ks, lane);
    if (with_v) stage_rows<DH>(head + 2 * c, row_stride, c0, kc, k_hi, vs, lane);
    tae::cp_async_commit();
    tae::wait_pending(0);
    __syncwarp();
  };

  // exact form: a first pass finds each row's max over its own keys
  float mx[2] = {-INFINITY, -INFINITY};
  if (MODE == kExact) {
    for (int c0 = k_lo; c0 < k_hi; c0 += chunk) {
      const int kc = min(chunk, pad16(k_hi - c0));
      if (!single) stage_chunk(c0, kc, false);
      for (int kb = 0; kb < kc; kb += 16) {
        float s[2][4];
        score16<DH>(s, qa, kl + kb * LD);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (own(c0 + kb + 8 * j + 2 * t + (e & 1), e >> 1))
              mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e] * scale);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
  }

#pragma unroll
  for (int d = 0; d < DH / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  // l of rows g, g + 8: over each chunk's keys [0, 32) and [32, kc)
  float l_lo[2] = {0.f, 0.f}, l_hi[2] = {0.f, 0.f};
  // 16 keys from chunk offset kb: scores, p, the row sums, O += P V
  auto keys16 = [&](int c0, int kb, float (&l)[2]) {
    float s[2][4];
    score16<DH>(s, qa, kl + kb * LD);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = own(c0 + kb + 8 * j + 2 * t + (e & 1), e >> 1)
                      ? softmax_p<MODE>(s[j][e] * scale, mx[e >> 1])
                      : 0.f;
    // each row's 16 p in key order, lane by lane of its quad: every lane
    // folds the whole row, so the sum is one fp32 chain in ascending order
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int src = 0; src < 4; ++src)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int from = (lane & ~3) | src;
          const float a = __shfl_sync(0xffffffffu, s[j][e], from);
          const float b = __shfl_sync(0xffffffffu, s[j][2 + e], from);
          l[0] += a;
          l[1] += b;
        }
    const unsigned pa[4] = {tae::pack_bf16(s[0][0], s[0][1]), tae::pack_bf16(s[0][2], s[0][3]),
                            tae::pack_bf16(s[1][0], s[1][1]), tae::pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int dp = 0; dp < DH / 16; ++dp) {
      unsigned bv[4];
      tae::ldmatrix_x4_trans(bv, vl + kb * LD + dp * 16);
      tae::mma_bf16(o[2 * dp], pa, bv[0], bv[1]);
      tae::mma_bf16(o[2 * dp + 1], pa, bv[2], bv[3]);
    }
  };
  for (int c0 = k_lo; c0 < k_hi; c0 += chunk) {
    const int kc = min(chunk, pad16(k_hi - c0));
    if (!single) stage_chunk(c0, kc, true);
    for (int kb = 0; kb < min(kc, 32); kb += 16) keys16(c0, kb, l_lo);
    for (int kb = 32; kb < kc; kb += 16) keys16(c0, kb, l_hi);
  }
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) inv[i] = 1.f / (l_lo[i] + l_hi[i]);
#pragma unroll
  for (int d = 0; d < DH / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = __fmul_rn(o[d][e], inv[e >> 1]);
}

// The int8 output of a block: each warp's o (has_head: the warp has a
// head, h) scaled by one scale per row over every head of the row tile's
// cluster. pmax: (warps + 1, 16) floats of shared memory, each warp's
// partial row maxima and then the block's.
template <int DH>
__device__ __forceinline__ void q8_epilogue(const float (&o)[DH / 8][4], bool has_head, int h,
                                            int c, int rows, int r0, int8_t* __restrict__ out_q,
                                            float* __restrict__ out_s, float* pmax) {
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  // int8 output: the rows' max |o| over the warp's head, published ...
  cg::cluster_group cluster = cg::this_cluster();
  float amax[2] = {0.f, 0.f};
  if (has_head) {
#pragma unroll
    for (int d = 0; d < DH / 8; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) amax[e >> 1] = fmaxf(amax[e >> 1], fabsf(o[d][e]));
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    amax[i] = fmaxf(amax[i], __shfl_xor_sync(0xffffffffu, amax[i], 1));
    amax[i] = fmaxf(amax[i], __shfl_xor_sync(0xffffffffu, amax[i], 2));
  }
  if (t == 0) {
    pmax[warp * kTile + g] = amax[0];
    pmax[warp * kTile + g + 8] = amax[1];
  }
  __syncthreads();
  // ... over the block's heads, published to the cluster ...
  float* block_max = pmax + warps * kTile;
  if (warp == 0 && lane < kTile) {
    float m = 0.f;
    for (int w = 0; w < warps; ++w) m = fmaxf(m, pmax[w * kTile + lane]);
    block_max[lane] = m;
  }
  cluster.sync();  // every rank's block maxima are in its shared memory

  // ... and the max over every rank: lane t reads ranks t, t + 4, ...
  // through distributed shared memory, all reads in flight together
  const int ranks = gridDim.y;
  float m[2] = {0.f, 0.f};
#pragma unroll
  for (int k = 0; k < tae::rows::kMaxCluster / 4; ++k) {
    const int r = t + 4 * k;
    if (r < ranks) {
      const float* pm = cluster.map_shared_rank(block_max, r);
      m[0] = fmaxf(m[0], pm[g]);
      m[1] = fmaxf(m[1], pm[g + 8]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
    m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 2));
  }
  // done with the others' shared memory: arrive now, wait before exiting
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float s = tae::i8::quant_scale(m[i]);
    inv[i] = 1.0f / s;
    const int r = r0 + g + 8 * i;
    if (blockIdx.y == 0 && warp == 0 && t == 0 && r < rows) out_s[r] = s;
  }
  if (has_head) {
    int8_t* qbase = out_q + h * DH;
    tae::i8::store_c_codes<DH>(o, inv, [&](int half, int ch, uint4 w) {
      const int r = r0 + g + 8 * half;
      if (r < rows) *reinterpret_cast<uint4*>(qbase + static_cast<long>(r) * c + ch * 16) = w;
    });
  }
  // no block's shared memory goes away while another block reads it
  __syncwarp();
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// qkv: (rows, 3 * heads * DH), rows = B * n. out (MODE != kQ8): (rows, C)
// bf16; out_q, out_s (kQ8): (rows, C) int8 and (rows,) fp32. grid.x: tiles
// of 16 rows; grid.y: groups of heads_per_block heads, a warp each (the
// last group may leave warps without a head); kQ8: grid.y is one
// thread-block cluster. chunk: tae::rows::chunk_for(n).
template <int DH, int MODE>
__global__ void __launch_bounds__(tae::rows::kMaxHeadsPerBlock * 32)
rows_attention_bf16(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                    int8_t* __restrict__ out_q, float* __restrict__ out_s, int rows, int n,
                    int heads, int heads_per_block, int chunk, float scale) {
  constexpr int LD = DH + 8;
  const int c = heads * DH;
  const long row_stride = 3L * c;
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) >> 2;
  const int h = blockIdx.y * heads_per_block + warp;
  const bool has_head = h < heads;  // warp-uniform

  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int per_warp = tae::rows::warp_bytes(DH, chunk);
  bf16* qs = reinterpret_cast<bf16*>(smem_raw + warp * per_warp);  // (16, LD)
  bf16* ks = qs + kTile * LD;                                       // (chunk, LD)
  bf16* vs = ks + chunk * LD;                                       // (chunk, LD)
  float* pmax = reinterpret_cast<float*>(smem_raw + warps * per_warp);  // kQ8: (warps + 1, 16)

  // the tile's rows and the keys they can see: whole images
  const int r0 = blockIdx.x * kTile;
  const int r_last = min(r0 + kTile, rows) - 1;
  const int k_lo = r0 / n * n, k_hi = (r_last / n + 1) * n;

  float o[DH / 8][4];
  if (has_head)
    attend_rows<DH, MODE>(qkv + h * DH, row_stride, c, rows, n, r0, k_lo, k_hi, chunk, scale, qs,
                          ks, vs, o);

  if constexpr (MODE == kQ8) {
    q8_epilogue<DH>(o, has_head, h, c, rows, r0, out_q, out_s, pmax);
  } else if (has_head) {
    // o rounded to bf16, 16 bytes a lane (tae::store_c_rows)
    bf16* obase = out + h * DH;
    tae::store_c_rows<DH>(o, [&](int half, int ch, uint4 w) {
      const int r = r0 + g + 8 * half;
      if (r < rows) *reinterpret_cast<uint4*>(obase + static_cast<long>(r) * c + ch * 8) = w;
    });
  }
}

// ----------------------------------------------------------------- float32

// Head rows [j0, j0 + nr) of one fp32 operand into rows of DH + 4 floats of
// dst by 16-byte cp.async in the lane's current group; rows at or beyond
// `end` are zero.
template <int DH>
__device__ __forceinline__ void stage_rows_f32(const float* __restrict__ src, long row_stride,
                                               int j0, int nr, int end, float* dst, int lane) {
  constexpr int LD = DH + 4, CH = DH / 4;
  for (int idx = lane; idx < nr * CH; idx += 32) {
    const int rr = idx / CH, ch = idx - rr * CH;
    float* d = dst + rr * LD + ch * 4;
    if (j0 + rr < end)
      tae::cp_async16(d, src + (j0 + rr) * row_stride + ch * 4);
    else
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// The float32 form: qkv (rows, 3 * heads * DH) fp32, a block per 16 flat
// rows and heads_per_block heads along grid.y (the plan:
// tae::rows::plan_f32), a warp a head. The warp stages its head's Q tile
// and a window of keys (the tile's keys where they fit `chunk`, else one
// image's; K, V by cp.async into its own shared memory), then on the CUDA
// cores: lane l scores keys l and l + 32 of the window against all 16 rows
// (s sums fmaf(q_d, k_d) over d ascending and is scaled once), p goes to a
// (key, row) tile, 0 for keys of another image; each row's l is summed from
// that tile as the first design did (lane partials over its own keys lane +
// 32 t, then tae::warp_sum); P.V takes float2 output columns a lane for all
// 16 rows, one float4 of p per 4 rows and key, in ascending key order
// (another image's keys add exact zeros); o = (P.V) * (1 / l). So the
// outputs equal the first design's (a warp per (row, head) reading keys
// from device memory) bit for bit. The int8 output shares each row's max
// over the cluster as rows_attention_bf16 does.
//   Measured on an H100 80GB HBM3 at 700 W (bench/rows_body.py --dtype fp32,
// in turns with the variants named): K6 at p128's (64, 4, 7680) 0.0124 ms
// serving against the first design's 0.0526, K9 at 256 rows 0.0195 against
// 0.1892; of K6's exact form (0.0135) the scores take 0.0018 (f32_no_scores),
// P.V 0.0012 (f32_no_pv), staging K and V 0.0011 (f32_no_staging): the rest
// is a block's latency (K2 fp32 takes 0.0108 at the same shape).
template <int DH, int MODE>
__global__ void __launch_bounds__(tae::rows::kMaxHeadsPerBlock * 32)
rows_attention_f32(const float* __restrict__ qkv, float* __restrict__ out,
                   int8_t* __restrict__ out_q, float* __restrict__ out_s, int rows, int n,
                   int heads, int heads_per_block, int chunk, float scale) {
  constexpr int LD = DH + 4, LDP = tae::rows::kF32LdP;
  constexpr int C2 = DH / 2, C2L = (C2 + 31) / 32;  // float2 output columns, a lane's
  const int c = heads * DH;
  const long row_stride = 3L * c;
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.y * heads_per_block + warp;
  const bool has_head = h < heads;  // warp-uniform

  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int per_warp = tae::rows::f32_warp_bytes(DH, chunk);
  float* qs = reinterpret_cast<float*>(smem_raw + warp * per_warp);  // (16, LD)
  float* ks = qs + kTile * LD;                                       // (chunk, LD)
  float* vs = ks + chunk * LD;                                       // (chunk, LD)
  float* pt = vs + chunk * LD;                                       // (chunk, LDP)
  float* pmax = reinterpret_cast<float*>(smem_raw + warps * per_warp);  // kQ8: (warps + 1, 16)

  const int r0 = blockIdx.x * kTile;
  const int r_last = min(r0 + kTile, rows) - 1;
  const int k_lo = r0 / n * n, k_hi = (r_last / n + 1) * n;

  float2 acc[kTile][C2L];
  float l[kTile];
#pragma unroll
  for (int rr = 0; rr < kTile; ++rr) {
    l[rr] = 1.f;
#pragma unroll
    for (int k = 0; k < C2L; ++k) acc[rr][k] = make_float2(0.f, 0.f);
  }
  if (has_head) {
    const float* head = qkv + h * DH;
    const bool single = k_hi - k_lo <= chunk;  // else one window an image
    const int windows = single ? 1 : (k_hi - k_lo) / n;
    for (int w = 0; w < windows; ++w) {
      const int w_lo = single ? k_lo : k_lo + w * n, wn = single ? k_hi - k_lo : n;
      __syncwarp();  // every lane is done with the last window
      if (w == 0) stage_rows_f32<DH>(head, row_stride, r0, kTile, rows, qs, lane);
      stage_rows_f32<DH>(head + c, row_stride, w_lo, wn, k_hi, ks, lane);
      stage_rows_f32<DH>(head + 2 * c, row_stride, w_lo, wn, k_hi, vs, lane);
      tae::cp_async_commit();
      tae::wait_pending(0);
      __syncwarp();

      // scores of keys lane, lane + 32 against the 16 rows
      const bool two = wn > 32;  // warp-uniform
      float s[2][kTile];
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int rr = 0; rr < kTile; ++rr) s[t][rr] = 0.f;
      const int kr0 = min(lane, chunk - 1), kr1 = min(lane + 32, chunk - 1);
#pragma unroll 4
      for (int d = 0; d < DH; d += 4) {
        const float4 k0 = *reinterpret_cast<const float4*>(ks + kr0 * LD + d);
        const float4 k1 = two ? *reinterpret_cast<const float4*>(ks + kr1 * LD + d) : k0;
#pragma unroll
        for (int rr = 0; rr < kTile; ++rr) {
          const float4 x = *reinterpret_cast<const float4*>(qs + rr * LD + d);
          float a0 = s[0][rr];
          a0 = fmaf(x.x, k0.x, a0);
          a0 = fmaf(x.y, k0.y, a0);
          a0 = fmaf(x.z, k0.z, a0);
          a0 = fmaf(x.w, k0.w, a0);
          s[0][rr] = a0;
          if (two) {
            float a1 = s[1][rr];
            a1 = fmaf(x.x, k1.x, a1);
            a1 = fmaf(x.y, k1.y, a1);
            a1 = fmaf(x.z, k1.z, a1);
            a1 = fmaf(x.w, k1.w, a1);
            s[1][rr] = a1;
          }
        }
      }
      // the mask: row r0 + rr sees keys [own, own + n) of its image
#pragma unroll
      for (int rr = 0; rr < kTile; ++rr) {
        const int r = r0 + rr, own = r / n * n;
        bool in[2];
        float mx = -INFINITY;
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int key = w_lo + lane + 32 * t;
          in[t] = r < rows && lane + 32 * t < wn && key >= own && key < own + n;
          s[t][rr] = s[t][rr] * scale;
          if (in[t]) mx = fmaxf(mx, s[t][rr]);
        }
        if (MODE == kExact) mx = tae::warp_max(mx);
#pragma unroll
        for (int t = 0; t < 2; ++t)
          if (lane + 32 * t < chunk)
            pt[(lane + 32 * t) * LDP + rr] = in[t] ? softmax_p<MODE>(s[t][rr], mx) : 0.f;
      }
      __syncwarp();
      // l of the rows whose image is this window's, in the first design's order
#pragma unroll
      for (int rr = 0; rr < kTile; ++rr) {
        const int r = r0 + rr, own = r / n * n;
        if (r < rows && own >= w_lo && own < w_lo + wn) {  // warp-uniform
          const float* pc = pt + (own - w_lo) * LDP + rr;
          float lp = lane < n ? pc[lane * LDP] : 0.f;
          if (n > 32) lp += lane + 32 < n ? pc[(lane + 32) * LDP] : 0.f;
          l[rr] = tae::warp_sum(lp);
        }
      }
      // P.V over the window's keys, ascending
#pragma unroll 2
      for (int kw = 0; kw < wn; ++kw) {
        float pr[kTile];
#pragma unroll
        for (int q = 0; q < kTile / 4; ++q) {
          const float4 p4 = *reinterpret_cast<const float4*>(pt + kw * LDP + 4 * q);
          pr[4 * q] = p4.x;
          pr[4 * q + 1] = p4.y;
          pr[4 * q + 2] = p4.z;
          pr[4 * q + 3] = p4.w;
        }
#pragma unroll
        for (int k = 0; k < C2L; ++k) {
          const int cc = lane + 32 * k;
          if (cc < C2) {
            const float2 vv = *reinterpret_cast<const float2*>(vs + kw * LD + 2 * cc);
#pragma unroll
            for (int rr = 0; rr < kTile; ++rr) {
              acc[rr][k].x = fmaf(pr[rr], vv.x, acc[rr][k].x);
              acc[rr][k].y = fmaf(pr[rr], vv.y, acc[rr][k].y);
            }
          }
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < kTile; ++rr) {
      const float inv = 1.f / l[rr];
#pragma unroll
      for (int k = 0; k < C2L; ++k) {
        acc[rr][k].x = __fmul_rn(acc[rr][k].x, inv);
        acc[rr][k].y = __fmul_rn(acc[rr][k].y, inv);
      }
    }
  }

  if constexpr (MODE == kQ8) {
    // each row's max |o| over the warp's head, lane rr holding row rr's ...
    cg::cluster_group cluster = cg::this_cluster();
    float mine = 0.f;
#pragma unroll
    for (int rr = 0; rr < kTile; ++rr) {
      float m = 0.f;
      if (has_head && r0 + rr < rows)
#pragma unroll
        for (int k = 0; k < C2L; ++k)
          if (lane + 32 * k < C2) m = fmaxf(m, fmaxf(fabsf(acc[rr][k].x), fabsf(acc[rr][k].y)));
      m = tae::warp_max(m);
      if (lane == rr) mine = m;
    }
    if (lane < kTile) pmax[warp * kTile + lane] = mine;
    __syncthreads();
    // ... over the block's heads, published to the cluster ...
    float* block_max = pmax + warps * kTile;
    if (warp == 0 && lane < kTile) {
      float m = 0.f;
      for (int w = 0; w < warps; ++w) m = fmaxf(m, pmax[w * kTile + lane]);
      block_max[lane] = m;
    }
    cluster.sync();  // the block maxima of every rank are in its shared memory
    // ... and over every rank: lane rr takes row rr
    const int ranks = gridDim.y;
    float inv = 0.f;
    if (lane < kTile) {
      float m = 0.f;
      for (int r = 0; r < ranks; ++r) m = fmaxf(m, cluster.map_shared_rank(block_max, r)[lane]);
      const float sc = tae::i8::quant_scale(m);
      inv = 1.0f / sc;
      if (blockIdx.y == 0 && warp == 0 && r0 + lane < rows) out_s[r0 + lane] = sc;
    }
    // done with the others' shared memory: arrive now, wait before exiting
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
#pragma unroll
    for (int rr = 0; rr < kTile; ++rr) {
      const float ir = __shfl_sync(0xffffffffu, inv, rr);
      const int r = r0 + rr;
      if (has_head && r < rows) {
        int8_t* q = out_q + static_cast<long>(r) * c + h * DH;
#pragma unroll
        for (int k = 0; k < C2L; ++k) {
          const int cc = lane + 32 * k;
          if (cc < C2) {
            const unsigned lo = static_cast<unsigned>(tae::i8::quantize1(acc[rr][k].x, ir)) & 0xffu;
            const unsigned hi = static_cast<unsigned>(tae::i8::quantize1(acc[rr][k].y, ir)) & 0xffu;
            *reinterpret_cast<unsigned short*>(q + 2 * cc) =
                static_cast<unsigned short>(lo | (hi << 8));
          }
        }
      }
    }
    // no block's shared memory goes away while another block reads it
    __syncwarp();
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
  } else if (has_head) {
#pragma unroll
    for (int rr = 0; rr < kTile; ++rr) {
      const int r = r0 + rr;
      if (r < rows) {
        float* orow = out + static_cast<long>(r) * c + h * DH;
#pragma unroll
        for (int k = 0; k < C2L; ++k) {
          const int cc = lane + 32 * k;
          if (cc < C2) tae::store2(orow + 2 * cc, acc[rr][k].x, acc[rr][k].y);
        }
      }
    }
  }
}

// ---------------------------------------------------------------- launchers

// rows_attention_bf16<DH, MODE> with p's shape: the attributes it needs,
// set once per instantiation (the shared-memory limit raised as launches
// need), and the launch configuration, with a cluster along grid.y for the
// int8 output.
template <int DH, int MODE>
cudaError_t rows_config(const tae::rows::Plan& p, int rows, cudaStream_t stream,
                        cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr) {
  auto* kernel = rows_attention_bf16<DH, MODE>;
  static bool prepared = false;
  static int smem_allowed = 48 * 1024;
  if (!prepared && MODE == kQ8) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  prepared = true;
  if (p.smem > smem_allowed) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return err;
    smem_allowed = p.smem;
  }
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3((rows + kTile - 1) / kTile, p.groups);
  cfg.blockDim = dim3(32 * p.heads_per_block);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = p.cluster;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = MODE == kQ8 ? 1 : 0;
  return cudaSuccess;
}

template <int DH, int MODE>
int launch_bf16(const tae::rows::Plan& p, const void* qkv, void* out, void* out_q, void* out_s,
                int rows, int n, int heads, float scale, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = rows_config<DH, MODE>(p, rows, stream, cfg, attr);
  if (err == cudaSuccess)
    err = cudaLaunchKernelEx(&cfg, rows_attention_bf16<DH, MODE>, static_cast<const bf16*>(qkv),
                             static_cast<bf16*>(out), static_cast<int8_t*>(out_q),
                             static_cast<float*>(out_s), rows, n, heads, p.heads_per_block,
                             p.chunk, scale);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// How many clusters (int8 output) or blocks of p's shape the card holds at
// once (0: none fits).
template <int DH, int MODE>
int rows_at_once(const tae::rows::Plan& p, int& units) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = rows_config<DH, MODE>(p, kTile, nullptr, cfg, attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (MODE == kQ8)
    return static_cast<int>(
        cudaOccupancyMaxActiveClusters(&units, rows_attention_bf16<DH, MODE>, &cfg));
  int per_sm = 0, device = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rows_attention_bf16<DH, MODE>,
                                                      32 * p.heads_per_block, p.smem);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  units = per_sm * sms;
  return static_cast<int>(err);
}

// rows_attention_f32<DH, MODE> with p's shape (tae::rows::plan_f32), as
// rows_config.
template <int DH, int MODE>
cudaError_t rows_f32_config(const tae::rows::Plan& p, int rows, cudaStream_t stream,
                            cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr) {
  auto* kernel = rows_attention_f32<DH, MODE>;
  static bool prepared = false;
  static int smem_allowed = 48 * 1024;
  if (!prepared && MODE == kQ8) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  prepared = true;
  if (p.smem > smem_allowed) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return err;
    smem_allowed = p.smem;
  }
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3((rows + kTile - 1) / kTile, p.groups);
  cfg.blockDim = dim3(32 * p.heads_per_block);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = p.cluster;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = MODE == kQ8 ? 1 : 0;
  return cudaSuccess;
}

template <int DH, int MODE>
int launch_f32(const tae::rows::Plan& p, const void* qkv, void* out, void* out_q, void* out_s,
               int rows, int n, int heads, float scale, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = rows_f32_config<DH, MODE>(p, rows, stream, cfg, attr);
  if (err == cudaSuccess)
    err = cudaLaunchKernelEx(&cfg, rows_attention_f32<DH, MODE>, static_cast<const float*>(qkv),
                             static_cast<float*>(out), static_cast<int8_t*>(out_q),
                             static_cast<float*>(out_s), rows, n, heads, p.heads_per_block,
                             p.chunk, scale);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// How many clusters (int8 output) or blocks of p's fp32 shape the card
// holds at once (0: none fits).
template <int DH, int MODE>
int rows_f32_at_once(const tae::rows::Plan& p, int& units) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = rows_f32_config<DH, MODE>(p, kTile, nullptr, cfg, attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (MODE == kQ8)
    return static_cast<int>(
        cudaOccupancyMaxActiveClusters(&units, rows_attention_f32<DH, MODE>, &cfg));
  int per_sm = 0, device = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rows_attention_f32<DH, MODE>,
                                                      32 * p.heads_per_block, p.smem);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  units = per_sm * sms;
  return static_cast<int>(err);
}

template <int DH, int MODE>
int launch_dtype(const void* qkv, void* out, void* out_q, void* out_s, int rows, int n,
                 int heads, float scale, int dtype, cudaStream_t stream) {
  if (dtype == tae::kBFloat16) {
    tae::rows::Plan p;
    if (!tae::rows::plan(n, heads, DH, MODE == kQ8, p))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_bf16<DH, MODE>(p, qkv, out, out_q, out_s, rows, n, heads, scale, stream);
  }
  if (dtype == tae::kFloat32) {
    tae::rows::Plan p;
    if (!tae::rows::plan_f32(n, heads, DH, MODE == kQ8, p))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_f32<DH, MODE>(p, qkv, out, out_q, out_s, rows, n, heads, scale, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int MODE>
int launch_rows(const void* qkv, void* out, void* out_q, void* out_s, long rows, int n,
                int max_n, int heads, int dh, float scale, int dtype, void* stream) {
  // rows and its 16-row tiles are ints; heads * dh columns, grid.y <= 65535
  if (n < 1 || n > max_n || rows < 1 || rows % n || rows > (1L << 30) || heads < 1 ||
      heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int r = static_cast<int>(rows);
  if (dh == 64)
    return launch_dtype<64, MODE>(qkv, out, out_q, out_s, r, n, heads, scale, dtype, s);
  if (dh == 80)
    return launch_dtype<80, MODE>(qkv, out, out_q, out_s, r, n, heads, scale, dtype, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

constexpr int kWideMaxN = 64;  // tokens per image of the wide entries

// K7 and K8: in bf16, from tae::q8::kMinTokens tokens and where its shared
// memory holds the heads a block buffers, the attention forward body of
// flash_attention.cu with the row epilogue shared over a thread-block
// cluster; otherwise (fewer tokens, more heads, float32) the flat-row body
// here.
int launch_q8(const void* qkv, void* out_q, void* out_s, int batch, int n, int max_n, int heads,
              int dh, float scale, int dtype, void* stream) {
  tae::q8::Plan p;
  if (dtype == tae::kBFloat16 && n <= max_n && tae::q8::plan(n, heads, dh, p))
    return tae::q8::launch(p, qkv, out_q, out_s, batch, n, heads, dh, scale, stream);
  if (dtype == tae::kFloat32 && n <= max_n && tae::q8::plan_f32(n, heads, dh, p))
    return tae::q8::launch_f32(p, qkv, out_q, out_s, batch, n, heads, dh, scale, stream);
  return launch_rows<kQ8>(qkv, nullptr, out_q, out_s, static_cast<long>(batch) * n, n, max_n,
                          heads, dh, scale, dtype, stream);
}

template <int MODE>
int rows_at_once_dh(const tae::rows::Plan& p, int dh, int& units) {
  return dh == 64 ? rows_at_once<64, MODE>(p, units) : rows_at_once<80, MODE>(p, units);
}

template <int MODE>
int rows_f32_at_once_dh(const tae::rows::Plan& p, int dh, int& units) {
  return dh == 64 ? rows_f32_at_once<64, MODE>(p, units) : rows_f32_at_once<80, MODE>(p, units);
}

}  // namespace

// K6. qkv: (batch, n, 3 * heads * dh) contiguous; out: (batch, n, heads * dh)
// of the same dtype; n <= 64.
extern "C" int tae_wide_attention_fwd(const void* qkv, void* out, int batch, int n, int heads,
                                      int dh, float scale, int serving, int dtype,
                                      void* stream) {
  const long rows = static_cast<long>(batch) * n;
  return serving ? launch_rows<kServing>(qkv, out, nullptr, nullptr, rows, n, kWideMaxN, heads,
                                         dh, scale, dtype, stream)
                 : launch_rows<kExact>(qkv, out, nullptr, nullptr, rows, n, kWideMaxN, heads,
                                       dh, scale, dtype, stream);
}

// K7. qkv as above with n <= 256; out_q: (batch, n, heads * dh) int8; out_s:
// (batch, n, 1) fp32.
extern "C" int tae_packed_attention_q8_fwd(const void* qkv, void* out_q, void* out_s,
                                           int batch, int n, int heads, int dh, float scale,
                                           int dtype, void* stream) {
  return launch_q8(qkv, out_q, out_s, batch, n, kMaxN, heads, dh, scale, dtype, stream);
}

// K8. As K7 with n <= 64.
extern "C" int tae_wide_attention_q8_fwd(const void* qkv, void* out_q, void* out_s, int batch,
                                         int n, int heads, int dh, float scale, int dtype,
                                         void* stream) {
  return launch_q8(qkv, out_q, out_s, batch, n, kWideMaxN, heads, dh, scale, dtype, stream);
}

// K9. qkv2: (rows, 3 * heads * dh) flat token rows of rows / n images; out_q:
// (rows, heads * dh) int8; out_s: (rows, 1) fp32; n <= 64.
extern "C" int tae_wide_attention_q8_2d_fwd(const void* qkv2, void* out_q, void* out_s,
                                            int rows, int n, int heads, int dh, float scale,
                                            int dtype, void* stream) {
  return launch_rows<kQ8>(qkv2, nullptr, out_q, out_s, rows, n, kWideMaxN, heads, dh, scale,
                          dtype, stream);
}

// The plan of the flat-row body in bf16 for (n, heads, dh), with the int8
// output (q8 != 0: K9, and K7 / K8 where they run here) or a bf16 one (K6):
// out[0] 1 where the body takes the shape (else 0, and nothing more is
// written), out[1..5] cluster, head groups, heads per block, keys per
// chunk, shared memory bytes, out[6] the clusters (q8) or blocks the card
// holds at once.
extern "C" int tae_rows_attention_plan(int n, int heads, int dh, int q8, int* out) {
  tae::rows::Plan p;
  out[0] = tae::rows::plan(n, heads, dh, q8 != 0, p) ? 1 : 0;
  if (!out[0]) return 0;
  out[1] = p.cluster;
  out[2] = p.groups;
  out[3] = p.heads_per_block;
  out[4] = p.chunk;
  out[5] = p.smem;
  return q8 ? rows_at_once_dh<kQ8>(p, dh, out[6]) : rows_at_once_dh<kServing>(p, dh, out[6]);
}

// The plan of the flat-row body in float32 (tae::rows::plan_f32), as
// tae_rows_attention_plan.
extern "C" int tae_rows_attention_f32_plan(int n, int heads, int dh, int q8, int* out) {
  tae::rows::Plan p;
  out[0] = tae::rows::plan_f32(n, heads, dh, q8 != 0, p) ? 1 : 0;
  if (!out[0]) return 0;
  out[1] = p.cluster;
  out[2] = p.groups;
  out[3] = p.heads_per_block;
  out[4] = p.chunk;
  out[5] = p.smem;
  return q8 ? rows_f32_at_once_dh<kQ8>(p, dh, out[6])
            : rows_f32_at_once_dh<kServing>(p, dh, out[6]);
}
