// K10, K17 — attention backward, one device body for two layouts.
//
// Replaces:
//   K10 tae_tpu/ops/pallas/flash_attention.py::_packed_vjp_bwd
//       (_packed_bwd_kernel_stacked, _packed_bwd_kernel). From the packed qkv
//       (B, N, 3C), the saved output o (B, N, C), the saved lse (B, H, N) fp32
//       and the output's gradient do (B, N, C) it writes dqkv (B, N, 3C),
//       every element exactly once, heads as contiguous dh-column slices as
//       in qkv.
//   K17 flash_attention.py::_flash_bwd (_bwd_kernel): the same from
//       unpacked q, k, v, o, do (B, H, N, dh), each with its own (image,
//       head, row) strides, to dq, dk, dv (B, H, N, dh). The JAX body runs
//       every product in fp32; in bfloat16 this one rounds P and dS as below
//       (the plain version and chip_smoke.py hold it to the fp32 form).
// Numerics, per (image, head): S = Q.K^T * scale and dP = dO.V^T with fp32
//   accumulation; P = exp(S - lse) (the accurate expf); delta = rowsum(dO *
//   o) from the saved, rounded o; dS = P * (dP - delta) * scale, from the
//   fp32 P; dV = P^T.dO, dQ = dS.K, dK = dS^T.Q, each rounded once to the
//   input dtype. In bfloat16 the tensor cores take P and dS rounded to
//   bfloat16 ahead of those three products (as the forward rounds p ahead of
//   P.V). In float32 nothing is rounded.
// What bounds it on the H100: the seven N x N x dh products per head (five of
//   the formula, S and dP formed twice, see below) against tensor-core and
//   shared-memory throughput, and the accurate expf of 2 N^2 scores; its
//   bytes (qkv, o, do in, dqkv out) take 0.080 ms at the main path's shape
//   (B 64, N 256, 16 heads of 64), its 60 GFLOP 0.061 ms at the dense rate.
// What the design does about it: dK and dV sum over query rows, dQ over keys.
//   A CUDA grid has no sequential axis to carry such sums and float atomics
//   would change bits from run to run, so every output row has one writer,
//   a warp, and every sum runs in a fixed order: two runs are bit-equal.
//   * bfloat16: a head is split over blocks by role and by row range. The
//     grid is (role x range, head, image), role and range fastest, so that a
//     head's blocks run together and share its operands in L2. A block takes
//     up to kTcWarps (8) warps of 16 rows; a head of N tokens has
//     ceil(N / 128) ranges per role, the tiles dealt evenly (`partition`).
//     At N <= 16 a block is one warp.
//     - dK/dV blocks own a range of keys. They stage all of the head's Q and
//       dO in shared memory (rows padded by 8 elements, so that ldmatrix of 8
//       rows hits 8 distinct 16-byte bank groups) by 16-byte cp.async, one
//       commit group per 64 rows, so that the first rows' products start
//       while later ones land, and lse and delta per query beside them
//       (delta from 16-byte loads of o and dO, a quad of lanes a row). A
//       warp owns 16 keys: its K and V rows, staged beside them, are A
//       fragments of mma.sync.m16n8k16 read by ldmatrix on every query tile
//       (held in registers instead they spilled at dh 80, where dK and dV
//       take 80 registers a lane, and ran slower at dh 64). Per 16-query
//       tile, S^T = K.Q^T and dP^T = V.dO^T
//       (B fragments by ldmatrix of Q and dO) land in C fragments, P^T and
//       dS^T are formed there (lse and delta indexed by column), packed to
//       bf16 and become the A fragments of dV += P^T.dO and dK += dS^T.Q (B
//       by ldmatrix.trans of dO and Q). dK and dV accumulate in registers.
//     - dQ blocks own a range of query rows and stage all of K and V the
//       same way. A warp owns 16 query rows: Q and dO are A fragments read
//       once from device memory (one 16-byte load a lane and a quad
//       transpose; delta of its rows from the same loads of dO), lse and
//       delta of its rows stay in registers. Per 16-key tile, S and dP
//       against K and V by ldmatrix, dS packed to bf16 becomes the A
//       fragment of dQ += dS.K (K by ldmatrix.trans).
//     Forming S and dP in both roles costs 7 N^2 dh products in place of 5:
//     the price of one writer per row without a reduction across blocks.
//     Only the last, ragged tile masks (p = 0 for queries, or keys, at or
//     beyond n); nothing is written beyond n. Outputs leave as one 16-byte
//     store a lane after a quad transpose. No WMMA, no per-warp scratch.
//   * float32: CUDA cores, fp32 throughout (the tensor cores would round to
//     TF32). From kF32TiledMinTokens tokens the register-tiled body
//     (attention_bwd_f32_tiled, described at it) forms S and dP once per
//     (query, key): the formula's 5 N^2 dh products. Below, the first
//     design (attention_bwd_f32): K and V staged for the dQ phase (a warp
//     per query row, a lane per key), then Q and dO in their place for the
//     dK / dV phase (a warp per key, a lane per query row), S and dP formed
//     in both (7 products). Both sum in the same order, so their outputs
//     are equal bit for bit.
//   wgmma and TMA are later work.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using tae::HeadLayout;

constexpr int kMaxN = 256;  // tokens supported (a block stages a whole head)
constexpr int kWarps = 8;   // warps of the float32 body

__host__ __device__ constexpr int pad16(int n) { return (n + 15) / 16 * 16; }

// The operands of one launch: pointers to the first element of each tensor
// and each one's layout (tae::HeadLayout).
template <typename T>
struct BwdArgs {
  const T* q;
  const T* k;
  const T* v;
  const T* o;
  const T* dout;
  T* dq;
  T* dk;
  T* dv;
  const float* lse;  // (batch, heads, n), contiguous
  HeadLayout lq, lk, lv, lo, ldo, ldq, ldk, ldv;
  int n, heads;
  float scale;
};

// ---------------------------------------------------------------- bfloat16

constexpr int kTcWarps = 8;  // most warps (16-row tiles) in a block
constexpr int kRC = 64;      // rows per cp.async commit group

template <int DH> __host__ __device__ constexpr int tc_ld() { return DH + 8; }

// Row ranges per role and warps (16-row tiles) per block for n tokens: at
// most kTcWarps tiles a range, the tiles dealt evenly over the ranges.
struct Partition {
  int ranges, warps;
};
__host__ __device__ inline Partition partition(int n) {
  const int tiles = pad16(n) / 16;
  const int ranges = (tiles + kTcWarps - 1) / kTcWarps;
  return {ranges, (tiles + ranges - 1) / ranges};
}

// Dynamic shared memory of a block: two staged (np, LD) operands (dQ: K and
// V; dK/dV: Q and dO), and for dK/dV lse and delta per query and the K and
// V rows of the block's keys.
template <int DH>
size_t tc_smem_bytes(int n) {
  const size_t np = pad16(n), ld = tc_ld<DH>();
  const size_t own = 2 * static_cast<size_t>(partition(n).warps) * 16 * ld;
  return sizeof(bf16) * (2 * np * ld + own) + sizeof(float) * 2 * np;
}

// Rows [r0, r1) of two operands (src0, src1 with row strides st0, st1) into
// shared memory (row stride LD) by 16-byte cp.async; rows at or beyond
// `valid` are zeroed. The caller commits the group.
template <int DH>
__device__ __forceinline__ void stage_rows(bf16* dst0, const bf16* src0, long long st0,
                                           bf16* dst1, const bf16* src1, long long st1,
                                           int r0, int r1, int valid) {
  constexpr int LD = tc_ld<DH>(), CH = DH / 8;
  for (int idx = threadIdx.x; idx < (r1 - r0) * CH; idx += blockDim.x) {
    const int r = r0 + idx / CH, ch = idx % CH;
    bf16* d0 = dst0 + r * LD + ch * 8;
    bf16* d1 = dst1 + r * LD + ch * 8;
    if (r < valid) {
      tae::cp_async16(d0, src0 + r * st0 + ch * 8);
      tae::cp_async16(d1, src1 + r * st1 + ch * 8);
    } else {
      *reinterpret_cast<uint4*>(d0) = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(d1) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// acc + the dot product of two 16-byte chunks of bf16, in element order.
__device__ __forceinline__ float dot8(uint4 x, uint4 y, float acc) {
  const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 fa = __bfloat1622float2(a[k]), fb = __bfloat1622float2(b[k]);
    acc = fmaf(fa.x, fb.x, acc);
    acc = fmaf(fa.y, fb.y, acc);
  }
  return acc;
}

// The sum of a row's partial sums over the four lanes of its quad.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// The S (or S^T) and dP (or dP^T) tiles of 16 rows against 16 staged rows:
// c[j] holds columns 8j + 2t, +1 of rows g (c[j][0], c[j][1]) and g + 8
// (c[j][2], c[j][3]). afrag(kk, which, a) gives the A fragment of k-step kk
// of the warp's first (which 0) or second operand; bl0, bl1: this lane's
// ldmatrix shared-memory address in the two staged operands at the tile's
// first row (b_addr). One
// product at a time, so that one A and one B fragment are live.
template <int DH, typename AFrag>
__device__ __forceinline__ void two_scores(float (&s)[2][4], float (&dp)[2][4], AFrag afrag,
                                           unsigned bl0, unsigned bl1) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    unsigned a[4], b[4];
    afrag(kk, 0, a);
    tae::ldmatrix_x4_at(b, bl0 + kk * 32);
    tae::mma_bf16(s[0], a, b[0], b[1]);
    tae::mma_bf16(s[1], a, b[2], b[3]);
    afrag(kk, 1, a);
    tae::ldmatrix_x4_at(b, bl1 + kk * 32);
    tae::mma_bf16(dp[0], a, b[0], b[1]);
    tae::mma_bf16(dp[1], a, b[2], b[3]);
  }
}

// acc[d] += a . B for the 16 staged rows at bt (this lane's ldmatrix.trans
// shared-memory address at the tile's first row, a_addr): the (16, DH)
// product of an m16n8k16 A fragment and 16 rows of an operand.
template <int DH>
__device__ __forceinline__ void accumulate(float (&acc)[DH / 8][4], const unsigned (&a)[4],
                                           unsigned bt) {
#pragma unroll
  for (int dp = 0; dp < DH / 16; ++dp) {
    unsigned b[4];
    tae::ldmatrix_x4_trans_at(b, bt + dp * 32);
    tae::mma_bf16(acc[2 * dp], a, b[0], b[1]);
    tae::mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
  }
}

// p and dS of one C fragment element: s and dp the raw products, l and dl
// the lse and delta of its query.
__device__ __forceinline__ void p_ds(float s, float dp, float l, float dl, float scale, float& p,
                                     float& ds) {
  p = expf(s * scale - l);
  ds = p * (dp - dl) * scale;
}

// The A fragment of two C fragments packed to bf16 (m16n8k16: columns
// 0..7 in c[0], 8..15 in c[1]).
__device__ __forceinline__ void pack_a(unsigned (&a)[4], const float (&c)[2][4]) {
  a[0] = tae::pack_bf16(c[0][0], c[0][1]);
  a[1] = tae::pack_bf16(c[0][2], c[0][3]);
  a[2] = tae::pack_bf16(c[1][0], c[1][1]);
  a[3] = tae::pack_bf16(c[1][2], c[1][3]);
}

template <int DH>
__device__ __forceinline__ void zero(float (&acc)[DH / 8][4]) {
#pragma unroll
  for (int d = 0; d < DH / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
}

// Lane l's ldmatrix_x4 shared-memory address in 16 staged rows from `base`
// (lane l gives row l % 8 of matrix l / 8). b_addr: rows + 8 (l / 16), columns + 8
// ((l / 8) % 2), the B fragments of two n-tiles (rows 0..7 in b[0..1], 8..15
// in b[2..3]) of a product over the columns. a_addr: rows + 8 ((l / 8) % 2),
// columns + 8 (l / 16), the A fragment of those rows, and with .trans the B
// fragments of two 8-column n-tiles of a product over the rows.
template <int DH>
__device__ __forceinline__ unsigned b_addr(const bf16* base, int lane) {
  return tae::smem_addr(base + ((lane & 7) + ((lane >> 4) << 3)) * tc_ld<DH>() +
                        ((lane >> 3) & 1) * 8);
}
template <int DH>
__device__ __forceinline__ unsigned a_addr(const bf16* base, int lane) {
  return tae::smem_addr(base + ((lane & 7) + ((lane >> 3) & 1) * 8) * tc_ld<DH>() +
                        (lane >> 4) * 8);
}

// dK/dV block: keys of tiles [range * warps, (range + 1) * warps).
template <int DH>
__device__ __forceinline__ void dkdv_block(const BwdArgs<bf16>& a, int b, int h, int range,
                                           unsigned char* smem) {
  constexpr int LD = tc_ld<DH>(), RB = 2 * LD, CH = DH / 8, QG = (CH + 3) / 4;
  const int n = a.n, np = pad16(n), chunks = (np + kRC - 1) / kRC;
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kbase = range * warps * 16;  // the block's first key
  bf16* qs = reinterpret_cast<bf16*>(smem);  // (np, LD) each
  bf16* dos = qs + np * LD;
  bf16* kown = dos + np * LD;  // (warps * 16, LD) each: the block's keys
  bf16* vown = kown + warps * 16 * LD;
  float* lse_s = reinterpret_cast<float*>(vown + warps * 16 * LD);
  float* delta_s = lse_s + np;

  const bf16* qb = a.q + a.lq.at(b, h);
  const bf16* kb = a.k + a.lk.at(b, h);
  const bf16* vb = a.v + a.lv.at(b, h);
  const bf16* ob = a.o + a.lo.at(b, h);
  const bf16* dob = a.dout + a.ldo.at(b, h);
  for (int c = 0; c < chunks; ++c) {
    if (c == 0)
      stage_rows<DH>(kown, kb + kbase * a.lk.row, a.lk.row, vown, vb + kbase * a.lv.row,
                     a.lv.row, 0, warps * 16, n - kbase);
    stage_rows<DH>(qs, qb, a.lq.row, dos, dob, a.ldo.row, c * kRC, min(np, (c + 1) * kRC), n);
    tae::cp_async_commit();
  }
  // lse and delta of every query, a quad of lanes a row
  for (int r = warp * 8 + g; r < np; r += warps * 8) {
    float sum = 0.f;
    if (r < n) {
#pragma unroll
      for (int q = 0; q < QG; ++q) {
        const int ch = 4 * q + t;
        if (ch < CH)
          sum = dot8(*reinterpret_cast<const uint4*>(dob + r * a.ldo.row + ch * 8),
                     *reinterpret_cast<const uint4*>(ob + r * a.lo.row + ch * 8), sum);
      }
    }
    sum = quad_sum(sum);
    if (t == 0) {
      delta_s[r] = sum;
      lse_s[r] = r < n ? a.lse[(static_cast<long>(b) * a.heads + h) * n + r] : 0.f;
    }
  }

  const int j0 = kbase + warp * 16;  // the warp's first key
  const bool active = j0 < n;
  // K and V rows as A fragments, by ldmatrix from the staged rows
  const unsigned kl = a_addr<DH>(kown + warp * 16 * LD, lane);
  const unsigned vl = a_addr<DH>(vown + warp * 16 * LD, lane);
  auto afrag = [&](int kk, int which, unsigned (&x)[4]) {
    tae::ldmatrix_x4_at(x, (which ? vl : kl) + kk * 32);
  };

  float dk[DH / 8][4], dv[DH / 8][4];
  zero<DH>(dk);
  zero<DH>(dv);
  const unsigned qbl = b_addr<DH>(qs, lane), dobl = b_addr<DH>(dos, lane);
  const unsigned qtl = a_addr<DH>(qs, lane), dotl = a_addr<DH>(dos, lane);
  const float scale = a.scale;
  for (int it = 0; it < np / 16; ++it) {
    if (it * 16 % kRC == 0) {
      tae::wait_pending(chunks - 1 - it * 16 / kRC);
      __syncthreads();
    }
    if (!active) continue;
    const int i0 = it * 16;  // the tile's first query
    float st[2][4], dpt[2][4];
    two_scores<DH>(st, dpt, afrag, qbl + i0 * RB, dobl + i0 * RB);
    // column j's queries: i0 + 8j + 2t, +1
    if (i0 + 16 <= n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(lse_s + i0 + 8 * j + 2 * t);
        const float2 dl = *reinterpret_cast<const float2*>(delta_s + i0 + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p_ds(st[j][e], dpt[j][e], e & 1 ? l.y : l.x, e & 1 ? dl.y : dl.x, scale, st[j][e],
               dpt[j][e]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(lse_s + i0 + 8 * j + 2 * t);
        const float2 dl = *reinterpret_cast<const float2*>(delta_s + i0 + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p_ds(st[j][e], dpt[j][e], e & 1 ? l.y : l.x, e & 1 ? dl.y : dl.x, scale, st[j][e],
               dpt[j][e]);
          if (i0 + 8 * j + 2 * t + (e & 1) >= n) st[j][e] = dpt[j][e] = 0.f;
        }
      }
    }
    unsigned pa[4], dsa[4];
    pack_a(pa, st);
    pack_a(dsa, dpt);
    accumulate<DH>(dv, pa, dotl + i0 * RB);
    accumulate<DH>(dk, dsa, qtl + i0 * RB);
  }
  if (!active) return;
  bf16* dkb = a.dk + a.ldk.at(b, h);
  bf16* dvb = a.dv + a.ldv.at(b, h);
  tae::store_c_rows<DH>(dk, [&](int half, int ch, uint4 w) {
    const int r = j0 + g + 8 * half;
    if (r < n) *reinterpret_cast<uint4*>(dkb + r * a.ldk.row + ch * 8) = w;
  });
  tae::store_c_rows<DH>(dv, [&](int half, int ch, uint4 w) {
    const int r = j0 + g + 8 * half;
    if (r < n) *reinterpret_cast<uint4*>(dvb + r * a.ldv.row + ch * 8) = w;
  });
}

// dQ block: query rows of tiles [range * warps, (range + 1) * warps).
template <int DH>
__device__ __forceinline__ void dq_block(const BwdArgs<bf16>& a, int b, int h, int range,
                                         unsigned char* smem) {
  constexpr int LD = tc_ld<DH>(), RB = 2 * LD;  // RB: bytes per staged row
  const int n = a.n, np = pad16(n), chunks = (np + kRC - 1) / kRC;
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int g = lane >> 2;
  bf16* ks = reinterpret_cast<bf16*>(smem);  // (np, LD) each
  bf16* vs = ks + np * LD;
  const bf16* kb = a.k + a.lk.at(b, h);
  const bf16* vb = a.v + a.lv.at(b, h);
  for (int c = 0; c < chunks; ++c) {
    stage_rows<DH>(ks, kb, a.lk.row, vs, vb, a.lv.row, c * kRC, min(np, (c + 1) * kRC), n);
    tae::cp_async_commit();
  }

  const int q0 = (range * warps + warp) * 16;  // the warp's first query row
  const bool active = q0 < n;
  const bf16* qb = a.q + a.lq.at(b, h);
  const bf16* ob = a.o + a.lo.at(b, h);
  const bf16* dob = a.dout + a.ldo.at(b, h);
  // Q and dO as A fragments; delta of rows g, g + 8 from the same loads of
  // dO, summed in the dK/dV blocks' order
  unsigned qa[DH / 16][4], da[DH / 16][4];
  float delta[2] = {0.f, 0.f}, lse[2];
  tae::a_fragments<DH>(qa, [&](int half, int ch) {
    const int r = q0 + g + 8 * half;
    return active && r < n ? *reinterpret_cast<const uint4*>(qb + r * a.lq.row + ch * 8)
                           : make_uint4(0u, 0u, 0u, 0u);
  });
  tae::a_fragments<DH>(da, [&](int half, int ch) {
    const int r = q0 + g + 8 * half;
    if (!active || r >= n) return make_uint4(0u, 0u, 0u, 0u);
    const uint4 d = *reinterpret_cast<const uint4*>(dob + r * a.ldo.row + ch * 8);
    delta[half] = dot8(d, *reinterpret_cast<const uint4*>(ob + r * a.lo.row + ch * 8),
                       delta[half]);
    return d;
  });
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    delta[half] = quad_sum(delta[half]);
    const int r = q0 + g + 8 * half;
    lse[half] = active && r < n ? a.lse[(static_cast<long>(b) * a.heads + h) * n + r] : 0.f;
  }
  auto afrag = [&](int kk, int which, unsigned (&x)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = which ? da[kk][i] : qa[kk][i];
  };

  float dq[DH / 8][4];
  zero<DH>(dq);
  const unsigned kbl = b_addr<DH>(ks, lane), vbl = b_addr<DH>(vs, lane);
  const unsigned ktl = a_addr<DH>(ks, lane);
  const int t2 = 2 * (lane & 3);
  const float scale = a.scale;
  for (int jt = 0; jt < np / 16; ++jt) {
    if (jt * 16 % kRC == 0) {
      tae::wait_pending(chunks - 1 - jt * 16 / kRC);
      __syncthreads();
    }
    if (!active) continue;
    const int k0 = jt * 16;  // the tile's first key
    float s[2][4], dp[2][4];
    two_scores<DH>(s, dp, afrag, kbl + k0 * RB, vbl + k0 * RB);
    // column j's keys: k0 + 8j + 2t, +1
    if (k0 + 16 <= n) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p_ds(s[j][e], dp[j][e], lse[e >> 1], delta[e >> 1], scale, s[j][e], dp[j][e]);
    } else {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p_ds(s[j][e], dp[j][e], lse[e >> 1], delta[e >> 1], scale, s[j][e], dp[j][e]);
          if (k0 + 8 * j + t2 + (e & 1) >= n) dp[j][e] = 0.f;
        }
    }
    unsigned dsa[4];
    pack_a(dsa, dp);
    accumulate<DH>(dq, dsa, ktl + k0 * RB);
  }
  if (!active) return;
  bf16* dqb = a.dq + a.ldq.at(b, h);
  tae::store_c_rows<DH>(dq, [&](int half, int ch, uint4 w) {
    const int r = q0 + g + 8 * half;
    if (r < n) *reinterpret_cast<uint4*>(dqb + r * a.ldq.row + ch * 8) = w;
  });
}

// blockIdx = (role x range, head, image): x < ranges are dK/dV blocks.
template <int DH>
__global__ void __launch_bounds__(kTcWarps * 32, 2)
attention_bwd_bf16(const BwdArgs<bf16> a, int ranges) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int x = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  if (x < ranges)
    dkdv_block<DH>(a, b, h, x, smem_raw);
  else
    dq_block<DH>(a, b, h, x - ranges, smem_raw);
}

// ----------------------------------------------------------------- float32

constexpr int kKeysPerLane = kMaxN / 32;

template <int DH> __host__ __device__ constexpr int f32_ld() { return DH + 4; }
__host__ __device__ constexpr int pad4(int n) { return (n + 3) / 4 * 4; }

template <int DH>
size_t f32_smem_bytes(int n) {
  return sizeof(float) * (static_cast<size_t>(2 * n) * f32_ld<DH>() + 2 * pad4(n) +
                          kWarps * 2 * f32_ld<DH>() + kWarps * 2 * n);
}

template <int DH>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const float4* b4 = reinterpret_cast<const float4*>(b);
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < DH / 4; ++d) {
    const float4 x = a4[d], y = b4[d];
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
    acc = fmaf(x.z, y.z, acc);
    acc = fmaf(x.w, y.w, acc);
  }
  return acc;
}

// Stage the head's columns of `rows` rows of two row-major sources.
template <int DH>
__device__ __forceinline__ void stage2(float* as, float* bs, const float* a,
                                       long long a_stride, const float* b,
                                       long long b_stride, int rows) {
  constexpr int LD = f32_ld<DH>();
  for (int idx = threadIdx.x; idx < rows * DH; idx += blockDim.x) {
    const int r = idx / DH, col = idx - r * DH;
    as[r * LD + col] = a[r * a_stride + col];
    bs[r * LD + col] = b[r * b_stride + col];
  }
}

template <int DH>
__global__ void __launch_bounds__(kWarps * 32)
attention_bwd_f32(const BwdArgs<float> a) {
  const int n = a.n;
  const float scale = a.scale;
  constexpr int LD = f32_ld<DH>();
  constexpr int C2 = DH / 2;  // float2 output columns
  constexpr int C2_PER_LANE = (C2 + 31) / 32;
  extern __shared__ __align__(16) float smem[];
  float* as = smem;                      // (n, LD): K, then Q
  float* bs = as + n * LD;               // (n, LD): V, then dO
  float* lse = bs + n * LD;              // (pad4(n))
  float* delta = lse + pad4(n);          // (pad4(n))
  float* own = delta + pad4(n);          // warps x 2 x LD: the warp's own rows
  float* rowbuf = own + kWarps * 2 * LD;  // warps x 2 x n: p and dS of one row

  const int b = blockIdx.y, h = blockIdx.x;
  const float* qb = a.q + a.lq.at(b, h);
  const float* kb = a.k + a.lk.at(b, h);
  const float* vb = a.v + a.lv.at(b, h);
  const float* obase = a.o + a.lo.at(b, h);
  const float* dobase = a.dout + a.ldo.at(b, h);
  float* dqb = a.dq + a.ldq.at(b, h);
  float* dkb = a.dk + a.ldk.at(b, h);
  float* dvb = a.dv + a.ldv.at(b, h);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* own_a = own + warp * 2 * LD;
  float* own_b = own_a + LD;
  float* p_row = rowbuf + warp * 2 * n;
  float* ds_row = p_row + n;

  for (int r = warp; r < n; r += kWarps) {
    float sum = 0.f;
    for (int d = lane; d < DH; d += 32)
      sum += dobase[r * a.ldo.row + d] * obase[r * a.lo.row + d];
    sum = tae::warp_sum(sum);
    if (lane == 0) {
      delta[r] = sum;
      lse[r] = a.lse[(static_cast<long>(b) * a.heads + h) * n + r];
    }
  }
  stage2<DH>(as, bs, kb, a.lk.row, vb, a.lv.row, n);  // K, V
  __syncthreads();

  // dQ: a warp per query row i, a lane per key
  for (int i = warp; i < n; i += kWarps) {
    for (int d = lane; d < DH; d += 32) {
      own_a[d] = qb[i * a.lq.row + d];                      // q_i
      own_b[d] = dobase[i * a.ldo.row + d];                 // dO_i
    }
    __syncwarp();
    const float li = lse[i], di = delta[i];
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) {
      const int j = lane + 32 * t;
      if (j < n) {
        const float s = dot<DH>(own_a, as + j * LD) * scale;
        const float dp = dot<DH>(own_b, bs + j * LD);
        ds_row[j] = expf(s - li) * (dp - di) * scale;
      }
    }
    __syncwarp();
    float2 acc[C2_PER_LANE];
#pragma unroll
    for (int k = 0; k < C2_PER_LANE; ++k) acc[k] = make_float2(0.f, 0.f);
    const float2* k2 = reinterpret_cast<const float2*>(as);
    for (int j = 0; j < n; ++j) {
      const float ds = ds_row[j];
#pragma unroll
      for (int k = 0; k < C2_PER_LANE; ++k) {
        const int cc = lane + 32 * k;
        if (cc < C2) {
          const float2 kk = k2[j * (LD / 2) + cc];
          acc[k].x = fmaf(ds, kk.x, acc[k].x);
          acc[k].y = fmaf(ds, kk.y, acc[k].y);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < C2_PER_LANE; ++k) {
      const int cc = lane + 32 * k;
      if (cc < C2) tae::store2(dqb + i * a.ldq.row + 2 * cc, acc[k].x, acc[k].y);
    }
    __syncwarp();  // every lane is done with the row buffers
  }
  __syncthreads();  // K and V are consumed
  stage2<DH>(as, bs, qb, a.lq.row, dobase, a.ldo.row, n);  // Q, dO
  __syncthreads();

  // dK, dV: a warp per key j, a lane per query row
  for (int j = warp; j < n; j += kWarps) {
    for (int d = lane; d < DH; d += 32) {
      own_a[d] = kb[j * a.lk.row + d];  // k_j
      own_b[d] = vb[j * a.lv.row + d];  // v_j
    }
    __syncwarp();
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) {
      const int i = lane + 32 * t;
      if (i < n) {
        const float s = dot<DH>(as + i * LD, own_a) * scale;
        const float dp = dot<DH>(bs + i * LD, own_b);
        const float p = expf(s - lse[i]);
        p_row[i] = p;
        ds_row[i] = p * (dp - delta[i]) * scale;
      }
    }
    __syncwarp();
    float2 dk[C2_PER_LANE], dv[C2_PER_LANE];
#pragma unroll
    for (int k = 0; k < C2_PER_LANE; ++k) dk[k] = dv[k] = make_float2(0.f, 0.f);
    const float2* q2 = reinterpret_cast<const float2*>(as);
    const float2* do2 = reinterpret_cast<const float2*>(bs);
    for (int i = 0; i < n; ++i) {
      const float p = p_row[i], ds = ds_row[i];
#pragma unroll
      for (int k = 0; k < C2_PER_LANE; ++k) {
        const int cc = lane + 32 * k;
        if (cc < C2) {
          const float2 qq = q2[i * (LD / 2) + cc], dd = do2[i * (LD / 2) + cc];
          dk[k].x = fmaf(ds, qq.x, dk[k].x);
          dk[k].y = fmaf(ds, qq.y, dk[k].y);
          dv[k].x = fmaf(p, dd.x, dv[k].x);
          dv[k].y = fmaf(p, dd.y, dv[k].y);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < C2_PER_LANE; ++k) {
      const int cc = lane + 32 * k;
      if (cc < C2) {
        tae::store2(dkb + j * a.ldk.row + 2 * cc, dk[k].x, dk[k].y);
        tae::store2(dvb + j * a.ldv.row + 2 * cc, dv[k].x, dv[k].y);
      }
    }
    __syncwarp();
  }
}

// ------------------------------------------------ float32, register tiles

// The register-tiled fp32 body, from kF32TiledMinTokens tokens. A block of
// kBT threads takes one (image, head) and forms S and dP once per (query,
// key): Q and dO of the whole head stay in shared memory (rows of DH + 4
// floats, so that 16-byte loads of 8 consecutive rows hit 8 distinct bank
// groups), K and V arrive in chunks of KC keys, ascending. Per chunk:
//   A. thread (ra, ka) forms S and dP of rows ra + ARG i and keys ka + AKG j
//      (AR x AK register tiles: per 4 columns of d, one float4 of q, k, dO
//      and v a row or key feeds 4 FMAs of each of its row's or key's
//      scores), then P = exp(S * scale - lse) and dS = P (dP - delta) scale,
//      written to two (rows, KC) tiles in shared memory (0 for keys past n);
//   B. dQ += dS.K_chunk on AR x (4 QH) register tiles held across chunks
//      (per 4 keys, a float4 of dS a row and QH of K a key), and the chunk's
//      dK = dS^T.Q and dV = P^T.dO on 4 x 4 tiles (a float4 of each operand
//      a query feeds 16 FMAs), complete once every query has been summed,
//      so written once.
// The next chunk's K and V are loaded into registers while a chunk is in
// use and stored to its single slot after the chunk's last barrier (a second
// slot does not fit beside Q, dO, P and dS at 256 tokens). Every product and
// sum is the first design's: s and dp sum fmaf over d ascending, s is scaled
// once, p and dS are the same expressions; dQ sums fmaf(dS_ij, k_j) over j
// ascending, dK and dV over i ascending, each from 0; delta is the first
// design's lane-strided sum and tae::warp_sum. Keys past n (zero rows, p =
// dS = 0) and queries past n add exact zeros or are never read. So dq, dk
// and dv equal attention_bwd_f32's bit for bit; no atomics, two runs are
// bit-equal.
//   Measured on an H100 80GB HBM3 at 700 W (bench/attention_bwd_body.py
// --dtype fp32, in turns with the variants named): 1.283 ms at (64, 256,
// 3072) h16, the first design 6.17; the S and dP products cost 0.42 of it,
// dK / dV 0.48, dQ 0.18, the exp 0.015, the K / V staging 0.02 (f32_no_*).
// The unguarded instantiation (FULL) saves 0.64 (f32_guarded: 1.93), the
// prologue's o rows loaded at once 0.23 (one row at a time: 1.51); dQ kept
// in device memory between chunks ran 7% slower (f32_dq_global), the dK /
// dV loop unrolled by 16 beat 8 by 2.4%. One block an SM: Q, dO, P and dS
// fill 227 KB at 256 tokens. The first design keeps fewer than 56 tokens:
// at 48, (64, 48, 3072) h16, it took 0.265 ms against the tiled body's
// 0.277, at 56 0.325 against 0.295.
constexpr int kBT = 256;  // threads of the tiled body
// tokens from which the tiled body runs (below: attention_bwd_f32)
constexpr int kF32TiledMinTokens = 56;

// Per head dim: KC keys a chunk; AKG key groups of phase A (each thread AK
// = KC / AKG keys, AR = kMaxN / (kBT / AKG) rows); QCG column groups of dQ
// (each thread QH float4 columns, QR rows). dK / dV take 4 x 4 tiles, one
// thread each, (KC / 4) (DH / 4) a product.
template <int DH> struct BwdTiles;
template <> struct BwdTiles<64> {
  static constexpr int KC = 32, AKG = 8, QCG = 8;
};
template <> struct BwdTiles<80> {
  static constexpr int KC = 16, AKG = 4, QCG = 4;
};
__host__ __device__ constexpr int pad8(int n) { return (n + 7) / 8 * 8; }

// Q, dO (pad8(n) rows of DH + 4), the K and V slot (KC rows), P and dS
// (pad8(n) rows of KC + 4), lse and delta (pad8(n))
template <int DH>
size_t tiled_smem_bytes(int n) {
  constexpr int KC = BwdTiles<DH>::KC;
  const size_t np = pad8(n);
  return sizeof(float) * (2 * np * f32_ld<DH>() + 2 * KC * f32_ld<DH>() + 2 * np * (KC + 4) +
                          2 * np);
}

// FULL: every warp's every row tile of phases A and B holds a row below n
// (n >= full_tokens<DH>()), so no tile is guarded: at 256 tokens the guards
// cost 8% (bench/attention_bwd_body.py's f32_no_guard).
template <int DH>
__host__ __device__ constexpr int full_tokens() {
  using T = BwdTiles<DH>;
  return (kBT / T::AKG) * (kMaxN / (kBT / T::AKG) - 1) + (kBT / 32 - 1) * 32 / T::AKG + 1;
}

template <int DH, bool FULL>
__global__ void __launch_bounds__(kBT, 1)
attention_bwd_f32_tiled(const BwdArgs<float> a) {
  using T = BwdTiles<DH>;
  constexpr int LD = f32_ld<DH>(), KC = T::KC, LDP = KC + 4;
  constexpr int AKG = T::AKG, ARG = kBT / AKG, AR = kMaxN / ARG, AK = KC / AKG;
  constexpr int QCG = T::QCG, QRG = kBT / QCG, QR = kMaxN / QRG, QH = DH / 4 / QCG;
  constexpr int KVT = (KC / 4) * (DH / 4);           // dK (or dV) tiles of a chunk
  constexpr int C4 = DH / 4;                         // float4 columns of a row
  constexpr int PF = (2 * KC * C4 + kBT - 1) / kBT;  // float4s a thread prefetches
  // unrolling of the dQ and dK / dV loops: whole and by 16 where no row tile
  // is guarded; by 2 and 8 where one is (the registers of the guards spill
  // at the wider unrolling)
  constexpr int kDqUnroll = FULL ? KC / 4 : 2, kKvUnroll = FULL ? 16 : 8;
  const int n = a.n, np = pad8(n), nc = (n + KC - 1) / KC;
  const float scale = a.scale;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // (np, LD)
  float* dos = qs + np * LD;        // (np, LD)
  float* ks = dos + np * LD;        // (KC, LD)
  float* vs = ks + KC * LD;         // (KC, LD)
  float* ps = vs + KC * LD;         // (np, LDP)
  float* dss = ps + np * LDP;       // (np, LDP)
  float* lse = dss + np * LDP;      // (np)
  float* delta = lse + np;          // (np)

  const int b = blockIdx.y, h = blockIdx.x;
  const float* qb = a.q + a.lq.at(b, h);
  const float* kb = a.k + a.lk.at(b, h);
  const float* vb = a.v + a.lv.at(b, h);
  const float* obase = a.o + a.lo.at(b, h);
  const float* dobase = a.dout + a.ldo.at(b, h);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // Q and dO by cp.async, rows past n zero
  for (int idx = tid; idx < np * C4; idx += kBT) {
    const int r = idx / C4, col = (idx - r * C4) * 4;
    if (r < n) {
      tae::cp_async16(qs + r * LD + col, qb + r * a.lq.row + col);
      tae::cp_async16(dos + r * LD + col, dobase + r * a.ldo.row + col);
    } else {
      *reinterpret_cast<float4*>(qs + r * LD + col) = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(dos + r * LD + col) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  tae::cp_async_commit();
  // chunk c's K and V rows into registers (zero past n), then into the slot
  float4 pf[PF];
  auto fetch = [&](int c) {
#pragma unroll
    for (int u = 0; u < PF; ++u) {
      const int idx = tid + kBT * u;
      const int which = idx / (KC * C4), rem = idx - which * (KC * C4);
      const int r = rem / C4, col = (rem - r * C4) * 4, key = c * KC + r;
      pf[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (idx < 2 * KC * C4 && key < n)
        pf[u] = *reinterpret_cast<const float4*>(
            which ? vb + key * a.lv.row + col : kb + key * a.lk.row + col);
    }
  };
  auto park = [&]() {
#pragma unroll
    for (int u = 0; u < PF; ++u) {
      const int idx = tid + kBT * u;
      const int which = idx / (KC * C4), rem = idx - which * (KC * C4);
      const int r = rem / C4, col = (rem - r * C4) * 4;
      if (idx < 2 * KC * C4) *reinterpret_cast<float4*>((which ? vs : ks) + r * LD + col) = pf[u];
    }
  };
  fetch(0);
  // lse and delta of every query: warp w takes rows w + kWarps k, their o
  // and lse loaded RB rows at once (at dh 64 while Q and dO land; one row at
  // a time each row's device-memory latency stood in line: 15% of the
  // kernel at 256 tokens), delta summed as the first design does (the
  // lane's columns in order, then tae::warp_sum), dO from its staged rows.
  // At dh 80 two batches of 16 rows, as 32 rows of o spilled.
  constexpr int OT = (DH + 31) / 32, RW = kMaxN / kWarps, RB = DH == 80 ? RW / 2 : RW;
  const float* lse_in = a.lse + (static_cast<long>(b) * a.heads + h) * n;
#pragma unroll 1
  for (int k0 = 0; k0 < RW; k0 += RB) {
    float ov[RB][OT], lv[RB];
#pragma unroll
    for (int k = 0; k < RB; ++k) {
      const int r = warp + kWarps * (k0 + k);
      lv[k] = r < n ? lse_in[r] : 0.f;
#pragma unroll
      for (int t = 0; t < OT; ++t) {
        const int d = lane + 32 * t;
        ov[k][t] = r < n && d < DH ? obase[r * a.lo.row + d] : 0.f;
      }
    }
    if (k0 == 0) {
      tae::wait_pending(0);
      __syncthreads();  // Q and dO staged
    }
#pragma unroll
    for (int k = 0; k < RB; ++k) {
      const int r = warp + kWarps * (k0 + k);
      if (r < np) {
        float sum = 0.f;
        if (r < n)
#pragma unroll
          for (int t = 0; t < OT; ++t) {
            const int d = lane + 32 * t;
            if (d < DH) sum += dos[r * LD + d] * ov[k][t];
          }
        sum = tae::warp_sum(sum);
        if (lane == 0) {
          delta[r] = sum;
          lse[r] = lv[k];
        }
      }
    }
  }

  // phase A's rows ra + ARG i and keys ka + AKG j; a warp's rows are
  // consecutive, so whether row tile i holds a row below n is warp-uniform
  const int ra = tid / AKG, ka = tid % AKG, wa = (warp * 32) / AKG;
  // dQ's rows rq + QRG i and float4 columns cq + QCG hh
  const int rq = tid / QCG, cq = tid % QCG, wq = (warp * 32) / QCG;
  // dK (tid < KVT) or dV (KVT <= tid < 2 KVT): keys 4 kg .., columns 4 cgk ..
  const bool kv_v = tid >= KVT, kv_on = tid < 2 * KVT;
  const int kvt = kv_v ? tid - KVT : tid, kg = kvt % (KC / 4), cgk = kvt / (KC / 4);
  const float* kv_a = kv_v ? ps : dss;   // [query][key]
  const float* kv_b = kv_v ? dos : qs;   // [query][column]
  float* kv_out = kv_v ? a.dv + a.ldv.at(b, h) : a.dk + a.ldk.at(b, h);
  const long long kv_row = kv_v ? a.ldv.row : a.ldk.row;

  float dq[QR][QH][4];
#pragma unroll
  for (int i = 0; i < QR; ++i)
#pragma unroll
    for (int hh = 0; hh < QH; ++hh)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[i][hh][e] = 0.f;

  for (int c = 0; c < nc; ++c) {
    park();
    __syncthreads();  // the chunk (and on the first, Q, dO, lse, delta) visible
    if (c + 1 < nc) fetch(c + 1);

    // ---- A: S and dP of the chunk, then P and dS into shared memory
    float s[AR][AK], dp[AR][AK];
#pragma unroll
    for (int i = 0; i < AR; ++i)
#pragma unroll
      for (int j = 0; j < AK; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < DH; d += 4) {
      float4 kv[AK];
#pragma unroll
      for (int j = 0; j < AK; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (ka + AKG * j) * LD + d);
#pragma unroll
      for (int i = 0; i < AR; ++i) {
        if (FULL || ARG * i + wa < n) {
          const float4 x = *reinterpret_cast<const float4*>(qs + (ra + ARG * i) * LD + d);
#pragma unroll
          for (int j = 0; j < AK; ++j) {
            float acc = s[i][j];
            acc = fmaf(x.x, kv[j].x, acc);
            acc = fmaf(x.y, kv[j].y, acc);
            acc = fmaf(x.z, kv[j].z, acc);
            acc = fmaf(x.w, kv[j].w, acc);
            s[i][j] = acc;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < AK; ++j)
        kv[j] = *reinterpret_cast<const float4*>(vs + (ka + AKG * j) * LD + d);
#pragma unroll
      for (int i = 0; i < AR; ++i) {
        if (FULL || ARG * i + wa < n) {
          const float4 x = *reinterpret_cast<const float4*>(dos + (ra + ARG * i) * LD + d);
#pragma unroll
          for (int j = 0; j < AK; ++j) {
            float acc = dp[i][j];
            acc = fmaf(x.x, kv[j].x, acc);
            acc = fmaf(x.y, kv[j].y, acc);
            acc = fmaf(x.z, kv[j].z, acc);
            acc = fmaf(x.w, kv[j].w, acc);
            dp[i][j] = acc;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < AR; ++i) {
      if (FULL || ARG * i + wa < n) {
        const int row = ra + ARG * i;
        const float li = lse[row], di = delta[row];
#pragma unroll
        for (int j = 0; j < AK; ++j) {
          const int key = c * KC + ka + AKG * j;
          const float sv = s[i][j] * scale;
          float p = expf(sv - li);
          float ds = p * (dp[i][j] - di) * scale;
          if (key >= n) p = ds = 0.f;
          ps[row * LDP + ka + AKG * j] = p;
          dss[row * LDP + ka + AKG * j] = ds;
        }
      }
    }
    __syncthreads();  // P and dS of the chunk visible

    // ---- B: dQ += dS.K over the chunk's keys, ascending
#pragma unroll kDqUnroll
    for (int j = 0; j < KC; j += 4) {
      float4 d4[QR];
#pragma unroll
      for (int i = 0; i < QR; ++i)
        if (FULL || QRG * i + wq < n)
          d4[i] = *reinterpret_cast<const float4*>(dss + (rq + QRG * i) * LDP + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float4 kk[QH];
#pragma unroll
        for (int hh = 0; hh < QH; ++hh)
          kk[hh] = *reinterpret_cast<const float4*>(ks + (j + jj) * LD + 4 * (cq + QCG * hh));
#pragma unroll
        for (int i = 0; i < QR; ++i) {
          if (FULL || QRG * i + wq < n) {
            const float x = jj == 0 ? d4[i].x : jj == 1 ? d4[i].y : jj == 2 ? d4[i].z : d4[i].w;
#pragma unroll
            for (int hh = 0; hh < QH; ++hh) {
              dq[i][hh][0] = fmaf(x, kk[hh].x, dq[i][hh][0]);
              dq[i][hh][1] = fmaf(x, kk[hh].y, dq[i][hh][1]);
              dq[i][hh][2] = fmaf(x, kk[hh].z, dq[i][hh][2]);
              dq[i][hh][3] = fmaf(x, kk[hh].w, dq[i][hh][3]);
            }
          }
        }
      }
    }
    // ---- B: the chunk's dK = dS^T.Q and dV = P^T.dO over every query
    if (kv_on) {
      float acc[4][4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[k][e] = 0.f;
#pragma unroll kKvUnroll
      for (int i = 0; i < n; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(kv_a + i * LDP + 4 * kg);
        const float4 y = *reinterpret_cast<const float4*>(kv_b + i * LD + 4 * cgk);
        const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          acc[k][0] = fmaf(xs[k], y.x, acc[k][0]);
          acc[k][1] = fmaf(xs[k], y.y, acc[k][1]);
          acc[k][2] = fmaf(xs[k], y.z, acc[k][2]);
          acc[k][3] = fmaf(xs[k], y.w, acc[k][3]);
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int key = c * KC + 4 * kg + k;
        if (key < n)
          *reinterpret_cast<float4*>(kv_out + key * kv_row + 4 * cgk) =
              make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
      }
    }
    __syncthreads();  // the slot, P and dS are free for the next chunk
  }

  float* dqb = a.dq + a.ldq.at(b, h);
#pragma unroll
  for (int i = 0; i < QR; ++i) {
    const int row = rq + QRG * i;
    if (row < n)
#pragma unroll
      for (int hh = 0; hh < QH; ++hh)
        *reinterpret_cast<float4*>(dqb + row * a.ldq.row + 4 * (cq + QCG * hh)) =
            make_float4(dq[i][hh][0], dq[i][hh][1], dq[i][hh][2], dq[i][hh][3]);
  }
}

// ---------------------------------------------------------------- launchers

// ptrs: q, k, v, o, do, dq, dk, dv; layouts in the same order.
template <typename T>
BwdArgs<T> make_args(const void* const (&ptrs)[8], const HeadLayout (&l)[8], const void* lse,
                     int n, int heads, float scale) {
  BwdArgs<T> a;
  a.q = static_cast<const T*>(ptrs[0]);
  a.k = static_cast<const T*>(ptrs[1]);
  a.v = static_cast<const T*>(ptrs[2]);
  a.o = static_cast<const T*>(ptrs[3]);
  a.dout = static_cast<const T*>(ptrs[4]);
  a.dq = static_cast<T*>(const_cast<void*>(ptrs[5]));
  a.dk = static_cast<T*>(const_cast<void*>(ptrs[6]));
  a.dv = static_cast<T*>(const_cast<void*>(ptrs[7]));
  a.lse = static_cast<const float*>(lse);
  a.lq = l[0]; a.lk = l[1]; a.lv = l[2]; a.lo = l[3];
  a.ldo = l[4]; a.ldq = l[5]; a.ldk = l[6]; a.ldv = l[7];
  a.n = n;
  a.heads = heads;
  a.scale = scale;
  return a;
}

// Raise the kernel's dynamic shared-memory limit to smem where smem_allowed
// (its limit as last raised, one per instantiation) is below it.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, size_t& smem_allowed) {
  if (smem <= smem_allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess) smem_allowed = smem;
  return err;
}

template <int DH>
int launch_bf16(const BwdArgs<bf16>& args, int batch, cudaStream_t stream) {
  auto* kernel = attention_bwd_bf16<DH>;
  static size_t smem_allowed = 0;  // one per instantiation
  static bool carved = false;
  if (!carved) {
    // all of the SM's unified memory as shared memory, so that as many
    // blocks fit as the registers allow
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    carved = true;
  }
  const size_t smem = tc_smem_bytes<DH>(args.n);
  const cudaError_t err = allow_smem(kernel, smem, smem_allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Partition p = partition(args.n);
  const dim3 grid(2 * p.ranges, args.heads, batch);
  kernel<<<grid, p.warps * 32, smem, stream>>>(args, p.ranges);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_f32(const BwdArgs<float>& args, int batch, cudaStream_t stream) {
  const dim3 grid(args.heads, batch);
  // the shape rule: the first design below kF32TiledMinTokens tokens (the
  // tiled body's note); no fallback on failure
  if (args.n < kF32TiledMinTokens) {
    static size_t smem_allowed = 0;
    const size_t smem = f32_smem_bytes<DH>(args.n);
    const cudaError_t err = allow_smem(attention_bwd_f32<DH>, smem, smem_allowed);
    if (err != cudaSuccess) return static_cast<int>(err);
    attention_bwd_f32<DH><<<grid, kWarps * 32, smem, stream>>>(args);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = tiled_smem_bytes<DH>(args.n);
  if (args.n >= full_tokens<DH>()) {
    static size_t smem_allowed = 0;
    const cudaError_t err = allow_smem(attention_bwd_f32_tiled<DH, true>, smem, smem_allowed);
    if (err != cudaSuccess) return static_cast<int>(err);
    attention_bwd_f32_tiled<DH, true><<<grid, kBT, smem, stream>>>(args);
  } else {
    static size_t smem_allowed = 0;
    const cudaError_t err = allow_smem(attention_bwd_f32_tiled<DH, false>, smem, smem_allowed);
    if (err != cudaSuccess) return static_cast<int>(err);
    attention_bwd_f32_tiled<DH, false><<<grid, kBT, smem, stream>>>(args);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_dtype(const void* const (&ptrs)[8], const HeadLayout (&l)[8], const void* lse,
                 int batch, int n, int heads, float scale, int dtype, cudaStream_t stream) {
  if (dtype == tae::kBFloat16)
    return launch_bf16<DH>(make_args<bf16>(ptrs, l, lse, n, heads, scale), batch, stream);
  if (dtype == tae::kFloat32)
    return launch_f32<DH>(make_args<float>(ptrs, l, lse, n, heads, scale), batch, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

int launch_dh(const void* const (&ptrs)[8], const HeadLayout (&l)[8], const void* lse,
              int batch, int n, int heads, int dh, float scale, int dtype, void* stream) {
  if (batch < 1 || batch > 65535 || heads < 1 || heads > 65535 || n < 1 || n > kMaxN ||
      lse == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh == 64) return launch_dtype<64>(ptrs, l, lse, batch, n, heads, scale, dtype, s);
  if (dh == 80) return launch_dtype<80>(ptrs, l, lse, batch, n, heads, scale, dtype, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// K10. qkv, dqkv: (batch, n, 3 * heads * dh) contiguous; o, dout: (batch, n,
// heads * dh); lse: (batch, heads, n) fp32.
extern "C" int tae_packed_attention_bwd(const void* qkv, const void* o, const void* lse,
                                        const void* dout, void* dqkv, int batch, int n,
                                        int heads, int dh, float scale, int dtype,
                                        void* stream) {
  const long long c = static_cast<long long>(heads) * dh;
  const size_t el = dtype == tae::kBFloat16 ? 2 : 4;
  const char* in = static_cast<const char*>(qkv);
  const char* d = static_cast<const char*>(dqkv);
  const void* const ptrs[8] = {in, in + c * el, in + 2 * c * el, o, dout,
                               d, d + c * el, d + 2 * c * el};
  const HeadLayout packed = {n * 3 * c, dh, 3 * c}, merged = {n * c, dh, c};
  const HeadLayout l[8] = {packed, packed, packed, merged, merged, packed, packed, packed};
  return launch_dh(ptrs, l, lse, batch, n, heads, dh, scale, dtype, stream);
}

// K17. q, k, v, o, dout, dq, dk, dv: (batch, heads, n, dh), operand i with
// the element strides strides[3 * i .. 3 * i + 2] = (image, head, row); the
// last axis contiguous, rows 16-byte aligned. lse: (batch, heads, n) fp32.
extern "C" int tae_flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* o, const void* lse, const void* dout,
                                       void* dq, void* dk, void* dv,
                                       const long long* strides, int batch, int n, int heads,
                                       int dh, float scale, int dtype, void* stream) {
  const void* const ptrs[8] = {q, k, v, o, dout, dq, dk, dv};
  HeadLayout l[8];
  for (int i = 0; i < 8; ++i) l[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  return launch_dh(ptrs, l, lse, batch, n, heads, dh, scale, dtype, stream);
}

// The fp32 backward's launch for (n, dh): out[0] 1 where the tiled body
// runs (else the first design), out[1] keys a chunk (the tiled body; else
// 0), out[2] threads a block, out[3] dynamic shared memory bytes.
// ops/cuda/flash_attention.py::bwd_f32_plan mirrors it.
extern "C" int tae_attention_bwd_f32_plan(int n, int dh, int* out) {
  if (n < 1 || n > kMaxN || (dh != 64 && dh != 80)) return static_cast<int>(cudaErrorInvalidValue);
  const bool tiled = n >= kF32TiledMinTokens;
  out[0] = tiled ? 1 : 0;
  out[1] = !tiled ? 0 : dh == 64 ? BwdTiles<64>::KC : BwdTiles<80>::KC;
  out[2] = tiled ? kBT : kWarps * 32;
  const size_t smem = tiled ? (dh == 64 ? tiled_smem_bytes<64>(n) : tiled_smem_bytes<80>(n))
                            : (dh == 64 ? f32_smem_bytes<64>(n) : f32_smem_bytes<80>(n));
  out[3] = static_cast<int>(smem);
  return 0;
}
