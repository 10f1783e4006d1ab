// K6-K9 — packed-qkv attention over flat token rows: the tiny-N ("wide")
// form and the forms with int8 output.
//
// Replaces, in tae_tpu/ops/pallas/flash_attention.py:
//   K6 fused_qkv_attention_wide        (_packed_wide_fwd_kernel_stacked)
//   K7 fused_qkv_attention_q8          (_packed_fwd_kernel_stacked_q8)
//   K8 fused_qkv_attention_wide_q8     (_packed_wide_fwd_kernel_stacked_q8)
//   K9 fused_qkv_attention_wide_q8_2d  (_packed_wide_fwd_kernel_stacked_q8_2d,
//                                       _block_diag_mask, _masked_serving_softmax)
// This is a file of its own beside flash_attention.cu (K2): K2 gives a block
// one (image, head); here a block owns 16 consecutive rows of the flat
// (B*N, 3C) token axis, whatever images they belong to, and every head.
// K6, K9 and every float32 form run one kernel template here; qkv (B, N, 3C)
// and its (B*N, 3C) view are the same bytes. K7 and K8 in bf16 from 16
// tokens (tae::q8::kMinTokens) and up to 32 heads run on K2's body instead
// (flash_attention.cu, attention_q8.cuh), with the row epilogue shared over
// a thread-block cluster; below 16 tokens, in float32 and above 32 heads
// they run here, where K8 and K9 are bit-identical.
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
// What bounds it on the H100: bytes. 4*N*dh flops per (row, head) against
//   3*dh*2 bytes read put every shape here far below the tensor cores' ridge
//   (N <= 256), so the least time is qkv read once and the output written
//   once; what the kernel really waits for is latency, since a tile of 16
//   rows is little work per head.
// What the design does about it:
//   * a tile is 16 flat rows: 16/N whole images at N <= 8 under the block-
//     diagonal mask, one image at N = 16, a quarter of one at N = 64, so the
//     16-row MMA tiles are full at every N (K2 pads 4 rows to 16 at N = 4);
//   * the warps of a block take the heads in turn and share nothing until the
//     end, so they never wait for each other: each stages its head's K and V
//     for the tile's key range ([first image's first row, last image's last
//     row)) in its own shared memory, 64 keys at a time, with cp.async so
//     that a chunk's copies (and the Q tile's) are in flight together and
//     cost one memory latency, and runs K2's chunk loop (WMMA 16x16x16 bf16 -> fp32 scores, a lane pair per row for the
//     softmax, P.V accumulated in registers);
//   * the int8 epilogue needs a row's every head: each warp writes its heads'
//     o * (1 / l) in fp32 into a block-wide (16, C + 4) scratch in shared
//     memory (160 KB at C = 2560, which is why a block has 16 rows and not
//     more), and after one barrier the warps take the rows in turn: amax,
//     scale, codes. The bf16-output entry has no scratch and spreads the
//     heads over grid.y as well;
//   * float32 input runs on the CUDA cores (tensor cores would round to
//     TF32): a warp per (row, head), lanes over the row's own keys straight
//     from device memory, then over output columns. It is off the serving
//     path, which is bf16.
//   Each image's K and V are read by N/16 blocks at N > 16 (from L2), which
//   is why K7 and K8 moved to K2's body from 16 tokens; K9 (4 tokens) and K6
//   stay here, on the redesign queue.
#include <mma.h>

#include "attention_q8.cuh"
#include "common.cuh"
#include "int8_common.cuh"

namespace {

namespace wm = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int kTile = 16;      // flat query rows of one block
constexpr int kKC = 64;        // most keys per staged chunk
constexpr int kMaxWarps = 8;
constexpr int kMaxN = 256;     // tokens per image (float32: N/32 scores per lane)
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
template <int DH> __host__ __device__ constexpr int kv_ld() { return DH + 8; }
// floats per row of a warp's region: a chunk of scores or a row of outputs
template <int DH> __host__ __device__ constexpr int region_ld() {
  return (kKC > DH ? kKC : DH) + 4;
}
// shared memory of one warp: K and V chunk, the region, 16 reciprocals
template <int DH> __host__ __device__ constexpr int warp_bytes(int chunk) {
  return 2 * chunk * kv_ld<DH>() * 2 + kTile * region_ld<DH>() * 4 + kTile * 4;
}
// the block-wide fp32 output rows of the int8 epilogue: row stride, bytes
__host__ __device__ constexpr int scratch_ld(int c) { return c + 4; }
__host__ __device__ constexpr int scratch_bytes(int c) { return kTile * scratch_ld(c) * 4; }

// amax, scale and codes of the block's rows from the fp32 scratch; the warps
// take the rows in turn. Call after a block barrier.
__device__ __forceinline__ void quantize_rows_epilogue(const float* scratch, int c, int r0,
                                                       int rows, int8_t* __restrict__ out_q,
                                                       float* __restrict__ out_s) {
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int rr = warp; rr < kTile && r0 + rr < rows; rr += warps) {
    const tae::i8::RowF32 load{scratch + rr * scratch_ld(c)};
    float v[8];
    float amax = 0.f;
    for (int i = lane * 8; i < c; i += 256) {
      load(i, v);
#pragma unroll
      for (int k = 0; k < 8; ++k) amax = fmaxf(amax, fabsf(v[k]));
    }
    const float s = tae::i8::quant_scale(tae::warp_max(amax));
    const float inv = 1.0f / s;
    int8_t* q = out_q + static_cast<long>(r0 + rr) * c;
    for (int i = lane * 8; i < c; i += 256) {
      load(i, v);
      *reinterpret_cast<uint2*>(q + i) = tae::i8::quantize8(v, inv);
    }
    if (lane == 0) out_s[r0 + rr] = s;
  }
}

// ---------------------------------------------------------------- bfloat16

using QFrag = wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major>;
using Acc = wm::fragment<wm::accumulator, 16, 16, 16, float>;

// One head's K (and V) rows [j0, j0 + kc) of the flat token axis into the
// warp's shared memory, as asynchronous 16-byte copies that are all in
// flight together (one wait at the end, which also covers copies the caller
// issued before); rows at or beyond k_hi are zero.
template <int DH, bool WITH_V>
__device__ __forceinline__ void stage_chunk(const bf16* __restrict__ head_base, int c,
                                            long row_stride, int j0, int kc, int k_hi,
                                            bf16* ks, bf16* vs, int lane) {
  constexpr int LDK = kv_ld<DH>();
  constexpr int CH = DH / 8;  // 16-byte pieces per head row
  __syncwarp();               // every lane has left the chunk staged before
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int idx = lane; idx < kc * CH; idx += 32) {
    const int rr = idx / CH, ch = idx - rr * CH;
    bf16* kd = ks + rr * LDK + ch * 8;
    bf16* vd = vs + rr * LDK + ch * 8;
    if (j0 + rr < k_hi) {
      const bf16* src = head_base + (j0 + rr) * row_stride + ch * 8;
      __pipeline_memcpy_async(kd, src + c, 16);
      if (WITH_V) __pipeline_memcpy_async(vd, src + 2 * c, 16);
    } else {
      *reinterpret_cast<uint4*>(kd) = zero;
      if (WITH_V) *reinterpret_cast<uint4*>(vd) = zero;
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncwarp();
}

// fp32 scores of the warp's 16 query rows against the kc staged keys, into
// the warp's region.
template <int DH>
__device__ __forceinline__ void score_chunk(const QFrag (&qa)[DH / 16], const bf16* ks, int kc,
                                            float* region) {
  constexpr int LDK = kv_ld<DH>();
  for (int jt = 0; jt < kc / 16; ++jt) {
    Acc sacc;
    wm::fill_fragment(sacc, 0.f);
#pragma unroll
    for (int kt = 0; kt < DH / 16; ++kt) {
      wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::col_major> kb;
      wm::load_matrix_sync(kb, ks + jt * 16 * LDK + kt * 16, LDK);
      wm::mma_sync(sacc, qa[kt], kb, sacc);
    }
    wm::store_matrix_sync(region + jt * 16, sacc, region_ld<DH>(), wm::mem_row_major);
  }
  __syncwarp();
}

// qkv: (rows, 3 * heads * DH), rows = B * n. out (MODE != kQ8): (rows, C) of
// the input dtype; out_q, out_s (kQ8): (rows, C) int8 and (rows,) fp32.
// grid.x: tiles of 16 rows; grid.y: groups of heads_per_block heads (one
// group for kQ8). chunk: keys per staged chunk, a multiple of 16 up to kKC.
template <int DH, int MODE>
__global__ void __launch_bounds__(kMaxWarps * 32)
rows_attention_bf16(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                    int8_t* __restrict__ out_q, float* __restrict__ out_s, int rows, int n,
                    int heads, int heads_per_block, int chunk, float scale) {
  constexpr int LDK = kv_ld<DH>();
  constexpr int RW = region_ld<DH>();
  constexpr int LDB = 2 * RW;  // the region's row stride in bf16 elements
  constexpr int CH = DH / 8;
  const int c = heads * DH;
  const long row_stride = 3L * c;
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* scratch = reinterpret_cast<float*>(smem_raw);  // kQ8 only
  unsigned char* mine = smem_raw + (MODE == kQ8 ? scratch_bytes(c) : 0) +
                        static_cast<size_t>(warp) * warp_bytes<DH>(chunk);
  bf16* ks = reinterpret_cast<bf16*>(mine);               // (chunk, LDK)
  bf16* vs = ks + chunk * LDK;                             // (chunk, LDK)
  float* region = reinterpret_cast<float*>(vs + chunk * LDK);  // (16, RW)
  float* linv = region + kTile * RW;                       // 16
  bf16* rb = reinterpret_cast<bf16*>(region);

  // the tile's rows and the keys they can see: whole images
  const int r0 = blockIdx.x * kTile;
  const int r_last = min(r0 + kTile, rows) - 1;
  const int k_lo = r0 / n * n, k_hi = (r_last / n + 1) * n;
  const bool single = k_hi - k_lo <= chunk;  // one chunk: staged once per head

  // Softmax layout over a 16 x kKC chunk: lane -> row sr, the 32 columns
  // from sc, so a row's max and sum need one shuffle with the lane's pair.
  const int sr = lane >> 1, sc = (lane & 1) * 32;
  float* srow = region + sr * RW + sc;
  // the keys of this lane's row are its own image's; a row past the end
  // keeps the tile's range (finite numbers, never written)
  const bool live = r0 + sr < rows;
  const int own_lo = live ? (r0 + sr) / n * n : k_lo;
  const int own_hi = live ? own_lo + n : k_hi;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  const int h_end = min(heads, static_cast<int>(blockIdx.y + 1) * heads_per_block);
  for (int h = static_cast<int>(blockIdx.y) * heads_per_block + warp; h < h_end; h += warps) {
    const bf16* head_base = qkv + h * DH;
    // the Q tile into the region, in flight together with the first chunk
    for (int idx = lane; idx < kTile * CH; idx += 32) {
      const int rr = idx / CH, ch = idx - rr * CH;
      bf16* qd = rb + rr * LDB + ch * 8;
      if (r0 + rr < rows)
        __pipeline_memcpy_async(qd, head_base + (r0 + rr) * row_stride + ch * 8, 16);
      else
        *reinterpret_cast<uint4*>(qd) = zero;
    }
    if (single) {
      stage_chunk<DH, true>(head_base, c, row_stride, k_lo, pad16(k_hi - k_lo), k_hi, ks, vs,
                            lane);
    } else {
      __pipeline_commit();
      __pipeline_wait_prior(0);
      __syncwarp();
    }
    QFrag qa[DH / 16];
#pragma unroll
    for (int kt = 0; kt < DH / 16; ++kt) wm::load_matrix_sync(qa[kt], rb + kt * 16, LDB);
    __syncwarp();  // Q now lives in registers; the region takes the scores

    float s[32];
    // exact form: a first pass over the key chunks finds each row's max
    float mx = -INFINITY;
    if (MODE == kExact) {
      for (int c0 = k_lo; c0 < k_hi; c0 += chunk) {
        const int kc = min(chunk, pad16(k_hi - c0));
        if (!single) stage_chunk<DH, false>(head_base, c, row_stride, c0, kc, k_hi, ks, vs, lane);
        score_chunk<DH>(qa, ks, kc, region);
#pragma unroll
        for (int k = 0; k < 32; k += 4) tae::load_vec(srow + k, s + k);
#pragma unroll
        for (int k = 0; k < 32; ++k) {
          const int j = c0 + sc + k;
          if (sc + k < kc && j >= own_lo && j < own_hi) mx = fmaxf(mx, s[k] * scale);
        }
        __syncwarp();
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    }

    // scores -> p (fp32 into the row sum, bf16 over the scores) -> O += P V
    float lsum = 0.f;
    Acc oacc[DH / 16];
#pragma unroll
    for (int dt = 0; dt < DH / 16; ++dt) wm::fill_fragment(oacc[dt], 0.f);
    for (int c0 = k_lo; c0 < k_hi; c0 += chunk) {
      const int kc = min(chunk, pad16(k_hi - c0));
      if (!single) stage_chunk<DH, true>(head_base, c, row_stride, c0, kc, k_hi, ks, vs, lane);
      score_chunk<DH>(qa, ks, kc, region);
#pragma unroll
      for (int k = 0; k < 32; k += 4) tae::load_vec(srow + k, s + k);
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const int j = c0 + sc + k;
        s[k] = sc + k < kc && j >= own_lo && j < own_hi ? softmax_p<MODE>(s[k] * scale, mx) : 0.f;
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
          wm::load_matrix_sync(vb, vs + kt * 16 * LDK + dt * 16, LDK);
          wm::mma_sync(oacc[dt], pa, vb, oacc[dt]);
        }
      }
      __syncwarp();  // P is consumed before the next chunk's scores land
    }
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    if (sc == 0) linv[sr] = 1.f / lsum;
#pragma unroll
    for (int dt = 0; dt < DH / 16; ++dt)
      wm::store_matrix_sync(region + dt * 16, oacc[dt], RW, wm::mem_row_major);
    __syncwarp();

    for (int idx = lane; idx < kTile * (DH / 2); idx += 32) {
      const int rr = idx / (DH / 2), c2 = idx - rr * (DH / 2);
      const float* o = region + rr * RW + 2 * c2;
      const float inv = linv[rr];
      const float o0 = __fmul_rn(o[0], inv), o1 = __fmul_rn(o[1], inv);
      if (MODE == kQ8) {
        tae::store2(scratch + rr * scratch_ld(c) + h * DH + 2 * c2, o0, o1);
      } else if (r0 + rr < rows) {
        tae::store2(out + static_cast<long>(r0 + rr) * c + h * DH + 2 * c2, o0, o1);
      }
    }
    __syncwarp();  // the region is read before the next head's Q lands in it
  }

  if (MODE == kQ8) {
    __syncthreads();  // every head of every row is in the scratch
    quantize_rows_epilogue(scratch, c, r0, rows, out_q, out_s);
  }
}

// ----------------------------------------------------------------- float32

constexpr int kKeysPerLane = kMaxN / 32;

// A warp per (row, head): each lane scores the row's own keys lane, lane +
// 32, ... straight from device memory, then takes float2 output columns.
template <int DH, int MODE>
__global__ void __launch_bounds__(kMaxWarps * 32)
rows_attention_f32(const float* __restrict__ qkv, float* __restrict__ out,
                   int8_t* __restrict__ out_q, float* __restrict__ out_s, int rows, int n,
                   int heads, int heads_per_block, int /*chunk*/, float scale) {
  constexpr int C2 = DH / 2;  // float2 output columns
  constexpr int C2_PER_LANE = (C2 + 31) / 32;
  const int c = heads * DH;
  const long row_stride = 3L * c;
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* scratch = reinterpret_cast<float*>(smem_raw);  // kQ8 only

  const int r0 = blockIdx.x * kTile;
  const int h_begin = static_cast<int>(blockIdx.y) * heads_per_block;
  const int nh = min(heads, h_begin + heads_per_block) - h_begin;
  for (int item = warp; item < kTile * nh; item += warps) {
    const int rr = item % kTile, h = h_begin + item / kTile;
    const int r = r0 + rr;
    if (r >= rows) continue;
    const int own_lo = r / n * n;
    const float4* q4 = reinterpret_cast<const float4*>(qkv + r * row_stride + h * DH);
    const float* kbase = qkv + c + h * DH;
    const float* vbase = qkv + 2 * c + h * DH;

    float p[kKeysPerLane];
    float mx = -INFINITY;
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) {
      const int jj = lane + 32 * t;
      p[t] = -INFINITY;
      if (jj < n) {
        const float4* k4 = reinterpret_cast<const float4*>(kbase + (own_lo + jj) * row_stride);
        float acc = 0.f;
#pragma unroll
        for (int d = 0; d < DH / 4; ++d) {
          const float4 a = q4[d], kk = k4[d];
          acc = fmaf(a.x, kk.x, acc);
          acc = fmaf(a.y, kk.y, acc);
          acc = fmaf(a.z, kk.z, acc);
          acc = fmaf(a.w, kk.w, acc);
        }
        p[t] = acc * scale;
        mx = fmaxf(mx, p[t]);
      }
    }
    if (MODE == kExact) mx = tae::warp_max(mx);
    float l = 0.f;
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) {
      // fp32 input: rounding p to the input dtype is exact
      p[t] = lane + 32 * t < n ? softmax_p<MODE>(p[t], mx) : 0.f;
      l += p[t];
    }
    const float inv = 1.f / tae::warp_sum(l);

    float2 acc[C2_PER_LANE];
#pragma unroll
    for (int k = 0; k < C2_PER_LANE; ++k) acc[k] = make_float2(0.f, 0.f);
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) {
      for (int src = 0; src < 32 && 32 * t + src < n; ++src) {
        const float pj = __shfl_sync(0xffffffffu, p[t], src);
        const float2* v2 =
            reinterpret_cast<const float2*>(vbase + (own_lo + 32 * t + src) * row_stride);
#pragma unroll
        for (int k = 0; k < C2_PER_LANE; ++k) {
          const int cc = lane + 32 * k;
          if (cc < C2) {
            const float2 vv = v2[cc];
            acc[k].x = fmaf(pj, vv.x, acc[k].x);
            acc[k].y = fmaf(pj, vv.y, acc[k].y);
          }
        }
      }
    }
    float* orow = MODE == kQ8 ? scratch + rr * scratch_ld(c) + h * DH
                              : out + static_cast<long>(r) * c + h * DH;
#pragma unroll
    for (int k = 0; k < C2_PER_LANE; ++k) {
      const int cc = lane + 32 * k;
      if (cc < C2) tae::store2(orow + 2 * cc, __fmul_rn(acc[k].x, inv), __fmul_rn(acc[k].y, inv));
    }
  }

  if (MODE == kQ8) {
    __syncthreads();
    quantize_rows_epilogue(scratch, c, r0, rows, out_q, out_s);
  }
}

// ---------------------------------------------------------------- launchers

// Keys per staged chunk for n tokens per image: the widest key range a
// 16-row tile can see, up to kKC.
int chunk_for(int n) {
  const int span = 16 % n == 0 ? 16 : n % 16 == 0 ? n : n * (15 / n + 2);
  return span < kKC ? pad16(span) : kKC;
}

struct Plan {
  int warps, heads_per_block, chunk;
  size_t smem;
};

// Warps per block, heads per block and shared memory. kQ8: one block takes
// every head (the epilogue needs them), as many warps as fit beside the
// scratch, evened out over the rounds of heads. Otherwise up to kMaxWarps
// heads per block, a warp each, and grid.y covers the rest.
template <typename T, int DH, int MODE>
bool plan(int n, int heads, Plan& p) {
  constexpr bool TC = sizeof(T) == 2;
  p.chunk = chunk_for(n);
  const int per_warp = TC ? warp_bytes<DH>(p.chunk) : 0;
  if (MODE != kQ8) {
    p.warps = p.heads_per_block = heads < kMaxWarps ? heads : kMaxWarps;
    p.smem = static_cast<size_t>(p.warps) * per_warp;
    return true;
  }
  const int scratch = scratch_bytes(heads * DH);
  p.heads_per_block = heads;
  int fit = kMaxWarps;
  if (TC) fit = (tae::i8::kSmemLimit - scratch) / per_warp;
  if (scratch > tae::i8::kSmemLimit || fit < 1) return false;
  fit = fit < kMaxWarps ? fit : kMaxWarps;
  fit = fit < heads ? fit : heads;
  const int rounds = (heads + fit - 1) / fit;
  p.warps = TC ? (heads + rounds - 1) / rounds : kMaxWarps;
  p.smem = scratch + static_cast<size_t>(p.warps) * per_warp;
  return true;
}

template <typename T, int DH, int MODE>
int launch(void (*kernel)(const T*, T*, int8_t*, float*, int, int, int, int, int, float),
           const void* qkv, void* out, void* out_q, void* out_s, int rows, int n, int heads,
           float scale, cudaStream_t stream) {
  Plan p;
  if (!plan<T, DH, MODE>(n, heads, p)) return static_cast<int>(cudaErrorInvalidValue);
  // the kernel's dynamic shared-memory limit as last raised (one per
  // instantiation): cudaFuncSetAttribute runs only when a launch needs more
  static size_t smem_allowed = 48 * 1024;
  if (p.smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(p.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_allowed = p.smem;
  }
  const dim3 grid((rows + kTile - 1) / kTile,
                  (heads + p.heads_per_block - 1) / p.heads_per_block);
  kernel<<<grid, p.warps * 32, p.smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), static_cast<int8_t*>(out_q),
      static_cast<float*>(out_s), rows, n, heads, p.heads_per_block, p.chunk, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DH, int MODE>
int launch_dtype(const void* qkv, void* out, void* out_q, void* out_s, int rows, int n,
                 int heads, float scale, int dtype, cudaStream_t stream) {
  if (dtype == tae::kBFloat16)
    return launch<bf16, DH, MODE>(rows_attention_bf16<DH, MODE>, qkv, out, out_q, out_s, rows,
                                  n, heads, scale, stream);
  if (dtype == tae::kFloat32)
    return launch<float, DH, MODE>(rows_attention_f32<DH, MODE>, qkv, out, out_q, out_s, rows,
                                   n, heads, scale, stream);
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
// cluster; otherwise (fewer tokens, float32) the flat-row body here.
int launch_q8(const void* qkv, void* out_q, void* out_s, int batch, int n, int max_n, int heads,
              int dh, float scale, int dtype, void* stream) {
  tae::q8::Plan p;
  if (dtype == tae::kBFloat16 && n <= max_n && tae::q8::plan(n, heads, dh, p))
    return tae::q8::launch(p, qkv, out_q, out_s, batch, n, heads, dh, scale, stream);
  return launch_rows<kQ8>(qkv, nullptr, out_q, out_s, static_cast<long>(batch) * n, n, max_n,
                          heads, dh, scale, dtype, stream);
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
