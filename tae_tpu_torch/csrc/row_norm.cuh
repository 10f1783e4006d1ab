// The LayerNorm row kernels that hold a row in registers: K3 ln_quant
// (ln_quant_regs_kernel in int8_block.cu) and K11, the LayerNorm backward
// (layer_norm_bwd_rows_kernel in layernorm.cu). Their launch plans, and the
// 8-column groups a lane holds. ops/cuda/int8_block.py::ln_quant_plan and
// ops/cuda/layernorm.py::bwd_plan mirror the plans.
#pragma once

#include "common.cuh"

namespace tae {
namespace rownorm {

// One warp a row. A lane holds nv groups of 8 consecutive columns: group j
// is columns (32 j + lane) * 8 .. + 7, so a warp's 16-byte loads of one
// group are contiguous and a lane meets its columns in the order of the
// first design's runtime loop (i = lane * 8, lane * 8 + 256, ...). K11
// holds the same columns as 16-byte vectors, the unit of its first design:
// vector m is columns (32 m + lane) * Vec<T>::kN .., 8 nv / kN of them (in
// fp32 4 columns a vector, 2 nv vectors). nv is the first of kNvSteps that
// covers the row; the bodies are instantiated at each.
constexpr int kNvSteps[] = {1, 2, 4, 8, 10, 12, 16};
constexpr int kGroupCols = 256;  // columns of one group across a warp

// Blocks that cover the card: about one for each of the H100's 132 SMs.
constexpr int kFillBlocks = 128;

// K3. The row in registers up to kLnqMaxNv groups (4096 columns); a wider
// row runs the first design's runtime loop (int8_common.cuh's ln_quant_row),
// so nv 0 names that body. Warps a block: kLnqMaxWarps, halved while the
// grid would have fewer than kLnqMinBlocks blocks, down to 1: 4096 blocks of
// 4 at 16384 rows, 64 of 4 at 256, 32 of 1 at 32. At 256 rows of 2560, 64
// blocks of 4 ran 5-8% faster than 128 of 2 or 256 of 1 (a block's warps
// share gamma and beta through L1; bench/norm_body.py's warps variants).
constexpr int kLnqMaxNv = 16;
constexpr int kLnqMaxWarps = 4;
constexpr int kLnqMinBlocks = 64;

// K3's register body: up to 1024 columns (nv 4) at most 64 registers a
// thread, so that 8 blocks of 4 warps fit an SM (many rows are bound by
// the bytes in flight), gamma and beta then read at the affine step (from
// L1: every row reads them); wider, gamma and beta come with x's loads
// where nv * 4 * (x's and the affine's bytes a value) stays within 160
// (bf16 to nv 10; fp32 x with bf16 gamma and beta at nv 10 spilled so).
__host__ __device__ constexpr int lnq_min_blocks(int nv) { return nv <= 4 ? 8 : 1; }
__host__ __device__ constexpr bool lnq_affine_first(int nv, int x_bytes, int w_bytes) {
  return nv > 4 && nv * 4 * (x_bytes + w_bytes) <= 160;
}

// K11. A block takes a chunk of rows, its kBwdWarps warps the chunk's rows
// in turn, and writes the chunk's column sums; a finish kernel adds the
// chunks in order. Chunks of kBwdRowsPerChunk rows where that makes
// kFillBlocks chunks or more (more rows a chunk where it would make over
// kBwdMaxChunks): with 8 warps each column's sum then meets its terms in
// the first design's order. Fewer rows take the fewest rows a chunk, a
// multiple of kBwdWarps, that make at most kFillBlocks chunks (32 rows: 4
// chunks of 8, a row a warp), so that few rows still spread over the card;
// their dw and db then differ from the first design's in fp32 summation
// order. The row in registers up to kBwdMaxNv groups (2560 columns: x and
// dy both held); a wider row runs the first design's three launches (nv
// 0). Each warp's column sums in registers up to kBwdRegAccNv groups (1024
// columns: 64 a lane), in shared memory above. Each warp asks L2 for its
// rows kBwdL2Ahead rows ahead of the one it works on (bf16). Where the
// chunks are kFillBlocks / 2 or fewer, the columns are split too: grid.y
// takes up to kFillBlocks / chunks slices of 256-column groups, each block
// reading its rows whole for the row means but writing dx and the column
// sums of its slice only (32 rows of 2560: 4 chunks x 10 slices).
constexpr int kBwdMaxNv = 10;
constexpr int kBwdRegAccNv = 4;
constexpr int kBwdWarps = 8;
constexpr int kBwdRowsPerChunk = 128;
constexpr int kBwdMaxChunks = 1024;
constexpr int kBwdL2Ahead = 2;

// The first of kNvSteps that covers cols, or 0 above max_nv.
inline int nv_for(int cols, int max_nv) {
  const int need = (cols + kGroupCols - 1) / kGroupCols;
  for (const int nv : kNvSteps)
    if (nv >= need) return nv <= max_nv ? nv : 0;
  return 0;
}

struct LnqPlan {
  int nv;      // groups a lane holds; 0: the runtime-loop body
  int warps;   // warps (rows) a block
  int blocks;  // grid
};

inline bool ln_quant_plan(int rows, int cols, LnqPlan& p) {
  if (rows < 1 || cols < 8 || cols % 8 != 0) return false;
  p.nv = nv_for(cols, kLnqMaxNv);
  int warps = kLnqMaxWarps;
  while (warps > 1 && rows < static_cast<long>(warps) * kLnqMinBlocks) warps /= 2;
  p.warps = warps;
  p.blocks = static_cast<int>((static_cast<long>(rows) + warps - 1) / warps);
  return true;
}

struct BwdPlan {
  int nv;              // groups a lane holds; 0: the first design's launches
  int chunks;          // blocks, and partial sums of each column
  int rows_per_chunk;
  int warps;           // warps a block
  int reg_acc;         // 1: the column sums in registers, 0: in shared memory
  int smem;            // dynamic shared memory of a block, bytes
  int splits;          // grid.y: slices of the columns, 256-column groups each
};

inline bool layer_norm_bwd_plan(int rows, int cols, BwdPlan& p) {
  if (rows < 1 || cols < 8 || cols % 8 != 0) return false;
  long per = (static_cast<long>(rows) + kBwdMaxChunks - 1) / kBwdMaxChunks;
  if (per < kBwdRowsPerChunk) {
    if (rows >= static_cast<long>(kBwdRowsPerChunk) * kFillBlocks) {
      per = kBwdRowsPerChunk;
    } else {
      per = (rows + kFillBlocks - 1) / kFillBlocks;
      per = (per + kBwdWarps - 1) / kBwdWarps * kBwdWarps;
    }
  }
  p.rows_per_chunk = static_cast<int>(per);
  p.chunks = static_cast<int>((static_cast<long>(rows) + p.rows_per_chunk - 1) / p.rows_per_chunk);
  p.nv = nv_for(cols, kBwdMaxNv);
  p.warps = kBwdWarps;
  p.reg_acc = p.nv != 0 && p.nv <= kBwdRegAccNv ? 1 : 0;
  // the weight in fp32, then each warp's two column sums, nv groups wide
  p.smem = p.nv == 0 ? 0 : (2 * p.warps + 1) * p.nv * kGroupCols * 4;
  const int groups = (cols + kGroupCols - 1) / kGroupCols;
  const int most = kFillBlocks / p.chunks;
  p.splits = p.nv != 0 && p.chunks <= kFillBlocks / 2 ? (most < groups ? most : groups) : 1;
  return true;
}

// One 16-byte vector of a row (Vec<T>::kN values: 8 in bf16, 4 in fp32)
// held raw, and its values in fp32. K11 holds its rows so, in the first
// design's unit.
template <typename T> __device__ __forceinline__ void unpack16(const uint4& u, float* o);
template <> __device__ __forceinline__ void unpack16<float>(const uint4& u, float* o) {
  o[0] = __uint_as_float(u.x); o[1] = __uint_as_float(u.y);
  o[2] = __uint_as_float(u.z); o[3] = __uint_as_float(u.w);
}
template <> __device__ __forceinline__ void unpack16<__nv_bfloat16>(const uint4& u, float* o) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    o[2 * k] = f.x;
    o[2 * k + 1] = f.y;
  }
}

// K3: 8 consecutive values of a row, as one lane holds them (one 16-byte
// vector in bf16, two in fp32). fp32 keeps its values as floats: held as
// raw words they spilled at nv 16.
template <typename T> struct Group;

template <> struct Group<__nv_bfloat16> {
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    u = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void get(float* o) const { unpack16<__nv_bfloat16>(u, o); }
};

template <> struct Group<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = *reinterpret_cast<const float4*>(p);
    b = *reinterpret_cast<const float4*>(p + 4);
  }
  __device__ __forceinline__ void get(float* o) const {
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
  }
};

// N (4 or 8) fp32 values from / to 16-byte aligned memory.
template <int N> __device__ __forceinline__ void load_fv(const float* p, float* o) {
#pragma unroll
  for (int h = 0; h < N; h += 4) load_vec(p + h, o + h);
}
template <int N> __device__ __forceinline__ void store_fv(float* p, const float* v) {
#pragma unroll
  for (int h = 0; h < N; h += 4) store_vec(p + h, v + h);
}

}  // namespace rownorm
}  // namespace tae
