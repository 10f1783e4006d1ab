// K14's launch plan for the bf16 codebook search (nearest_code_wgmma_kernel
// in quantizer.cu), mirrored by ops/cuda/quantizer.py::vq_plan and exposed
// as tae_nearest_code_plan.
//
// A block takes `rows` rows of z (64 for each of its `consumers` consumer
// warpgroups) and a contiguous range of `per` code tiles of kCodes codes;
// a pipeline step is one tile's kCols columns (128 bytes of bf16, the
// swizzle's span), so a code tile takes ceil(V / kCols) steps. A producer
// warp fills a ring of slots by TMA: each slot holds the step's codebook
// slab (kCodes x kCols), z's slab when z rides the ring, and, in the
// tile's last step, the tile's |c|^2. z stays resident (its V / kCols
// slabs loaded once) where the block's shared memory holds it beside
// kMinStages slots; the ring takes as many slots as then fit, up to
// kMaxStages (a TMA load from L2 takes several steps' products to land).
//   Rows a block: kMaxConsumers warpgroups from kPairRows rows on, and from
// 65 rows where 64-row blocks could not keep z resident (a block's products
// per byte staged grow with its rows: where z rides the ring the search is
// bound by what the SMs can take from L2); one otherwise (fewer rows: a
// block then stages less of z before its first product). Where the blocks
// are fewer than the SMs the codebook is split into ranges over grid.y,
// about one block an SM in all, at most one range a code tile, and a merge
// kernel takes each row's best of the ranges in code order.
//   The choices, each timed in turns with the tree by bench/vq_body.py on an
// H100 80GB HBM3 at 700 W, at (16384, 256) x 8192 codes (the tree 0.111 ms)
// and (256, 16384): 256-code tiles 0.109 there but 0.255 against 0.203 at
// (256, 16384); 4 slots at most 0.112 and 0.212 against 0.204; one consumer
// warpgroup 0.130 and 0.221 (but at (256, 256) 0.0106 against 0.0125,
// hence kPairRows). Row blocks paired into thread-block clusters, each
// loading half of every codebook slab and multicasting it to both (the
// bench's cluster2), took 0.116 and 0.204: each SM still takes every slab
// into its shared memory, so the search runs unclustered. The two consumer
// warpgroups run in step, not ping-ponged: without the distances and the
// running argmin the search takes 0.084 ms.
#pragma once

namespace tae {
namespace vq {

constexpr int kCols = 64;          // columns of a pipeline step
constexpr int kCodes = 128;        // codes of a tile: the wgmma's N
constexpr int kMinStages = 4;      // ring slots beside a resident z, at least
constexpr int kMaxStages = 8;      // ring slots, at most
constexpr int kMaxConsumers = 2;   // consumer warpgroups of 64 rows a block
constexpr int kPairRows = 512;     // rows from which a block takes two
// dynamic shared memory a block may take, beside its few static barriers
constexpr int kSmemLimit = 232448 - 1024;

struct Plan {
  int rows;       // rows of z a block: 64 a consumer warpgroup
  int consumers;  // consumer warpgroups (the block has one producer warp more)
  int codes;      // codes of a tile
  int stages;     // ring slots
  int resident;   // 1: z's slabs stay in shared memory; 0: z rides the ring
  int blocks;     // grid.x: row blocks
  int splits;     // grid.y: ranges of the codebook
  int per;        // code tiles a range
  int smem;       // dynamic shared memory of a block, bytes
};

__host__ __device__ constexpr int ceil_div(int x, int d) { return (x + d - 1) / d; }
__host__ __device__ constexpr int round_up(int x, int to) { return ceil_div(x, to) * to; }

// One ring slot: the codebook slab, z's slab when it rides the ring, the
// tile's norms; whole 1024-byte units, so that every slab keeps the
// 128-byte swizzle's alignment.
__host__ __device__ constexpr int slot_bytes(int rows, int codes, bool resident) {
  return round_up(codes * kCols * 2 + (resident ? 0 : rows * kCols * 2) + codes * 4, 1024);
}
// The block's dynamic shared memory: z's resident slabs, `stages` ring
// slots, and 1024 bytes to align the base.
__host__ __device__ constexpr int smem_bytes(int rows, int codes, int stages, int v,
                                             bool resident) {
  return (resident ? ceil_div(v, kCols) * rows * kCols * 2 : 0) +
         stages * slot_bytes(rows, codes, resident) + 1024;
}

// False where the kernel does not take the shape (bf16 needs V a multiple
// of 8: 16-byte rows for TMA).
inline bool plan(int m, int v, int k, int sms, Plan& p) {
  if (m < 1 || k < 1 || v < 8 || v % 8 != 0 || sms < 1) return false;
  const bool z64 = smem_bytes(64, kCodes, kMinStages, v, true) <= kSmemLimit;
  p.consumers = m > 64 && (m >= kPairRows || !z64) ? kMaxConsumers : 1;
  p.rows = 64 * p.consumers;
  p.codes = kCodes;
  p.blocks = ceil_div(m, p.rows);
  const int tiles = ceil_div(k, p.codes);
  int splits = 1;
  if (p.blocks < sms) {
    splits = sms / p.blocks;
    if (splits > tiles) splits = tiles;
    if (splits < 1) splits = 1;
  }
  p.per = ceil_div(tiles, splits);
  p.splits = ceil_div(tiles, p.per);  // none of the ranges empty
  p.resident = smem_bytes(p.rows, p.codes, kMinStages, v, true) <= kSmemLimit ? 1 : 0;
  const int slot = slot_bytes(p.rows, p.codes, p.resident != 0);
  const int room = kSmemLimit - smem_bytes(p.rows, p.codes, 0, v, p.resident != 0);
  p.stages = room / slot < kMaxStages ? room / slot : kMaxStages;
  p.smem = smem_bytes(p.rows, p.codes, p.stages, v, p.resident != 0);
  return p.stages >= 2;
}

// The fp32 search (nearest_code_f32_kernel, on the CUDA cores: no TF32),
// mirrored by ops/cuda/quantizer.py::vq_f32_plan and exposed as
// tae_nearest_code_f32_plan. A block of kThreads threads (16 x 16) takes
// kRows rows of z and a contiguous range of `per` code tiles, each thread
// an 8-row register tile of (row, code) sums against 16 codes of a
// kWideCodes-code tile (8 of a kCodes-code tile where the row blocks times
// the wide tiles are fewer than the SMs: there the narrow tile keeps every
// SM busy). The columns come in chunks of kChunk by cp.async through a
// ring of `stages` slots (the codebook's chunk, and z's where z rides the
// ring); z stays resident in shared memory, its rows padded to an odd
// number of 16-byte units, where it fits beside kMinStages slots. Where the
// row blocks are fewer than the SMs the codebook is split over grid.y as
// the bf16 plan splits it, and nearest_code_merge_kernel takes each row's
// best of the ranges.
namespace f32 {

constexpr int kRows = 128;       // rows of z a block
constexpr int kCodes = 128;      // codes of a narrow tile: 8 a thread
constexpr int kWideCodes = 256;  // codes of a wide tile: 16 a thread
constexpr int kChunk = 32;       // columns of a ring slot
constexpr int kMinStages = 2;    // ring slots, at least
constexpr int kMaxStages = 4;    // ring slots, at most
constexpr int kThreads = 256;    // 16 x 16 threads, each 8 rows x 8 or 16 codes
constexpr int kLd = kChunk + 4;  // a ring slot's row of floats

struct Plan {
  int rows;      // rows of z a block
  int codes;     // codes of a tile (kCodes or kWideCodes)
  int chunk;     // columns of a ring slot
  int stages;    // ring slots
  int resident;  // 1: z stays in shared memory; 0: z rides the ring
  int blocks;    // grid.x: row blocks
  int splits;    // grid.y: ranges of the codebook
  int per;       // code tiles a range
  int smem;      // dynamic shared memory of a block, bytes
};

// a resident z row: V rounded up to whole chunks (zeros past V), plus 4
__host__ __device__ constexpr int ldz(int v) { return round_up(v, kChunk) + 4; }
// one ring slot: the codebook's chunk, and z's where it rides
__host__ __device__ constexpr int slot_bytes(int codes, bool resident) {
  return 4 * (codes + (resident ? 0 : kRows)) * kLd;
}
// resident z, `stages` slots, and the (distance, index) pairs of the
// block's two row halves
__host__ __device__ constexpr int smem_bytes(int v, int codes, int stages, bool resident) {
  return (resident ? 4 * kRows * ldz(v) : 0) + stages * slot_bytes(codes, resident) +
         8 * 2 * kRows;
}

// False where the kernel does not take the shape (V a multiple of 4:
// 16-byte rows for cp.async).
inline bool plan(int m, int v, int k, int sms, Plan& p) {
  if (m < 1 || k < 1 || v < 4 || v % 4 != 0 || sms < 1) return false;
  p.rows = kRows;
  p.chunk = kChunk;
  p.blocks = ceil_div(m, kRows);
  p.codes = p.blocks * ceil_div(k, kWideCodes) >= sms ? kWideCodes : kCodes;
  const int tiles = ceil_div(k, p.codes);
  int splits = 1;
  if (p.blocks < sms) {
    splits = sms / p.blocks;
    if (splits > tiles) splits = tiles;
    if (splits < 1) splits = 1;
  }
  p.per = ceil_div(tiles, splits);
  p.splits = ceil_div(tiles, p.per);  // none of the ranges empty
  p.resident = smem_bytes(v, p.codes, kMinStages, true) <= kSmemLimit ? 1 : 0;
  const int room = kSmemLimit - smem_bytes(v, p.codes, 0, p.resident != 0);
  const int fit = room / slot_bytes(p.codes, p.resident != 0);
  p.stages = fit < kMaxStages ? fit : kMaxStages;
  p.smem = smem_bytes(v, p.codes, p.stages, p.resident != 0);
  return p.stages >= kMinStages;
}

}  // namespace f32
}  // namespace vq
}  // namespace tae
