// The flat-row attention body (rows_attention_bf16 in wide_attention.cu:
// K6, K9, and K7 / K8 where the per-image body does not take the shape):
// its launch plan. ops/cuda/wide_attention.py::rows_plan mirrors it.
#pragma once

namespace tae {
namespace rows {

// A block takes kTile consecutive rows of the flat (B * N, 3C) token axis
// and a group of heads, one warp a head, along grid.y. Measured at p128 (4
// tokens, 32 heads of 80; bench/rows_body.py, PERF.md section 6): K9 in 8
// blocks of 4 heads ran 4-5% faster than in 16 of 2; K6 ran level with 1,
// 2 and 4 heads a block.
constexpr int kTile = 16;
constexpr int kHeadsPerBlock = 4;
// With the int8 output the blocks of one row tile form a thread-block
// cluster along grid.y (non-portable above 8 blocks); where kMaxCluster
// blocks of kHeadsPerBlock do not cover the heads, a block takes more, up
// to kMaxHeadsPerBlock: so the int8 form takes up to 128 heads.
constexpr int kMaxCluster = 16;
constexpr int kMaxHeadsPerBlock = 8;
// Most keys of one staged chunk; fewer where a tile sees fewer keys.
constexpr int kMaxChunk = 64;
// Most tokens per image (K7's limit; K6, K8 and K9 take up to 64).
constexpr int kMaxTokens = 256;

struct Plan {
  int cluster;          // int8 output: blocks of a cluster along grid.y; else 1
  int groups;           // grid.y: head groups of heads_per_block (the last fewer)
  int heads_per_block;  // warps of a block, one a head
  int chunk;            // keys per staged chunk, a multiple of 16
  int smem;             // dynamic shared memory of a block, bytes
};

// Keys per staged chunk for n tokens per image: the widest key range a
// 16-row tile can see (16 / n whole images, one image, or parts of up to
// 15 / n + 2 images), padded to 16, up to kMaxChunk.
__host__ __device__ inline int chunk_for(int n) {
  const int span = kTile % n == 0 ? kTile : n % kTile == 0 ? n : n * (15 / n + 2);
  const int padded = (span + 15) / 16 * 16;
  return padded < kMaxChunk ? padded : kMaxChunk;
}

// Shared memory of one warp: its head's Q tile and a chunk of K and V, bf16
// rows of dh + 8 (ldmatrix of 8 rows hits 8 distinct 16-byte bank groups).
__host__ __device__ inline int warp_bytes(int dh, int chunk) {
  return (kTile + 2 * chunk) * (dh + 8) * 2;
}

// Whether the bf16 body takes (n, heads, dh), with an int8 output (q8) or
// a bf16 one, and how it is launched.
inline bool plan(int n, int heads, int dh, bool q8, Plan& p) {
  if (n < 1 || n > kMaxTokens || heads < 1 || heads > 65535 || (dh != 64 && dh != 80))
    return false;
  int hpb = heads < kHeadsPerBlock ? heads : kHeadsPerBlock;
  if (q8) {
    const int need = (heads + kMaxCluster - 1) / kMaxCluster;
    hpb = hpb > need ? hpb : need;
    if (hpb > kMaxHeadsPerBlock) return false;
  }
  p.heads_per_block = hpb;
  p.groups = (heads + hpb - 1) / hpb;
  p.cluster = q8 ? p.groups : 1;
  p.chunk = chunk_for(n);
  // q8: each warp's row maxima and the block's, exchanged over the cluster
  p.smem = hpb * warp_bytes(dh, p.chunk) + (q8 ? 4 * kTile * (hpb + 1) : 0);
  return true;
}

}  // namespace rows
}  // namespace tae
