// K7 / K8 on the bf16 attention forward body (flash_attention.cu): the
// launch plan and the launcher, called by the entries in wide_attention.cu.
// ops/cuda/wide_attention.py::q8_plan mirrors the plan.
#pragma once

namespace tae {
namespace q8 {

// A cluster's blocks cover the heads of one (image, row tile), each taking
// kHeadsPerBlock heads (the last rank fewer where the count is odd; a single
// head where heads is 1): at most kMaxCluster blocks, so the body takes up to
// 32 heads. Above 8 blocks the cluster size is non-portable
// (cudaFuncAttributeNonPortableClusterSizeAllowed). Measured at 16 heads
// (p16), 2 heads a block (8 blocks) beat 1 (16 blocks: fewer clusters fit
// the card at once) and 4; at 32 (p32), 16 blocks of 2 beat 8 of 4.
constexpr int kMaxCluster = 16;
constexpr int kHeadsPerBlock = 2;
// Fewest tokens per image at which K7 and K8 run on this body; below, a
// per-image block pads its 16-row tiles and the flat-row body of
// wide_attention.cu keeps them.
constexpr int kMinTokens = 16;

struct Plan {
  int cluster;          // blocks of a cluster, along grid.y
  int heads_per_block;  // the last rank may take fewer
  int warps;            // 16 query rows each
  int smem;             // dynamic shared memory of a block, bytes
};

// Whether the body takes (n, heads, dh) in bf16, and how it is launched.
bool plan(int n, int heads, int dh, Plan& p);

// qkv: (batch, n, 3 * heads * dh) bf16 contiguous; out_q: (batch, n, heads *
// dh) int8; out_s: (batch * n) fp32. p from plan(n, heads, dh, p).
int launch(const Plan& p, const void* qkv, void* out_q, void* out_s, int batch, int n,
           int heads, int dh, float scale, void* stream);

// K7 / K8 in float32 from kF32TiledMinTokens (33) tokens, on the fp32 tiled
// forward body (attention_q8_f32_tiled): a cluster of up to kF32MaxCluster
// blocks of 256 threads covers the heads of one (image, 64-row tile), each
// taking ceil(heads / kF32MaxCluster) heads (the last rank fewer).
constexpr int kF32MaxCluster = 16;
bool plan_f32(int n, int heads, int dh, Plan& p);

// qkv: (batch, n, 3 * heads * dh) fp32 contiguous; out_q, out_s as launch.
int launch_f32(const Plan& p, const void* qkv, void* out_q, void* out_s, int batch, int n,
               int heads, int dh, float scale, void* stream);

}  // namespace q8
}  // namespace tae
