// K13 int4_mlp — the fused w4a8 MLP of the int4 serving block.
//
// Replaces: tae_tpu/ops/pallas/int4_block.py::int4_mlp (_mlp4_kernel).
//   out = residual + fc2(gelu_tanh(fc1(xq))), both weights in the packed
//   int4 layout with group-wise scales (int4_common.cuh). Per hidden block
//   of 256 columns: fc1 by scale groups (h += float(ig_g) * s1_g), h * sx +
//   b1, tanh-GELU in fp32, one scale per (row, hidden block) max(amax /
//   127, 1e-12) and the codes round(h * (1 / sh)), fc2 by groups (part +=
//   float(ig_g) * s2_g), acc += part * sh; then + b2 + residual. The hidden
//   block is part of the numerics.
// What bounds it on the H100: device-memory bytes of the two packed weights
//   at the few rows int4 serving is for (26 MB at D = 2560), tensor-core
//   operations (4 * M * D * H) at M = 16384.
// What the design does about it: K5's three launches (int8_block.cu) on
//   K12's body (int8_common.cuh's gemm_mainloop with the packed int4 B
//   operand, RowsI4), output tiles spread over the grid so that no block
//   streams a whole weight.
//   * int4_mlp_fc1_kernel: a block owns BM rows x one hidden block; its
//     fp32 tile folds each G1 group in ascending K; the epilogue applies
//     sx, b1 and gelu_tanh in registers, takes each row's amax over the
//     hidden block (quad shuffles, then across the block's warps through
//     shared memory) and writes the int8 codes hq (M, H) and the scales sh
//     (H / 256, M) to workspaces the wrapper allocates.
//   * int4_mlp_fc2_kernel: a block owns a (BM x BN) tile of the (M, D)
//     output and walks K = H (or its group's share) in order; each G2
//     group folds into an fp32 part, and at each hidden block's end acc =
//     acc + part * sh[b, row], part = 0. With one hidden group its epilogue
//     adds b2 and the residual and casts; with more the raw fp32 acc goes
//     to a (groups, M, D) workspace.
//   * int4_mlp_finish_kernel (more than one group only), a thread per 8
//     columns of a row: the groups added in order, + b2 + residual, the
//     cast. An int4 block chains no LayerNorm.
//   Few output tiles (few rows) deal the hidden blocks to groups over
//   grid.z (mlp4_tiles: mlp_hidden_groups of fc2's tiles); the last bit of
//   a sum follows the group count, as in K5.
#include "int4_common.cuh"

namespace {

using namespace tae;
using namespace tae::i8;
using namespace tae::i4;

constexpr int kBH = 256;   // hidden columns per activation scale

struct Mlp4Args {
  const int8_t* xq;       // (m, d)
  const float* sx;        // (m,)
  const uint8_t* w1;      // (hdim, d / 2)
  const float* s1;        // (d / g1, hdim)
  const void* b1;         // (hdim,) of p_dtype
  const uint8_t* w2;      // (d, hdim / 2)
  const float* s2;        // (hdim / g2, d)
  const void* b2;         // (d,) of p_dtype
  const void* residual;   // (m, d) of out_dtype
  void* out;              // (m, d) of out_dtype
  int m, d, hdim, g1, g2;
  int out_dtype, p_dtype;
  // workspaces
  int8_t* hq;             // (m, hdim) hidden codes
  float* sh;              // (hdim / kBH, m) hidden scales
  float* part;            // (groups, m, d) fp32 accumulators of the hidden groups
  int groups;
};

// fc1 tiles (the N tile is one hidden block), in the order of
// ops/cuda/int4_block.py's FC1_TILES; fc2 tiles, FC2_TILES' order. A lane
// holds an int32 and one (fc1) or two (fc2) fp32 accumulator tiles.
using kFc1Many = Tiles<32, 256, 1, 8, 4, 2>;
using kFc1Few = Tiles<16, 256, 1, 8, 6>;
using kFc2Many = Tiles<64, 64, 2, 2, 4>;
using kFc2Few = Tiles<16, 64, 1, 2, 4>;

template <class S, class B>
__host__ __device__ constexpr int fc1_smem() {
  return ring_bytes<S, B>() + S::BM * S::WARPS_N * 4;
}

// h = gelu(sum_g float(xq_g . w1_g^T) * s1_g * sx + b1) for BM rows x one
// hidden block, then one scale per row over the block and the int8 codes.
template <class S, class B>
__global__ void __launch_bounds__(S::NT, S::MINB) int4_mlp_fc1_kernel(const Mlp4Args p) {
  static_assert(S::BN == kBH, "fc1's tile is one hidden block");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* red = reinterpret_cast<float*>(smem_raw + ring_bytes<S, B>());   // [BM][WARPS_N]
  const int row0 = blockIdx.y * S::BM, blk = blockIdx.x, h0 = blk * kBH;
  const int lane = threadIdx.x % 32, wn = (threadIdx.x / 32) % S::WARPS_N;

  float h[S::MI][S::NI][4];
  zero<S>(h);
  const float* s1 = p.s1 + h0;
  const int n_groups = p.d / p.g1;
  float2 sc[S::NI];
  load_scales<S>(sc, s1, kBH);
  auto fold = [&](Acc<S>& c, int g) {
    fold_group<S>(c, h, sc);
    if (g + 1 < n_groups) load_scales<S>(sc, s1 + static_cast<long>(g + 1) * p.hdim, kBH);
  };
  int acc[S::MI][S::NI][4];
  gemm_mainloop<S, B>(acc, p.xq + static_cast<long>(row0) * p.d, p.d, p.m - row0,
                      reinterpret_cast<const int8_t*>(p.w1) + static_cast<long>(h0) * (p.d / 2),
                      p.d / 2, kBH, 0, p.d, p.g1 / B::kFoldK,
                      reinterpret_cast<int8_t*>(smem_raw), fold);
  transpose_rows8<S>(h);

  // column groups outer, so one group's biases are live at a time
  float amax[S::MI][2], sxr[S::MI][2];
#pragma unroll
  for (int mi = 0; mi < S::MI; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = row0 + acc_row<S>(mi, hf);
      // rows past m hold zero codes; scale 1 keeps them finite
      sxr[mi][hf] = row < p.m ? p.sx[row] : 1.0f;
      amax[mi][hf] = 0.f;
    }
#pragma unroll
  for (int q = 0; q < S::NI / 4; ++q) {
    float b[8];
    load8(p.b1, h0 + rows8_col<S>(q), p.p_dtype, b);
#pragma unroll
    for (int mi = 0; mi < S::MI; ++mi)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float& v = h[mi][4 * q + j / 2][2 * hf + j % 2];
          v = gelu_tanh(__fadd_rn(__fmul_rn(v, sxr[mi][hf]), b[j]));
          amax[mi][hf] = fmaxf(amax[mi][hf], fabsf(v));
        }
  }
#pragma unroll
  for (int mi = 0; mi < S::MI; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float a = amax[mi][hf];
      a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, 1));
      a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, 2));
      amax[mi][hf] = a;
      if (lane % 4 == 0) red[acc_row<S>(mi, hf) * S::WARPS_N + wn] = a;
    }
  __syncthreads();

#pragma unroll
  for (int mi = 0; mi < S::MI; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = acc_row<S>(mi, hf), row = row0 + r;
      float a = amax[mi][hf];
#pragma unroll
      for (int w = 0; w < S::WARPS_N; ++w) a = fmaxf(a, red[r * S::WARPS_N + w]);
      const float s = quant_scale(a);
      const float inv = 1.0f / s;
      if (row >= p.m) continue;
#pragma unroll
      for (int q = 0; q < S::NI / 4; ++q) {
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = h[mi][4 * q + j / 2][2 * hf + j % 2];
        *reinterpret_cast<uint2*>(p.hq + static_cast<long>(row) * p.hdim + h0 +
                                  rows8_col<S>(q)) = quantize8(v, inv);
      }
      if (wn == 0 && lane % 4 == 0) p.sh[static_cast<long>(blk) * p.m + row] = s;
    }
}

// This group's share of fc2 for a (BM x BN) tile of the (m, d) output: per
// hidden block b in ascending order, part = sum over its G2 groups of
// float(hq_g . w2_g^T) * s2_g, acc = acc + part * sh[b, row]. One group:
// out = acc + b2 + residual; more: the raw fp32 acc to part[group].
template <class S, class B>
__global__ void __launch_bounds__(S::NT, S::MINB) int4_mlp_fc2_kernel(const Mlp4Args p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int row0 = blockIdx.y * S::BM, col0 = blockIdx.x * S::BN, grp = blockIdx.z;
  const int hgroup = p.hdim / p.groups, k0 = grp * hgroup;
  const int per_block = kBH / p.g2;   // scale groups per hidden block

  float part[S::MI][S::NI][4], facc[S::MI][S::NI][4];
  zero<S>(part);
  zero<S>(facc);
  const float* s2 = p.s2 + static_cast<long>(k0 / p.g2) * p.d + col0;
  const float* sh = p.sh + static_cast<long>(k0 / kBH) * p.m;
  const int n_groups = hgroup / p.g2, cols = p.d - col0;
  // this lane's rows' scales of the current hidden block, loaded a block ahead
  float shv[S::MI][2];
  auto load_sh = [&](int b) {
#pragma unroll
    for (int mi = 0; mi < S::MI; ++mi)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = row0 + acc_row<S>(mi, hf);
        shv[mi][hf] = row < p.m ? sh[static_cast<long>(b) * p.m + row] : 0.f;
      }
  };
  float2 sc[S::NI];
  load_scales<S>(sc, s2, cols);
  load_sh(0);
  auto fold = [&](Acc<S>& c, int g) {
    fold_group<S>(c, part, sc);
    if (g + 1 < n_groups) load_scales<S>(sc, s2 + static_cast<long>(g + 1) * p.d, cols);
    if ((g + 1) % per_block != 0) return;
#pragma unroll
    for (int mi = 0; mi < S::MI; ++mi)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int ni = 0; ni < S::NI; ++ni)
#pragma unroll
          for (int e = 2 * hf; e < 2 * hf + 2; ++e) {
            facc[mi][ni][e] = __fadd_rn(facc[mi][ni][e], __fmul_rn(part[mi][ni][e], shv[mi][hf]));
            part[mi][ni][e] = 0.f;
          }
    if (g + 1 < n_groups) load_sh((g + 1) / per_block);
  };
  int acc[S::MI][S::NI][4];
  gemm_mainloop<S, B>(acc, p.hq + static_cast<long>(row0) * p.hdim, p.hdim, p.m - row0,
                      reinterpret_cast<const int8_t*>(p.w2) + static_cast<long>(col0) * (p.hdim / 2),
                      p.hdim / 2, p.d - col0, k0, k0 + hgroup, p.g2 / B::kFoldK,
                      reinterpret_cast<int8_t*>(smem_raw), fold);

  if (p.groups > 1) {
    float* out = p.part + static_cast<long>(grp) * p.m * p.d;
    for_rows8<S>(facc, [&](int r, int c, const float* v) {
      const long row = row0 + r;
      const int col = col0 + c;
      if (row >= p.m || col >= p.d) return;
      store_vec(out + row * p.d + col, v);
      store_vec(out + row * p.d + col + 4, v + 4);
    });
    return;
  }
  for_rows8<S>(facc, [&](int r, int c, const float* v) {
    const long row = row0 + r;
    const int col = col0 + c;
    if (row >= p.m || col >= p.d) return;
    float y[8], b[8], res[8];
    load8(p.b2, col, p.p_dtype, b);
    load8(p.residual, row * p.d + col, p.out_dtype, res);
#pragma unroll
    for (int j = 0; j < 8; ++j) y[j] = __fadd_rn(__fadd_rn(v[j], b[j]), res[j]);
    store8(p.out, row * p.d + col, p.out_dtype, y);
  });
}

// The epilogue of a launch split into hidden groups, a thread per 8 columns
// of a row: the groups' fp32 accumulators added in group order, then + b2
// + residual and the cast.
__global__ void __launch_bounds__(256) int4_mlp_finish_kernel(const Mlp4Args p) {
  const int vecs = p.d / 8;
  const long i = static_cast<long>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= static_cast<long>(p.m) * vecs) return;
  const long row = i / vecs;
  const int col = static_cast<int>(i % vecs) * 8;
  const long gstride = static_cast<long>(p.m) * p.d;
  const float* y0 = p.part + row * p.d + col;
  float y[8], t[8], b[8], res[8];
  load_vec(y0, y);
  load_vec(y0 + 4, y + 4);
  for (int g = 1; g < p.groups; ++g) {
    load_vec(y0 + g * gstride, t);
    load_vec(y0 + g * gstride + 4, t + 4);
#pragma unroll
    for (int j = 0; j < 8; ++j) y[j] = __fadd_rn(y[j], t[j]);
  }
  load8(p.b2, col, p.p_dtype, b);
  load8(p.residual, row * p.d + col, p.out_dtype, res);
#pragma unroll
  for (int j = 0; j < 8; ++j) y[j] = __fadd_rn(__fadd_rn(y[j], b[j]), res[j]);
  store8(p.out, row * p.d + col, p.out_dtype, y);
}

template <class S, class B>
int launch_fc1(const Mlp4Args& p, cudaStream_t stream) {
  const long tiles_m = (static_cast<long>(p.m) + S::BM - 1) / S::BM;
  if (tiles_m > 65535) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = fc1_smem<S, B>();
  static_assert(smem <= kSmemLimit, "fc1 tile exceeds a block's shared memory");
  const cudaError_t rc = allow_smem(int4_mlp_fc1_kernel<S, B>, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid(p.hdim / kBH, static_cast<unsigned>(tiles_m));
  int4_mlp_fc1_kernel<S, B><<<grid, S::NT, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <class S, class B>
int launch_fc2(const Mlp4Args& p, cudaStream_t stream) {
  const long tiles_m = (static_cast<long>(p.m) + S::BM - 1) / S::BM;
  if (tiles_m > 65535) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = ring_bytes<S, B>();
  static_assert(smem <= kSmemLimit, "fc2 tile exceeds a block's shared memory");
  const cudaError_t rc = allow_smem(int4_mlp_fc2_kernel<S, B>, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid((p.d + S::BN - 1) / S::BN, static_cast<unsigned>(tiles_m), p.groups);
  int4_mlp_fc2_kernel<S, B><<<grid, S::NT, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <class B>
int launch_fc1_tiles(const Mlp4Args& p, int tiles, cudaStream_t stream) {
  switch (tiles) {
    case 0: return launch_fc1<kFc1Many, B>(p, stream);
    case 1: return launch_fc1<kFc1Few, B>(p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <class B>
int launch_fc2_tiles(const Mlp4Args& p, int tiles, cudaStream_t stream) {
  switch (tiles) {
    case 0: return launch_fc2<kFc2Many, B>(p, stream);
    case 1: return launch_fc2<kFc2Few, B>(p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch_mlp(const Mlp4Args& p, int fc1_tiles, int fc2_tiles, cudaStream_t stream) {
  int rc = p.g1 % kBK == 0 ? launch_fc1_tiles<RowsI4<kBK>>(p, fc1_tiles, stream)
                           : launch_fc1_tiles<RowsI4<64>>(p, fc1_tiles, stream);
  if (rc != 0) return rc;
  rc = p.g2 % kBK == 0 ? launch_fc2_tiles<RowsI4<kBK>>(p, fc2_tiles, stream)
                       : launch_fc2_tiles<RowsI4<64>>(p, fc2_tiles, stream);
  if (rc != 0 || p.groups == 1) return rc;
  const long threads = static_cast<long>(p.m) * (p.d / 8);
  int4_mlp_finish_kernel<<<static_cast<unsigned>((threads + 255) / 256), 256, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

bool bad_dtype(int d) { return d != kFloat32 && d != kBFloat16; }

}  // namespace

// xq (m, d) int8, sx (m,) f32, w1 (hdim, d / 2) and w2 (d, hdim / 2) packed
// uint8, s1 (d / g1, hdim) and s2 (hdim / g2, d) f32, b1 (hdim,) and b2 (d,)
// of p_dtype, residual and out (m, d) of out_dtype. The hidden block is 256:
// hdim a multiple of it, g2 a multiple of 64 dividing it, g1 a multiple of
// 64 dividing d. Workspaces: hq (m, hdim) int8, sh (hdim / 256, m) f32,
// part (groups, m, d) f32 (needed with groups > 1). fc1_tiles and fc2_tiles
// pick the products' tile shapes (ops/cuda/int4_block.py's mlp4_tiles);
// groups splits the hidden blocks evenly over fc2's grid.z. All contiguous
// and 16-byte aligned.
extern "C" int tae_int4_mlp_fwd(const void* xq, const void* sx, const void* w1, const void* s1,
                                const void* b1, const void* w2, const void* s2, const void* b2,
                                const void* residual, void* out, int m, int d, int hdim, int g1,
                                int g2, int out_dtype, int p_dtype, void* hq, void* sh,
                                void* part, int groups, int fc1_tiles, int fc2_tiles,
                                void* stream) {
  if (m < 1 || d < 64 || hdim < kBH || hdim % kBH != 0 || g1 < 64 || g1 % 64 != 0 ||
      d % g1 != 0 || g2 < 64 || g2 % 64 != 0 || kBH % g2 != 0 || groups < 1 ||
      groups > 65535 || (hdim / kBH) % groups != 0 || hq == nullptr || sh == nullptr ||
      (groups > 1 && part == nullptr) || bad_dtype(out_dtype) || bad_dtype(p_dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Mlp4Args p;
  p.xq = static_cast<const int8_t*>(xq);
  p.sx = static_cast<const float*>(sx);
  p.w1 = static_cast<const uint8_t*>(w1);
  p.s1 = static_cast<const float*>(s1);
  p.b1 = b1;
  p.w2 = static_cast<const uint8_t*>(w2);
  p.s2 = static_cast<const float*>(s2);
  p.b2 = b2;
  p.residual = residual;
  p.out = out;
  p.m = m; p.d = d; p.hdim = hdim; p.g1 = g1; p.g2 = g2;
  p.out_dtype = out_dtype;
  p.p_dtype = p_dtype;
  p.hq = static_cast<int8_t*>(hq);
  p.sh = static_cast<float*>(sh);
  p.part = static_cast<float*>(part);
  p.groups = groups;
  return launch_mlp(p, fc1_tiles, fc2_tiles, static_cast<cudaStream_t>(stream));
}
