// K3 ln_quant and K5 int8_mlp — the fused kernels of the int8 serving block.
//
// K3 replaces: tae_tpu/ops/pallas/int8_block.py::ln_quant (_ln_quant_kernel).
//   LayerNorm with fp32 statistics, then per-row symmetric int8:
//   s = max(max|y| / 127, 1e-12), q = clip(round(y * (1 / s)), -127, 127).
//   x (M, D) float32 / bfloat16 -> (M, D) int8 + (M,) float32.
//   Bound on the H100 by device-memory bytes (one read of x, half as many
//   bytes written) at many rows; at p128's few rows (4 to 256 of 2560) the
//   work is a few microseconds of memory latency, under a launch's cost.
//   Design (ln_quant_regs_kernel; plan in row_norm.cuh): one warp per row,
//   the row held in registers. Templated on the input and affine dtypes
//   and on nv, the 8-column groups a lane holds (4 at 1024 columns, 8 at
//   2048, 10 at 2560), a lane issues its nv 16-byte loads of x, and in
//   bf16 of gamma and beta, in one unrolled burst, so a row costs one memory
//   round trip; then the four steps (sum, centred squares, max|y|,
//   quantize) run on registers, y computed once. Each lane sums in the
//   first design's column order and every epilogue product is rounded as
//   in ln_quant_row, so codes and scales are that design's bit for bit;
//   what is exact in any order is reordered: max|y| as a tree and one
//   redux, the codes without conversion instructions (codes8).
//   Rows a block from the rows: 4 from 256 rows on, fewer below, so that
//   few rows spread over the SMs. Rows wider than 4096 columns take the
//   first design: ln_quant_row's runtime loop of 16-byte loads, re-read
//   from L1 in each of the four passes.
//
// K5 replaces: tae_tpu/ops/pallas/int8_block.py::int8_mlp (_mlp_kernel).
//   out = residual + fc2(gelu_tanh(fc1(xq))); the hidden activation is
//   requantized per (row, hidden block of block_h columns) and the fc2
//   partial products are summed in fp32 with that block's scale, so
//   block_h is part of the numerics. Optional ln_next epilogue: LayerNorm +
//   int8 quantize of the fp32 output row.
//   Bound on the H100 by tensor-core operations (4 * M * D * H of them) at
//   many rows and by the weights' bytes (2 * D * H) at few.
//   Design: three device launches a call, the two products on
//   int8_common.cuh's gemm_mainloop (mma.sync.m16n8k32, accumulators in
//   registers), their output tiles spread over the grid so that no block
//   streams a whole weight.
//   * int8_mlp_fc1_kernel: a block owns BM rows x one hidden block (its
//     N tile is block_h wide: 128, 256 or 512). Its epilogue dequantizes,
//     adds b1 and applies gelu_tanh to the fp32 values in registers, takes
//     each row's amax over the hidden block (quad shuffles, then across the
//     block's warps through shared memory), and writes the int8 codes hq
//     (M, H) and the scales sh (H / block_h, M) to workspaces the wrapper
//     allocates (64 MB + 1 MB at M = 16384, H = 4096).
//   * int8_mlp_fc2_kernel: a block owns a (BM x BN) tile of the (M, D)
//     output and walks K = H (or its group's share) in order; after each
//     hidden block b the int32 sums are folded into an fp32 register
//     accumulator, acc = acc + float(ig_b) * sh[b, row], each product and
//     sum rounded separately, in ascending b, as int8_mlp_reference. The
//     raw fp32 accumulator goes to a (groups, M, D) workspace.
//   * int8_mlp_finish_kernel, one block per row: the groups' accumulators
//     added in group order, then acc * sw2 + b2 + residual, the cast, and
//     ln_next on the fp32 row (in shared memory, one warp's reductions).
//   Few output tiles (few rows) split the hidden blocks into groups over
//   grid.z (mlp_hidden_groups); with one group the fp32 sum is the plain
//   version's order exactly, with more each group sums its blocks in order
//   and the finish adds the groups in order (the last bit of a sum then
//   follows the group count).
#include "int8_common.cuh"
#include "row_norm.cuh"

namespace {

using namespace tae;
using namespace tae::i8;

// ------------------------------------------------------------------- K3

// The first design, for rows wider than the register body takes: a warp a
// row, blockDim.x / 32 rows a block.
__global__ void __launch_bounds__(rownorm::kLnqMaxWarps * 32)
ln_quant_kernel(const void* __restrict__ x, int x_dtype, const void* __restrict__ gamma,
                const void* __restrict__ beta, int w_dtype, int8_t* __restrict__ q,
                float* __restrict__ s, int rows, int cols, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long row = static_cast<long>(blockIdx.x) * (blockDim.x / 32) + warp;
  if (row >= rows) return;
  const long base = row * cols;
  auto load = [=](int i, float* v) { load8(x, base + i, x_dtype, v); };
  ln_quant_row(load, cols, gamma, beta, w_dtype, eps, q + base, s + row, lane);
}

// quantize8's codes of y[0..7] * inv, clip(rint(y * inv), -127, 127),
// without its conversions: the value clamped to the integer bounds first
// (rint commutes with such a clamp; a NaN clamps to -127 either way), then
// 1.5 * 2^23 added, which rounds it half to even into the low mantissa
// bits, whose low byte is the two's-complement code; byte permutes pack
// them.
__device__ __forceinline__ uint2 codes8(const float* y, float inv) {
  unsigned c[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    c[k] = __float_as_uint(__fadd_rn(
        fminf(fmaxf(__fmul_rn(y[k], inv), -127.0f), 127.0f), 12582912.0f));
  unsigned w[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    w[h] = __byte_perm(__byte_perm(c[4 * h], c[4 * h + 1], 0x0040),
                       __byte_perm(c[4 * h + 2], c[4 * h + 3], 0x0040), 0x5410);
  return make_uint2(w[0], w[1]);
}

// The register body: lane holds columns (32 j + lane) * 8 .. + 7 of its
// row for j < NV. gamma and beta come with x's burst where they fit beside
// it (bf16 up to NV 10), else at the affine step (from L1 / L2: every row
// of the card reads them).
template <typename T, typename W, int NV>
__global__ void __launch_bounds__(rownorm::kLnqMaxWarps * 32, rownorm::lnq_min_blocks(NV))
ln_quant_regs_kernel(const T* __restrict__ x, const W* __restrict__ gamma,
                     const W* __restrict__ beta, int8_t* __restrict__ q,
                     float* __restrict__ s, int rows, int cols, float eps) {
  constexpr bool kAffineFirst = rownorm::lnq_affine_first(NV, sizeof(T), sizeof(W));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long row = static_cast<long>(blockIdx.x) * (blockDim.x / 32) + warp;
  if (row >= rows) return;
  const T* xr = x + row * cols;
  rownorm::Group<T> xg[NV];
  rownorm::Group<W> gg[NV], bg[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = (j * 32 + lane) * 8;
    if (i < cols) {
      xg[j].load(xr + i);
      if (kAffineFirst) {
        gg[j].load(gamma + i);
        bg[j].load(beta + i);
      }
    }
  }
  float v[NV][8];
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if ((j * 32 + lane) * 8 < cols) {
      xg[j].get(v[j]);
#pragma unroll
      for (int k = 0; k < 8; ++k) sum += v[j][k];
    }
  }
  const float mean = warp_sum(sum) / cols;

  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if ((j * 32 + lane) * 8 < cols) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float d = v[j][k] - mean;
        sq += d * d;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / cols + eps);

  // max|y| is exact in any order: a tree over the lane's groups, not a chain
  float gmax[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = (j * 32 + lane) * 8;
    gmax[j] = 0.f;
    if (i < cols) {
      if (!kAffineFirst) {
        gg[j].load(gamma + i);
        bg[j].load(beta + i);
      }
      float g[8], b[8], m[4];
      gg[j].get(g);
      bg[j].get(b);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        v[j][k] = __fadd_rn(__fmul_rn(__fmul_rn(v[j][k] - mean, rstd), g[k]), b[k]);
#pragma unroll
      for (int k = 0; k < 4; ++k) m[k] = fmaxf(fabsf(v[j][k]), fabsf(v[j][k + 4]));
      gmax[j] = fmaxf(fmaxf(m[0], m[1]), fmaxf(m[2], m[3]));
    }
  }
#pragma unroll
  for (int w = 1; w < NV; w *= 2)
#pragma unroll
    for (int j = 0; j + w < NV; j += 2 * w) gmax[j] = fmaxf(gmax[j], gmax[j + w]);
  // fmaxf with 0 maps a NaN-only lane to 0, as the first design's chain from
  // 0 does; non-negative floats order as their bits, so one redux instruction
  // gives warp_max's value
  const float amax = __uint_as_float(
      __reduce_max_sync(0xffffffffu, __float_as_uint(fmaxf(gmax[0], 0.f))));
  const float sc = quant_scale(amax);
  const float inv = 1.0f / sc;

  int8_t* qr = q + row * cols;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = (j * 32 + lane) * 8;
    if (i < cols) *reinterpret_cast<uint2*>(qr + i) = codes8(v[j], inv);
  }
  if (lane == 0) s[row] = sc;
}

template <typename T, typename W>
int launch_ln_quant_regs(const rownorm::LnqPlan& p, const void* x, const void* gamma,
                         const void* beta, int8_t* q, float* s, int rows, int cols, float eps,
                         cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const W* gp = static_cast<const W*>(gamma);
  const W* bp = static_cast<const W*>(beta);
  const int threads = p.warps * 32;
  switch (p.nv) {
#define TAE_LNQ_CASE(NV)                                                                      \
  case NV:                                                                                    \
    ln_quant_regs_kernel<T, W, NV><<<p.blocks, threads, 0, stream>>>(xp, gp, bp, q, s, rows, \
                                                                     cols, eps);              \
    break;
    TAE_LNQ_CASE(1)
    TAE_LNQ_CASE(2)
    TAE_LNQ_CASE(4)
    TAE_LNQ_CASE(8)
    TAE_LNQ_CASE(10)
    TAE_LNQ_CASE(12)
    TAE_LNQ_CASE(16)
#undef TAE_LNQ_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------- K5

struct MlpArgs {
  const int8_t* xq;       // (m, d)
  const float* sx;        // (m,)
  const int8_t* w1;       // (hdim, d)
  const float* sw1;       // (hdim,)
  const void* b1;         // (hdim,) of p_dtype
  const int8_t* w2;       // (d, hdim)
  const float* sw2;       // (d,)
  const void* b2;         // (d,) of p_dtype
  const void* residual;   // (m, d) of out_dtype
  void* out;              // (m, d) of out_dtype
  int m, d, hdim, block_h;
  int out_dtype, p_dtype;
  // ln_next; gamma == null turns it off
  const void* gamma;      // (d,) of ln_dtype
  const void* beta;
  int ln_dtype;
  float eps;
  int8_t* nq;             // (m, d)
  float* ns;              // (m,)
  // workspaces
  int8_t* hq;             // (m, hdim) hidden codes
  float* sh;              // (hdim / block_h, m) hidden scales
  float* part;            // (groups, m, d) fp32 accumulators of the hidden groups
  int groups;
};

// fc1 tiles: the N tile is one hidden block. Order of
// ops/cuda/int8_block.py's FC1_TILES.
using kFc1Bh128 = Tiles<128, 128, 2, 2, 3>;
using kFc1Bh128Few = Tiles<16, 128, 1, 2, 4>;
using kFc1Bh256 = Tiles<64, 256, 2, 4, 2, 2>;   // two blocks an SM: one's epilogue
                                                 // overlaps the other's products
using kFc1Bh256Few = Tiles<16, 256, 1, 4, 4>;
using kFc1Bh512Few = Tiles<16, 512, 1, 8, 3>;
// fc2 tiles (an int32 and an fp32 accumulator a lane): FC2_TILES' order.
using kFc2Large = Tiles<64, 128, 2, 4, 3, 2>;
using kFc2Mid = Tiles<64, 64, 2, 2, 4>;
using kFc2Few = Tiles<16, 64, 1, 2, 4>;

template <class S>
__host__ __device__ constexpr int fc1_smem() {
  return S::kSmem + S::BM * S::WARPS_N * 4;
}

// h = gelu(float(xq . w1^T) * sx * sw1 + b1) for BM rows x one hidden block,
// then one scale per row over the block and the int8 codes.
template <class S>
__global__ void __launch_bounds__(S::NT, S::MINB) int8_mlp_fc1_kernel(const MlpArgs p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  int8_t* smem = reinterpret_cast<int8_t*>(smem_raw);
  float* red = reinterpret_cast<float*>(smem_raw + S::kSmem);   // [BM][WARPS_N]
  const int row0 = blockIdx.y * S::BM, blk = blockIdx.x, h0 = blk * S::BN;
  const int lane = threadIdx.x % 32, wn = (threadIdx.x / 32) % S::WARPS_N;

  int acc[S::MI][S::NI][4];
  gemm_mainloop<S>(acc, p.xq + static_cast<long>(row0) * p.d, p.d, p.m - row0,
                   p.w1 + static_cast<long>(h0) * p.d, p.d, S::BN, 0, p.d, 0x7fffffff, smem,
                   NoFold{});
  transpose_rows8<S>(acc);

  // column groups outer, so one group's scales and biases are live at a time
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
    const int col = h0 + rows8_col<S>(q);
    float sw[8], b[8];
    load_vec(p.sw1 + col, sw);
    load_vec(p.sw1 + col + 4, sw + 4);
    load8(p.b1, col, p.p_dtype, b);
#pragma unroll
    for (int mi = 0; mi < S::MI; ++mi)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          int& v = acc[mi][4 * q + j / 2][2 * hf + j % 2];
          const float h = gelu_tanh(
              __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(v), sxr[mi][hf]), sw[j]), b[j]));
          v = __float_as_int(h);
          amax[mi][hf] = fmaxf(amax[mi][hf], fabsf(h));
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
        float h[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) h[j] = __int_as_float(acc[mi][4 * q + j / 2][2 * hf + j % 2]);
        *reinterpret_cast<uint2*>(p.hq + static_cast<long>(row) * p.hdim + h0 +
                                  rows8_col<S>(q)) = quantize8(h, inv);
      }
      if (wn == 0 && lane % 4 == 0) p.sh[static_cast<long>(blk) * p.m + row] = s;
    }
}

// This group's share of fc2 for a (BM x BN) tile of the (m, d) output: per
// hidden block b in ascending order, acc = acc + float(hq_b . w2_b^T) *
// sh[b, row]; the raw fp32 accumulator to part[group].
template <class S>
__global__ void __launch_bounds__(S::NT, S::MINB) int8_mlp_fc2_kernel(const MlpArgs p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  int8_t* smem = reinterpret_cast<int8_t*>(smem_raw);
  const int row0 = blockIdx.y * S::BM, col0 = blockIdx.x * S::BN, grp = blockIdx.z;
  const int hgroup = p.hdim / p.groups, k0 = grp * hgroup;
  const int blk0 = k0 / p.block_h;

  float facc[S::MI][S::NI][4];
#pragma unroll
  for (int mi = 0; mi < S::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < S::NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) facc[mi][ni][e] = 0.f;

  auto fold = [&](int (&acc)[S::MI][S::NI][4], int i) {
    const float* sb = p.sh + static_cast<long>(blk0 + i) * p.m;
#pragma unroll
    for (int mi = 0; mi < S::MI; ++mi)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = row0 + acc_row<S>(mi, hf);
        const float s = row < p.m ? sb[row] : 0.f;
#pragma unroll
        for (int ni = 0; ni < S::NI; ++ni)
#pragma unroll
          for (int e = 2 * hf; e < 2 * hf + 2; ++e) {
            facc[mi][ni][e] =
                __fadd_rn(facc[mi][ni][e], __fmul_rn(__int2float_rn(acc[mi][ni][e]), s));
            acc[mi][ni][e] = 0;
          }
      }
  };
  int acc[S::MI][S::NI][4];
  gemm_mainloop<S>(acc, p.hq + static_cast<long>(row0) * p.hdim, p.hdim, p.m - row0,
                   p.w2 + static_cast<long>(col0) * p.hdim, p.hdim, p.d - col0, k0, k0 + hgroup,
                   p.block_h / kBK, smem, fold);

  float* part = p.part + static_cast<long>(grp) * p.m * p.d;
  for_rows8<S>(facc, [&](int r, int c, const float* v) {
    const long row = row0 + r;
    const int col = col0 + c;
    if (row >= p.m || col >= p.d) return;
    store_vec(part + row * p.d + col, v);
    store_vec(part + row * p.d + col + 4, v + 4);
  });
}

// The epilogue of both products, one block per row: its threads add the
// hidden groups' fp32 accumulators in group order (nothing to add with one
// group) and compute acc * sw2 + b2 + residual and the cast, 8 columns
// each; with ln_next the fp32 row goes to shared memory and warp 0 runs
// ln_quant_row on it (one warp's reduction order).
constexpr int kFinishThreads = 128;

__global__ void __launch_bounds__(kFinishThreads) int8_mlp_finish_kernel(const MlpArgs p) {
  extern __shared__ __align__(16) float yrow[];   // d floats with ln_next
  const long row = blockIdx.x;
  const float* y0 = p.part + row * p.d;
  const long gstride = static_cast<long>(p.m) * p.d;
  for (int i = threadIdx.x * 8; i < p.d; i += kFinishThreads * 8) {
    float y[8], t[8], sw[8], b[8], res[8];
    load_vec(y0 + i, y);
    load_vec(y0 + i + 4, y + 4);
    for (int g = 1; g < p.groups; ++g) {
      load_vec(y0 + g * gstride + i, t);
      load_vec(y0 + g * gstride + i + 4, t + 4);
#pragma unroll
      for (int j = 0; j < 8; ++j) y[j] = __fadd_rn(y[j], t[j]);
    }
    load_vec(p.sw2 + i, sw);
    load_vec(p.sw2 + i + 4, sw + 4);
    load8(p.b2, i, p.p_dtype, b);
    load8(p.residual, row * p.d + i, p.out_dtype, res);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      y[j] = __fadd_rn(__fadd_rn(__fmul_rn(y[j], sw[j]), b[j]), res[j]);
    }
    store8(p.out, row * p.d + i, p.out_dtype, y);
    if (p.gamma != nullptr) {
      store_vec(yrow + i, y);
      store_vec(yrow + i + 4, y + 4);
    }
  }
  if (p.gamma == nullptr) return;
  __syncthreads();
  if (threadIdx.x < 32) {
    ln_quant_row(RowF32{yrow}, p.d, p.gamma, p.beta, p.ln_dtype, p.eps, p.nq + row * p.d,
                 p.ns + row, threadIdx.x);
  }
}

template <class S>
int launch_fc1(const MlpArgs& p, cudaStream_t stream) {
  if (S::BN != p.block_h) return static_cast<int>(cudaErrorInvalidValue);
  const long tiles_m = (static_cast<long>(p.m) + S::BM - 1) / S::BM;
  if (tiles_m > 65535) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = fc1_smem<S>();
  static_assert(smem <= kSmemLimit, "fc1 tile exceeds a block's shared memory");
  const cudaError_t rc = allow_smem(int8_mlp_fc1_kernel<S>, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid(p.hdim / p.block_h, static_cast<unsigned>(tiles_m));
  int8_mlp_fc1_kernel<S><<<grid, S::NT, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <class S>
int launch_fc2(const MlpArgs& p, cudaStream_t stream) {
  const long tiles_m = (static_cast<long>(p.m) + S::BM - 1) / S::BM;
  if (tiles_m > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t rc = allow_smem(int8_mlp_fc2_kernel<S>, S::kSmem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid((p.d + S::BN - 1) / S::BN, static_cast<unsigned>(tiles_m), p.groups);
  int8_mlp_fc2_kernel<S><<<grid, S::NT, S::kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int launch_mlp(const MlpArgs& p, int fc1_tiles, int fc2_tiles, cudaStream_t stream) {
  int rc;
  switch (fc1_tiles) {
    case 0: rc = launch_fc1<kFc1Bh128>(p, stream); break;
    case 1: rc = launch_fc1<kFc1Bh128Few>(p, stream); break;
    case 2: rc = launch_fc1<kFc1Bh256>(p, stream); break;
    case 3: rc = launch_fc1<kFc1Bh256Few>(p, stream); break;
    case 4: rc = launch_fc1<kFc1Bh512Few>(p, stream); break;
    default: rc = static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  switch (fc2_tiles) {
    case 0: rc = launch_fc2<kFc2Large>(p, stream); break;
    case 1: rc = launch_fc2<kFc2Mid>(p, stream); break;
    case 2: rc = launch_fc2<kFc2Few>(p, stream); break;
    default: rc = static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  const int smem = p.gamma == nullptr ? 0 : p.d * 4;
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t rc2 = allow_smem(int8_mlp_finish_kernel, smem);
    if (rc2 != cudaSuccess) return static_cast<int>(rc2);
  }
  int8_mlp_finish_kernel<<<static_cast<unsigned>(p.m), kFinishThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

bool bad_dtype(int d) { return d != kFloat32 && d != kBFloat16; }

}  // namespace

// x (rows, cols) of x_dtype, gamma / beta (cols,) of w_dtype -> q (rows, cols)
// int8, s (rows,) f32. cols a multiple of 8; all contiguous, 16-byte aligned.
// Launched as row_norm.cuh's ln_quant_plan says.
extern "C" int tae_ln_quant_fwd(const void* x, const void* gamma, const void* beta, void* q,
                                void* s, int rows, int cols, float eps, int x_dtype,
                                int w_dtype, void* stream) {
  rownorm::LnqPlan p;
  if (!rownorm::ln_quant_plan(rows, cols, p) || bad_dtype(x_dtype) || bad_dtype(w_dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* qp = static_cast<int8_t*>(q);
  float* sp = static_cast<float*>(s);
  if (p.nv == 0) {
    ln_quant_kernel<<<p.blocks, p.warps * 32, 0, st>>>(x, x_dtype, gamma, beta, w_dtype, qp,
                                                       sp, rows, cols, eps);
    return static_cast<int>(cudaGetLastError());
  }
  const bool xb = x_dtype == kBFloat16, wb = w_dtype == kBFloat16;
  if (xb && wb)
    return launch_ln_quant_regs<__nv_bfloat16, __nv_bfloat16>(p, x, gamma, beta, qp, sp, rows,
                                                              cols, eps, st);
  if (xb)
    return launch_ln_quant_regs<__nv_bfloat16, float>(p, x, gamma, beta, qp, sp, rows, cols,
                                                      eps, st);
  if (wb)
    return launch_ln_quant_regs<float, __nv_bfloat16>(p, x, gamma, beta, qp, sp, rows, cols,
                                                      eps, st);
  return launch_ln_quant_regs<float, float>(p, x, gamma, beta, qp, sp, rows, cols, eps, st);
}

// K3's plan for (rows, cols) (row_norm.cuh): out[0] 1 where the kernel
// takes the shape (else 0, and nothing more is written), out[1] nv (0: the
// runtime-loop body), out[2] warps a block, out[3] blocks.
extern "C" int tae_ln_quant_plan(int rows, int cols, int* out) {
  rownorm::LnqPlan p;
  out[0] = rownorm::ln_quant_plan(rows, cols, p) ? 1 : 0;
  if (!out[0]) return 0;
  out[1] = p.nv;
  out[2] = p.warps;
  out[3] = p.blocks;
  return 0;
}

// xq (m, d) int8, sx (m,) f32, w1 (hdim, d) int8, sw1 (hdim,) f32, b1 (hdim,),
// w2 (d, hdim) int8, sw2 (d,) f32, b2 (d,), residual and out (m, d) of
// out_dtype; b1, b2 of p_dtype. block_h 128, 256 or 512, dividing hdim; d a
// multiple of 16. gamma = null: no ln_next; otherwise gamma, beta (d,) of
// ln_dtype and outputs nq (m, d) int8, ns (m,) f32. Workspaces: hq (m, hdim)
// int8, sh (hdim / block_h, m) f32, part (groups, m, d) f32. fc1_tiles and
// fc2_tiles pick the products' tile shapes (ops/cuda/int8_block.py's
// mlp_tiles: fc1's N tile must be block_h wide); groups splits the hidden
// blocks evenly over fc2's grid.z. All contiguous and 16-byte aligned.
extern "C" int tae_int8_mlp_fwd(const void* xq, const void* sx, const void* w1,
                                const void* sw1, const void* b1, const void* w2,
                                const void* sw2, const void* b2, const void* residual,
                                void* out, int m, int d, int hdim, int block_h,
                                int out_dtype, int p_dtype, const void* gamma,
                                const void* beta, int ln_dtype, float eps, void* nq, void* ns,
                                void* hq, void* sh, void* part, int groups, int fc1_tiles,
                                int fc2_tiles, void* stream) {
  if (m < 1 || d < 16 || d % 16 != 0 || block_h < 128 || block_h % 128 != 0 ||
      hdim % block_h != 0 || hdim < block_h || groups < 1 || groups > 65535 ||
      (hdim / block_h) % groups != 0 || hq == nullptr || sh == nullptr || part == nullptr ||
      bad_dtype(out_dtype) || bad_dtype(p_dtype) ||
      (gamma != nullptr &&
       (beta == nullptr || nq == nullptr || ns == nullptr || bad_dtype(ln_dtype)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  MlpArgs p;
  p.xq = static_cast<const int8_t*>(xq);
  p.sx = static_cast<const float*>(sx);
  p.w1 = static_cast<const int8_t*>(w1);
  p.sw1 = static_cast<const float*>(sw1);
  p.b1 = b1;
  p.w2 = static_cast<const int8_t*>(w2);
  p.sw2 = static_cast<const float*>(sw2);
  p.b2 = b2;
  p.residual = residual;
  p.out = out;
  p.m = m; p.d = d; p.hdim = hdim; p.block_h = block_h;
  p.out_dtype = out_dtype;
  p.p_dtype = p_dtype;
  p.gamma = gamma;
  p.beta = beta;
  p.ln_dtype = ln_dtype;
  p.eps = eps;
  p.nq = static_cast<int8_t*>(nq);
  p.ns = static_cast<float*>(ns);
  p.hq = static_cast<int8_t*>(hq);
  p.sh = static_cast<float*>(sh);
  p.part = static_cast<float*>(part);
  p.groups = groups;
  return launch_mlp(p, fc1_tiles, fc2_tiles, static_cast<cudaStream_t>(stream));
}
