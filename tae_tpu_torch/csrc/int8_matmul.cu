// K4 — int8 x int8 -> int32 matrix product with a fused dequantize epilogue.
//
// Replaces: tae_tpu/ops/pallas/int8_matmul.py::int8_matmul_fused (body
//   _kernel), for prequantized input: x (M, K) int8 with one fp32 scale per
//   row, w (N, K) int8 (torch layout, so both operands are K-contiguous)
//   with one fp32 scale per output column. The epilogue computes
//   y = (float)acc * sx * sw (+ bias) (+ residual) in fp32 and casts once.
//   With ln_out it also emits LayerNorm(y) of that fp32 y as int8 codes plus
//   one scale per row (int8_block.py::_ln_quant_epilogue), the next
//   operation's quantized input. With q8_out (the output mode only the
//   int8-input attention, K15, consumes) y itself leaves as int8: one scale
//   per (row, block of bn columns), s = max(max|y| / 127, 1e-12), codes
//   clip(round_half_even(y * (1 / s)), +-127), the scales laid out
//   (N / bn, M). A float x with its precomputed row scales (the Pallas
//   body's quantize_in_kernel, prequantize=False) is quantized first,
//   clip(round_half_even(x * (1 / sx)), +-127).
// What bounds it on the H100: tensor-core operations at the wide shapes
//   (M x 1024 x 3072), device-memory bytes at the narrow ones (the
//   residual, y and the int8 LN output outweigh the product at N = 1024)
//   and at few rows (the weight: 6.6 MB at p128's 2560 x 2560, 4 rows).
// What the design does about it: the output is tiled over (M, N) across
//   the grid in one of three tile shapes (kLarge, kMedium, kSmall below;
//   the wrapper's matmul_tiles picks one from M and N), each block runs
//   int8_common.cuh's gemm_mainloop (mma.sync.m16n8k32, ldmatrix, a
//   cp.async ring of 128 bytes of K a stage) with the accumulators in
//   registers, and no block streams more of the weight than its columns.
//   Where the tiles are fewer than the SMs, K is split over grid.z as well:
//   int32 sums are exact, so the split partials add up to the same product
//   bit for bit. The epilogue reads the C fragments through quad transposes
//   (8 consecutive columns a lane, 16-byte loads and stores).
//   A row epilogue (ln_out, q8_out) needs a whole fp32 row: the product
//   writes its int32 tile (per K split) to a workspace the wrapper
//   allocates, and int8_matmul_finish_kernel, one block per row, adds the
//   splits, runs the dequantize epilogue and then ln_quant_row or the
//   per-block amax and quantize on the fp32 row held in shared memory
//   (two-pass statistics over the fp32 y, as _ln_quant_epilogue, in one
//   warp's order). So do split plain launches.
//   Device launches per call: 1 (plain, unsplit), 2 (split or a row
//   epilogue), one more for a float x (its quantize pass). Ragged M, N and
//   K edges are zero-filled on load and masked on store; N must be a
//   multiple of 8 and K of 16.
#include "int8_common.cuh"

namespace {

using namespace tae;
using namespace tae::i8;

struct MatmulArgs {
  const int8_t* x;        // (m, k)
  const float* sx;        // (m,)
  const int8_t* w;        // (n, k)
  const float* sw;        // (n,)
  const void* bias;       // (n,) of bias_dtype, or null
  const void* residual;   // (m, n) of out_dtype, or null
  void* out;              // (m, n) of out_dtype (q8_out: int8)
  int m, n, k;
  int out_dtype, bias_dtype;
  int* ws;                // (splits, m, n) int32 partial products, or null
  int splits;
  // ln_out
  const void* gamma;      // (n,) of ln_dtype, or null
  const void* beta;
  int ln_dtype;
  float eps;
  int8_t* nq;             // (m, n)
  float* ns;              // (m,)
  // q8_out
  float* so;              // (n / bn, m) scales of the int8 y in out, or null
  int bn;
};

// y for 8 consecutive columns of one row from their int32 sums.
__device__ __forceinline__ void dequant8(const MatmulArgs& p, const int* acc, long row,
                                         int col, float* y) {
  const float sxr = p.sx[row];
  float sw[8], t[8];
  load_vec(p.sw + col, sw);
  load_vec(p.sw + col + 4, sw + 4);
  to_float8(acc, y);
#pragma unroll
  for (int j = 0; j < 8; ++j) y[j] = __fmul_rn(__fmul_rn(y[j], sxr), sw[j]);
  if (p.bias != nullptr) {
    load8(p.bias, col, p.bias_dtype, t);
#pragma unroll
    for (int j = 0; j < 8; ++j) y[j] = __fadd_rn(y[j], t[j]);
  }
  if (p.residual != nullptr) {
    load8(p.residual, row * p.n + col, p.out_dtype, t);
#pragma unroll
    for (int j = 0; j < 8; ++j) y[j] = __fadd_rn(y[j], t[j]);
  }
}

// The tile shapes, in the order of ops/cuda/int8_matmul.py's MATMUL_TILES:
// many rows; a few hundred rows; up to 64 rows (few rows leave the
// tensor cores idle anyway: the weight's bytes bound those launches).
using kLarge = Tiles<128, 128, 2, 4, 3, 2>;
using kMedium = Tiles<64, 128, 2, 4, 4, 2>;
using kSmall = Tiles<16, 64, 1, 2, 4>;

// One block tile of the product over this block's K split. PARTIAL: the
// int32 tile goes to ws[split]; otherwise the dequantize epilogue writes y.
template <class S, bool PARTIAL>
__global__ void __launch_bounds__(S::NT, S::MINB) int8_matmul_kernel(const MatmulArgs p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  int8_t* smem = reinterpret_cast<int8_t*>(smem_raw);
  const int row0 = blockIdx.y * S::BM, col0 = blockIdx.x * S::BN, split = blockIdx.z;
  const int steps = (p.k + kBK - 1) / kBK;
  const int per = (steps + p.splits - 1) / p.splits;
  const int k0 = min(split * per * kBK, p.k), k1 = min(k0 + per * kBK, p.k);

  int acc[S::MI][S::NI][4];
  gemm_mainloop<S>(acc, p.x + static_cast<long>(row0) * p.k, p.k, p.m - row0,
                   p.w + static_cast<long>(col0) * p.k, p.k, p.n - col0, k0, k1, 0x7fffffff,
                   smem, NoFold{});
  if (PARTIAL) {
    for_rows8<S>(acc, [&](int r, int c, const int* v) {
      const long row = row0 + r;
      const int col = col0 + c;
      if (row >= p.m || col >= p.n) return;
      int* o = p.ws + (static_cast<long>(split) * p.m + row) * p.n + col;
      *reinterpret_cast<int4*>(o) = make_int4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<int4*>(o + 4) = make_int4(v[4], v[5], v[6], v[7]);
    });
    return;
  }
  // the dequantize epilogue, a column group's scales and bias read once
  transpose_rows8<S>(acc);
#pragma unroll
  for (int q = 0; q < S::NI / 4; ++q) {
    const int col = col0 + rows8_col<S>(q);
    if (col >= p.n) continue;
    float sw[8], bias[8];
    load_vec(p.sw + col, sw);
    load_vec(p.sw + col + 4, sw + 4);
    if (p.bias != nullptr) load8(p.bias, col, p.bias_dtype, bias);
#pragma unroll
    for (int mi = 0; mi < S::MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long row = row0 + acc_row<S>(mi, h);
        if (row >= p.m) continue;
        const float sxr = p.sx[row];
        float y[8], t[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          y[j] = __fmul_rn(__fmul_rn(__int2float_rn(acc[mi][4 * q + j / 2][2 * h + j % 2]), sxr),
                           sw[j]);
          if (p.bias != nullptr) y[j] = __fadd_rn(y[j], bias[j]);
        }
        if (p.residual != nullptr) {
          load8(p.residual, row * p.n + col, p.out_dtype, t);
#pragma unroll
          for (int j = 0; j < 8; ++j) y[j] = __fadd_rn(y[j], t[j]);
        }
        store8(p.out, row * p.n + col, p.out_dtype, y);
      }
  }
}

constexpr int kFinishThreads = 128;
enum FinishMode { kPlain = 0, kLnOut = 1, kQ8Out = 2 };

// The epilogue of a split or row-epilogue launch, one block per row: its
// threads add the splits' int32 partials and run the dequantize epilogue, 8
// columns each, storing y (not for q8_out) and, for a row epilogue, the
// fp32 y in shared memory; then warp 0 runs ln_quant_row on that row, or
// warp w the amax and quantize of the q8_out column blocks w, w + 4, ...:
// the warp-per-row arithmetic of the reductions, with the row's loads
// spread over the block (few rows no longer leave a few warps walking
// whole rows from device memory).
__global__ void __launch_bounds__(kFinishThreads)
int8_matmul_finish_kernel(const MatmulArgs p, int mode) {
  extern __shared__ __align__(16) float yrow[];   // n floats for a row epilogue
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long row = blockIdx.x;
  const long plane = static_cast<long>(p.m) * p.n;
  const int* w0 = p.ws + row * p.n;
  for (int i = threadIdx.x * 8; i < p.n; i += kFinishThreads * 8) {
    int v[8];
    {
      const int4 a = *reinterpret_cast<const int4*>(w0 + i);
      const int4 b = *reinterpret_cast<const int4*>(w0 + i + 4);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    }
    for (int s = 1; s < p.splits; ++s) {
      const int4 a = *reinterpret_cast<const int4*>(w0 + s * plane + i);
      const int4 b = *reinterpret_cast<const int4*>(w0 + s * plane + i + 4);
      v[0] += a.x; v[1] += a.y; v[2] += a.z; v[3] += a.w;
      v[4] += b.x; v[5] += b.y; v[6] += b.z; v[7] += b.w;
    }
    float y[8];
    dequant8(p, v, row, i, y);
    if (mode != kQ8Out) store8(p.out, row * p.n + i, p.out_dtype, y);
    if (mode != kPlain) {
      store_vec(yrow + i, y);
      store_vec(yrow + i + 4, y + 4);
    }
  }
  if (mode == kPlain) return;
  __syncthreads();
  if (mode == kLnOut) {
    if (warp == 0) {
      ln_quant_row(RowF32{yrow}, p.n, p.gamma, p.beta, p.ln_dtype, p.eps, p.nq + row * p.n,
                   p.ns + row, lane);
    }
    return;
  }
  int8_t* out = static_cast<int8_t*>(p.out);
  for (int blk = warp; blk * p.bn < p.n; blk += kFinishThreads / 32) {
    const int c0 = blk * p.bn;
    float v[8], amax = 0.f;
    for (int i = lane * 8; i < p.bn; i += 256) {
      load_vec(yrow + c0 + i, v);
      load_vec(yrow + c0 + i + 4, v + 4);
#pragma unroll
      for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(v[j]));
    }
    const float s = quant_scale(warp_max(amax));
    const float inv = 1.0f / s;
    for (int i = lane * 8; i < p.bn; i += 256) {
      load_vec(yrow + c0 + i, v);
      load_vec(yrow + c0 + i + 4, v + 4);
      *reinterpret_cast<uint2*>(out + row * p.n + c0 + i) = quantize8(v, inv);
    }
    if (lane == 0) p.so[static_cast<long>(blk) * p.m + row] = s;
  }
}

// x * (1 / sx) rounded to int8 codes, 8 elements a thread.
__global__ void __launch_bounds__(256)
quantize_x_kernel(const void* __restrict__ x, int x_dtype, const float* __restrict__ sx,
                  int8_t* __restrict__ xq, int m, int k) {
  const long chunks = static_cast<long>(m) * (k / 8);
  for (long c = blockIdx.x * 256L + threadIdx.x; c < chunks; c += gridDim.x * 256L) {
    const long row = c / (k / 8);
    float v[8];
    load8(x, c * 8, x_dtype, v);
    *reinterpret_cast<uint2*>(xq + c * 8) = quantize8(v, 1.0f / sx[row]);
  }
}

template <class S, bool PARTIAL>
int launch_tiles(const MatmulArgs& p, cudaStream_t stream) {
  const long tiles_m = (static_cast<long>(p.m) + S::BM - 1) / S::BM;
  const long tiles_n = (static_cast<long>(p.n) + S::BN - 1) / S::BN;
  if (tiles_m > 65535 || tiles_n > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t rc = allow_smem(int8_matmul_kernel<S, PARTIAL>, S::kSmem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid(static_cast<unsigned>(tiles_n), static_cast<unsigned>(tiles_m), p.splits);
  int8_matmul_kernel<S, PARTIAL><<<grid, S::NT, S::kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool PARTIAL>
int launch_product(const MatmulArgs& p, int tiles, cudaStream_t stream) {
  switch (tiles) {
    case 0: return launch_tiles<kLarge, PARTIAL>(p, stream);
    case 1: return launch_tiles<kMedium, PARTIAL>(p, stream);
    case 2: return launch_tiles<kSmall, PARTIAL>(p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The product and, where needed, the finish pass.
int launch(const MatmulArgs& p, int tiles, int mode, cudaStream_t stream) {
  if (mode == kPlain && p.splits == 1) return launch_product<false>(p, tiles, stream);
  if (p.ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int rc = launch_product<true>(p, tiles, stream);
  if (rc != 0) return rc;
  const int smem = mode == kPlain ? 0 : p.n * 4;
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t rc2 = allow_smem(int8_matmul_finish_kernel, smem);
    if (rc2 != cudaSuccess) return static_cast<int>(rc2);
  }
  int8_matmul_finish_kernel<<<static_cast<unsigned>(p.m), kFinishThreads, smem, stream>>>(p,
                                                                                       mode);
  return static_cast<int>(cudaGetLastError());
}

bool bad_dtype(int d) { return d != kFloat32 && d != kBFloat16; }

bool bad_tiling(int tiles, int splits, int k) {
  return tiles < 0 || tiles > 2 || splits < 1 || splits > 64 || splits > (k + kBK - 1) / kBK;
}

}  // namespace

// x (m, k) int8, sx (m,) f32, w (n, k) int8, sw (n,) f32, bias (n,) or null,
// residual (m, n) or null, out (m, n); all contiguous and 16-byte aligned.
// tiles: the tile shape (ops/cuda/int8_matmul.py's matmul_tiles), splits:
// the K splits. ln = 0: plain epilogue. ln = 1: the chained LayerNorm +
// quantize epilogue, which also writes nq (m, n) int8 and ns (m,) f32 from
// gamma, beta (n,) of ln_dtype. ws: a (splits, m, n) int32 workspace, used
// (and then needed) with splits > 1 or ln = 1.
extern "C" int tae_int8_matmul_fwd(const void* x, const void* sx, const void* w,
                                   const void* sw, const void* bias, const void* residual,
                                   void* out, int m, int n, int k, int out_dtype,
                                   int bias_dtype, int ln, const void* gamma,
                                   const void* beta, int ln_dtype, float eps, void* nq,
                                   void* ns, int tiles, int splits, void* ws, void* stream) {
  if (m < 1 || n < 8 || n % 8 != 0 || k < 16 || k % 16 != 0 || bad_dtype(out_dtype) ||
      (bias != nullptr && bad_dtype(bias_dtype)) || bad_tiling(tiles, splits, k) ||
      (ln != 0 && ln != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (ln == 1 && (gamma == nullptr || beta == nullptr || nq == nullptr || ns == nullptr ||
                  bad_dtype(ln_dtype))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  MatmulArgs p = {};
  p.x = static_cast<const int8_t*>(x);
  p.sx = static_cast<const float*>(sx);
  p.w = static_cast<const int8_t*>(w);
  p.sw = static_cast<const float*>(sw);
  p.bias = bias;
  p.residual = residual;
  p.out = out;
  p.m = m; p.n = n; p.k = k;
  p.out_dtype = out_dtype;
  p.bias_dtype = bias_dtype;
  p.ws = static_cast<int*>(ws);
  p.splits = splits;
  p.gamma = gamma;
  p.beta = beta;
  p.ln_dtype = ln_dtype;
  p.eps = eps;
  p.nq = static_cast<int8_t*>(nq);
  p.ns = static_cast<float*>(ns);
  return launch(p, tiles, ln ? kLnOut : kPlain, static_cast<cudaStream_t>(stream));
}

// The q8_out and float-x forms. x: (m, k) int8 codes (x_dtype = 2) with
// their row scales sx (m,), or a float x (x_dtype a float code) that is
// quantized with the precomputed sx into xq_ws (m, k) int8 first. bn > 0:
// q8_out, out (m, n) int8 and so (n / bn, m) fp32, n a multiple of bn and
// bn of 8; residual, if any, of out_dtype. bn = 0: out (m, n) of out_dtype
// (for a float x only; int8 codes take tae_int8_matmul_fwd). tiles, splits,
// ws as tae_int8_matmul_fwd's; ws needed with bn > 0 or splits > 1.
extern "C" int tae_int8_matmul_rows_fwd(const void* x, int x_dtype, const void* sx,
                                        const void* w, const void* sw, const void* bias,
                                        int bias_dtype, const void* residual, void* out,
                                        int out_dtype, void* so, int bn, int m, int n, int k,
                                        int tiles, int splits, void* ws, void* xq_ws,
                                        void* stream) {
  constexpr int kCodes = 2;
  const bool qik = x_dtype != kCodes;
  if (m < 1 || n < 8 || n % 8 != 0 || k < 16 || k % 16 != 0 || bad_dtype(out_dtype) ||
      (qik && (bad_dtype(x_dtype) || xq_ws == nullptr)) ||
      (bias != nullptr && bad_dtype(bias_dtype)) ||
      (bn > 0 && (bn % 8 != 0 || n % bn != 0 || so == nullptr)) || (bn == 0 && !qik) ||
      bn < 0 || bad_tiling(tiles, splits, k)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MatmulArgs p = {};
  p.x = static_cast<const int8_t*>(x);
  if (qik) {
    const long chunks = static_cast<long>(m) * (k / 8);
    const long want = (chunks + 255) / 256;
    const unsigned blocks = static_cast<unsigned>(want < 4096 ? want : 4096);
    quantize_x_kernel<<<blocks, 256, 0, s>>>(x, x_dtype, static_cast<const float*>(sx),
                                             static_cast<int8_t*>(xq_ws), m, k);
    const cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess) return static_cast<int>(rc);
    p.x = static_cast<const int8_t*>(xq_ws);
  }
  p.sx = static_cast<const float*>(sx);
  p.w = static_cast<const int8_t*>(w);
  p.sw = static_cast<const float*>(sw);
  p.bias = bias;
  p.bias_dtype = bias_dtype;
  p.residual = residual;
  p.out = out;
  p.out_dtype = out_dtype;
  p.so = static_cast<float*>(so);
  p.bn = bn;
  p.m = m; p.n = n; p.k = k;
  p.ws = static_cast<int*>(ws);
  p.splits = splits;
  return launch(p, tiles, bn > 0 ? kQ8Out : kPlain, s);
}
