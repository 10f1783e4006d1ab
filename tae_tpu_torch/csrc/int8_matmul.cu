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
//   body's quantize_in_kernel, prequantize=False) is quantized in the
//   kernel, clip(round_half_even(x * (1 / sx)), +-127), on its way into
//   shared memory.
// What bounds it on the H100: tensor-core operations at the wide shapes
//   (M x 1024 x 3072), device-memory bytes at the narrow ones (the
//   residual, y and the int8 LN output outweigh the product at N = 1024).
// What the design does about it: 128 x 128 output tiles, 8 warps of wmma
//   int8 fragments, operand tiles brought in by a three-stage cp.async
//   ring; the int32 tile goes through shared memory (over the ring) so the
//   epilogue reads whole rows with 16-byte accesses. The ln_out form needs
//   a full output row in one block: a block owns 32 rows (16 for wide N),
//   walks the N columns in chunks of 256 (128), keeps the fp32 y rows in
//   shared memory ((rows x N) floats) and normalises and quantizes them at
//   the end, one warp per row. The q8_out form and the in-kernel quantize
//   take the same shape of block: 32 rows and a block of output columns
//   (bn for q8_out, 512 otherwise) in chunks of 128; q8_out keeps the fp32
//   y of the block in shared memory for its per-row amax, and a float x is
//   quantized once per block into a (32 x K) int8 tile that every chunk's
//   product reads from shared memory. Ragged M, N and K edges are
//   zero-filled on load and masked on store; N must be a multiple of 8 and
//   K of 16.
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
  void* out;              // (m, n) of out_dtype
  int m, n, k;
  int out_dtype, bias_dtype;
  // ln_out only
  const void* gamma;      // (n,) of ln_dtype
  const void* beta;
  int ln_dtype;
  float eps;
  int8_t* nq;             // (m, n)
  float* ns;              // (m,)
  // the row-block kernel only
  const void* xf;         // (m, k) float x of x_dtype, quantized in the kernel
  int x_dtype;
  float* so;              // q8_out: (n / bn, m) scales of the int8 y in out
};

// y for 8 consecutive columns of one row from the staged int32 tile.
__device__ __forceinline__ void dequant8(const MatmulArgs& p, const int* acc, long row,
                                         int col, float* y) {
  const float sxr = p.sx[row];
  float sw[8], t[8];
  load_vec(p.sw + col, sw);
  load_vec(p.sw + col + 4, sw + 4);
  load8_i32(acc, y);
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

constexpr int kThreads = 256;   // of the 128 x 128 kernel; two blocks fit an SM
constexpr int kGemmBM = 128, kGemmBN = 128;
constexpr int kGemmSmem =
    max_int(ring_bytes(kGemmBM, kGemmBN), tile_bytes(kGemmBM, kGemmBN));

__global__ void __launch_bounds__(kThreads) int8_matmul_kernel(const MatmulArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* ring = reinterpret_cast<int8_t*>(smem);
  int* tile = reinterpret_cast<int*>(smem);          // over the ring
  constexpr int ldt = tile_ld(kGemmBN);

  const int row0 = blockIdx.y * kGemmBM, col0 = blockIdx.x * kGemmBN;
  gemm_tile<kThreads, kGemmBM, kGemmBN, 4, false>(
      p.x + static_cast<long>(row0) * p.k, p.k, p.m - row0,
      p.w + static_cast<long>(col0) * p.k, p.k, p.n - col0, p.k, ring, tile, ldt);
  __syncthreads();

  const int tc = tile_col<kGemmBN>();
  const int col = col0 + tc;
  if (col >= p.n) return;
  for (int r = tile_row0<kGemmBN>(); r < kGemmBM; r += tile_rows<kThreads, kGemmBN>()) {
    const long row = row0 + r;
    if (row >= p.m) break;
    float y[8];
    dequant8(p, tile + r * ldt + tc, row, col, y);
    store8(p.out, row * p.n + col, p.out_dtype, y);
  }
}

// The ln_out kernel: BM rows per block, BN-column chunks. Shared memory:
// the fp32 y rows, then the operand ring with the result tile over it.
__host__ __device__ constexpr int ln_ld(int n) { return n + 4; }
__host__ __device__ constexpr int ln_smem(int bm, int bn, int n) {
  return bm * ln_ld(n) * 4 + max_int(ring_bytes(bm, bn), tile_bytes(bm, bn));
}

template <int NT, int BM, int BN>
__global__ void __launch_bounds__(NT) int8_matmul_ln_kernel(const MatmulArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* ybuf = reinterpret_cast<float*>(smem);
  const int ldy = ln_ld(p.n);
  int8_t* ring = reinterpret_cast<int8_t*>(ybuf + BM * ldy);
  int* tile = reinterpret_cast<int*>(ring);          // over the ring
  constexpr int ldt = tile_ld(BN);

  const int row0 = blockIdx.x * BM;
  const int tc = tile_col<BN>();
  for (int col0 = 0; col0 < p.n; col0 += BN) {
    gemm_tile<NT, BM, BN, BM / 16, false>(
        p.x + static_cast<long>(row0) * p.k, p.k, p.m - row0,
        p.w + static_cast<long>(col0) * p.k, p.k, p.n - col0, p.k, ring, tile, ldt);
    __syncthreads();
    const int col = col0 + tc;
    if (col < p.n) {
      for (int r = tile_row0<BN>(); r < BM; r += tile_rows<NT, BN>()) {
        const long row = row0 + r;
        if (row >= p.m) break;
        float y[8];
        dequant8(p, tile + r * ldt + tc, row, col, y);
        store8(p.out, row * p.n + col, p.out_dtype, y);
        store_vec(ybuf + r * ldy + col, y);
        store_vec(ybuf + r * ldy + col + 4, y + 4);
      }
    }
    __syncthreads();   // the tile lies over the ring the next chunk refills
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < BM; r += NT / 32) {
    const long row = row0 + r;
    if (row >= p.m) break;
    ln_quant_row(RowF32{ybuf + r * ldy}, p.n, p.gamma, p.beta, p.ln_dtype, p.eps,
                 p.nq + row * p.n, p.ns + row, lane);
  }
}

template <int NT, int BM, int BN>
int launch_ln(const MatmulArgs& p, cudaStream_t stream) {
  const int smem = ln_smem(BM, BN, p.n);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t rc = cudaFuncSetAttribute(int8_matmul_ln_kernel<NT, BM, BN>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  int8_matmul_ln_kernel<NT, BM, BN><<<(p.m + BM - 1) / BM, NT, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The row-block kernel: BM rows x `cols` output columns (a block of the
// q8_out scales, or of the in-kernel quantize), walked in BN-column chunks.
// Shared memory: (q8_out) the block's fp32 y, (in-kernel quantize) the
// block's int8 x, then the operand ring with the result tile over it.
__host__ __device__ constexpr int round_up(int x, int to) { return (x + to - 1) / to * to; }
constexpr int kRowsBM = 32, kRowsBN = 128;

template <bool QIK, bool Q8OUT>
__host__ __device__ constexpr int rows_smem(int cols, int k) {
  return (Q8OUT ? kRowsBM * (cols + 4) * 4 : 0) + (QIK ? kRowsBM * (round_up(k, kBK) + 16) : 0) +
         max_int(ring_bytes(kRowsBM, kRowsBN), tile_bytes(kRowsBM, kRowsBN));
}

template <bool QIK, bool Q8OUT>
__global__ void __launch_bounds__(kThreads) int8_matmul_rows_kernel(const MatmulArgs p, int cols) {
  constexpr int BM = kRowsBM, BN = kRowsBN;
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = round_up(p.k, kBK) + 16, ldy = cols + 4;
  float* ybuf = reinterpret_cast<float*>(smem);
  int8_t* xs = reinterpret_cast<int8_t*>(ybuf + (Q8OUT ? BM * ldy : 0));
  int8_t* ring = xs + (QIK ? BM * lda : 0);
  int* tile = reinterpret_cast<int*>(ring);          // over the ring
  constexpr int ldt = tile_ld(BN);

  const int row0 = blockIdx.x * BM, c0 = blockIdx.y * cols;
  const int c_end = min(c0 + cols, p.n);
  if (QIK) {
    // x * (1 / sx) rounded to codes, zero beyond m and k; the first barrier
    // of gemm_tile orders these stores before any read
    const int chunks = (lda - 16) / 8;
    for (int idx = threadIdx.x; idx < BM * chunks; idx += kThreads) {
      const int r = idx / chunks, col = (idx - r * chunks) * 8;
      const long row = row0 + r;
      uint2 q = make_uint2(0u, 0u);
      if (row < p.m && col < p.k) {
        float v[8];
        load8(p.xf, row * p.k + col, p.x_dtype, v);
        q = quantize8(v, 1.0f / p.sx[row]);
      }
      *reinterpret_cast<uint2*>(xs + r * lda + col) = q;
    }
  }

  const int tc = tile_col<BN>();
  for (int col0 = c0; col0 < c_end; col0 += BN) {
    gemm_tile<kThreads, BM, BN, 2, QIK>(
        QIK ? xs : p.x + static_cast<long>(row0) * p.k, QIK ? lda : p.k, p.m - row0,
        p.w + static_cast<long>(col0) * p.k, p.k, c_end - col0, p.k, ring, tile, ldt);
    __syncthreads();
    const int col = col0 + tc;
    if (col < c_end) {
      for (int r = tile_row0<BN>(); r < BM; r += tile_rows<kThreads, BN>()) {
        const long row = row0 + r;
        if (row >= p.m) break;
        float y[8];
        dequant8(p, tile + r * ldt + tc, row, col, y);
        if (Q8OUT) {
          store_vec(ybuf + r * ldy + (col - c0), y);
          store_vec(ybuf + r * ldy + (col - c0) + 4, y + 4);
        } else {
          store8(p.out, row * p.n + col, p.out_dtype, y);
        }
      }
    }
    __syncthreads();   // the tile lies over the ring the next chunk refills
  }
  if (!Q8OUT) return;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int width = c_end - c0;
  int8_t* out = static_cast<int8_t*>(p.out);
  for (int r = warp; r < BM; r += kThreads / 32) {
    const long row = row0 + r;
    if (row >= p.m) break;
    const float* yr = ybuf + r * ldy;
    float v[8], amax = 0.f;
    for (int i = lane * 8; i < width; i += 256) {
      load_vec(yr + i, v);
      load_vec(yr + i + 4, v + 4);
#pragma unroll
      for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(v[j]));
    }
    const float s = quant_scale(warp_max(amax));
    const float inv = 1.0f / s;
    for (int i = lane * 8; i < width; i += 256) {
      load_vec(yr + i, v);
      load_vec(yr + i + 4, v + 4);
      *reinterpret_cast<uint2*>(out + row * p.n + c0 + i) = quantize8(v, inv);
    }
    if (lane == 0) p.so[static_cast<long>(blockIdx.y) * p.m + row] = s;
  }
}

template <bool QIK, bool Q8OUT>
int launch_rows(const MatmulArgs& p, int cols, cudaStream_t stream) {
  const int smem = rows_smem<QIK, Q8OUT>(cols, p.k);
  const long tiles_m = (static_cast<long>(p.m) + kRowsBM - 1) / kRowsBM;
  const int blocks_n = (p.n + cols - 1) / cols;
  if (smem > kSmemLimit || tiles_m > 0x7fffffffL || blocks_n > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t rc = cudaFuncSetAttribute(int8_matmul_rows_kernel<QIK, Q8OUT>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid(static_cast<unsigned>(tiles_m), blocks_n);
  int8_matmul_rows_kernel<QIK, Q8OUT><<<grid, kThreads, smem, stream>>>(p, cols);
  return static_cast<int>(cudaGetLastError());
}

bool bad_dtype(int d) { return d != kFloat32 && d != kBFloat16; }

}  // namespace

// x (m, k) int8, sx (m,) f32, w (n, k) int8, sw (n,) f32, bias (n,) or null,
// residual (m, n) or null, out (m, n); all contiguous and 16-byte aligned.
// ln_rows = 0: plain epilogue. ln_rows = 32 or 16: rows per block of the
// chained LayerNorm + quantize epilogue (column chunks of 256 or 128),
// which also writes nq (m, n) int8 and ns (m,) f32 from gamma, beta (n,)
// of ln_dtype.
extern "C" int tae_int8_matmul_fwd(const void* x, const void* sx, const void* w,
                                   const void* sw, const void* bias, const void* residual,
                                   void* out, int m, int n, int k, int out_dtype,
                                   int bias_dtype, int ln_rows, const void* gamma,
                                   const void* beta, int ln_dtype, float eps, void* nq,
                                   void* ns, void* stream) {
  if (m < 1 || n < 8 || n % 8 != 0 || k < 16 || k % 16 != 0 || bad_dtype(out_dtype) ||
      (bias != nullptr && bad_dtype(bias_dtype))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  MatmulArgs p;
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
  p.gamma = gamma;
  p.beta = beta;
  p.ln_dtype = ln_dtype;
  p.eps = eps;
  p.nq = static_cast<int8_t*>(nq);
  p.ns = static_cast<float*>(ns);
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  if (ln_rows == 0) {
    const long tiles_m = (static_cast<long>(m) + kGemmBM - 1) / kGemmBM;
    if (tiles_m > 65535) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t rc = cudaFuncSetAttribute(
        int8_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    const dim3 grid((n + kGemmBN - 1) / kGemmBN, static_cast<unsigned>(tiles_m));
    int8_matmul_kernel<<<grid, kThreads, kGemmSmem, s>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  if (gamma == nullptr || beta == nullptr || nq == nullptr || ns == nullptr ||
      bad_dtype(ln_dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (ln_rows == 32) return launch_ln<512, 32, 256>(p, s);
  if (ln_rows == 16) return launch_ln<256, 16, 128>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The row-block forms. x: (m, k) int8 codes (x_dtype = 2) with their row
// scales sx (m,), or a float x (x_dtype a float code) that the kernel
// quantizes with the precomputed sx. bn > 0: q8_out, out (m, n) int8 and
// so (n / bn, m) fp32, n a multiple of bn and bn of 8; residual, if any, of
// out_dtype. bn = 0: out (m, n) of out_dtype (for a float x only; int8 codes
// take tae_int8_matmul_fwd).
extern "C" int tae_int8_matmul_rows_fwd(const void* x, int x_dtype, const void* sx,
                                        const void* w, const void* sw, const void* bias,
                                        int bias_dtype, const void* residual, void* out,
                                        int out_dtype, void* so, int bn, int m, int n, int k,
                                        void* stream) {
  constexpr int kCodes = 2;
  const bool qik = x_dtype != kCodes;
  if (m < 1 || n < 8 || n % 8 != 0 || k < 16 || k % 16 != 0 || bad_dtype(out_dtype) ||
      (qik && bad_dtype(x_dtype)) || (bias != nullptr && bad_dtype(bias_dtype)) ||
      (bn > 0 && (bn % 8 != 0 || n % bn != 0 || so == nullptr)) || (bn == 0 && !qik) ||
      bn < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  MatmulArgs p = {};
  p.x = static_cast<const int8_t*>(x);
  p.xf = x;
  p.x_dtype = x_dtype;
  p.sx = static_cast<const float*>(sx);
  p.w = static_cast<const int8_t*>(w);
  p.sw = static_cast<const float*>(sw);
  p.bias = bias;
  p.bias_dtype = bias_dtype;
  p.residual = residual;
  p.out = out;
  p.out_dtype = out_dtype;
  p.so = static_cast<float*>(so);
  p.m = m; p.n = n; p.k = k;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 0) return launch_rows<true, false>(p, 512, s);
  return qik ? launch_rows<true, true>(p, bn, s) : launch_rows<false, true>(p, bn, s);
}
