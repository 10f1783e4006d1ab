// K1 — LayerNorm forward with fp32 statistics — and K11, its backward.
//
// K1 replaces: tae_tpu/ops/pallas/layernorm.py::fused_layer_norm (forward,
//   _fwd_kernel / _fwd_call). The inference entry writes y only; the training
//   entry also writes each row's mean and rstd (fp32), which the backward
//   reads.
// Numerics: mean, centred variance and rsqrt(var + eps) in fp32, the affine
//   in fp32, one rounding to the output dtype at the end.
// What bounds it on the H100: device-memory bytes. Each row is read once
//   from HBM and written once; there is no tensor-core work. At the slice's
//   shape (B*256 rows of 1024) a row is 2 KB in bf16.
// What the design does about it: one warp per row, 16-byte vector loads and
//   stores, warp-shuffle reductions, no shared memory and no block-wide
//   barrier. The three passes over a row (sum, centred sum of squares,
//   normalise) re-read it from L1 rather than HBM, so HBM traffic stays one
//   read and one write. The row width must be a multiple of 8 elements.
//
// K11 replaces: tae_tpu/ops/pallas/layernorm.py::_fln_bwd (_bwd_kernel).
// Numerics, all in fp32: xhat = (x - mean) * rstd, g = dy * w,
//   dx = (g - mean(g) - xhat * mean(g * xhat)) * rstd, rounded once to x's
//   dtype; dw = sum over rows of dy * xhat, db = sum over rows of dy, rounded
//   once to the weight's dtype.
// What bounds it on the H100: device-memory bytes (x and dy read, dx
//   written; no tensor-core work).
// What the design does about it: dx is a row reduction and dw / db a column
//   reduction over all rows, which the TPU's sequential grid carries in one
//   accumulator block and a CUDA grid cannot. Three launches: (1) dx, one
//   warp per row as the forward; (2) per-block partial column sums over a
//   chunk of rows (a lane owns one 16-byte vector of columns, so a block
//   covers 32 vectors of columns; its warps take the chunk's rows in turn and
//   are summed through shared memory in warp order); (3) a finish kernel that
//   adds the chunks' partial sums in chunk order. No atomics: the same
//   inputs give the same bits. x and dy are read twice (the second read
//   partly from L2); fusing (1) and (2) is later work.
#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;

template <typename T, typename W>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
layer_norm_fwd_kernel(const T* __restrict__ x, const W* __restrict__ w,
                      const W* __restrict__ b, T* __restrict__ y,
                      float* __restrict__ mean_out, float* __restrict__ rstd_out,
                      int rows, int cols, float eps) {
  constexpr int V = tae::Vec<T>::kN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long row = static_cast<long>(blockIdx.x) * kWarpsPerBlock + warp;
  if (row >= rows) return;
  const T* xr = x + row * cols;
  T* yr = y + row * cols;
  float v[V];

  float sum = 0.f;
  for (int i = lane * V; i < cols; i += 32 * V) {
    tae::load_vec(xr + i, v);
#pragma unroll
    for (int k = 0; k < V; ++k) sum += v[k];
  }
  const float mean = tae::warp_sum(sum) / cols;

  float sq = 0.f;
  for (int i = lane * V; i < cols; i += 32 * V) {
    tae::load_vec(xr + i, v);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float d = v[k] - mean;
      sq += d * d;
    }
  }
  const float rstd = rsqrtf(tae::warp_sum(sq) / cols + eps);
  if (mean_out != nullptr && lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }

  for (int i = lane * V; i < cols; i += 32 * V) {
    tae::load_vec(xr + i, v);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      v[k] = (v[k] - mean) * rstd * tae::to_float(w[i + k]) + tae::to_float(b[i + k]);
    }
    tae::store_vec(yr + i, v);
  }
}

// ------------------------------------------------------------------- K11

constexpr int kBwdWarps = 8;  // warps per block of the partial-sum kernel

template <typename T, typename W>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
layer_norm_bwd_dx_kernel(const T* __restrict__ x, const W* __restrict__ w,
                         const float* __restrict__ mean, const float* __restrict__ rstd,
                         const T* __restrict__ dy, T* __restrict__ dx, int rows,
                         int cols) {
  constexpr int V = tae::Vec<T>::kN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long row = static_cast<long>(blockIdx.x) * kWarpsPerBlock + warp;
  if (row >= rows) return;
  const T* xr = x + row * cols;
  const T* gr = dy + row * cols;
  T* dr = dx + row * cols;
  const float mu = mean[row], rs = rstd[row];
  float xv[V], gv[V];

  float s1 = 0.f, s2 = 0.f;
  for (int i = lane * V; i < cols; i += 32 * V) {
    tae::load_vec(xr + i, xv);
    tae::load_vec(gr + i, gv);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float g = gv[k] * tae::to_float(w[i + k]);
      s1 += g;
      s2 += g * ((xv[k] - mu) * rs);
    }
  }
  const float m1 = tae::warp_sum(s1) / cols, m2 = tae::warp_sum(s2) / cols;

  for (int i = lane * V; i < cols; i += 32 * V) {
    tae::load_vec(xr + i, xv);
    tae::load_vec(gr + i, gv);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float g = gv[k] * tae::to_float(w[i + k]);
      xv[k] = (g - m1 - (xv[k] - mu) * rs * m2) * rs;
    }
    tae::store_vec(dr + i, xv);
  }
}

// part: (2, chunks, cols) fp32; [0] the chunk's sums of dy * xhat, [1] of dy.
template <typename T>
__global__ void __launch_bounds__(kBwdWarps * 32)
layer_norm_bwd_partial_kernel(const T* __restrict__ x, const float* __restrict__ mean,
                              const float* __restrict__ rstd, const T* __restrict__ dy,
                              float* __restrict__ part, int rows, int cols,
                              int rows_per_chunk) {
  constexpr int V = tae::Vec<T>::kN;
  constexpr int BC = 32 * V;  // columns per block
  __shared__ float red[2][kBwdWarps][BC];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = blockIdx.x * BC + lane * V;
  const int chunk = blockIdx.y, chunks = gridDim.y;
  const long r0 = static_cast<long>(chunk) * rows_per_chunk;
  const long r1 = min(static_cast<long>(rows), r0 + rows_per_chunk);
  float aw[V], ab[V], xv[V], gv[V];
#pragma unroll
  for (int k = 0; k < V; ++k) aw[k] = ab[k] = 0.f;
  if (col < cols) {
    for (long r = r0 + warp; r < r1; r += kBwdWarps) {
      tae::load_vec(x + r * cols + col, xv);
      tae::load_vec(dy + r * cols + col, gv);
      const float mu = mean[r], rs = rstd[r];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        aw[k] += gv[k] * ((xv[k] - mu) * rs);
        ab[k] += gv[k];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < V; ++k) {
    red[0][warp][lane * V + k] = aw[k];
    red[1][warp][lane * V + k] = ab[k];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < BC; c += blockDim.x) {
    const int gc = blockIdx.x * BC + c;
    if (gc >= cols) continue;
    float sw = 0.f, sb = 0.f;
#pragma unroll
    for (int q = 0; q < kBwdWarps; ++q) {
      sw += red[0][q][c];
      sb += red[1][q][c];
    }
    part[static_cast<long>(chunk) * cols + gc] = sw;
    part[(static_cast<long>(chunks) + chunk) * cols + gc] = sb;
  }
}

template <typename W>
__global__ void layer_norm_bwd_finish_kernel(const float* __restrict__ part,
                                             W* __restrict__ dw, W* __restrict__ db,
                                             int chunks, int cols) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= cols) return;
  float sw = 0.f, sb = 0.f;
  for (int q = 0; q < chunks; ++q) {
    sw += part[static_cast<long>(q) * cols + col];
    sb += part[(static_cast<long>(chunks) + q) * cols + col];
  }
  dw[col] = tae::from_float<W>(sw);
  db[col] = tae::from_float<W>(sb);
}

template <typename T, typename W>
int launch_bwd(const void* x, const void* w, const void* mean, const void* rstd,
               const void* dy, void* dx, void* dw, void* db, void* part, int rows,
               int cols, int chunks, int rows_per_chunk, cudaStream_t stream) {
  constexpr int BC = 32 * tae::Vec<T>::kN;
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(dy);
  const float* mp = static_cast<const float*>(mean);
  const float* rp = static_cast<const float*>(rstd);
  float* pp = static_cast<float*>(part);
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  layer_norm_bwd_dx_kernel<T, W><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      xp, static_cast<const W*>(w), mp, rp, gp, static_cast<T*>(dx), rows, cols);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((cols + BC - 1) / BC, chunks);
  layer_norm_bwd_partial_kernel<T><<<grid, kBwdWarps * 32, 0, stream>>>(
      xp, mp, rp, gp, pp, rows, cols, rows_per_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  layer_norm_bwd_finish_kernel<W><<<(cols + 255) / 256, 256, 0, stream>>>(
      pp, static_cast<W*>(dw), static_cast<W*>(db), chunks, cols);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------- launchers

template <typename T, typename W>
int launch(const void* x, const void* w, const void* b, void* y, void* mean,
           void* rstd, int rows, int cols, float eps, cudaStream_t stream) {
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  layer_norm_fwd_kernel<T, W><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<const W*>(b),
      static_cast<T*>(y), static_cast<float*>(mean), static_cast<float*>(rstd), rows,
      cols, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_w(const void* x, const void* w, const void* b, void* y, void* mean,
             void* rstd, int rows, int cols, float eps, int w_dtype,
             cudaStream_t stream) {
  if (w_dtype == tae::kFloat32)
    return launch<T, float>(x, w, b, y, mean, rstd, rows, cols, eps, stream);
  if (w_dtype == tae::kBFloat16)
    return launch<T, __nv_bfloat16>(x, w, b, y, mean, rstd, rows, cols, eps, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

int launch_fwd(const void* x, const void* w, const void* b, void* y, void* mean,
               void* rstd, int rows, int cols, float eps, int x_dtype, int w_dtype,
               void* stream) {
  if (rows < 1 || cols < 8 || cols % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == tae::kFloat32)
    return launch_w<float>(x, w, b, y, mean, rstd, rows, cols, eps, w_dtype, s);
  if (x_dtype == tae::kBFloat16)
    return launch_w<__nv_bfloat16>(x, w, b, y, mean, rstd, rows, cols, eps, w_dtype, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x, y: (rows, cols) contiguous, dtype x_dtype; w, b: (cols,), dtype w_dtype.
extern "C" int tae_layer_norm_fwd(const void* x, const void* w, const void* b,
                                  void* y, int rows, int cols, float eps,
                                  int x_dtype, int w_dtype, void* stream) {
  return launch_fwd(x, w, b, y, nullptr, nullptr, rows, cols, eps, x_dtype, w_dtype,
                    stream);
}

// The same, also writing mean and rstd: (rows,) fp32.
extern "C" int tae_layer_norm_fwd_stats(const void* x, const void* w, const void* b,
                                        void* y, void* mean, void* rstd, int rows,
                                        int cols, float eps, int x_dtype, int w_dtype,
                                        void* stream) {
  if (mean == nullptr || rstd == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_fwd(x, w, b, y, mean, rstd, rows, cols, eps, x_dtype, w_dtype, stream);
}

// x, dy, dx: (rows, cols), dtype x_dtype; w, dw, db: (cols,), dtype w_dtype;
// mean, rstd: (rows,) fp32; part: (2, chunks, cols) fp32 scratch, where
// chunks * rows_per_chunk >= rows.
extern "C" int tae_layer_norm_bwd(const void* x, const void* w, const void* mean,
                                  const void* rstd, const void* dy, void* dx, void* dw,
                                  void* db, void* part, int rows, int cols, int chunks,
                                  int rows_per_chunk, int x_dtype, int w_dtype,
                                  void* stream) {
  if (rows < 1 || cols < 8 || cols % 8 != 0 || chunks < 1 || chunks > 65535 ||
      rows_per_chunk < 1 || static_cast<long>(chunks) * rows_per_chunk < rows)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wf = w_dtype == tae::kFloat32, wb = w_dtype == tae::kBFloat16;
  if (x_dtype == tae::kFloat32 && wf)
    return launch_bwd<float, float>(x, w, mean, rstd, dy, dx, dw, db, part, rows, cols,
                                    chunks, rows_per_chunk, s);
  if (x_dtype == tae::kFloat32 && wb)
    return launch_bwd<float, __nv_bfloat16>(x, w, mean, rstd, dy, dx, dw, db, part, rows,
                                            cols, chunks, rows_per_chunk, s);
  if (x_dtype == tae::kBFloat16 && wf)
    return launch_bwd<__nv_bfloat16, float>(x, w, mean, rstd, dy, dx, dw, db, part, rows,
                                            cols, chunks, rows_per_chunk, s);
  if (x_dtype == tae::kBFloat16 && wb)
    return launch_bwd<__nv_bfloat16, __nv_bfloat16>(x, w, mean, rstd, dy, dx, dw, db, part,
                                                    rows, cols, chunks, rows_per_chunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
