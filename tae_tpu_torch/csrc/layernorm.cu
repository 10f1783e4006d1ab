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
// What the design does about it (layer_norm_bwd_rows_kernel; plan in
//   row_norm.cuh): one pass over x and dy. dx is a row reduction and dw /
//   db a column reduction over all rows, which the TPU's sequential grid
//   carries in one accumulator block and a CUDA grid cannot. A block takes
//   a chunk of rows and its 8 warps the chunk's rows in turn; per row a warp
//   loads x and dy once into registers (in bf16 the next row's loads in
//   flight while it works, and L2 asked for the rows after), forms the
//   row's two means and dx, and adds dy * xhat and dy to warp-private
//   column sums (registers up to 1024 columns, shared memory above); the
//   block then adds its warps in order and writes the chunk's sums, and a
//   finish kernel adds the chunks in order. Two launches, no atomics: the
//   same inputs give the same bits. Each lane meets its columns in the
//   first design's order, so dx equals its bits; from 16384 rows each
//   column's sum meets its rows in that design's order too (chunks of 128
//   rows, rows in turn over 8 warps), so dw and db do. Fewer rows are
//   spread over more, smaller chunks and, where those are few, over column
//   slices (row_norm.cuh), and dw / db differ in fp32 order. Rows wider than
//   2560 columns take the first design: (1) dx, one warp a row reading the
//   row twice from a runtime loop; (2) per-block partial column sums over a
//   chunk of rows (a lane owns one 16-byte vector of columns, a block 32
//   vectors of columns; its warps take the chunk's rows in turn and are
//   summed through shared memory in warp order), x and dy read a second
//   time; (3) the same finish.
#include "common.cuh"
#include "row_norm.cuh"

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

constexpr int kBwdWarps = tae::rownorm::kBwdWarps;  // warps of the partial-sum kernel

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

// The finish: a thread a column and sum (warp 0 of a block dw, warp 1 db,
// of 32 columns), adding the chunks' partial sums in chunk order, the loads
// of kBatch chunks in flight at once. Small blocks, so that the partial
// sums (1 MB at 16384 rows of 1024) are read by as many SMs as there are
// 32-column slices: blocks of 256 threads left 4 SMs to read them all, most
// of the finish's time.
constexpr int kFinishCols = 32;
constexpr int kFinishThreads = 2 * kFinishCols;

template <typename W>
__global__ void __launch_bounds__(kFinishThreads)
layer_norm_bwd_finish_kernel(const float* __restrict__ part, W* __restrict__ dw,
                             W* __restrict__ db, int chunks, int cols) {
  const int col = blockIdx.x * kFinishCols + threadIdx.x % kFinishCols;
  const int which = threadIdx.x / kFinishCols;  // 0: dw, 1: db
  if (col >= cols) return;
  const float* src = part + static_cast<long>(which) * chunks * cols + col;
  float s = 0.f;
  constexpr int kBatch = 64;
  int q = 0;
  for (; q + kBatch <= chunks; q += kBatch) {
    float a[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) a[u] = src[static_cast<long>(q + u) * cols];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) s += a[u];
  }
  for (; q < chunks; ++q) s += src[static_cast<long>(q) * cols];
  (which == 0 ? dw : db)[col] = tae::from_float<W>(s);
}

// One pass over x and dy: block (blockIdx.x, blockIdx.y) = a chunk of rows
// and a slice of the columns, its warps the chunk's rows in turn. A lane
// holds its row's 16-byte vectors m < NVEC at columns (32 m + lane) * V,
// all of them for the row's means; dx and the sums of dy * xhat and dy over
// its warp's rows only for the slice's vectors, the sums in registers
// (REG_ACC) or in the warp's rows of acc. part: (2, chunks, cols) fp32 as
// the first design's.
template <typename T, typename W, int NV, bool REG_ACC>
__global__ void __launch_bounds__(kBwdWarps * 32)
layer_norm_bwd_rows_kernel(const T* __restrict__ x, const W* __restrict__ w,
                           const float* __restrict__ mean, const float* __restrict__ rstd,
                           const T* __restrict__ dy, T* __restrict__ dx,
                           float* __restrict__ part, int rows, int cols, int rows_per_chunk) {
  constexpr int V = tae::Vec<T>::kN;
  constexpr int NVEC = NV * 8 / V;
  constexpr int C = NV * tae::rownorm::kGroupCols;  // columns of the smem rows
  constexpr bool PREFETCH = sizeof(T) == 2;          // two bf16 rows fit the registers
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                                    // (C,) the weight in fp32
  float* acc = smem + C;                               // (2, kBwdWarps, C)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chunk = blockIdx.x, chunks = gridDim.x;
  const long r0 = static_cast<long>(chunk) * rows_per_chunk;
  const long r1 = min(static_cast<long>(rows), r0 + rows_per_chunk);
  // the slice: groups [g0, g1) of 256 columns, vectors [m0, m1)
  const int groups = (cols + tae::rownorm::kGroupCols - 1) / tae::rownorm::kGroupCols;
  const int g0 = blockIdx.y * groups / gridDim.y, g1 = (blockIdx.y + 1) * groups / gridDim.y;
  const int m0 = g0 * (8 / V), m1 = g1 * (8 / V);
  const int c1 = min(cols, g1 * tae::rownorm::kGroupCols);
  float* aws = acc + warp * C;
  float* abs_ = acc + (kBwdWarps + warp) * C;
  float aw[REG_ACC ? NVEC : 1][V], ab[REG_ACC ? NVEC : 1][V];
  if constexpr (REG_ACC) {
#pragma unroll
    for (int m = 0; m < NVEC; ++m)
#pragma unroll
      for (int k = 0; k < V; ++k) aw[m][k] = ab[m][k] = 0.f;
  }

  const long row_bytes = static_cast<long>(cols) * sizeof(T);
  // bf16 only: measured, fp32 rows (no register prefetch) ran slower with it
  auto prefetch_l2 = [&](long r) {
    if (PREFETCH && lane == 0 && r < r1) {
      asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(x + r * cols),
                   "r"(static_cast<unsigned>(row_bytes)) : "memory");
      asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(dy + r * cols),
                   "r"(static_cast<unsigned>(row_bytes)) : "memory");
    }
  };
  auto load_row = [&](long r, uint4 (&xr)[NVEC], uint4 (&gr)[NVEC], float& mu, float& rs) {
#pragma unroll
    for (int m = 0; m < NVEC; ++m) {
      const int i = (m * 32 + lane) * V;
      if (i < cols) {
        xr[m] = *reinterpret_cast<const uint4*>(x + r * cols + i);
        gr[m] = *reinterpret_cast<const uint4*>(dy + r * cols + i);
      }
    }
    mu = mean[r];
    rs = rstd[r];
  };
  // dx of row r and its terms of the column sums, from the row's registers
  auto row = [&](long r, const uint4 (&xr)[NVEC], const uint4 (&gr)[NVEC], float mu,
                 float rs) {
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int m = 0; m < NVEC; ++m) {
      const int i = (m * 32 + lane) * V;
      if (i < cols) {
        float xv[V], gv[V], wv[V];
        tae::rownorm::unpack16<T>(xr[m], xv);
        tae::rownorm::unpack16<T>(gr[m], gv);
        tae::rownorm::load_fv<V>(ws + i, wv);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float g = gv[k] * wv[k];
          s1 += g;
          s2 += g * ((xv[k] - mu) * rs);
        }
      }
    }
    const float mean_g = tae::warp_sum(s1) / cols, mean_gx = tae::warp_sum(s2) / cols;
    T* dr = dx + r * cols;
#pragma unroll
    for (int m = 0; m < NVEC; ++m) {
      const int i = (m * 32 + lane) * V;
      if (m >= m0 && m < m1 && i < cols) {
        float xv[V], gv[V], wv[V], d[V];
        tae::rownorm::unpack16<T>(xr[m], xv);
        tae::rownorm::unpack16<T>(gr[m], gv);
        tae::rownorm::load_fv<V>(ws + i, wv);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float g = gv[k] * wv[k];
          d[k] = (g - mean_g - (xv[k] - mu) * rs * mean_gx) * rs;
        }
        tae::store_vec(dr + i, d);
        if constexpr (REG_ACC) {
#pragma unroll
          for (int k = 0; k < V; ++k) {
            aw[m][k] += gv[k] * ((xv[k] - mu) * rs);
            ab[m][k] += gv[k];
          }
        } else {
          // the warp's first row starts its sums from 0, as the registers do
          float a[V], b[V];
          if (r == r0 + warp) {
#pragma unroll
            for (int k = 0; k < V; ++k) a[k] = b[k] = 0.f;
          } else {
            tae::rownorm::load_fv<V>(aws + i, a);
            tae::rownorm::load_fv<V>(abs_ + i, b);
          }
#pragma unroll
          for (int k = 0; k < V; ++k) {
            a[k] += gv[k] * ((xv[k] - mu) * rs);
            b[k] += gv[k];
          }
          tae::rownorm::store_fv<V>(aws + i, a);
          tae::rownorm::store_fv<V>(abs_ + i, b);
        }
      }
    }
  };

  // the first row's loads in flight while the block stages the weight
  uint4 xr[NVEC], gr[NVEC];
  float mu = 0.f, rs = 0.f;
  long r = r0 + warp;
  for (int a = 1; a < tae::rownorm::kBwdL2Ahead; ++a) prefetch_l2(r + a * kBwdWarps);
  if (r < r1) load_row(r, xr, gr, mu, rs);
  for (int c = threadIdx.x; c < cols; c += blockDim.x) ws[c] = tae::to_float(w[c]);
  __syncthreads();
  for (; r < r1; r += kBwdWarps) {
    const long rn = r + kBwdWarps;
    prefetch_l2(r + tae::rownorm::kBwdL2Ahead * kBwdWarps);
    if constexpr (PREFETCH) {
      uint4 xn[NVEC], gn[NVEC];
      float mun = 0.f, rsn = 0.f;
      if (rn < r1) load_row(rn, xn, gn, mun, rsn);
      row(r, xr, gr, mu, rs);
#pragma unroll
      for (int m = 0; m < NVEC; ++m) {
        xr[m] = xn[m];
        gr[m] = gn[m];
      }
      mu = mun;
      rs = rsn;
    } else {
      row(r, xr, gr, mu, rs);
      if (rn < r1) load_row(rn, xr, gr, mu, rs);
    }
  }

  if (REG_ACC || r0 + warp >= r1) {  // registers, or a warp without rows: zeros
#pragma unroll
    for (int m = 0; m < NVEC; ++m) {
      if (m < m0 || m >= m1) continue;
      const int i = (m * 32 + lane) * V;
      float a[V], b[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        a[k] = REG_ACC ? aw[REG_ACC ? m : 0][k] : 0.f;
        b[k] = REG_ACC ? ab[REG_ACC ? m : 0][k] : 0.f;
      }
      tae::rownorm::store_fv<V>(aws + i, a);
      tae::rownorm::store_fv<V>(abs_ + i, b);
    }
  }
  __syncthreads();
  // the block's warps in order, as the first design's partial-sum kernel
  for (int c = g0 * tae::rownorm::kGroupCols + threadIdx.x; c < c1; c += blockDim.x) {
    float sw = 0.f, sb = 0.f;
#pragma unroll
    for (int q = 0; q < kBwdWarps; ++q) {
      sw += acc[q * C + c];
      sb += acc[(kBwdWarps + q) * C + c];
    }
    part[static_cast<long>(chunk) * cols + c] = sw;
    part[(static_cast<long>(chunks) + chunk) * cols + c] = sb;
  }
}

template <typename T, typename W, int NV>
int launch_bwd_rows(const tae::rownorm::BwdPlan& p, const void* x, const void* w,
                    const void* mean, const void* rstd, const void* dy, void* dx, void* part,
                    int rows, int cols, cudaStream_t stream) {
  constexpr bool kRegAcc = NV <= tae::rownorm::kBwdRegAccNv;
  auto* kernel = layer_norm_bwd_rows_kernel<T, W, NV, kRegAcc>;
  static bool prepared = false;  // one per instantiation: its shared memory is fixed
  if (!prepared) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    prepared = true;
  }
  kernel<<<dim3(p.chunks, p.splits), p.warps * 32, p.smem, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<const float*>(mean),
      static_cast<const float*>(rstd), static_cast<const T*>(dy), static_cast<T*>(dx),
      static_cast<float*>(part), rows, cols, p.rows_per_chunk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename W>
int launch_bwd_fused(const tae::rownorm::BwdPlan& p, const void* x, const void* w,
                     const void* mean, const void* rstd, const void* dy, void* dx, void* dw,
                     void* db, void* part, int rows, int cols, cudaStream_t stream) {
  int rc;
  switch (p.nv) {
#define TAE_BWD_CASE(NV)                                                                  \
  case NV:                                                                                \
    rc = launch_bwd_rows<T, W, NV>(p, x, w, mean, rstd, dy, dx, part, rows, cols, stream); \
    break;
    TAE_BWD_CASE(1)
    TAE_BWD_CASE(2)
    TAE_BWD_CASE(4)
    TAE_BWD_CASE(8)
    TAE_BWD_CASE(10)
#undef TAE_BWD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  layer_norm_bwd_finish_kernel<W><<<(cols + kFinishCols - 1) / kFinishCols, kFinishThreads, 0,
                                     stream>>>(
      static_cast<const float*>(part), static_cast<W*>(dw), static_cast<W*>(db), p.chunks,
      cols);
  return static_cast<int>(cudaGetLastError());
}

// The first design's three launches, for rows wider than the fused body
// takes.
template <typename T, typename W>
int launch_bwd_loop(const void* x, const void* w, const void* mean, const void* rstd,
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
  layer_norm_bwd_finish_kernel<W><<<(cols + kFinishCols - 1) / kFinishCols, kFinishThreads, 0,
                                     stream>>>(
      pp, static_cast<W*>(dw), static_cast<W*>(db), chunks, cols);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename W>
int launch_bwd(const tae::rownorm::BwdPlan& p, const void* x, const void* w,
               const void* mean, const void* rstd, const void* dy, void* dx, void* dw,
               void* db, void* part, int rows, int cols, cudaStream_t stream) {
  if (p.nv == 0)
    return launch_bwd_loop<T, W>(x, w, mean, rstd, dy, dx, dw, db, part, rows, cols,
                                 p.chunks, p.rows_per_chunk, stream);
  return launch_bwd_fused<T, W>(p, x, w, mean, rstd, dy, dx, dw, db, part, rows, cols,
                                stream);
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
// mean, rstd: (rows,) fp32; part: (2, chunks, cols) fp32 scratch. chunks and
// rows_per_chunk must be row_norm.cuh's layer_norm_bwd_plan's.
extern "C" int tae_layer_norm_bwd(const void* x, const void* w, const void* mean,
                                  const void* rstd, const void* dy, void* dx, void* dw,
                                  void* db, void* part, int rows, int cols, int chunks,
                                  int rows_per_chunk, int x_dtype, int w_dtype,
                                  void* stream) {
  tae::rownorm::BwdPlan p;
  if (!tae::rownorm::layer_norm_bwd_plan(rows, cols, p) || chunks != p.chunks ||
      rows_per_chunk != p.rows_per_chunk)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wf = w_dtype == tae::kFloat32, wb = w_dtype == tae::kBFloat16;
  if (x_dtype == tae::kFloat32 && wf)
    return launch_bwd<float, float>(p, x, w, mean, rstd, dy, dx, dw, db, part, rows, cols, s);
  if (x_dtype == tae::kFloat32 && wb)
    return launch_bwd<float, __nv_bfloat16>(p, x, w, mean, rstd, dy, dx, dw, db, part, rows,
                                            cols, s);
  if (x_dtype == tae::kBFloat16 && wf)
    return launch_bwd<__nv_bfloat16, float>(p, x, w, mean, rstd, dy, dx, dw, db, part, rows,
                                            cols, s);
  if (x_dtype == tae::kBFloat16 && wb)
    return launch_bwd<__nv_bfloat16, __nv_bfloat16>(p, x, w, mean, rstd, dy, dx, dw, db, part,
                                                    rows, cols, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K11's plan for (rows, cols) (row_norm.cuh): out[0] 1 where the kernels
// take the shape (else 0, and nothing more is written), out[1] nv (0: the
// first design's launches), out[2] chunks, out[3] rows a chunk, out[4] warps
// a block, out[5] 1 where the column sums live in registers, out[6] shared
// memory bytes of a block, out[7] column slices.
extern "C" int tae_layer_norm_bwd_plan(int rows, int cols, int* out) {
  tae::rownorm::BwdPlan p;
  out[0] = tae::rownorm::layer_norm_bwd_plan(rows, cols, p) ? 1 : 0;
  if (!out[0]) return 0;
  out[1] = p.nv;
  out[2] = p.chunks;
  out[3] = p.rows_per_chunk;
  out[4] = p.warps;
  out[5] = p.reg_acc;
  out[6] = p.smem;
  out[7] = p.splits;
  return 0;
}
