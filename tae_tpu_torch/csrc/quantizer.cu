// K14 nearest_code — codebook nearest-neighbour search of the VQ bottleneck.
//
// Replaces: tae_tpu/ops/pallas/quantizer.py::nearest_code_pallas (_kernel).
//   For latents z (M, V) and a codebook (K, V): argmin_k (|c_k|^2 - 2 z.c_k)
//   (the |z|^2 term is constant per row), the lowest index among equal
//   distances. The (M, K) distance matrix never reaches device memory.
// What bounds it on the H100: tensor-core operations at the serving shape
//   (2 * M * K * V = 6.9e10 at M = 16384, K = 8192, V = 256; the inputs are
//   12 MB).
// What the design does about it. nearest_code_norms_kernel writes |c_k|^2 in
//   fp32 once per call (a warp per code). bf16: a block keeps its rows of z
//   in shared memory and streams the codebook through a four-stage cp.async
//   ring as one flat sequence of (64 codes x 64 columns) tiles, so the ring
//   never drains between code tiles; the product is mma.sync.m16n8k16
//   (bf16, fp32 accumulate), whose documented register layout lets each
//   thread turn its scores into distances and keep a running (min, argmin)
//   for its four rows in registers. A thread meets its columns in ascending
//   order and replaces only on <; the lanes and warps that share a row are
//   merged at the end by comparing (distance, index) pairs, so the lowest
//   index wins every tie. Codes beyond K get the distance 3.4e38 and never
//   win; rows beyond M are zero-filled and not written. fp32 inputs take a
//   plain CUDA-core kernel (16 rows a block, a thread per code of a 64-code
//   tile): right, not fast. Few rows make few blocks (M = 256 is 8 of
//   32 rows), each streaming the whole codebook at one SM's rate: there the
//   bf16 kernel splits the codebook over the grid's second axis, each block
//   searching a contiguous range of code tiles, and a merge kernel takes
//   each row's (distance, index) pairs in code order, so the lowest index
//   still wins a tie across the ranges.
// Latents too wide for a block's rows of z to stay in shared memory (V above
//   1,472 at 64 rows, 2,944 at 32; the registry's vocab-4096 and -16384
//   configs)
//   take the same kernels with z tiled over V as well: each pipeline step
//   stages the z tile of its 64 columns beside the code tile, and the
//   partial dot products of the V tiles add up in the fp32 accumulators
//   before the running (min, argmin) sees a code. z is read from L2 once per
//   code tile instead of once.
#include <cuda_pipeline.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace tae;

constexpr float kBig = 3.4e38f;   // larger than any real distance
constexpr int kNT = 256;
constexpr int kTile = 64;         // codes per tile, columns per pipeline step
constexpr int kStages = 4;
constexpr int kLdC = kTile + 8;   // bf16 row stride of a codebook tile
constexpr int kSmemLimit = 232448;

// (d2, i2) replaces (d, i) if it is nearer, or as near with a lower index
__device__ __forceinline__ void take_better(float& d, int& i, float d2, int i2) {
  if (d2 < d || (d2 == d && i2 < i)) {
    d = d2;
    i = i2;
  }
}

template <typename T>
__global__ void __launch_bounds__(kNT) nearest_code_norms_kernel(const T* __restrict__ cb,
                                                                 float* __restrict__ cn, int k,
                                                                 int v) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long code = static_cast<long>(blockIdx.x) * (kNT / 32) + warp;
  if (code >= k) return;
  float s = 0.f;
  for (int i = lane; i < v; i += 32) {
    const float c = to_float(cb[code * v + i]);
    s += c * c;
  }
  s = warp_sum(s);
  if (lane == 0) cn[code] = s;
}

__host__ __device__ constexpr int round_up(int x, int to) { return (x + to - 1) / to * to; }
__host__ __device__ constexpr int bf16_smem(int bm, int v) {
  return bm * (round_up(v, kTile) + 8) * 2 + kStages * kTile * kLdC * 2;
}
// z tiled over V: every ring slot holds a code tile and the block's z tile
__host__ __device__ constexpr int bf16_stream_smem(int bm) {
  return kStages * (bm + kTile) * kLdC * 2;
}

// BM rows of z per block (32, 64 or 128), 8 warps as (BM / 32) x (256 / BM):
// a warp owns 32 rows and 64 / (256 / BM) codes of every tile. ZS: z tiled
// over V through the ring; otherwise the block's z rows stay resident.
template <int BM, bool ZS>
__global__ void __launch_bounds__(kNT)
nearest_code_bf16_kernel(const __nv_bfloat16* __restrict__ z, const __nv_bfloat16* __restrict__ cb,
                         const float* __restrict__ cn, long long* __restrict__ out,
                         float* __restrict__ ws_d, int* __restrict__ ws_i, int m, int v, int k,
                         int tiles_per_split) {
  constexpr int WARPS_M = BM / 32, WARPS_N = kNT / 32 / WARPS_M;
  constexpr int WN = kTile / WARPS_N, NI = WN / 8;
  static_assert(WN % 8 == 0, "a warp holds whole 8-code fragments");
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kSlot = (ZS ? BM + kTile : kTile) * kLdC;  // elements of a ring slot
  const int vp = round_up(v, kTile), ldz = ZS ? kLdC : vp + 8;
  __nv_bfloat16* zs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ring = zs + (ZS ? 0 : BM * ldz);

  const int row0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int g = lane / 4, t = lane % 4;
  // this block's range of code tiles (the whole codebook unless split)
  const int ksteps = vp / kTile, tile0 = blockIdx.y * tiles_per_split;
  const int tiles = min(tiles_per_split, (k + kTile - 1) / kTile - tile0);
  const int steps = tiles * ksteps;

  // the block's rows of z, zero beyond m and beyond v
  for (int c = threadIdx.x; !ZS && c < BM * (vp / 8); c += kNT) {
    const int r = c / (vp / 8), col = (c % (vp / 8)) * 8;
    __nv_bfloat16* d = zs + r * ldz + col;
    if (row0 + r < m && col < v) {
      __pipeline_memcpy_async(d, z + static_cast<long>(row0 + r) * v + col, 16);
    } else {
      *reinterpret_cast<int4*>(d) = make_int4(0, 0, 0, 0);
    }
  }
  auto stage = [&](int step) {
    const int code0 = (tile0 + step / ksteps) * kTile, col0 = (step % ksteps) * kTile;
    __nv_bfloat16* slot = ring + (step % kStages) * kSlot;
    for (int c = threadIdx.x; c < kTile * (kTile / 8); c += kNT) {
      const int r = c / (kTile / 8), col = col0 + (c % (kTile / 8)) * 8;
      __nv_bfloat16* d = slot + r * kLdC + (col - col0);
      if (code0 + r < k && col < v) {
        __pipeline_memcpy_async(d, cb + static_cast<long>(code0 + r) * v + col, 16);
      } else {
        *reinterpret_cast<int4*>(d) = make_int4(0, 0, 0, 0);
      }
    }
    for (int c = threadIdx.x; ZS && c < BM * (kTile / 8); c += kNT) {
      const int r = c / (kTile / 8), col = col0 + (c % (kTile / 8)) * 8;
      __nv_bfloat16* d = slot + (kTile + r) * kLdC + (col - col0);
      if (row0 + r < m && col < v) {
        __pipeline_memcpy_async(d, z + static_cast<long>(row0 + r) * v + col, 16);
      } else {
        *reinterpret_cast<int4*>(d) = make_int4(0, 0, 0, 0);
      }
    }
  };
  // z rides the first group
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) stage(s);
    __pipeline_commit();
  }

  float c[2][NI][4];
  float best[2][2];
  int best_i[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      best[mi][h] = kBig;
      best_i[mi][h] = 0;
    }
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[mi][ni][e] = 0.f;
  }

  for (int step = 0; step < steps; ++step) {
    __pipeline_wait_prior(kStages - 2);
    __syncthreads();
    if (step + kStages - 1 < steps) stage(step + kStages - 1);
    __pipeline_commit();

    const __nv_bfloat16* ct = ring + (step % kStages) * kSlot;
    const __nv_bfloat16* zt = ZS ? ct + kTile * kLdC : zs;
    const int zc0 = ZS ? 0 : (step % ksteps) * kTile;  // z tile's first column
#pragma unroll
    for (int kk = 0; kk < kTile; kk += 16) {
      unsigned fa[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const __nv_bfloat16* ap = zt + (wm * 32 + mi * 16 + g) * ldz + zc0 + kk + 2 * t;
        fa[mi][0] = *reinterpret_cast<const unsigned*>(ap);
        fa[mi][1] = *reinterpret_cast<const unsigned*>(ap + 8 * ldz);
        fa[mi][2] = *reinterpret_cast<const unsigned*>(ap + 8);
        fa[mi][3] = *reinterpret_cast<const unsigned*>(ap + 8 * ldz + 8);
      }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const __nv_bfloat16* bp = ct + (wn * WN + ni * 8 + g) * kLdC + kk + 2 * t;
        const unsigned b0 = *reinterpret_cast<const unsigned*>(bp);
        const unsigned b1 = *reinterpret_cast<const unsigned*>(bp + 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_bf16(c[mi][ni], fa[mi], b0, b1);
      }
    }

    if (step % ksteps == ksteps - 1) {
      // a code tile is whole: distances, then the running (min, argmin)
      const int code0 = (tile0 + step / ksteps) * kTile;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int code = code0 + wn * WN + ni * 8 + 2 * t + e;
          const float norm = code < k ? cn[code] : 0.f;
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float d =
                  code < k ? __fsub_rn(norm, __fmul_rn(2.0f, c[mi][ni][2 * h + e])) : kBig;
              if (d < best[mi][h]) {
                best[mi][h] = d;
                best_i[mi][h] = code;
              }
              c[mi][ni][2 * h + e] = 0.f;
            }
        }
    }
  }
  __syncthreads();   // the ring is free: the merge below reuses it

  // the four lanes of a row, then the warps side by side over the codes
  float* red_d = reinterpret_cast<float*>(ring);
  int* red_i = reinterpret_cast<int*>(red_d + WARPS_N * BM);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        const float d2 = __shfl_xor_sync(0xffffffffu, best[mi][h], o);
        const int i2 = __shfl_xor_sync(0xffffffffu, best_i[mi][h], o);
        take_better(best[mi][h], best_i[mi][h], d2, i2);
      }
      if (t == 0) {
        const int r = wm * 32 + mi * 16 + g + 8 * h;
        red_d[wn * BM + r] = best[mi][h];
        red_i[wn * BM + r] = best_i[mi][h];
      }
    }
  __syncthreads();
  for (int r = threadIdx.x; r < BM; r += kNT) {
    if (row0 + r >= m) break;
    float d = red_d[r];
    int i = red_i[r];
    for (int w = 1; w < WARPS_N; ++w) take_better(d, i, red_d[w * BM + r], red_i[w * BM + r]);
    if (ws_d == nullptr) {
      out[row0 + r] = i;
    } else {
      ws_d[static_cast<long>(blockIdx.y) * m + row0 + r] = d;
      ws_i[static_cast<long>(blockIdx.y) * m + row0 + r] = i;
    }
  }
}

// Each row's best of the code ranges, taken in code order (a thread a row).
__global__ void __launch_bounds__(kNT)
nearest_code_merge_kernel(const float* __restrict__ ws_d, const int* __restrict__ ws_i,
                          long long* __restrict__ out, int m, int splits) {
  const long row = static_cast<long>(blockIdx.x) * kNT + threadIdx.x;
  if (row >= m) return;
  float d = ws_d[row];
  int i = ws_i[row];
  for (int s = 1; s < splits; ++s) take_better(d, i, ws_d[s * static_cast<long>(m) + row],
                                               ws_i[s * static_cast<long>(m) + row]);
  out[row] = i;
}

// fp32 on CUDA cores: 16 rows of z in shared memory (ZS: their 32 columns of
// the current chunk), tiles of 64 codes x 32 columns; thread (ty, tx) holds
// rows 4 ty .. 4 ty + 3 against code tx.
constexpr int kRowsF = 16, kChunkF = 32, kLdF = kChunkF + 4;

__host__ __device__ constexpr int f32_smem(int v, bool zs) {
  return (kRowsF * (zs ? kChunkF : round_up(v, kChunkF)) + kTile * kLdF + 4 * kRowsF) * 4;
}

template <bool ZS>
__global__ void __launch_bounds__(kNT)
nearest_code_f32_kernel(const float* __restrict__ z, const float* __restrict__ cb,
                        const float* __restrict__ cn, long long* __restrict__ out, int m, int v,
                        int k) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int vp = round_up(v, kChunkF), ldz = ZS ? kChunkF : vp;
  float* zs = reinterpret_cast<float*>(smem);           // [16][ldz]
  float* cs = zs + kRowsF * ldz;                        // [64][kLdF]
  float* red_d = cs + kTile * kLdF;                     // [2][16]
  int* red_i = reinterpret_cast<int*>(red_d + 2 * kRowsF);

  const int row0 = blockIdx.x * kRowsF;
  const int ty = threadIdx.x / kTile, tx = threadIdx.x % kTile;
  for (int c = threadIdx.x; !ZS && c < kRowsF * (vp / 4); c += kNT) {
    const int r = c / (vp / 4), col = (c % (vp / 4)) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < m && col < v) {
      val = *reinterpret_cast<const float4*>(z + static_cast<long>(row0 + r) * v + col);
    }
    *reinterpret_cast<float4*>(zs + r * vp + col) = val;
  }

  float best[4];
  int best_i[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    best[r] = kBig;
    best_i[r] = 0;
  }
  for (int code0 = 0; code0 < k; code0 += kTile) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int col0 = 0; col0 < vp; col0 += kChunkF) {
      __syncthreads();   // the previous chunk is consumed (and zs is whole)
      for (int c = threadIdx.x; c < kTile * (kChunkF / 4); c += kNT) {
        const int r = c / (kChunkF / 4), col = col0 + (c % (kChunkF / 4)) * 4;
        float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
        if (code0 + r < k && col < v) {
          val = *reinterpret_cast<const float4*>(cb + static_cast<long>(code0 + r) * v + col);
        }
        *reinterpret_cast<float4*>(cs + r * kLdF + (col - col0)) = val;
      }
      for (int c = threadIdx.x; ZS && c < kRowsF * (kChunkF / 4); c += kNT) {
        const int r = c / (kChunkF / 4), col = col0 + (c % (kChunkF / 4)) * 4;
        float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row0 + r < m && col < v) {
          val = *reinterpret_cast<const float4*>(z + static_cast<long>(row0 + r) * v + col);
        }
        *reinterpret_cast<float4*>(zs + r * kChunkF + (col - col0)) = val;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kChunkF; j += 4) {
        const float4 cv = *reinterpret_cast<const float4*>(cs + tx * kLdF + j);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float4 zv =
              *reinterpret_cast<const float4*>(zs + (ty * 4 + r) * ldz + (ZS ? 0 : col0) + j);
          acc[r] = fmaf(zv.x, cv.x, acc[r]);
          acc[r] = fmaf(zv.y, cv.y, acc[r]);
          acc[r] = fmaf(zv.z, cv.z, acc[r]);
          acc[r] = fmaf(zv.w, cv.w, acc[r]);
        }
      }
    }
    const int code = code0 + tx;
    if (code < k) {
      const float norm = cn[code];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float d = __fsub_rn(norm, __fmul_rn(2.0f, acc[r]));
        if (d < best[r]) {
          best[r] = d;
          best_i[r] = code;
        }
      }
    }
  }
  // the 64 threads of a row group: a warp's lanes, then its two warps
  const int lane = threadIdx.x % 32, half = (threadIdx.x / 32) % 2;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float d2 = __shfl_xor_sync(0xffffffffu, best[r], o);
      const int i2 = __shfl_xor_sync(0xffffffffu, best_i[r], o);
      take_better(best[r], best_i[r], d2, i2);
    }
    if (lane == 0) {
      red_d[half * kRowsF + ty * 4 + r] = best[r];
      red_i[half * kRowsF + ty * 4 + r] = best_i[r];
    }
  }
  __syncthreads();
  if (threadIdx.x < kRowsF && row0 + threadIdx.x < m) {
    const int r = threadIdx.x;
    float d = red_d[r];
    int i = red_i[r];
    take_better(d, i, red_d[kRowsF + r], red_i[kRowsF + r]);
    out[row0 + r] = i;
  }
}

// splits > 1: the codebook's tiles in that many contiguous ranges, one per
// grid row, their per-row bests in ws (splits x m floats, then as many ints)
// and merged after.
template <int BM, bool ZS>
int launch_bf16(const void* z, const void* cb, const float* cn, long long* out, void* ws,
                int m, int v, int k, int splits, cudaStream_t stream) {
  const int smem = ZS ? bf16_stream_smem(BM) : bf16_smem(BM, v);
  cudaError_t rc = cudaFuncSetAttribute(nearest_code_bf16_kernel<BM, ZS>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int tiles = (k + kTile - 1) / kTile;
  const int per = (tiles + splits - 1) / splits;
  const int ranges = (tiles + per - 1) / per;  // none of them empty
  float* ws_d = ranges > 1 ? static_cast<float*>(ws) : nullptr;
  int* ws_i = ranges > 1 ? reinterpret_cast<int*>(ws_d + static_cast<long>(ranges) * m) : nullptr;
  const dim3 grid((m + BM - 1) / BM, ranges);
  nearest_code_bf16_kernel<BM, ZS><<<grid, kNT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(z), static_cast<const __nv_bfloat16*>(cb), cn, out, ws_d,
      ws_i, m, v, k, per);
  if (ranges > 1) {
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return static_cast<int>(rc);
    nearest_code_merge_kernel<<<(m + kNT - 1) / kNT, kNT, 0, stream>>>(ws_d, ws_i, out, m,
                                                                       ranges);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int BM>
int launch_bf16_rows(const void* z, const void* cb, const float* cn, long long* out, void* ws,
                     int m, int v, int k, int splits, cudaStream_t stream) {
  return bf16_smem(BM, v) <= kSmemLimit
             ? launch_bf16<BM, false>(z, cb, cn, out, ws, m, v, k, splits, stream)
             : launch_bf16<BM, true>(z, cb, cn, out, ws, m, v, k, splits, stream);
}

}  // namespace

// z (m, v) and codebook (k, v) of dtype (bfloat16: v a multiple of 8;
// float32: of 4), norms a (k,) f32 workspace, out (m,) int64; all
// contiguous and 16-byte aligned. block_rows: rows of z per block of the
// bf16 kernel (32, 64 or 128), whose rows of z stay in shared memory where
// they fit and are tiled over V where they do not; splits: ranges of the
// codebook searched by separate blocks (bf16; 1: none), with ws a workspace
// of 2 * splits * m 4-byte words (null when splits is 1). fp32 ignores both.
extern "C" int tae_nearest_code_fwd(const void* z, const void* cb, void* norms, void* out,
                                    void* ws, int m, int v, int k, int dtype, int block_rows,
                                    int splits, void* stream) {
  if (m < 1 || k < 1 || v < 4 || (dtype != kFloat32 && dtype != kBFloat16) ||
      v % (dtype == kBFloat16 ? 8 : 4) != 0 || splits < 1 || splits > 65535 ||
      (dtype == kBFloat16 && splits > 1 && ws == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* cn = static_cast<float*>(norms);
  long long* ids = static_cast<long long*>(out);
  const int norm_blocks = (k + kNT / 32 - 1) / (kNT / 32);
  if (dtype == kFloat32) {
    nearest_code_norms_kernel<float><<<norm_blocks, kNT, 0, s>>>(static_cast<const float*>(cb),
                                                                  cn, k, v);
    const bool zs = f32_smem(v, false) > kSmemLimit;
    const int smem = f32_smem(v, zs);
    auto kernel = zs ? nearest_code_f32_kernel<true> : nearest_code_f32_kernel<false>;
    cudaError_t rc =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    kernel<<<(m + kRowsF - 1) / kRowsF, kNT, smem, s>>>(
        static_cast<const float*>(z), static_cast<const float*>(cb), cn, ids, m, v, k);
    return static_cast<int>(cudaGetLastError());
  }
  nearest_code_norms_kernel<__nv_bfloat16><<<norm_blocks, kNT, 0, s>>>(
      static_cast<const __nv_bfloat16*>(cb), cn, k, v);
  if (block_rows == 128) return launch_bf16_rows<128>(z, cb, cn, ids, ws, m, v, k, splits, s);
  if (block_rows == 64) return launch_bf16_rows<64>(z, cb, cn, ids, ws, m, v, k, splits, s);
  if (block_rows == 32) return launch_bf16_rows<32>(z, cb, cn, ids, ws, m, v, k, splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
