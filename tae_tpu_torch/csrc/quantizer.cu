// K14 nearest_code — codebook nearest-neighbour search of the VQ bottleneck.
//
// Replaces: tae_tpu/ops/pallas/quantizer.py::nearest_code_pallas (_kernel).
//   For latents z (M, V) and a codebook (K, V): argmin_k (|c_k|^2 - 2 z.c_k)
//   (the |z|^2 term is constant per row), the lowest index among equal
//   distances. The (M, K) distance matrix never reaches device memory.
// What bounds it on the H100: tensor-core operations at the serving shape
//   (2 * M * K * V = 6.9e10 at M = 16384, K = 8192, V = 256; the inputs are
//   12 MB); where z is too wide to stay in shared memory, what the SMs can
//   take from L2 (z's and the codebook's slabs, restaged for every code
//   range and row block).
// What the design does about it (nearest_code_wgmma_kernel; plan in
//   quantizer.cuh). nearest_code_norms_kernel writes |c_k|^2 in fp32 once
//   per call (a warp per code), and 3.4e38 for the codes past K up to a
//   whole tile. bf16: a block is one producer warp and one or two consumer
//   warpgroups of 64 rows. The producer issues TMA loads
//   (cp.async.bulk.tensor from tensor maps the launcher encodes each call
//   and passes as __grid_constant__ parameters, 128-byte swizzle, zeros
//   past M, K and V) into an mbarrier ring of codebook slabs (128 codes x 64
//   columns) as the flat sequence of (code tile, 64-column step) of the
//   block's range, so the ring never drains between tiles; z's slabs are
//   loaded once where they fit beside the ring, else z's 64 columns ride
//   each slot; each tile's norms ride its last step's slot by a bulk copy.
//   The consumers run wgmma.mma_async m64n128k16 (bf16, fp32 accumulate),
//   both operands K-major from shared memory: four k16 products a step, one
//   group in flight while the previous step's slot is released. After a
//   tile's last step a thread holds the m64n128 accumulator in mma.sync's C
//   layout per 8 codes (rows 16 w + g, + 8; codes 8 j + 2 t + {0, 1}),
//   turns it into distances |c|^2 - 2 acc in one rounding (as the first
//   design's product and difference: 2 acc is exact) and keeps a running
//   (min, argmin) for its two rows, meeting its codes in ascending order and
//   replacing only on <; the four lanes of a row are merged by (distance,
//   index) pairs, so the lowest index wins every tie. A code past K has a
//   zero row, so a product of 0 and the distance 3.4e38: it never wins.
//   Rows past M are zero-filled and not written. Few rows make few row
//   blocks (M = 256: four of 64 rows), each streaming the whole codebook at
//   one SM's rate: there the codebook is split over the grid's second axis,
//   each block searching a contiguous range of code tiles, and a merge
//   kernel takes each row's (distance, index) pairs in code order, so the
//   lowest index still wins a tie across the ranges.
//   fp32 (nearest_code_f32_kernel; plan vq::f32 in quantizer.cuh): the
//   products stay fp32 FMAs on the CUDA cores (67 TFLOP/s: 0.128 ms at
//   (2048, 256) x 8192 codes, where the bytes take 0.004), as the first
//   design's, so its distances and ids are the first design's. That design
//   (16 rows a block, a thread per code of a 64-code tile) fed each 16 FMAs
//   with five shared-memory float4s and staged behind plain loads. Now a
//   block takes 128 rows and 256-code tiles over 256 threads, each an 8 x 16
//   register tile (24 float4s per 512 FMAs; 128-code tiles and 8 x 8 where
//   the wide tiles would leave SMs idle), 32-column chunks arrive by
//   cp.async through a ring of up to 4 slots, z stays resident where it
//   fits (V <= 288 wide, 352 narrow) and rides the ring otherwise, and at
//   few rows the codebook is split over grid.y and merged as in bf16.
//   Measured on an H100 80GB HBM3 at 700 W (bench/vq_body.py): (2048, 256)
//   0.235 ms, (16384, 256) 1.79, (256, 256) 0.046 (the first design 1.03,
//   4.28, 1.02); the 8 x 8 tile at every shape (f32_narrow) 0.257 and 1.97;
//   the column loop unrolled by 2 (f32_unroll2) 1-2% slower; the distances
//   and running argmin cost 5% (f32_no_epilogue); two ring slots as fast as
//   four (f32_stages2).
#include <stdint.h>

#include "common.cuh"
#include "quantizer.cuh"

namespace {

using namespace tae;
using vq::round_up;

constexpr float kBig = 3.4e38f;   // larger than any real distance
constexpr int kNT = 256;

// (d2, i2) replaces (d, i) if it is nearer, or as near with a lower index
__device__ __forceinline__ void take_better(float& d, int& i, float d2, int i2) {
  if (d2 < d || (d2 == d && i2 < i)) {
    d = d2;
    i = i2;
  }
}

// |c|^2 of codes [0, k), and `pad` for [k, kp): the bf16 search reads
// whole tiles of norms, and a code past K (a zero row, so that its product
// is 0) takes pad (kBig) for its distance and never wins.
template <typename T>
__global__ void __launch_bounds__(kNT) nearest_code_norms_kernel(const T* __restrict__ cb,
                                                                 float* __restrict__ cn, int k,
                                                                 int kp, int v, float pad) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long code = static_cast<long>(blockIdx.x) * (kNT / 32) + warp;
  if (code >= kp) return;
  float s = 0.f;
  for (int i = lane; code < k && i < v; i += 32) {
    const float c = to_float(cb[code * v + i]);
    s += c * c;
  }
  s = warp_sum(s);
  if (lane == 0) cn[code] = code < k ? s : pad;
}

// The bf16 search. NC consumer warpgroups (64 rows each) and one producer
// warp; ZS: z rides the ring (else its slabs stay resident). per: code
// tiles of the block's range (blockIdx.y); p_stages: ring slots (the
// plan's). ws_d / ws_i: the ranges' per-row bests, where the codebook is
// split (null otherwise: ids go to out).
template <int NC, bool ZS>
__global__ void __launch_bounds__(NC * 128 + 32, 1)
nearest_code_wgmma_kernel(const __grid_constant__ CUtensorMap zmap,
                          const __grid_constant__ CUtensorMap cmap, const float* __restrict__ cn,
                          long long* __restrict__ out, float* __restrict__ ws_d,
                          int* __restrict__ ws_i, int m, int v, int k, int per,
                          int p_stages) {
  using namespace sm90;
  constexpr int BN = vq::kCodes, BM = 64 * NC, kCols = vq::kCols;
  constexpr int kZSlab = BM * kCols * 2, kCSlab = BN * kCols * 2;
  constexpr int kSlot = vq::slot_bytes(BM, BN, !ZS);
  constexpr int kNorms = kCSlab + (ZS ? kZSlab : 0);  // the tile's norms in a slot
  __shared__ __align__(8) uint64_t full[vq::kMaxStages], empty[vq::kMaxStages], zfull;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzled slabs start on 1024-byte boundaries
  unsigned char* smem = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const int ksteps = (v + kCols - 1) / kCols;
  unsigned char* ring = smem + (ZS ? 0 : ksteps * kZSlab);
  const int tile0 = blockIdx.y * per;
  const int tiles = min(per, (k + BN - 1) / BN - tile0);
  const int row0 = blockIdx.x * BM;
  // the warp index through a shuffle, so that the compiler knows it is the
  // same across the warp: wgmma on a path it takes for divergent is
  // serialized
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 32), 0);
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p_stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NC);  // each consumer warpgroup
    }
    mbar_init(&zfull, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == NC * 4) {
    // the producer warp, whole (its lanes never wait apart from each
    // other), one lane issuing the copies
    if (!ZS && lane == 0) {
      mbar_expect_tx(&zfull, ksteps * kZSlab);
      for (int s = 0; s < ksteps; ++s)
        tma_load_2d(smem + s * kZSlab, &zmap, &zfull, s * kCols, row0);
    }
    int stage = 0;
    unsigned phase = 0;
    for (int step = 0; step < tiles * ksteps; ++step) {
      const int ks = step % ksteps;
      const int code0 = (tile0 + step / ksteps) * BN;
      unsigned char* slot = ring + stage * kSlot;
      mbar_wait(&empty[stage], phase ^ 1u);  // released by every consumer
      if (lane == 0) {
        const bool last = ks == ksteps - 1;
        mbar_expect_tx(&full[stage], kCSlab + (ZS ? kZSlab : 0) + (last ? BN * 4 : 0));
        tma_load_2d(slot, &cmap, &full[stage], ks * kCols, code0);
        if (ZS) tma_load_2d(slot + kCSlab, &zmap, &full[stage], ks * kCols, row0);
        if (last) bulk_load(slot + kNorms, cn + code0, BN * 4, &full[stage]);
      }
      __syncwarp();
      if (++stage == p_stages) {
        stage = 0;
        phase ^= 1u;
      }
    }
  } else {
    // a consumer warpgroup: rows row0 + 64 wg ..; thread (w, g, t) holds
    // rows 16 w + g and + 8 of them
    const int wg = warp / 4, w = warp % 4, g = lane / 4, t = lane % 4;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    float best[2] = {kBig, kBig};
    int best_i[2] = {0, 0};
    // one elected thread a warpgroup frees a slot
    auto release = [&](int s) {
      if (threadIdx.x % 128 == 0) mbar_arrive(&empty[s]);
    };
    if (!ZS) mbar_wait(&zfull, 0);
    int stage = 0, held = -1;
    unsigned phase = 0;
    for (int tile = 0; tile < tiles; ++tile) {
      const unsigned char* slot = nullptr;
      for (int ks = 0; ks < ksteps; ++ks) {
        slot = ring + stage * kSlot;
        mbar_wait(&full[stage], phase);
        const unsigned char* zs = (ZS ? slot + kCSlab : smem + ks * kZSlab) + wg * 64 * kCols * 2;
        const uint64_t da = desc_sw128(zs), db = desc_sw128(slot);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kCols / 16; ++kk)
          wgmma_bf16<BN>(acc, da + 2 * kk, db + 2 * kk, (ks > 0 || kk > 0) ? 1 : 0);
        wgmma_commit();
        wgmma_wait<1>();  // the previous step's products are done with its slot
        if (held >= 0) release(held);
        held = stage;
        if (++stage == p_stages) {
          stage = 0;
          phase ^= 1u;
        }
      }
      // the tile is whole: distances, then the running (min, argmin)
      wgmma_wait<0>();
      // |c|^2 - 2 acc in one rounding, as the first design's
      // __fsub_rn(norm, __fmul_rn(2, acc)) (2 acc is exact); codes past K
      // carry the norm kBig and a product of 0, so kBig and never win
      const int code0 = (tile0 + tile) * BN + 2 * t;
      const float* sn = reinterpret_cast<const float*>(slot + kNorms) + 2 * t;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float2 nn = *reinterpret_cast<const float2*>(sn + 8 * j);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float d = __fmaf_rn(-2.0f, acc[4 * j + 2 * h + e], e ? nn.y : nn.x);
            if (d < best[h]) {
              best[h] = d;
              best_i[h] = code0 + 8 * j + e;
            }
          }
        }
      }
      named_sync(1 + wg, 128);  // every warp of the warpgroup has read the norms
      release(held);
      held = -1;
    }
    // the four lanes of a row
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        const float d2 = __shfl_xor_sync(0xffffffffu, best[h], o);
        const int i2 = __shfl_xor_sync(0xffffffffu, best_i[h], o);
        take_better(best[h], best_i[h], d2, i2);
      }
      const int r = row0 + wg * 64 + 16 * w + g + 8 * h;
      if (t == 0 && r < m) {
        if (ws_d == nullptr) {
          out[r] = best_i[h];
        } else {
          ws_d[static_cast<long>(blockIdx.y) * m + r] = best[h];
          ws_i[static_cast<long>(blockIdx.y) * m + r] = best_i[h];
        }
      }
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

// fp32 on the CUDA cores (plan: quantizer.cuh, vq::f32). Thread (rg, cg) of
// the 16 x 16 grid owns rows rg + 16 r (r < 8) and codes cg + 16 j (j < NJ)
// of the block's tile of 16 NJ codes: per 4 columns, 8 float4s of z (held)
// and NJ of the codebook (one at a time, each feeding 32 FMAs) feed 32 NJ
// FMAs. Both are read along their rows (the codebook's
// chunk and z's, resident or riding, padded to an odd number of 16-byte
// units, so the 8 rows or codes a quarter-warp reads lie in distinct
// banks). Item i of the ring is chunk i % chunks of the range's code tile
// i / chunks; after a tile's last chunk each thread turns its sums into
// distances and keeps a running (min, argmin) for its 8 rows, meeting its
// codes in ascending order and replacing only on <; the 16 threads of a row
// are then merged by (distance, index) pairs, so the lowest index wins
// every tie.
template <bool ZRES, int NJ>
__global__ void __launch_bounds__(vq::f32::kThreads, 1)
nearest_code_f32_kernel(const float* __restrict__ z, const float* __restrict__ cb,
                        const float* __restrict__ cn, long long* __restrict__ out,
                        float* __restrict__ ws_d, int* __restrict__ ws_i, int m, int v, int k,
                        int per, int stages) {
  constexpr int kRows = vq::f32::kRows, kChunk = vq::f32::kChunk, kCodes = 16 * NJ;
  constexpr int kLd = vq::f32::kLd, kThreads = vq::f32::kThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  const int vp = round_up(v, kChunk), chunks = vp / kChunk, lz = vq::f32::ldz(v);
  float* zs = reinterpret_cast<float*>(smem);                  // [kRows][lz], resident
  float* ring = zs + (ZRES ? kRows * lz : 0);                   // [stages][slot]
  constexpr int kSlot = (kCodes + (ZRES ? 0 : kRows)) * kLd;    // floats
  float* red_d = ring + stages * kSlot;                         // [2][kRows]
  int* red_i = reinterpret_cast<int*>(red_d + 2 * kRows);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cg = (warp & 1) * 8 + (lane & 7), rg = (warp >> 1) * 4 + (lane >> 3);
  const int row0 = blockIdx.x * kRows;
  const int tiles = vq::ceil_div(k, kCodes), t0 = blockIdx.y * per;
  const int t1 = min(tiles, t0 + per), items = (t1 - t0) * chunks;

  // 16 bytes from src into dst, or zeros
  auto copy16 = [](float* dst, const float* src, bool valid) {
    if (valid)
      tae::cp_async16(dst, src);
    else
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  };
  auto issue = [&](int i) {
    if (i < items) {
      const int code0 = (t0 + i / chunks) * kCodes, col0 = (i % chunks) * kChunk;
      float* slot = ring + (i % stages) * kSlot;
      for (int idx = tid; idx < kCodes * (kChunk / 4); idx += kThreads) {
        const int r = idx / (kChunk / 4), col = col0 + (idx % (kChunk / 4)) * 4;
        copy16(slot + r * kLd + col - col0, cb + static_cast<long>(code0 + r) * v + col,
               code0 + r < k && col < v);
      }
      for (int idx = tid; !ZRES && idx < kRows * (kChunk / 4); idx += kThreads) {
        const int r = idx / (kChunk / 4), col = col0 + (idx % (kChunk / 4)) * 4;
        copy16(slot + (kCodes + r) * kLd + col - col0,
               z + static_cast<long>(row0 + r) * v + col, row0 + r < m && col < v);
      }
    }
    tae::cp_async_commit();
  };
  for (int idx = tid; ZRES && idx < kRows * (vp / 4); idx += kThreads) {
    const int r = idx / (vp / 4), col = (idx % (vp / 4)) * 4;
    copy16(zs + r * lz + col, z + static_cast<long>(row0 + r) * v + col,
           row0 + r < m && col < v);
  }
  for (int i = 0; i < stages - 1; ++i) issue(i);  // with resident z in the first group

  float acc[8][NJ], best[8];
  int best_i[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    best[r] = kBig;
    best_i[r] = 0;
  }
  for (int i = 0; i < items; ++i) {
    tae::wait_pending(stages - 2);  // item i (stages - 2 newer groups may fly)
    __syncthreads();                // ... landed for all; slot (i - 1) % stages is free
    issue(i + stages - 1);
    const int ch = i % chunks;
    if (ch == 0) {
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[r][j] = 0.f;
    }
    const float* cs = ring + (i % stages) * kSlot;
    const float* zr = ZRES ? zs + ch * kChunk : cs + kCodes * kLd;
    const int ldr = ZRES ? lz : kLd;
#pragma unroll 1
    for (int c = 0; c < kChunk; c += 4) {
      float4 zv[8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        zv[r] = *reinterpret_cast<const float4*>(zr + (rg + 16 * r) * ldr + c);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 cv = *reinterpret_cast<const float4*>(cs + (cg + 16 * j) * kLd + c);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          float a = acc[r][j];
          a = fmaf(zv[r].x, cv.x, a);
          a = fmaf(zv[r].y, cv.y, a);
          a = fmaf(zv[r].z, cv.z, a);
          a = fmaf(zv[r].w, cv.w, a);
          acc[r][j] = a;
        }
      }
    }
    if (ch == chunks - 1) {
      const int code0 = (t0 + i / chunks) * kCodes;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int code = code0 + cg + 16 * j;
        if (code < k) {
          const float norm = cn[code];
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const float d = __fsub_rn(norm, __fmul_rn(2.0f, acc[r][j]));
            if (d < best[r]) {
              best[r] = d;
              best_i[r] = code;
            }
          }
        }
      }
    }
  }
  tae::wait_pending(0);  // no copy in flight (the trailing groups are empty)
  // the 16 threads of a row: its 8 lanes of the warp (lane bits 0-2), then
  // the two warps of the row group
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) {
      const float d2 = __shfl_xor_sync(0xffffffffu, best[r], o);
      const int i2 = __shfl_xor_sync(0xffffffffu, best_i[r], o);
      take_better(best[r], best_i[r], d2, i2);
    }
    if ((lane & 7) == 0) {
      red_d[(warp & 1) * kRows + rg + 16 * r] = best[r];
      red_i[(warp & 1) * kRows + rg + 16 * r] = best_i[r];
    }
  }
  __syncthreads();
  if (tid < kRows && row0 + tid < m) {
    float d = red_d[tid];
    int i = red_i[tid];
    take_better(d, i, red_d[kRows + tid], red_i[kRows + tid]);
    const long row = row0 + tid;
    if (ws_d == nullptr) {
      out[row] = i;
    } else {
      ws_d[static_cast<long>(blockIdx.y) * m + row] = d;
      ws_i[static_cast<long>(blockIdx.y) * m + row] = i;
    }
  }
}

// The fp32 plan's search, then (splits > 1) the merge of its ranges'
// per-row bests (ws as launch_bf16's).
int launch_f32(const vq::f32::Plan& p, const float* z, const float* cb, const float* cn,
               long long* out, void* ws, int m, int v, int k, cudaStream_t stream) {
  const bool wide = p.codes == vq::f32::kWideCodes;
  auto* kernel = p.resident ? (wide ? nearest_code_f32_kernel<true, 16>
                                    : nearest_code_f32_kernel<true, 8>)
                            : (wide ? nearest_code_f32_kernel<false, 16>
                                    : nearest_code_f32_kernel<false, 8>);
  const cudaError_t rc =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  float* ws_d = p.splits > 1 ? static_cast<float*>(ws) : nullptr;
  int* ws_i = p.splits > 1 ? reinterpret_cast<int*>(ws_d + static_cast<long>(p.splits) * m)
                           : nullptr;
  kernel<<<dim3(p.blocks, p.splits), vq::f32::kThreads, p.smem, stream>>>(
      z, cb, cn, out, ws_d, ws_i, m, v, k, p.per, p.stages);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return static_cast<int>(err);
  nearest_code_merge_kernel<<<(m + kNT - 1) / kNT, kNT, 0, stream>>>(ws_d, ws_i, out, m,
                                                                     p.splits);
  return static_cast<int>(cudaGetLastError());
}

template <int NC, bool ZS>
int launch_wgmma(const vq::Plan& p, const CUtensorMap& zmap, const CUtensorMap& cmap,
                 const float* cn, long long* out, float* ws_d, int* ws_i, int m, int v, int k,
                 cudaStream_t stream) {
  auto* kernel = nearest_code_wgmma_kernel<NC, ZS>;
  const cudaError_t rc =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  kernel<<<dim3(p.blocks, p.splits), NC * 128 + 32, p.smem, stream>>>(
      zmap, cmap, cn, out, ws_d, ws_i, m, v, k, p.per, p.stages);
  return static_cast<int>(cudaGetLastError());
}

// The plan's search, then (splits > 1) the merge of its ranges' per-row
// bests (ws: splits x m floats, then as many ints).
int launch_bf16(const vq::Plan& p, const void* z, const void* cb, const float* cn,
                long long* out, void* ws, int m, int v, int k, cudaStream_t stream) {
  CUtensorMap zmap, cmap;
  const uint64_t row_bytes = static_cast<uint64_t>(v) * 2;
  int rc = tensor_map_bf16_2d(&zmap, z, v, m, row_bytes, vq::kCols, p.rows);
  if (rc != 0) return rc;
  rc = tensor_map_bf16_2d(&cmap, cb, v, k, row_bytes, vq::kCols, p.codes);
  if (rc != 0) return rc;
  float* ws_d = p.splits > 1 ? static_cast<float*>(ws) : nullptr;
  int* ws_i = p.splits > 1 ? reinterpret_cast<int*>(ws_d + static_cast<long>(p.splits) * m)
                           : nullptr;
  const bool zs = p.resident == 0, two = p.consumers == 2;
#define TAE_VQ_CASE(NC, ZS)                                                            \
  if (two == (NC == 2) && zs == ZS)                                                    \
    rc = launch_wgmma<NC, ZS>(p, zmap, cmap, cn, out, ws_d, ws_i, m, v, k, stream);
  TAE_VQ_CASE(1, false)
  TAE_VQ_CASE(1, true)
  TAE_VQ_CASE(2, false)
  TAE_VQ_CASE(2, true)
#undef TAE_VQ_CASE
  if (rc != 0 || p.splits == 1) return rc;
  nearest_code_merge_kernel<<<(m + kNT - 1) / kNT, kNT, 0, stream>>>(ws_d, ws_i, out, m,
                                                                     p.splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// z (m, v) and codebook (k, v) of dtype (bfloat16: v a multiple of 8;
// float32: of 4), out (m,) int64; all contiguous and 16-byte aligned. sms:
// the card's SM count, which the plans (quantizer.cuh) read; splits: the
// dtype's plan's ranges of the codebook, with ws a workspace of 2 * splits
// * m 4-byte words (null when splits is 1). norms: an f32 workspace of k
// values (float32) or of the bf16 plan's whole tiles (ceil(k / codes) *
// codes).
extern "C" int tae_nearest_code_fwd(const void* z, const void* cb, void* norms, void* out,
                                    void* ws, int m, int v, int k, int dtype, int sms,
                                    int splits, void* stream) {
  if (m < 1 || k < 1 || v < 4 || (dtype != kFloat32 && dtype != kBFloat16) ||
      v % (dtype == kBFloat16 ? 8 : 4) != 0 || splits < 1 || splits > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* cn = static_cast<float*>(norms);
  long long* ids = static_cast<long long*>(out);
  if (dtype == kFloat32) {
    vq::f32::Plan p;
    if (!vq::f32::plan(m, v, k, sms, p) || splits != p.splits || (splits > 1 && ws == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    nearest_code_norms_kernel<float><<<(k + kNT / 32 - 1) / (kNT / 32), kNT, 0, s>>>(
        static_cast<const float*>(cb), cn, k, k, v, 0.f);
    const cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess) return static_cast<int>(rc);
    return launch_f32(p, static_cast<const float*>(z), static_cast<const float*>(cb), cn, ids,
                      ws, m, v, k, s);
  }
  vq::Plan p;
  if (!vq::plan(m, v, k, sms, p) || splits != p.splits || (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int kp = vq::round_up(k, p.codes);
  nearest_code_norms_kernel<__nv_bfloat16><<<(kp + kNT / 32 - 1) / (kNT / 32), kNT, 0, s>>>(
      static_cast<const __nv_bfloat16*>(cb), cn, k, kp, v, kBig);
  const cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return launch_bf16(p, z, cb, cn, ids, ws, m, v, k, s);
}

// The bf16 plan for (m, v, k) on a card of `sms` SMs (quantizer.cuh):
// out[0] 1 where the kernel takes the shape (else 0, and nothing more is
// written), then rows, consumers, codes, stages, resident, blocks,
// splits, per, smem.
extern "C" int tae_nearest_code_plan(int m, int v, int k, int sms, int* out) {
  vq::Plan p;
  out[0] = vq::plan(m, v, k, sms, p) ? 1 : 0;
  if (!out[0]) return 0;
  const int fields[] = {p.rows,   p.consumers, p.codes, p.stages, p.resident,
                        p.blocks, p.splits,    p.per,   p.smem};
  for (int i = 0; i < 9; ++i) out[1 + i] = fields[i];
  return 0;
}

// The fp32 plan for (m, v, k) on a card of `sms` SMs (quantizer.cuh,
// vq::f32): out[0] 1 where the kernel takes the shape (else 0, and nothing
// more is written), then rows, codes, chunk, stages, resident, blocks,
// splits, per, smem.
extern "C" int tae_nearest_code_f32_plan(int m, int v, int k, int sms, int* out) {
  vq::f32::Plan p;
  out[0] = vq::f32::plan(m, v, k, sms, p) ? 1 : 0;
  if (!out[0]) return 0;
  const int fields[] = {p.rows,   p.codes,  p.chunk, p.stages, p.resident,
                        p.blocks, p.splits, p.per,   p.smem};
  for (int i = 0; i < 9; ++i) out[1 + i] = fields[i];
  return 0;
}
