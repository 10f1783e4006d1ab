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
//   fp32 inputs take a plain CUDA-core kernel (16 rows a block, a thread
//   per code of a 64-code tile, z resident where it fits and tiled over V
//   otherwise): right, not fast.
#include <stdint.h>

#include "common.cuh"
#include "quantizer.cuh"

namespace {

using namespace tae;
using vq::round_up;

constexpr float kBig = 3.4e38f;   // larger than any real distance
constexpr int kNT = 256;
constexpr int kTile = 64;         // codes of the fp32 kernel's tile
constexpr int kSmemLimit = 232448;

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
// the card's SM count, which the bf16 plan (quantizer.cuh) reads; splits:
// that plan's ranges of the codebook (1 for float32), with ws a workspace
// of 2 * splits * m 4-byte words (null when splits is 1). norms: an f32
// workspace of k values (float32) or of the bf16 plan's whole tiles
// (ceil(k / codes) * codes).
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
    if (splits != 1) return static_cast<int>(cudaErrorInvalidValue);
    nearest_code_norms_kernel<float><<<(k + kNT / 32 - 1) / (kNT / 32), kNT, 0, s>>>(
        static_cast<const float*>(cb), cn, k, k, v, 0.f);
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
