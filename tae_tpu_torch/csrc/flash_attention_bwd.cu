// K10, K17 — attention backward, one device body for two layouts.
//
// Replaces:
//   K10 tae_tpu/ops/pallas/flash_attention.py::_packed_vjp_bwd
//       (_packed_bwd_kernel_stacked, _packed_bwd_kernel). From the packed qkv
//       (B, N, 3C), the saved output o (B, N, C), the saved lse (B, H, N) fp32
//       and the output's gradient do (B, N, C) it writes dqkv (B, N, 3C),
//       every element exactly once, heads as contiguous dh-column slices as
//       in qkv.
//   K17 flash_attention.py::_flash_bwd (_bwd_kernel): the same from
//       unpacked q, k, v, o, do (B, H, N, dh), each with its own (image,
//       head, row) strides, to dq, dk, dv (B, H, N, dh). The JAX body runs
//       every product in fp32; in bfloat16 this one rounds P and dS as below
//       (the plain version and chip_smoke.py hold it to the fp32 form).
// Numerics, per (image, head): S = Q.K^T * scale and dP = dO.V^T with fp32
//   accumulation; P = exp(S - lse); delta = rowsum(dO * o) from the saved,
//   rounded o; dS = P * (dP - delta) * scale; dV = P^T.dO, dQ = dS.K,
//   dK = dS^T.Q, each rounded once to the input dtype. In bfloat16 the tensor
//   cores take P and dS rounded to bfloat16 ahead of those three products (as
//   the forward rounds p ahead of P.V); dS itself is formed from the fp32 P.
//   In float32 nothing is rounded.
// What bounds it on the H100: the seven N x N x dh products per head (five of
//   the formula, S and dP formed twice, see below) against tensor-core and
//   shared-memory throughput; its bytes (qkv, o, do in, dqkv out) are a tenth
//   of that time.
// What the design does about it: dK and dV sum over query rows, dQ over keys.
//   A CUDA grid has no sequential axis to carry such sums and float atomics
//   would change bits from run to run, so one block owns one (image, head)
//   whole (N <= 256) and no sum crosses a block.
//   * bfloat16: Q, K, V and dO of the head are staged once in shared memory
//     (147 KB at dh 64, 180 KB at dh 80: one block per SM). Pass 1: a warp
//     owns 16 keys, walks the query tiles, rebuilds the 16 x 16 tile of P and
//     dS (WMMA 16x16x16, fp32 accumulate, the elementwise step through a 4 KB
//     scratch per warp) and accumulates dV and dK of its keys in registers.
//     Pass 2: a warp owns 16 query rows, walks the key tiles and accumulates
//     dQ. Forming S and dP twice costs two products more and saves a
//     cross-warp reduction of dQ (64 to 80 KB of fp32 that shared memory has
//     no room for). Rows and keys beyond N in a padded tile: p = 0 exactly,
//     nothing written.
//   * float32: CUDA cores, fp32 throughout. K and V are staged for the dQ
//     phase (a warp per query row, a lane per key), then Q and dO take their
//     place for the dK / dV phase (a warp per key, a lane per query row).
//   Register-resident tiles, wgmma and TMA are later work.
#include <mma.h>

#include "common.cuh"

namespace {

namespace wm = nvcuda::wmma;
using bf16 = __nv_bfloat16;
using tae::HeadLayout;

constexpr int kMaxN = 256;  // tokens supported (one block holds a whole head)
constexpr int kWarps = 8;

__host__ __device__ constexpr int pad16(int n) { return (n + 15) / 16 * 16; }

// ---------------------------------------------------------------- bfloat16

constexpr int kSLd = 20;  // row stride of an fp32 16 x 16 tile in the scratch
constexpr int kBLd = 24;  // row stride of a bfloat16 16 x 16 tile

template <int DH> __host__ __device__ constexpr int tc_ld() { return DH + 8; }

struct WarpScratch {
  float s[16 * kSLd];   // S tile, then an output tile on its way out
  float dp[16 * kSLd];  // dP tile
  bf16 p[16 * kBLd];    // P rounded to bfloat16
  bf16 ds[16 * kBLd];   // dS rounded to bfloat16
};

using FragA = wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major>;
using FragAT = wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::col_major>;
using FragB = wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major>;
using FragBT = wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::col_major>;
using Acc = wm::fragment<wm::accumulator, 16, 16, 16, float>;

template <int DH>
size_t tc_smem_bytes(int n) {
  return sizeof(bf16) * 4 * static_cast<size_t>(pad16(n)) * tc_ld<DH>() +
         sizeof(WarpScratch) * kWarps + sizeof(float) * 2 * pad16(n);
}

// The 16 x 16 tile of P and dS for query rows [i0, i0 + 16) and keys
// [j0, j0 + 16), rounded to bfloat16, into the warp's scratch.
template <int DH>
__device__ __forceinline__ void tile_p_ds(const bf16* qs, const bf16* ks, const bf16* vs,
                                          const bf16* dos, const float* lse,
                                          const float* delta, int i0, int j0, int n,
                                          float scale, WarpScratch& w, int lane) {
  constexpr int LD = tc_ld<DH>();
  Acc sacc, pacc;
  wm::fill_fragment(sacc, 0.f);
  wm::fill_fragment(pacc, 0.f);
#pragma unroll
  for (int kt = 0; kt < DH / 16; ++kt) {
    FragA a;
    FragBT b;
    wm::load_matrix_sync(a, qs + i0 * LD + kt * 16, LD);
    wm::load_matrix_sync(b, ks + j0 * LD + kt * 16, LD);
    wm::mma_sync(sacc, a, b, sacc);
    wm::load_matrix_sync(a, dos + i0 * LD + kt * 16, LD);
    wm::load_matrix_sync(b, vs + j0 * LD + kt * 16, LD);
    wm::mma_sync(pacc, a, b, pacc);
  }
  wm::store_matrix_sync(w.s, sacc, kSLd, wm::mem_row_major);
  wm::store_matrix_sync(w.dp, pacc, kSLd, wm::mem_row_major);
  __syncwarp();
  // a lane pair per row, 8 columns each
  const int r = lane >> 1, c0 = (lane & 1) * 8;
  const bool row_ok = i0 + r < n;
  const float l = lse[i0 + r], dl = delta[i0 + r];
  float sv[8], dv[8], pv[8], dsv[8];
  tae::load_vec(w.s + r * kSLd + c0, sv);
  tae::load_vec(w.s + r * kSLd + c0 + 4, sv + 4);
  tae::load_vec(w.dp + r * kSLd + c0, dv);
  tae::load_vec(w.dp + r * kSLd + c0 + 4, dv + 4);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const bool ok = row_ok && j0 + c0 + k < n;
    pv[k] = ok ? expf(sv[k] * scale - l) : 0.f;
    dsv[k] = pv[k] * (dv[k] - dl) * scale;
  }
  tae::store_vec(w.p + r * kBLd + c0, pv);
  tae::store_vec(w.ds + r * kBLd + c0, dsv);
  __syncwarp();
}

// Round an accumulated (16, DH) tile to bfloat16 and write its first `rows`
// rows to dst (row stride `stride` elements), through the warp's scratch.
template <int DH>
__device__ __forceinline__ void write_tile(const Acc (&acc)[DH / 16], bf16* dst,
                                           long stride, int rows, WarpScratch& w,
                                           int lane) {
  const int r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
  for (int dt = 0; dt < DH / 16; ++dt) {
    wm::store_matrix_sync(w.s, acc[dt], kSLd, wm::mem_row_major);
    __syncwarp();
    if (r < rows) {
      float v[8];
      tae::load_vec(w.s + r * kSLd + c0, v);
      tae::load_vec(w.s + r * kSLd + c0 + 4, v + 4);
      tae::store_vec(dst + r * stride + dt * 16 + c0, v);
    }
    __syncwarp();
  }
}

// The operands of one launch: pointers to the first element of each tensor
// and each one's layout (tae::HeadLayout).
template <typename T>
struct BwdArgs {
  const T* q;
  const T* k;
  const T* v;
  const T* o;
  const T* dout;
  T* dq;
  T* dk;
  T* dv;
  const float* lse;  // (batch, heads, n), contiguous
  HeadLayout lq, lk, lv, lo, ldo, ldq, ldk, ldv;
  int n, heads;
  float scale;
};

template <int DH>
__global__ void __launch_bounds__(kWarps * 32, 1)
attention_bwd_bf16(const BwdArgs<bf16> a) {
  const int n = a.n;
  const float scale = a.scale;
  constexpr int LD = tc_ld<DH>();
  constexpr int CH = DH / 8;  // 16-byte chunks per head row
  const int np = pad16(n), tiles = np / 16;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // (np, LD) each
  bf16* ks = qs + np * LD;
  bf16* vs = ks + np * LD;
  bf16* dos = vs + np * LD;
  WarpScratch* scratch = reinterpret_cast<WarpScratch*>(dos + np * LD);
  float* lse = reinterpret_cast<float*>(scratch + kWarps);  // (np)
  float* delta = lse + np;                                    // (np)

  const int b = blockIdx.y, h = blockIdx.x;
  const bf16* qb = a.q + a.lq.at(b, h);
  const bf16* kb = a.k + a.lk.at(b, h);
  const bf16* vb = a.v + a.lv.at(b, h);
  const bf16* obase = a.o + a.lo.at(b, h);
  const bf16* dobase = a.dout + a.ldo.at(b, h);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int idx = threadIdx.x; idx < np * CH; idx += blockDim.x) {
    const int r = idx / CH, ch = idx - r * CH;
    uint4 qq = zero, kq = zero, vq = zero, dq = zero;
    if (r < n) {
      qq = *reinterpret_cast<const uint4*>(qb + r * a.lq.row + ch * 8);
      kq = *reinterpret_cast<const uint4*>(kb + r * a.lk.row + ch * 8);
      vq = *reinterpret_cast<const uint4*>(vb + r * a.lv.row + ch * 8);
      dq = *reinterpret_cast<const uint4*>(dobase + r * a.ldo.row + ch * 8);
    }
    *reinterpret_cast<uint4*>(qs + r * LD + ch * 8) = qq;
    *reinterpret_cast<uint4*>(ks + r * LD + ch * 8) = kq;
    *reinterpret_cast<uint4*>(vs + r * LD + ch * 8) = vq;
    *reinterpret_cast<uint4*>(dos + r * LD + ch * 8) = dq;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // delta = rowsum(dO * o) from global memory (o is read for nothing else)
  for (int r = warp; r < np; r += kWarps) {
    float sum = 0.f;
    if (r < n) {
      for (int d = lane; d < DH; d += 32)
        sum += __bfloat162float(dobase[r * a.ldo.row + d]) *
               __bfloat162float(obase[r * a.lo.row + d]);
    }
    sum = tae::warp_sum(sum);
    if (lane == 0) {
      delta[r] = sum;
      lse[r] = r < n ? a.lse[(static_cast<long>(b) * a.heads + h) * n + r] : 0.f;
    }
  }
  __syncthreads();  // the only block-wide barrier

  WarpScratch& w = scratch[warp];

  // pass 1: dV and dK of 16 keys, summed over the query tiles
  for (int jt = warp; jt < tiles; jt += kWarps) {
    const int j0 = jt * 16;
    Acc dv[DH / 16], dk[DH / 16];
#pragma unroll
    for (int dt = 0; dt < DH / 16; ++dt) {
      wm::fill_fragment(dv[dt], 0.f);
      wm::fill_fragment(dk[dt], 0.f);
    }
    for (int it = 0; it < tiles; ++it) {
      const int i0 = it * 16;
      tile_p_ds<DH>(qs, ks, vs, dos, lse, delta, i0, j0, n, scale, w, lane);
      FragAT pt, dst;  // P^T and dS^T: the tiles read column-major
      wm::load_matrix_sync(pt, w.p, kBLd);
      wm::load_matrix_sync(dst, w.ds, kBLd);
#pragma unroll
      for (int dt = 0; dt < DH / 16; ++dt) {
        FragB bm;
        wm::load_matrix_sync(bm, dos + i0 * LD + dt * 16, LD);
        wm::mma_sync(dv[dt], pt, bm, dv[dt]);
        wm::load_matrix_sync(bm, qs + i0 * LD + dt * 16, LD);
        wm::mma_sync(dk[dt], dst, bm, dk[dt]);
      }
      __syncwarp();  // the tiles are consumed before the next ones land
    }
    const int rows = min(16, n - j0);
    write_tile<DH>(dk, a.dk + a.ldk.at(b, h) + j0 * a.ldk.row, a.ldk.row, rows, w, lane);
    write_tile<DH>(dv, a.dv + a.ldv.at(b, h) + j0 * a.ldv.row, a.ldv.row, rows, w, lane);
  }

  // pass 2: dQ of 16 query rows, summed over the key tiles
  for (int it = warp; it < tiles; it += kWarps) {
    const int i0 = it * 16;
    Acc dq[DH / 16];
#pragma unroll
    for (int dt = 0; dt < DH / 16; ++dt) wm::fill_fragment(dq[dt], 0.f);
    for (int jt = 0; jt < tiles; ++jt) {
      const int j0 = jt * 16;
      tile_p_ds<DH>(qs, ks, vs, dos, lse, delta, i0, j0, n, scale, w, lane);
      FragA dsa;
      wm::load_matrix_sync(dsa, w.ds, kBLd);
#pragma unroll
      for (int dt = 0; dt < DH / 16; ++dt) {
        FragB bm;
        wm::load_matrix_sync(bm, ks + j0 * LD + dt * 16, LD);
        wm::mma_sync(dq[dt], dsa, bm, dq[dt]);
      }
      __syncwarp();
    }
    write_tile<DH>(dq, a.dq + a.ldq.at(b, h) + i0 * a.ldq.row, a.ldq.row, min(16, n - i0), w,
                   lane);
  }
}

// ----------------------------------------------------------------- float32

constexpr int kKeysPerLane = kMaxN / 32;

template <int DH> __host__ __device__ constexpr int f32_ld() { return DH + 4; }
__host__ __device__ constexpr int pad4(int n) { return (n + 3) / 4 * 4; }

template <int DH>
size_t f32_smem_bytes(int n) {
  return sizeof(float) * (static_cast<size_t>(2 * n) * f32_ld<DH>() + 2 * pad4(n) +
                          kWarps * 2 * f32_ld<DH>() + kWarps * 2 * n);
}

template <int DH>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const float4* b4 = reinterpret_cast<const float4*>(b);
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < DH / 4; ++d) {
    const float4 x = a4[d], y = b4[d];
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
    acc = fmaf(x.z, y.z, acc);
    acc = fmaf(x.w, y.w, acc);
  }
  return acc;
}

// Stage the head's columns of `rows` rows of two row-major sources.
template <int DH>
__device__ __forceinline__ void stage2(float* as, float* bs, const float* a,
                                       long long a_stride, const float* b,
                                       long long b_stride, int rows) {
  constexpr int LD = f32_ld<DH>();
  for (int idx = threadIdx.x; idx < rows * DH; idx += blockDim.x) {
    const int r = idx / DH, col = idx - r * DH;
    as[r * LD + col] = a[r * a_stride + col];
    bs[r * LD + col] = b[r * b_stride + col];
  }
}

template <int DH>
__global__ void __launch_bounds__(kWarps * 32)
attention_bwd_f32(const BwdArgs<float> a) {
  const int n = a.n;
  const float scale = a.scale;
  constexpr int LD = f32_ld<DH>();
  constexpr int C2 = DH / 2;  // float2 output columns
  constexpr int C2_PER_LANE = (C2 + 31) / 32;
  extern __shared__ __align__(16) float smem[];
  float* as = smem;                      // (n, LD): K, then Q
  float* bs = as + n * LD;               // (n, LD): V, then dO
  float* lse = bs + n * LD;              // (pad4(n))
  float* delta = lse + pad4(n);          // (pad4(n))
  float* own = delta + pad4(n);          // warps x 2 x LD: the warp's own rows
  float* rowbuf = own + kWarps * 2 * LD;  // warps x 2 x n: p and dS of one row

  const int b = blockIdx.y, h = blockIdx.x;
  const float* qb = a.q + a.lq.at(b, h);
  const float* kb = a.k + a.lk.at(b, h);
  const float* vb = a.v + a.lv.at(b, h);
  const float* obase = a.o + a.lo.at(b, h);
  const float* dobase = a.dout + a.ldo.at(b, h);
  float* dqb = a.dq + a.ldq.at(b, h);
  float* dkb = a.dk + a.ldk.at(b, h);
  float* dvb = a.dv + a.ldv.at(b, h);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* own_a = own + warp * 2 * LD;
  float* own_b = own_a + LD;
  float* p_row = rowbuf + warp * 2 * n;
  float* ds_row = p_row + n;

  for (int r = warp; r < n; r += kWarps) {
    float sum = 0.f;
    for (int d = lane; d < DH; d += 32)
      sum += dobase[r * a.ldo.row + d] * obase[r * a.lo.row + d];
    sum = tae::warp_sum(sum);
    if (lane == 0) {
      delta[r] = sum;
      lse[r] = a.lse[(static_cast<long>(b) * a.heads + h) * n + r];
    }
  }
  stage2<DH>(as, bs, kb, a.lk.row, vb, a.lv.row, n);  // K, V
  __syncthreads();

  // dQ: a warp per query row i, a lane per key
  for (int i = warp; i < n; i += kWarps) {
    for (int d = lane; d < DH; d += 32) {
      own_a[d] = qb[i * a.lq.row + d];                      // q_i
      own_b[d] = dobase[i * a.ldo.row + d];                 // dO_i
    }
    __syncwarp();
    const float li = lse[i], di = delta[i];
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) {
      const int j = lane + 32 * t;
      if (j < n) {
        const float s = dot<DH>(own_a, as + j * LD) * scale;
        const float dp = dot<DH>(own_b, bs + j * LD);
        ds_row[j] = expf(s - li) * (dp - di) * scale;
      }
    }
    __syncwarp();
    float2 acc[C2_PER_LANE];
#pragma unroll
    for (int k = 0; k < C2_PER_LANE; ++k) acc[k] = make_float2(0.f, 0.f);
    const float2* k2 = reinterpret_cast<const float2*>(as);
    for (int j = 0; j < n; ++j) {
      const float ds = ds_row[j];
#pragma unroll
      for (int k = 0; k < C2_PER_LANE; ++k) {
        const int cc = lane + 32 * k;
        if (cc < C2) {
          const float2 kk = k2[j * (LD / 2) + cc];
          acc[k].x = fmaf(ds, kk.x, acc[k].x);
          acc[k].y = fmaf(ds, kk.y, acc[k].y);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < C2_PER_LANE; ++k) {
      const int cc = lane + 32 * k;
      if (cc < C2) tae::store2(dqb + i * a.ldq.row + 2 * cc, acc[k].x, acc[k].y);
    }
    __syncwarp();  // every lane is done with the row buffers
  }
  __syncthreads();  // K and V are consumed
  stage2<DH>(as, bs, qb, a.lq.row, dobase, a.ldo.row, n);  // Q, dO
  __syncthreads();

  // dK, dV: a warp per key j, a lane per query row
  for (int j = warp; j < n; j += kWarps) {
    for (int d = lane; d < DH; d += 32) {
      own_a[d] = kb[j * a.lk.row + d];  // k_j
      own_b[d] = vb[j * a.lv.row + d];  // v_j
    }
    __syncwarp();
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) {
      const int i = lane + 32 * t;
      if (i < n) {
        const float s = dot<DH>(as + i * LD, own_a) * scale;
        const float dp = dot<DH>(bs + i * LD, own_b);
        const float p = expf(s - lse[i]);
        p_row[i] = p;
        ds_row[i] = p * (dp - delta[i]) * scale;
      }
    }
    __syncwarp();
    float2 dk[C2_PER_LANE], dv[C2_PER_LANE];
#pragma unroll
    for (int k = 0; k < C2_PER_LANE; ++k) dk[k] = dv[k] = make_float2(0.f, 0.f);
    const float2* q2 = reinterpret_cast<const float2*>(as);
    const float2* do2 = reinterpret_cast<const float2*>(bs);
    for (int i = 0; i < n; ++i) {
      const float p = p_row[i], ds = ds_row[i];
#pragma unroll
      for (int k = 0; k < C2_PER_LANE; ++k) {
        const int cc = lane + 32 * k;
        if (cc < C2) {
          const float2 qq = q2[i * (LD / 2) + cc], dd = do2[i * (LD / 2) + cc];
          dk[k].x = fmaf(ds, qq.x, dk[k].x);
          dk[k].y = fmaf(ds, qq.y, dk[k].y);
          dv[k].x = fmaf(p, dd.x, dv[k].x);
          dv[k].y = fmaf(p, dd.y, dv[k].y);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < C2_PER_LANE; ++k) {
      const int cc = lane + 32 * k;
      if (cc < C2) {
        tae::store2(dkb + j * a.ldk.row + 2 * cc, dk[k].x, dk[k].y);
        tae::store2(dvb + j * a.ldv.row + 2 * cc, dv[k].x, dv[k].y);
      }
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------- launchers

// smem_allowed: the kernel's dynamic shared-memory limit as last raised (one
// per instantiation); cudaFuncSetAttribute runs only when a launch needs more.
template <typename T>
int launch(void (*kernel)(const BwdArgs<T>), size_t smem, size_t& smem_allowed,
           const BwdArgs<T>& args, int batch, cudaStream_t stream) {
  if (smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_allowed = smem;
  }
  const dim3 grid(args.heads, batch);
  kernel<<<grid, kWarps * 32, smem, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

// ptrs: q, k, v, o, do, dq, dk, dv; layouts in the same order.
template <typename T>
BwdArgs<T> make_args(const void* const (&ptrs)[8], const HeadLayout (&l)[8], const void* lse,
                     int n, int heads, float scale) {
  BwdArgs<T> a;
  a.q = static_cast<const T*>(ptrs[0]);
  a.k = static_cast<const T*>(ptrs[1]);
  a.v = static_cast<const T*>(ptrs[2]);
  a.o = static_cast<const T*>(ptrs[3]);
  a.dout = static_cast<const T*>(ptrs[4]);
  a.dq = static_cast<T*>(const_cast<void*>(ptrs[5]));
  a.dk = static_cast<T*>(const_cast<void*>(ptrs[6]));
  a.dv = static_cast<T*>(const_cast<void*>(ptrs[7]));
  a.lse = static_cast<const float*>(lse);
  a.lq = l[0]; a.lk = l[1]; a.lv = l[2]; a.lo = l[3];
  a.ldo = l[4]; a.ldq = l[5]; a.ldk = l[6]; a.ldv = l[7];
  a.n = n;
  a.heads = heads;
  a.scale = scale;
  return a;
}

template <int DH>
int launch_dtype(const void* const (&ptrs)[8], const HeadLayout (&l)[8], const void* lse,
                 int batch, int n, int heads, float scale, int dtype, cudaStream_t stream) {
  if (dtype == tae::kBFloat16) {
    static size_t smem_allowed = 0;
    return launch(attention_bwd_bf16<DH>, tc_smem_bytes<DH>(n), smem_allowed,
                  make_args<bf16>(ptrs, l, lse, n, heads, scale), batch, stream);
  }
  if (dtype == tae::kFloat32) {
    static size_t smem_allowed = 0;
    return launch(attention_bwd_f32<DH>, f32_smem_bytes<DH>(n), smem_allowed,
                  make_args<float>(ptrs, l, lse, n, heads, scale), batch, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int launch_dh(const void* const (&ptrs)[8], const HeadLayout (&l)[8], const void* lse,
              int batch, int n, int heads, int dh, float scale, int dtype, void* stream) {
  if (batch < 1 || batch > 65535 || heads < 1 || heads > 65535 || n < 1 || n > kMaxN ||
      lse == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh == 64) return launch_dtype<64>(ptrs, l, lse, batch, n, heads, scale, dtype, s);
  if (dh == 80) return launch_dtype<80>(ptrs, l, lse, batch, n, heads, scale, dtype, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// K10. qkv, dqkv: (batch, n, 3 * heads * dh) contiguous; o, dout: (batch, n,
// heads * dh); lse: (batch, heads, n) fp32.
extern "C" int tae_packed_attention_bwd(const void* qkv, const void* o, const void* lse,
                                        const void* dout, void* dqkv, int batch, int n,
                                        int heads, int dh, float scale, int dtype,
                                        void* stream) {
  const long long c = static_cast<long long>(heads) * dh;
  const size_t el = dtype == tae::kBFloat16 ? 2 : 4;
  const char* in = static_cast<const char*>(qkv);
  const char* d = static_cast<const char*>(dqkv);
  const void* const ptrs[8] = {in, in + c * el, in + 2 * c * el, o, dout,
                               d, d + c * el, d + 2 * c * el};
  const HeadLayout packed = {n * 3 * c, dh, 3 * c}, merged = {n * c, dh, c};
  const HeadLayout l[8] = {packed, packed, packed, merged, merged, packed, packed, packed};
  return launch_dh(ptrs, l, lse, batch, n, heads, dh, scale, dtype, stream);
}

// K17. q, k, v, o, dout, dq, dk, dv: (batch, heads, n, dh), operand i with
// the element strides strides[3 * i .. 3 * i + 2] = (image, head, row); the
// last axis contiguous, rows 16-byte aligned. lse: (batch, heads, n) fp32.
extern "C" int tae_flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* o, const void* lse, const void* dout,
                                       void* dq, void* dk, void* dv,
                                       const long long* strides, int batch, int n, int heads,
                                       int dh, float scale, int dtype, void* stream) {
  const void* const ptrs[8] = {q, k, v, o, dout, dq, dk, dv};
  HeadLayout l[8];
  for (int i = 0; i < 8; ++i) l[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  return launch_dh(ptrs, l, lse, batch, n, heads, dh, scale, dtype, stream);
}
