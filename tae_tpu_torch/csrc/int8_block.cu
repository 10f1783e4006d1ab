// K3 ln_quant and K5 int8_mlp — the fused kernels of the int8 serving block.
//
// K3 replaces: tae_tpu/ops/pallas/int8_block.py::ln_quant (_ln_quant_kernel).
//   LayerNorm with fp32 statistics, then per-row symmetric int8:
//   s = max(max|y| / 127, 1e-12), q = clip(round(y * (1 / s)), -127, 127).
//   x (M, D) float32 / bfloat16 -> (M, D) int8 + (M,) float32.
//   Bound on the H100 by device-memory bytes (one read of x, half as many
//   bytes written). One warp per row, 16-byte loads, 8-byte code stores,
//   shuffle reductions; the four passes over a row (sum, centred squares,
//   max|y|, quantize) re-read it from L1, so device memory sees one read.
//
// K5 replaces: tae_tpu/ops/pallas/int8_block.py::int8_mlp (_mlp_kernel).
//   out = residual + fc2(gelu_tanh(fc1(xq))) in one kernel; the hidden
//   activation is requantized per (row, hidden block of block_h columns)
//   and the fc2 partial products are summed in fp32 with that block's
//   scale, so block_h is part of the numerics. Optional ln_next epilogue:
//   LayerNorm + int8 quantize of the fp32 output row.
//   Bound on the H100 by tensor-core operations (4 * M * D * H of them);
//   the (M, H) hidden activation never reaches device memory.
//   Design: a block owns 32 rows (16 when those do not fit) and the full
//   D-wide fp32 accumulator in shared memory. It walks the hidden dim in
//   blocks of block_h: fc1 tiles (gemm_tile over K = D, 256 or 128
//   columns wide) land in a (rows x block_h) buffer, are dequantized,
//   biased and GELU'd in place, then each row's amax over the block gives
//   the scale and the int8 codes; fc2 tiles (A from those codes in shared
//   memory, K = block_h) are added into the accumulator as float(int32) *
//   scale. The epilogue is acc * sw2 + b2 + residual, the cast, and
//   optionally ln_quant_row on the fp32 rows. When block_h is no wider
//   than a tile the hidden buffer and the fc2 result tiles lie over the
//   operand ring. Every block re-streams both weight matrices from L2;
//   larger row tiles and weight sharing across a cluster are later work.
//   Few rows make few blocks (M = 256 is 8 of them on 132 SMs), so the
//   launcher can split the hidden dim into groups (grid.y): each block then
//   walks only its group's hidden blocks and writes its raw fp32
//   accumulator to a (groups, M, D) workspace, and int8_mlp_finish_kernel
//   sums the groups in order and runs the epilogue, one warp per row.
#include "int8_common.cuh"

namespace {

using namespace tae;
using namespace tae::i8;

// ------------------------------------------------------------------- K3

constexpr int kLnWarps = 4;

__global__ void __launch_bounds__(kLnWarps * 32)
ln_quant_kernel(const void* __restrict__ x, int x_dtype, const void* __restrict__ gamma,
                const void* __restrict__ beta, int w_dtype, int8_t* __restrict__ q,
                float* __restrict__ s, int rows, int cols, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long row = static_cast<long>(blockIdx.x) * kLnWarps + warp;
  if (row >= rows) return;
  const long base = row * cols;
  auto load = [=](int i, float* v) { load8(x, base + i, x_dtype, v); };
  ln_quant_row(load, cols, gamma, beta, w_dtype, eps, q + base, s + row, lane);
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
  // hidden groups; part == null with groups == 1
  float* part;            // (groups, m, d) fp32 partial accumulators
  int groups;
};

// Shared memory of a block of BM rows working in BN-column tiles: the fp32
// accumulator, the hidden codes, the per-row hidden scales, then the
// operand ring. The fp32 hidden buffer (also the fc2 result tile) lies over
// the ring when block_h <= BN and after it otherwise.
__host__ __device__ constexpr int mlp_ld_acc(int d) { return d + 4; }
__host__ __device__ constexpr int mlp_ld_h(int bn, int bh) {
  return (bh + bn - 1) / bn * bn + 4;   // whole tiles
}
__host__ __device__ constexpr int mlp_ld_hq(int bh) { return bh + 16; }
__host__ __device__ constexpr int mlp_smem(int bm, int bn, int d, int bh) {
  const int fixed = bm * mlp_ld_acc(d) * 4 + bm * mlp_ld_hq(bh) + bm * 4;
  const int hbytes = bm * mlp_ld_h(bn, bh) * 4;
  return fixed + (bh <= bn ? max_int(ring_bytes(bm, bn), hbytes)
                           : ring_bytes(bm, bn) + hbytes);
}

template <int NT, int BM, int BN>
__global__ void __launch_bounds__(NT) int8_mlp_kernel(const MlpArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int bh = p.block_h;
  const int lda = mlp_ld_acc(p.d), ldh = mlp_ld_h(BN, bh), ldq = mlp_ld_hq(bh);
  float* acc = reinterpret_cast<float*>(smem);
  int8_t* hq = reinterpret_cast<int8_t*>(acc + BM * lda);
  float* sh = reinterpret_cast<float*>(hq + BM * ldq);
  int8_t* ring = reinterpret_cast<int8_t*>(sh + BM);
  // fc1 tile, then the fc2 result tiles
  float* hbuf = reinterpret_cast<float*>(bh <= BN ? ring : ring + ring_bytes(BM, BN));

  const int row0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tc = tile_col<BN>();

  for (int i = threadIdx.x; i < BM * lda; i += NT) acc[i] = 0.f;

  const int hgroup = p.hdim / p.groups;
  const int h_begin = blockIdx.y * hgroup;
  for (int h0 = h_begin; h0 < h_begin + hgroup; h0 += bh) {
    // fc1: h = gelu(float(xq . w1^T) * sx * sw1 + b1) for this hidden block
    for (int c0 = 0; c0 < bh; c0 += BN) {
      gemm_tile<NT, BM, BN, BM / 16, false>(p.xq + static_cast<long>(row0) * p.d, p.d, p.m - row0,
                                  p.w1 + static_cast<long>(h0 + c0) * p.d, p.d, bh - c0,
                                  p.d, ring, reinterpret_cast<int*>(hbuf) + c0, ldh);
      __syncthreads();
      if (c0 + tc < bh) {
        float sw[8], b[8];
        load_vec(p.sw1 + h0 + c0 + tc, sw);
        load_vec(p.sw1 + h0 + c0 + tc + 4, sw + 4);
        load8(p.b1, h0 + c0 + tc, p.p_dtype, b);
        for (int r = tile_row0<BN>(); r < BM; r += tile_rows<NT, BN>()) {
          // rows past m hold zero codes; scale 1 keeps them finite
          const float sxr = row0 + r < p.m ? p.sx[row0 + r] : 1.0f;
          float* hp = hbuf + r * ldh + c0 + tc;   // holds the int32 product's bits
          float h[8];
          load_vec(hp, h);
          load_vec(hp + 4, h + 4);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float ig = __int2float_rn(__float_as_int(h[j]));
            h[j] = gelu_tanh(__fadd_rn(__fmul_rn(__fmul_rn(ig, sxr), sw[j]), b[j]));
          }
          store_vec(hp, h);
          store_vec(hp + 4, h + 4);
        }
      }
      // with more chunks to come the hidden buffer is not over the ring
    }
    __syncthreads();

    // one scale per (row, hidden block), then the int8 codes
    for (int r = warp; r < BM; r += NT / 32) {
      const float* hr = hbuf + r * ldh;
      float v[8];
      float amax = 0.f;
      for (int i = lane * 8; i < bh; i += 256) {
        load_vec(hr + i, v);
        load_vec(hr + i + 4, v + 4);
#pragma unroll
        for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(v[j]));
      }
      const float s = quant_scale(warp_max(amax));
      const float inv = 1.0f / s;
      for (int i = lane * 8; i < bh; i += 256) {
        load_vec(hr + i, v);
        load_vec(hr + i + 4, v + 4);
        *reinterpret_cast<uint2*>(hq + r * ldq + i) = quantize8(v, inv);
      }
      if (lane == 0) sh[r] = s;
    }
    __syncthreads();

    // fc2 partial: acc += float(hq . w2[:, h0:h0+bh]^T) * sh
    int* tile = reinterpret_cast<int*>(hbuf);
    constexpr int ldt = tile_ld(BN);
    for (int n0 = 0; n0 < p.d; n0 += BN) {
      gemm_tile<NT, BM, BN, BM / 16, true>(hq, ldq, BM, p.w2 + static_cast<long>(n0) * p.hdim + h0,
                                 p.hdim, p.d - n0, bh, ring, tile, ldt);
      __syncthreads();
      if (n0 + tc < p.d) {
        for (int r = tile_row0<BN>(); r < BM; r += tile_rows<NT, BN>()) {
          const float s = sh[r];
          float* ap = acc + r * lda + n0 + tc;
          float ig[8], a[8];
          load8_i32(tile + r * ldt + tc, ig);
          load_vec(ap, a);
          load_vec(ap + 4, a + 4);
#pragma unroll
          for (int j = 0; j < 8; ++j) a[j] = __fadd_rn(a[j], __fmul_rn(ig[j], s));
          store_vec(ap, a);
          store_vec(ap + 4, a + 4);
        }
      }
      __syncthreads();   // the tile may lie over the ring the next call refills
    }
  }

  if (p.groups > 1) {
    // this group's share of the sum; the finish kernel does the rest
    float* part = p.part + static_cast<long>(blockIdx.y) * p.m * p.d;
    for (int n0 = 0; n0 < p.d; n0 += BN) {
      const int col = n0 + tc;
      if (col >= p.d) break;
      for (int r = tile_row0<BN>(); r < BM; r += tile_rows<NT, BN>()) {
        const long row = row0 + r;
        if (row >= p.m) break;
        float a[8];
        load_vec(acc + r * lda + col, a);
        load_vec(acc + r * lda + col + 4, a + 4);
        store_vec(part + row * p.d + col, a);
        store_vec(part + row * p.d + col + 4, a + 4);
      }
    }
    return;
  }

  // y = acc * sw2 + b2 + residual; kept in acc for ln_next
  for (int n0 = 0; n0 < p.d; n0 += BN) {
    const int col = n0 + tc;
    if (col >= p.d) break;
    float sw[8], b[8], res[8];
    load_vec(p.sw2 + col, sw);
    load_vec(p.sw2 + col + 4, sw + 4);
    load8(p.b2, col, p.p_dtype, b);
    for (int r = tile_row0<BN>(); r < BM; r += tile_rows<NT, BN>()) {
      const long row = row0 + r;
      if (row >= p.m) break;
      float* ap = acc + r * lda + col;
      load8(p.residual, row * p.d + col, p.out_dtype, res);
      float y[8];
      load_vec(ap, y);
      load_vec(ap + 4, y + 4);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        y[j] = __fadd_rn(__fadd_rn(__fmul_rn(y[j], sw[j]), b[j]), res[j]);
      }
      store_vec(ap, y);
      store_vec(ap + 4, y + 4);
      store8(p.out, row * p.d + col, p.out_dtype, y);
    }
  }
  if (p.gamma == nullptr) return;
  __syncthreads();
  for (int r = warp; r < BM; r += NT / 32) {
    const long row = row0 + r;
    if (row >= p.m) break;
    ln_quant_row(RowF32{acc + r * lda}, p.d, p.gamma, p.beta, p.ln_dtype, p.eps,
                 p.nq + row * p.d, p.ns + row, lane);
  }
}

// The epilogue of a launch split into hidden groups, one warp per row: the
// groups' partial sums added in group order, then acc * sw2 + b2 + residual,
// the cast, and ln_next on the fp32 row (kept in group 0's workspace row,
// each lane re-reading only what it wrote).
__global__ void __launch_bounds__(kLnWarps * 32) int8_mlp_finish_kernel(const MlpArgs p) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long row = static_cast<long>(blockIdx.x) * kLnWarps + warp;
  if (row >= p.m) return;
  float* y0 = p.part + row * p.d;
  const long gstride = static_cast<long>(p.m) * p.d;
  for (int i = lane * 8; i < p.d; i += 256) {
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
      store_vec(y0 + i, y);
      store_vec(y0 + i + 4, y + 4);
    }
  }
  if (p.gamma == nullptr) return;
  __syncwarp();
  ln_quant_row(RowF32{y0}, p.d, p.gamma, p.beta, p.ln_dtype, p.eps, p.nq + row * p.d,
               p.ns + row, lane);
}

template <int NT, int BM, int BN>
int launch_mlp(const MlpArgs& p, cudaStream_t stream) {
  const int smem = mlp_smem(BM, BN, p.d, p.block_h);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t rc = cudaFuncSetAttribute(int8_mlp_kernel<NT, BM, BN>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid((p.m + BM - 1) / BM, p.groups);
  int8_mlp_kernel<NT, BM, BN><<<grid, NT, smem, stream>>>(p);
  if (p.groups > 1) {
    int8_mlp_finish_kernel<<<(p.m + kLnWarps - 1) / kLnWarps, kLnWarps * 32, 0, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

bool bad_dtype(int d) { return d != kFloat32 && d != kBFloat16; }

}  // namespace

// x (rows, cols) of x_dtype, gamma / beta (cols,) of w_dtype -> q (rows, cols)
// int8, s (rows,) f32. cols a multiple of 8; all contiguous, 16-byte aligned.
extern "C" int tae_ln_quant_fwd(const void* x, const void* gamma, const void* beta, void* q,
                                void* s, int rows, int cols, float eps, int x_dtype,
                                int w_dtype, void* stream) {
  if (rows < 1 || cols < 8 || cols % 8 != 0 || bad_dtype(x_dtype) || bad_dtype(w_dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (rows + kLnWarps - 1) / kLnWarps;
  ln_quant_kernel<<<blocks, kLnWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      x, x_dtype, gamma, beta, w_dtype, static_cast<int8_t*>(q), static_cast<float*>(s), rows,
      cols, eps);
  return static_cast<int>(cudaGetLastError());
}

// xq (m, d) int8, sx (m,) f32, w1 (hdim, d) int8, sw1 (hdim,) f32, b1 (hdim,),
// w2 (d, hdim) int8, sw2 (d,) f32, b2 (d,), residual and out (m, d) of
// out_dtype; b1, b2 of p_dtype. block_rows is 32 (256-column tiles) or 16
// (128-column tiles); block_h a multiple
// of 128 that divides hdim; d a multiple of 16. gamma = null: no ln_next;
// otherwise gamma, beta (d,) of ln_dtype and outputs nq (m, d) int8,
// ns (m,) f32. groups splits the hidden blocks evenly over grid.y; with
// groups > 1, part is a (groups, m, d) f32 workspace. All contiguous and
// 16-byte aligned.
extern "C" int tae_int8_mlp_fwd(const void* xq, const void* sx, const void* w1,
                                const void* sw1, const void* b1, const void* w2,
                                const void* sw2, const void* b2, const void* residual,
                                void* out, int m, int d, int hdim, int block_h,
                                int block_rows, int out_dtype, int p_dtype,
                                const void* gamma, const void* beta, int ln_dtype, float eps,
                                void* nq, void* ns, void* part, int groups,
                                void* stream) {
  if (m < 1 || d < 16 || d % 16 != 0 || block_h < 128 || block_h % 128 != 0 ||
      hdim % block_h != 0 || hdim < block_h || groups < 1 || groups > 65535 ||
      (hdim / block_h) % groups != 0 || (groups > 1 && part == nullptr) ||
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
  p.part = static_cast<float*>(part);
  p.groups = groups;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block_rows == 32) return launch_mlp<512, 32, 256>(p, s);
  if (block_rows == 16) return launch_mlp<256, 16, 128>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
