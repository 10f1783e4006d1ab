// K13 int4_mlp — the fused w4a8 MLP of the int4 serving block.
//
// Replaces: tae_tpu/ops/pallas/int4_block.py::int4_mlp (_mlp4_kernel).
//   out = residual + fc2(gelu_tanh(fc1(xq))) in one kernel, both weights in
//   the packed int4 layout with group-wise scales (int4_common.cuh). Per
//   hidden block of 256 columns: fc1 by scale groups (h += float(ig_g) *
//   s1_g), h * sx + b1, tanh-GELU in fp32, one scale per (row, hidden
//   block) max(amax / 127, 1e-12) and the codes round(h * (1 / sh)), fc2 by
//   groups (part += float(ig_g) * s2_g), acc += part * sh; the epilogue adds
//   b2 and the residual. The (M, 4D) hidden activation never reaches device
//   memory; the hidden block is part of the numerics.
// What bounds it on the H100: device-memory bytes of the two packed weights
//   at the few rows int4 serving is for (26 MB at D = 2560), tensor-core
//   operations (4 * M * D * H) at M = 16384.
// What the design does about it: a block owns 16 rows (one m16 tile) and
//   their full D-wide fp32 accumulator in shared memory, 8 warps side by
//   side over the columns. fc1 of a hidden block is one w4_gemm over K = D
//   whose 16 x 256 fp32 result stays in the block's registers: the row
//   maxima are reduced through shuffles and 512 bytes of shared memory, the
//   codes go to a 16 x 256 int8 tile, and fc2 runs from that tile (A in
//   shared memory, K = 256) in chunks of 256 output columns. Few rows make
//   few blocks (M = 4 is one), so the launcher splits the hidden blocks over
//   grid.y: each block then writes its raw fp32 accumulator to a
//   (groups, M, D) workspace and int4_mlp_finish_kernel adds the groups in
//   order and runs the epilogue. Every block streams both weights from L2;
//   the fc2 chunks restart the operand ring ten times per hidden block at
//   D = 2560, which a ring kept running across chunks would avoid (later
//   work).
#include "int4_common.cuh"

namespace {

using namespace tae;
using namespace tae::i8;
using namespace tae::i4;

constexpr int kNT = 256;          // threads: 8 warps side by side over the columns
constexpr int kBM = 16;           // rows of a block
constexpr int kBH = 256;          // hidden columns per activation scale; fc2's column chunk
constexpr int kWarps = kNT / 32;

struct Mlp4Args {
  const int8_t* xq;       // (m, d)
  const float* sx;        // (m,)
  const uint8_t* w1;      // (hdim, d / 2)
  const float* s1;        // (d / g1, hdim)
  const void* b1;         // (hdim,) of p_dtype
  const uint8_t* w2;      // (d, hdim / 2)
  const float* s2;        // (hdim / g2, d)
  const void* b2;         // (d,) of p_dtype
  const void* residual;   // (m, d) of out_dtype
  void* out;              // (m, d) of out_dtype
  int m, d, hdim, g1, g2;
  int out_dtype, p_dtype;
  float* part;            // (groups, m, d) fp32 partial accumulators, or null
  int groups;
};

// Shared memory: the fp32 accumulator, the hidden codes, the per-warp row
// maxima, the operand ring (fc1's form, the larger one).
__host__ __device__ constexpr int mlp4_ld_acc(int d) { return d + 8; }
constexpr int kLdQ = kBH + 16;
__host__ __device__ constexpr int mlp4_smem(int d) {
  return kBM * mlp4_ld_acc(d) * 4 + kBM * kLdQ + kWarps * kBM * 4 +
         w4_ring_bytes(kBM, kBH, false);
}

__global__ void __launch_bounds__(kNT) int4_mlp_kernel(const Mlp4Args p) {
  extern __shared__ __align__(128) unsigned char smem[];
  using T = W4Tile<kNT, kBM, kBH, 1>;
  static_assert(T::kMI == 1, "one m16 tile of rows");
  const int lda = mlp4_ld_acc(p.d);
  float* acc = reinterpret_cast<float*>(smem);
  int8_t* hq = reinterpret_cast<int8_t*>(acc + kBM * lda);
  float* wmax = reinterpret_cast<float*>(hq + kBM * kLdQ);
  unsigned char* ring = reinterpret_cast<unsigned char*>(wmax + kWarps * kBM);

  const int row0 = blockIdx.x * kBM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r_lo = T::row(0, 0), r_hi = T::row(0, 2);   // this thread's two rows
  // rows past m hold zero codes; scale 1 keeps them finite
  const float sx_lo = row0 + r_lo < p.m ? p.sx[row0 + r_lo] : 1.0f;
  const float sx_hi = row0 + r_hi < p.m ? p.sx[row0 + r_hi] : 1.0f;

  for (int i = threadIdx.x; i < kBM * lda; i += kNT) acc[i] = 0.f;

  const int hgroup = p.hdim / p.groups;
  const int h_begin = blockIdx.y * hgroup;
  for (int h0 = h_begin; h0 < h_begin + hgroup; h0 += kBH) {
    // fc1: h = gelu((sum_g float(xq_g . w1_g^T) * s1_g) * sx + b1)
    float h[1][T::kNI][4];
#pragma unroll
    for (int ni = 0; ni < T::kNI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) h[0][ni][e] = 0.f;
    w4_gemm<kNT, kBM, kBH, 1, false>(
        p.xq + static_cast<long>(row0) * p.d, p.d, p.m - row0,
        p.w1 + static_cast<long>(h0) * (p.d / 2), p.d / 2, kBH, p.s1 + h0, p.hdim,
        p.d / p.g1, p.g1, ring, h);

    float amax_lo = 0.f, amax_hi = 0.f;
#pragma unroll
    for (int ni = 0; ni < T::kNI; ++ni) {
      const float2 b = load2(p.b1, h0 + T::col(ni, 0), p.p_dtype);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = gelu_tanh(__fadd_rn(__fmul_rn(h[0][ni][e], e < 2 ? sx_lo : sx_hi),
                                            e % 2 ? b.y : b.x));
        h[0][ni][e] = v;
        if (e < 2) amax_lo = fmaxf(amax_lo, fabsf(v));
        else amax_hi = fmaxf(amax_hi, fabsf(v));
      }
    }
    // one scale per (row, hidden block): the four lanes of a row, then the
    // eight warps through shared memory
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      amax_lo = fmaxf(amax_lo, __shfl_xor_sync(0xffffffffu, amax_lo, o));
      amax_hi = fmaxf(amax_hi, __shfl_xor_sync(0xffffffffu, amax_hi, o));
    }
    if (lane % 4 == 0) {
      wmax[warp * kBM + r_lo] = amax_lo;
      wmax[warp * kBM + r_hi] = amax_hi;
    }
    __syncthreads();
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) {
      amax_lo = fmaxf(amax_lo, wmax[wi * kBM + r_lo]);
      amax_hi = fmaxf(amax_hi, wmax[wi * kBM + r_hi]);
    }
    const float sh_lo = quant_scale(amax_lo), sh_hi = quant_scale(amax_hi);
    const float inv_lo = 1.0f / sh_lo, inv_hi = 1.0f / sh_hi;
#pragma unroll
    for (int ni = 0; ni < T::kNI; ++ni) {
      const int col = T::col(ni, 0);
      char2 q;
      q.x = static_cast<signed char>(quantize1(h[0][ni][0], inv_lo));
      q.y = static_cast<signed char>(quantize1(h[0][ni][1], inv_lo));
      *reinterpret_cast<char2*>(hq + r_lo * kLdQ + col) = q;
      q.x = static_cast<signed char>(quantize1(h[0][ni][2], inv_hi));
      q.y = static_cast<signed char>(quantize1(h[0][ni][3], inv_hi));
      *reinterpret_cast<char2*>(hq + r_hi * kLdQ + col) = q;
    }
    __syncthreads();   // the codes are whole; wmax may be rewritten

    // fc2 partial: acc += (sum_g float(hq_g . w2_g^T) * s2_g) * sh
    for (int n0 = 0; n0 < p.d; n0 += kBH) {
      float part[1][T::kNI][4];
#pragma unroll
      for (int ni = 0; ni < T::kNI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[0][ni][e] = 0.f;
      w4_gemm<kNT, kBM, kBH, 1, true>(
          hq, kLdQ, kBM, p.w2 + static_cast<long>(n0) * (p.hdim / 2) + h0 / 2, p.hdim / 2,
          p.d - n0, p.s2 + static_cast<long>(h0 / p.g2) * p.d + n0, p.d, kBH / p.g2, p.g2, ring,
          part);
#pragma unroll
      for (int ni = 0; ni < T::kNI; ++ni) {
        const int col = n0 + T::col(ni, 0);
        if (col >= p.d) continue;
        float2* lo = reinterpret_cast<float2*>(acc + r_lo * lda + col);
        float2* hi = reinterpret_cast<float2*>(acc + r_hi * lda + col);
        float2 a = *lo;
        a.x = __fadd_rn(a.x, __fmul_rn(part[0][ni][0], sh_lo));
        a.y = __fadd_rn(a.y, __fmul_rn(part[0][ni][1], sh_lo));
        *lo = a;
        a = *hi;
        a.x = __fadd_rn(a.x, __fmul_rn(part[0][ni][2], sh_hi));
        a.y = __fadd_rn(a.y, __fmul_rn(part[0][ni][3], sh_hi));
        *hi = a;
      }
    }
    // the next hidden block's first barrier (inside w4_gemm) orders these
    // reads of hq before its codes are rewritten
  }
  __syncthreads();

  // rows x 8-column vectors, for the block's threads
  const int vecs = p.d / 8;
  if (p.groups > 1) {
    // this group's share of the sum; the finish kernel does the rest
    float* part = p.part + static_cast<long>(blockIdx.y) * p.m * p.d;
    for (int i = threadIdx.x; i < kBM * vecs; i += kNT) {
      const int r = i / vecs, col = (i % vecs) * 8;
      const long row = row0 + r;
      if (row >= p.m) break;
      float a[8];
      load_vec(acc + r * lda + col, a);
      load_vec(acc + r * lda + col + 4, a + 4);
      store_vec(part + row * p.d + col, a);
      store_vec(part + row * p.d + col + 4, a + 4);
    }
    return;
  }
  for (int i = threadIdx.x; i < kBM * vecs; i += kNT) {
    const int r = i / vecs, col = (i % vecs) * 8;
    const long row = row0 + r;
    if (row >= p.m) break;
    float y[8], b[8], res[8];
    load_vec(acc + r * lda + col, y);
    load_vec(acc + r * lda + col + 4, y + 4);
    load8(p.b2, col, p.p_dtype, b);
    load8(p.residual, row * p.d + col, p.out_dtype, res);
#pragma unroll
    for (int j = 0; j < 8; ++j) y[j] = __fadd_rn(__fadd_rn(y[j], b[j]), res[j]);
    store8(p.out, row * p.d + col, p.out_dtype, y);
  }
}

// The epilogue of a launch split into hidden groups, a thread per 8 columns
// of a row: the groups' partial sums added in group order, then + b2 +
// residual and the cast.
__global__ void __launch_bounds__(256) int4_mlp_finish_kernel(const Mlp4Args p) {
  const int vecs = p.d / 8;
  const long i = static_cast<long>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= static_cast<long>(p.m) * vecs) return;
  const long row = i / vecs;
  const int col = static_cast<int>(i % vecs) * 8;
  const long gstride = static_cast<long>(p.m) * p.d;
  const float* y0 = p.part + row * p.d + col;
  float y[8], t[8], b[8], res[8];
  load_vec(y0, y);
  load_vec(y0 + 4, y + 4);
  for (int g = 1; g < p.groups; ++g) {
    load_vec(y0 + g * gstride, t);
    load_vec(y0 + g * gstride + 4, t + 4);
#pragma unroll
    for (int j = 0; j < 8; ++j) y[j] = __fadd_rn(y[j], t[j]);
  }
  load8(p.b2, col, p.p_dtype, b);
  load8(p.residual, row * p.d + col, p.out_dtype, res);
#pragma unroll
  for (int j = 0; j < 8; ++j) y[j] = __fadd_rn(__fadd_rn(y[j], b[j]), res[j]);
  store8(p.out, row * p.d + col, p.out_dtype, y);
}

bool bad_dtype(int d) { return d != kFloat32 && d != kBFloat16; }

}  // namespace

// xq (m, d) int8, sx (m,) f32, w1 (hdim, d / 2) and w2 (d, hdim / 2) packed
// uint8, s1 (d / g1, hdim) and s2 (hdim / g2, d) f32, b1 (hdim,) and b2 (d,)
// of p_dtype, residual and out (m, d) of out_dtype. The hidden block is 256:
// hdim a multiple of it, g2 a multiple of 64 dividing it, g1 a multiple of
// 64 dividing d, d a multiple of 8 that fits a block's shared memory. groups
// splits the hidden blocks evenly over grid.y; with groups > 1, part is a
// (groups, m, d) f32 workspace. All contiguous and 16-byte aligned.
extern "C" int tae_int4_mlp_fwd(const void* xq, const void* sx, const void* w1, const void* s1,
                                const void* b1, const void* w2, const void* s2, const void* b2,
                                const void* residual, void* out, int m, int d, int hdim, int g1,
                                int g2, int out_dtype, int p_dtype, void* part, int groups,
                                void* stream) {
  if (m < 1 || d < 64 || d % 8 != 0 || hdim < kBH || hdim % kBH != 0 || g1 < 64 ||
      g1 % 64 != 0 || d % g1 != 0 || g2 < 64 || g2 % 64 != 0 || kBH % g2 != 0 || groups < 1 ||
      groups > 65535 || (hdim / kBH) % groups != 0 || (groups > 1 && part == nullptr) ||
      bad_dtype(out_dtype) || bad_dtype(p_dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Mlp4Args p;
  p.xq = static_cast<const int8_t*>(xq);
  p.sx = static_cast<const float*>(sx);
  p.w1 = static_cast<const uint8_t*>(w1);
  p.s1 = static_cast<const float*>(s1);
  p.b1 = b1;
  p.w2 = static_cast<const uint8_t*>(w2);
  p.s2 = static_cast<const float*>(s2);
  p.b2 = b2;
  p.residual = residual;
  p.out = out;
  p.m = m; p.d = d; p.hdim = hdim; p.g1 = g1; p.g2 = g2;
  p.out_dtype = out_dtype;
  p.p_dtype = p_dtype;
  p.part = static_cast<float*>(part);
  p.groups = groups;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  const int smem = mlp4_smem(d);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t rc = cudaFuncSetAttribute(int4_mlp_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid((m + kBM - 1) / kBM, groups);
  int4_mlp_kernel<<<grid, kNT, smem, s>>>(p);
  if (groups > 1) {
    const long threads = static_cast<long>(m) * (d / 8);
    int4_mlp_finish_kernel<<<static_cast<unsigned>((threads + 255) / 256), 256, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
