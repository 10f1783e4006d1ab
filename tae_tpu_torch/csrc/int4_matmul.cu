// K12 — w4a8 matrix product: int8 rows against a packed int4 weight with
// group-wise scales, fused dequantize epilogue.
//
// Replaces: tae_tpu/ops/pallas/int4_matmul.py::int4_matmul_fused (body
//   _kernel, decode _unpack), for prequantized input: x (M, K) int8 with one
//   fp32 scale per row, w4 (N, K/2) packed bytes (the port's "k32-twos"
//   layout, int4_common.cuh), w_scale (K/G, N) fp32. Per scale group one
//   int8 x int8 -> int32 product, acc += float(ig_g) * s_g[col] in fp32 in
//   ascending K order; the epilogue computes y = acc * sx (+ bias)
//   (+ residual) and casts once. A float x is quantized per row by the
//   caller in plain PyTorch, as the JAX wrapper does in an XLA pass.
// What bounds it on the H100: device-memory bytes of the packed weight at
//   the few rows int4 serving is for (M = 4 .. 256 at K = 2560: the weight
//   is 3.3 to 9.8 MB, the activations kilobytes); tensor-core operations at
//   M = 16384.
// What the design does about it: the weight streams through the cp.async
//   ring still packed (half the bytes of an int8 tile in shared memory too)
//   and is decoded in registers, three integer operations per eight codes
//   (int4_common.cuh); the fp32 tile lives in registers across the groups.
//   No epilogue needs a full output row, so N is cut freely: 128 x 128
//   tiles where those alone fill the card, else 32 x 64 tiles (M = 256 at
//   N = 7680 is 960 blocks; M = 4 is 120, each streaming 1/120 of the
//   weight once). Ragged M and N edges are zero-filled on load and masked
//   on store; N must be a multiple of 8, G of 64.
#include "int4_common.cuh"

namespace {

using namespace tae;
using namespace tae::i4;

struct W4MatmulArgs {
  const int8_t* x;        // (m, k)
  const float* sx;        // (m,)
  const uint8_t* w;       // (n, k / 2)
  const float* scale;     // (k / group, n)
  const void* bias;       // (n,) of bias_dtype, or null
  const void* residual;   // (m, n) of out_dtype, or null
  void* out;              // (m, n) of out_dtype
  int m, n, k, group;
  int out_dtype, bias_dtype;
};

template <int NT, int BM, int BN, int WARPS_M>
__global__ void __launch_bounds__(NT) int4_matmul_kernel(const W4MatmulArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  using T = W4Tile<NT, BM, BN, WARPS_M>;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  float accf[T::kMI][T::kNI][4];
#pragma unroll
  for (int mi = 0; mi < T::kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < T::kNI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) accf[mi][ni][e] = 0.f;

  w4_gemm<NT, BM, BN, WARPS_M, false>(
      p.x + static_cast<long>(row0) * p.k, p.k, p.m - row0,
      p.w + static_cast<long>(col0) * (p.k / 2), p.k / 2, p.n - col0, p.scale + col0, p.n,
      p.k / p.group, p.group, smem, accf);

#pragma unroll
  for (int ni = 0; ni < T::kNI; ++ni) {
    const int col = col0 + T::col(ni, 0);
    if (col >= p.n) continue;
    float2 b = make_float2(0.f, 0.f);
    if (p.bias != nullptr) b = load2(p.bias, col, p.bias_dtype);
#pragma unroll
    for (int mi = 0; mi < T::kMI; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long row = row0 + T::row(mi, 2 * half);
        if (row >= p.m) continue;
        const float sxr = p.sx[row];
        float y0 = __fmul_rn(accf[mi][ni][2 * half], sxr);
        float y1 = __fmul_rn(accf[mi][ni][2 * half + 1], sxr);
        if (p.bias != nullptr) {
          y0 = __fadd_rn(y0, b.x);
          y1 = __fadd_rn(y1, b.y);
        }
        if (p.residual != nullptr) {
          const float2 r = load2(p.residual, row * p.n + col, p.out_dtype);
          y0 = __fadd_rn(y0, r.x);
          y1 = __fadd_rn(y1, r.y);
        }
        store2_as(p.out, row * p.n + col, p.out_dtype, y0, y1);
      }
  }
}

template <int NT, int BM, int BN, int WARPS_M>
int launch(const W4MatmulArgs& p, cudaStream_t stream) {
  constexpr int smem = w4_ring_bytes(BM, BN, false);
  const long tiles_m = (static_cast<long>(p.m) + BM - 1) / BM;
  if (tiles_m > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t rc = cudaFuncSetAttribute(int4_matmul_kernel<NT, BM, BN, WARPS_M>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid((p.n + BN - 1) / BN, static_cast<unsigned>(tiles_m));
  int4_matmul_kernel<NT, BM, BN, WARPS_M><<<grid, NT, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

bool bad_dtype(int d) { return d != kFloat32 && d != kBFloat16; }

}  // namespace

// x (m, k) int8, sx (m,) f32, w (n, k / 2) packed uint8, scale (k / group, n)
// f32, bias (n,) or null, residual (m, n) or null, out (m, n); all contiguous
// and 16-byte aligned. small = 1 selects 32 x 64 output tiles, 0 the
// 128 x 128 ones.
extern "C" int tae_int4_matmul_fwd(const void* x, const void* sx, const void* w,
                                   const void* scale, const void* bias, const void* residual,
                                   void* out, int m, int n, int k, int group, int out_dtype,
                                   int bias_dtype, int small, void* stream) {
  if (m < 1 || n < 8 || n % 8 != 0 || group < kBK || group % kBK != 0 || k < group ||
      k % group != 0 || bad_dtype(out_dtype) || (bias != nullptr && bad_dtype(bias_dtype))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  W4MatmulArgs p;
  p.x = static_cast<const int8_t*>(x);
  p.sx = static_cast<const float*>(sx);
  p.w = static_cast<const uint8_t*>(w);
  p.scale = static_cast<const float*>(scale);
  p.bias = bias;
  p.residual = residual;
  p.out = out;
  p.m = m; p.n = n; p.k = k; p.group = group;
  p.out_dtype = out_dtype;
  p.bias_dtype = bias_dtype;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (small) return launch<128, 32, 64, 1>(p, s);
  return launch<256, 128, 128, 2>(p, s);
}
