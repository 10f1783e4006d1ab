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
// What the design does about it: K4's body (int8_common.cuh's
//   gemm_mainloop: mma.sync.m16n8k32, ldmatrix, a cp.async ring of 128 K
//   values a stage) with the packed B operand (RowsI4): the weight's bytes
//   stay packed through the ring, one ldmatrix.x4 a stage and n8 tile hands
//   each lane the words of four k32 steps, decoded by a shift and two masks.
//   The fold after every scale group (int4_common.cuh::fold_group) turns
//   the group's int32 sums into the fp32 tile in registers; groups of 64
//   fold every two k32 steps (RowsI4<64>), wider groups after whole stages.
//   Output tiles spread over the grid as K4's (kMany, kFew;
//   ops/cuda/int4_matmul.py's w4_matmul_tiles picks one from M), so no
//   block streams more of the weight than its columns. Each group's scales
//   are loaded while the group before it is folded. No K split: the fp32
//   group sums keep their ascending order, so the kernel equals
//   int4_matmul_reference bit for bit. The epilogue reads the fp32 tile
//   through quad transposes, 16 bytes a lane. Ragged M and N edges are
//   zero-filled on load and masked on store; N must be a multiple of 8, G
//   of 64.
#include "int4_common.cuh"

namespace {

using namespace tae;
using namespace tae::i8;
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

// The tile shapes, in the order of ops/cuda/int4_matmul.py's W4_TILES: more
// than 64 rows; up to 64 rows. A lane holds an int32 and an fp32
// accumulator tile, so two blocks of kMany share an SM at 128 registers a
// thread (K4's 128-row tile would need twice that).
using kMany = Tiles<64, 128, 2, 4, 5, 2>;
using kFew = Tiles<16, 64, 1, 2, 4>;

template <class S, class B>
__global__ void __launch_bounds__(S::NT, S::MINB) int4_matmul_kernel(const W4MatmulArgs p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int row0 = blockIdx.y * S::BM, col0 = blockIdx.x * S::BN;

  float accf[S::MI][S::NI][4];
  zero<S>(accf);
  const float* scale = p.scale + col0;
  const int n_groups = p.k / p.group, cols = p.n - col0;
  float2 sc[S::NI];
  load_scales<S>(sc, scale, cols);
  auto fold = [&](Acc<S>& c, int g) {
    fold_group<S>(c, accf, sc);
    if (g + 1 < n_groups) load_scales<S>(sc, scale + static_cast<long>(g + 1) * p.n, cols);
  };
  int acc[S::MI][S::NI][4];
  gemm_mainloop<S, B>(acc, p.x + static_cast<long>(row0) * p.k, p.k, p.m - row0,
                      reinterpret_cast<const int8_t*>(p.w) + static_cast<long>(col0) * (p.k / 2),
                      p.k / 2, p.n - col0, 0, p.k, p.group / B::kFoldK,
                      reinterpret_cast<int8_t*>(smem_raw), fold);

  for_rows8<S>(accf, [&](int r, int c, const float* v) {
    const long row = row0 + r;
    const int col = col0 + c;
    if (row >= p.m || col >= p.n) return;
    const float sxr = p.sx[row];
    float y[8], t[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) y[j] = __fmul_rn(v[j], sxr);
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
    store8(p.out, row * p.n + col, p.out_dtype, y);
  });
}

template <class S, class B>
int launch(const W4MatmulArgs& p, cudaStream_t stream) {
  const long tiles_m = (static_cast<long>(p.m) + S::BM - 1) / S::BM;
  const long tiles_n = (static_cast<long>(p.n) + S::BN - 1) / S::BN;
  if (tiles_m > 65535 || tiles_n > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = ring_bytes<S, B>();
  static_assert(smem <= kSmemLimit, "tile exceeds a block's shared memory");
  const cudaError_t rc = allow_smem(int4_matmul_kernel<S, B>, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid(static_cast<unsigned>(tiles_n), static_cast<unsigned>(tiles_m));
  int4_matmul_kernel<S, B><<<grid, S::NT, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <class B>
int launch_tiles(const W4MatmulArgs& p, int tiles, cudaStream_t stream) {
  switch (tiles) {
    case 0: return launch<kMany, B>(p, stream);
    case 1: return launch<kFew, B>(p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool bad_dtype(int d) { return d != kFloat32 && d != kBFloat16; }

}  // namespace

// x (m, k) int8, sx (m,) f32, w (n, k / 2) packed uint8, scale (k / group, n)
// f32, bias (n,) or null, residual (m, n) or null, out (m, n); all contiguous
// and 16-byte aligned. tiles: the tile shape (ops/cuda/int4_matmul.py's
// w4_matmul_tiles).
extern "C" int tae_int4_matmul_fwd(const void* x, const void* sx, const void* w,
                                   const void* scale, const void* bias, const void* residual,
                                   void* out, int m, int n, int k, int group, int out_dtype,
                                   int bias_dtype, int tiles, void* stream) {
  if (m < 1 || n < 8 || n % 8 != 0 || group < 64 || group % 64 != 0 || k < group ||
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
  if (group % kBK == 0) return launch_tiles<RowsI4<kBK>>(p, tiles, s);
  return launch_tiles<RowsI4<64>>(p, tiles, s);
}
