// K18 — AdamW with its moments in a reduced type: one multi-tensor update.
//
// Replaces no TPU kernel. The JAX package's update (tae_tpu/train/optim.py,
//   adamw(moment_dtype=)) is elementwise work that XLA fuses into the
//   jitted step. The port needs a kernel of its own because
//   torch.optim.AdamW keeps its moments in the parameters' dtype: bf16
//   moments save 8 of the 16 bytes a parameter of fp32 training state.
// Numerics, all in fp32, in the JAX package's order (optim.py:67-76), each
//   operation rounded once (__fmul_rn / __fadd_rn / __fdiv_rn / __fsqrt_rn,
//   so that nvcc contracts no FMA that the plain version lacks):
//     p <- p * decay                      (decay = 1 - lr * wd, 1 where exempt)
//     m <- b1 * m + (1 - b1) * g
//     v <- b2 * v + (1 - b2) * (g * g)
//     p <- p - (lr * (m / c1)) / (sqrt(v / c2) + eps)
//   then p rounded to its dtype and m, v to the moments' (nearest even, as
//   Tensor.to rounds). decay, lr, c1 = 1 - b1^t and c2 = 1 - b2^t are fp32
//   values the host computes per tensor (ops/cuda/adamw.py), the plain
//   version's own, so the two agree bit for bit.
// What bounds it on the H100: device-memory bytes. With fp32 parameters and
//   gradients and bf16 moments a parameter moves 20 bytes (p, g, m, v read;
//   p, m, v written); there is no reuse and 10 flops a parameter.
// What the design does about it: one launch for every tensor of a dtype
//   pair. The host writes a table of the tensors (pointers, length, first
//   chunk, decay, lr, c1, c2); the grid has one block per chunk of kChunk
//   elements over all tensors, and a block finds its tensor by a binary
//   search over the chunks' starts. A thread carries kPerThread elements a
//   pass, neighbouring threads on neighbouring elements, all loads of a
//   pass issued before the arithmetic. Loads are scalar: FSDP2's gradient
//   shards are views at any element offset, so no 16-byte alignment is
//   assumed.
#include <cuda_fp16.h>

#include "common.cuh"

namespace {

constexpr int kFloat16 = 2;  // moments only; ops/cuda/adamw.py::DTYPE_CODES
constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr long long kChunk = 8192;  // ops/cuda/adamw.py::CHUNK

// One tensor of the update; ops/cuda/adamw.py::table writes it as eight
// int64 a row.
struct Entry {
  long long p, g, m, v;    // device addresses
  long long n;             // elements
  long long chunk0;        // its first chunk in the grid
  float decay, lr, c1, c2;
};
static_assert(sizeof(Entry) == 64, "table rows are 8 int64");

__device__ __forceinline__ float load(const float* x, long long i) { return x[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* x, long long i) {
  return __bfloat162float(x[i]);
}
__device__ __forceinline__ float load(const __half* x, long long i) {
  return __half2float(x[i]);
}
__device__ __forceinline__ void store(float* x, long long i, float v) { x[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* x, long long i, float v) {
  x[i] = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store(__half* x, long long i, float v) {
  x[i] = __float2half_rn(v);
}

template <typename P, typename M>
__global__ void __launch_bounds__(kThreads)
    adamw_kernel(const Entry* __restrict__ table, int tensors, float b1, float omb1,
                 float b2, float omb2, float eps) {
  const long long chunk = blockIdx.x;
  int lo = 0, hi = tensors - 1;  // the last tensor whose chunks start at or before ours
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table[mid].chunk0 <= chunk) lo = mid; else hi = mid - 1;
  }
  const Entry e = table[lo];
  P* p = reinterpret_cast<P*>(e.p);
  const P* g = reinterpret_cast<const P*>(e.g);
  M* m = reinterpret_cast<M*>(e.m);
  M* v = reinterpret_cast<M*>(e.v);
  const long long begin = (chunk - e.chunk0) * kChunk;
  const long long end = begin + kChunk < e.n ? begin + kChunk : e.n;
  for (long long base = begin + threadIdx.x; base < end; base += kThreads * kPerThread) {
    float pr[kPerThread], gr[kPerThread], mr[kPerThread], vr[kPerThread];
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const long long i = base + u * kThreads;
      if (i < end) {
        pr[u] = load(p, i);
        gr[u] = load(g, i);
        mr[u] = load(m, i);
        vr[u] = load(v, i);
      }
    }
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const long long i = base + u * kThreads;
      if (i >= end) continue;
      const float p32 = __fmul_rn(pr[u], e.decay);
      const float m32 = __fadd_rn(__fmul_rn(b1, mr[u]), __fmul_rn(omb1, gr[u]));
      const float v32 = __fadd_rn(__fmul_rn(b2, vr[u]),
                                  __fmul_rn(omb2, __fmul_rn(gr[u], gr[u])));
      const float step = __fdiv_rn(__fmul_rn(e.lr, __fdiv_rn(m32, e.c1)),
                                   __fadd_rn(__fsqrt_rn(__fdiv_rn(v32, e.c2)), eps));
      store(p, i, __fsub_rn(p32, step));
      store(m, i, m32);
      store(v, i, v32);
    }
  }
}

template <typename P, typename M>
int launch(const void* table, int tensors, long long chunks, float b1, float omb1, float b2,
           float omb2, float eps, cudaStream_t s) {
  adamw_kernel<P, M><<<static_cast<unsigned>(chunks), kThreads, 0, s>>>(
      static_cast<const Entry*>(table), tensors, b1, omb1, b2, omb2, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename P>
int launch_moments(int m_dtype, const void* table, int tensors, long long chunks, float b1,
                   float omb1, float b2, float omb2, float eps, cudaStream_t s) {
  switch (m_dtype) {
    case tae::kFloat32:
      return launch<P, float>(table, tensors, chunks, b1, omb1, b2, omb2, eps, s);
    case tae::kBFloat16:
      return launch<P, __nv_bfloat16>(table, tensors, chunks, b1, omb1, b2, omb2, eps, s);
    case kFloat16:
      return launch<P, __half>(table, tensors, chunks, b1, omb1, b2, omb2, eps, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// table: (tensors, 8) int64 on the device, rows as Entry; chunks: the
// grid, the last row's chunk0 plus its chunks; p / g dtype p_dtype (0 fp32,
// 1 bf16), m / v dtype m_dtype (0 fp32, 1 bf16, 2 fp16).
extern "C" int tae_adamw_update(const void* table, int tensors, long long chunks, int p_dtype,
                                int m_dtype, float b1, float omb1, float b2, float omb2,
                                float eps, void* stream) {
  if (tensors < 1 || chunks < 1 || chunks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p_dtype == tae::kFloat32)
    return launch_moments<float>(m_dtype, table, tensors, chunks, b1, omb1, b2, omb2, eps, s);
  if (p_dtype == tae::kBFloat16)
    return launch_moments<__nv_bfloat16>(m_dtype, table, tensors, chunks, b1, omb1, b2, omb2,
                                         eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
