// Ceilings of one Hopper card for the kernels' building blocks:
//   * mma.sync int8 issue rate, m16n8k16 and m16n8k32, and bf16 m16n8k16
//     with fp32 accumulators (the attention bodies'), register operands only;
//   * wgmma m64nNk16 bf16 with fp32 accumulators (the codebook search's),
//     both operands from 128-byte-swizzled shared memory, two warpgroups a
//     block, four k16 products a group and one group in flight;
//   * a three-stage cp.async ring streaming L2-resident tiles into shared
//     memory with one barrier per step and no compute, as the int8 GEMM
//     body's ring (int8_common.cuh) runs it.
// Build and run: python -m tae_tpu_torch.bench.ceilings  (needs nvcc and a card)
// Rates per clock assume the SM clock printed last (nvidia-smi).
#include <cstdio>
#include <cstdint>
#include <cstdlib>
#include <cuda_runtime.h>
#include <cuda_pipeline.h>

#include "../csrc/common.cuh"

template <int K32>
__global__ void __launch_bounds__(256) mma_rate(int iters, int* out) {
  int c[8][4];
  for (int i = 0; i < 8; ++i) for (int j = 0; j < 4; ++j) c[i][j] = 0;
  unsigned a0 = threadIdx.x, a1 = a0 * 3, a2 = a0 * 5, a3 = a0 * 7, b0 = a0 * 11, b1 = a0 * 13;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (K32) {
        asm volatile("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                     : "+r"(c[i][0]), "+r"(c[i][1]), "+r"(c[i][2]), "+r"(c[i][3])
                     : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      } else {
        asm volatile("mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};"
                     : "+r"(c[i][0]), "+r"(c[i][1]), "+r"(c[i][2]), "+r"(c[i][3])
                     : "r"(a0), "r"(a1), "r"(b0));
      }
    }
  }
  int s = 0;
  for (int i = 0; i < 8; ++i) for (int j = 0; j < 4; ++j) s += c[i][j];
  if (s == 0x7fffffff) out[0] = s;
}

__global__ void __launch_bounds__(256) mma_rate_bf16(int iters, float* out) {
  float c[8][4];
  for (int i = 0; i < 8; ++i) for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
  unsigned a0 = threadIdx.x, a1 = a0 * 3, a2 = a0 * 5, a3 = a0 * 7, b0 = a0 * 11, b1 = a0 * 13;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                   : "+f"(c[i][0]), "+f"(c[i][1]), "+f"(c[i][2]), "+f"(c[i][3])
                   : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  float s = 0.f;
  for (int i = 0; i < 8; ++i) for (int j = 0; j < 4; ++j) s += c[i][j];
  if (s == 1.2345f) out[0] = s;
}

template <int N>
__global__ void __launch_bounds__(256) wgmma_rate(int iters, float* out) {
  using namespace tae::sm90;
  extern __shared__ unsigned char raw[];
  unsigned char* smem = raw + ((1024u - (tae::smem_addr(raw) & 1023u)) & 1023u);
  for (int i = threadIdx.x; i < (2 * 64 + N) * 128 / 16; i += 256)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);
  const uint64_t da = desc_sw128(smem + wg * 64 * 128), db = desc_sw128(smem + 2 * 64 * 128);
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  for (int it = 0; it < iters; ++it) {
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) wgmma_bf16<N>(acc, da + 2 * k, db + 2 * k, 1);
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) s += acc[i];
  if (s == 1.2345f) out[0] = s;
}

// each block streams `steps` tiles of `tile_bytes` from a small (L2-resident) buffer through a 3-stage ring
__global__ void __launch_bounds__(256) ring_rate(const int8_t* src, size_t src_bytes, int steps, int tile_bytes, int* out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int chunks = tile_bytes / 16;
  size_t off = (size_t)blockIdx.x * 65536 % src_bytes;
  auto issue = [&](int s, int slot) {
    for (int c = threadIdx.x; c < chunks; c += 256) {
      size_t o = (off + (size_t)s * tile_bytes + c * 16) % src_bytes;
      __pipeline_memcpy_async(smem + slot * tile_bytes + c * 16, src + o, 16);
    }
  };
  issue(0, 0); __pipeline_commit();
  issue(1, 1); __pipeline_commit();
  int acc = 0;
  for (int kt = 0; kt < steps; ++kt) {
    __pipeline_wait_prior(1);
    __syncthreads();
    if (kt + 2 < steps) issue(kt + 2, (kt + 2) % 3);
    __pipeline_commit();
    acc += smem[(kt % 3) * tile_bytes + threadIdx.x * 16];
  }
  if (acc == 0x7fffffff) out[0] = acc;
}

int main(int argc, char** argv) {
  // SM clock in GHz (argv[1], e.g. from nvidia-smi clocks.max.sm) for the per-clock figures
  const double ghz = argc > 1 ? atof(argv[1]) : 1.98;
  cudaDeviceProp prop; cudaGetDeviceProperties(&prop, 0);
  const int sms = prop.multiProcessorCount;
  int* out; cudaMalloc(&out, 4);
  cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
  float ms;
  for (int k32 = 0; k32 < 2; ++k32) for (int bps = 1; bps <= 4; bps *= 2) {
    const int iters = 20000, blocks = sms * bps;
    for (int rep = 0; rep < 2; ++rep) {
      cudaEventRecord(e0);
      if (k32) mma_rate<1><<<blocks, 256>>>(iters, out); else mma_rate<0><<<blocks, 256>>>(iters, out);
      cudaEventRecord(e1); cudaEventSynchronize(e1);
    }
    cudaEventElapsedTime(&ms, e0, e1);
    double mmas = (double)blocks * 8 * iters * 8;
    double ops = mmas * 2.0 * 16 * 8 * (k32 ? 32 : 16);
    printf("mma m16n8k%d, %d blocks of 8 warps per SM: %.3f ms, %.1f TOP/s, %.3f mma/clk/SM (at %.3f GHz)\n",
           k32 ? 32 : 16, bps, ms, ops / ms / 1e9, mmas / sms / (ms * 1e-3 * ghz * 1e9), ghz);
  }
  for (int bps = 1; bps <= 2; ++bps) {
    const int iters = 20000, blocks = sms * bps;
    for (int rep = 0; rep < 2; ++rep) {
      cudaEventRecord(e0);
      mma_rate_bf16<<<blocks, 256>>>(iters, reinterpret_cast<float*>(out));
      cudaEventRecord(e1); cudaEventSynchronize(e1);
    }
    cudaEventElapsedTime(&ms, e0, e1);
    double mmas = (double)blocks * 8 * iters * 8;
    double ops = mmas * 2.0 * 16 * 8 * 16;
    printf("mma m16n8k16 bf16 -> f32, %d blocks of 8 warps per SM: %.3f ms, %.1f TFLOP/s, %.3f mma/clk/SM (at %.3f GHz)\n",
           bps, ms, ops / ms / 1e9, mmas / sms / (ms * 1e-3 * ghz * 1e9), ghz);
  }
  for (int n = 128; n <= 256; n *= 2) {
    const int iters = 20000, blocks = sms, smem = (2 * 64 + n) * 128 + 1024;
    auto kernel = n == 128 ? wgmma_rate<128> : wgmma_rate<256>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    for (int rep = 0; rep < 2; ++rep) {
      cudaEventRecord(e0);
      kernel<<<blocks, 256, smem>>>(iters, reinterpret_cast<float*>(out));
      cudaEventRecord(e1); cudaEventSynchronize(e1);
    }
    cudaEventElapsedTime(&ms, e0, e1);
    const double wgmmas = (double)blocks * 2 * iters * 4;
    const double ops = wgmmas * 2.0 * 64 * n * 16;
    printf("wgmma m64n%dk16 bf16 -> f32, 2 warpgroups a block, a block per SM: %.3f ms, %.1f TFLOP/s, "
           "%.0f FLOP/clk/SM (at %.3f GHz)\n",
           n, ms, ops / ms / 1e9, ops / sms / (ms * 1e-3 * ghz * 1e9), ghz);
  }
  int8_t* src; size_t src_bytes = 8u << 20; cudaMalloc(&src, src_bytes); cudaMemset(src, 1, src_bytes);
  for (int tile = 8192; tile <= 32768; tile *= 2) for (int bps = 1; bps <= 2; ++bps) {
    if (3 * tile * bps > 220000) continue;
    const int steps = 2000, blocks = sms * bps;
    cudaFuncSetAttribute(ring_rate, cudaFuncAttributeMaxDynamicSharedMemorySize, 3 * tile);
    for (int rep = 0; rep < 2; ++rep) {
      cudaEventRecord(e0);
      ring_rate<<<blocks, 256, 3 * tile>>>(src, src_bytes, steps, tile, out);
      cudaEventRecord(e1); cudaEventSynchronize(e1);
    }
    cudaEventElapsedTime(&ms, e0, e1);
    double bytes = (double)blocks * steps * tile;
    printf("cp.async ring, tile %d B x 3 stages, %d blocks per SM: %.3f ms, %.2f TB/s total, %.1f B/clk/SM\n",
           tile, bps, ms, bytes / ms / 1e9, bytes / sms / (ms * 1e-3 * ghz * 1e9));
  }
  // few blocks: per-SM rate when the rest of the card is idle
  {
    const int tile = 16384, steps = 2000, blocks = 8;
    cudaFuncSetAttribute(ring_rate, cudaFuncAttributeMaxDynamicSharedMemorySize, 3 * tile);
    for (int rep = 0; rep < 2; ++rep) {
      cudaEventRecord(e0);
      ring_rate<<<blocks, 256, 3 * tile>>>(src, src_bytes, steps, tile, out);
      cudaEventRecord(e1); cudaEventSynchronize(e1);
    }
    cudaEventElapsedTime(&ms, e0, e1);
    printf("cp.async ring, 8 blocks only: %.1f B/clk/SM\n", (double)steps * tile / (ms * 1e-3 * ghz * 1e9));
  }
  printf("%s\n", cudaGetErrorString(cudaGetLastError()));
  return 0;
}
