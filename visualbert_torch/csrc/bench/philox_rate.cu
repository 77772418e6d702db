// The issue rate of one attention dropout call, measured on the SM's own
// clock: philox.cuh::attn_philox and the four keep-bit compares that K1/K2
// (flash_attention_packed.cu) make on its words, with every call
// independent, as in the kernels' fragment loops. Not part of the kernel
// library: tools/attn_steps.py builds it alone and reads
// cycles / (warp calls a sub-partition) from one wave of resident blocks.
#include <cuda_runtime.h>
#include <stdint.h>

#include "../philox.cuh"

namespace {

__global__ void philox_rate_kernel(int calls, uint32_t seed, uint32_t thr, uint32_t* __restrict__ sink,
                                   long long* __restrict__ cycles) {
  const uint32_t bh = blockIdx.x;
  const int i = 2 * threadIdx.x;
  uint32_t acc = 0;
  __syncthreads();
  const long long t0 = clock64();
#pragma unroll 4
  for (int c = 0; c < calls; ++c) {
    const uint4 r = vb::attn_philox(seed, bh, i, 2 * c);
    acc += (uint32_t)(r.x >= thr) | ((uint32_t)(r.y >= thr) << 1) | ((uint32_t)(r.z >= thr) << 2) |
           ((uint32_t)(r.w >= thr) << 3);
  }
  __syncthreads();
  const long long t1 = clock64();
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
  sink[blockIdx.x * blockDim.x + threadIdx.x] = acc;  // keeps the calls live
}

}  // namespace

// Resident blocks of `threads` threads an SM, or -1 on an error.
extern "C" int vb_philox_blocks_per_sm(int threads) {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, philox_rate_kernel, threads, 0) != cudaSuccess) return -1;
  return n;
}

// sink [blocks * threads] uint32 and cycles [blocks] int64 on the card.
extern "C" int vb_philox_rate(int blocks, int threads, int calls, unsigned int seed, unsigned int thr, void* sink,
                              void* cycles, void* stream) {
  philox_rate_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      calls, seed, thr, static_cast<uint32_t*>(sink), static_cast<long long*>(cycles));
  return (int)cudaGetLastError();
}
