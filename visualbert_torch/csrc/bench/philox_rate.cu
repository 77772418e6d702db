// The issue rate of a Philox call, measured on the SM's own clock, in two
// forms, with every call independent:
//
// * form 0, attention dropout: philox.cuh::attn_philox and the four
//   keep-bit compares that K1/K2 (flash_attention_packed.cu) make on its
//   words, as in the kernels' fragment loops;
// * form 1, the dropout mask (K3, dropout.cu): counter (q low, q high, 0, 1)
//   and key (seed, 0), q stepping by the grid's threads, and the four
//   compares against the threshold that K3 makes.
//
// Not part of the kernel library: tools/attn_steps.py builds it alone and
// reads cycles / (warp calls a sub-partition) from one wave of resident
// blocks.
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

__global__ void philox_mask_rate_kernel(int calls, uint32_t seed, uint32_t thr, uint32_t* __restrict__ sink,
                                        long long* __restrict__ cycles) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t acc = 0;
  __syncthreads();
  const long long t0 = clock64();
#pragma unroll 4
  for (int c = 0; c < calls; ++c, q += stride) {
    const uint4 r = vb::philox4x32_10(make_uint4((uint32_t)q, (uint32_t)((unsigned long long)q >> 32), 0u, 1u),
                                      make_uint2(seed, 0u));
    acc += (uint32_t)(r.x >= thr) | ((uint32_t)(r.y >= thr) << 1) | ((uint32_t)(r.z >= thr) << 2) |
           ((uint32_t)(r.w >= thr) << 3);
  }
  __syncthreads();
  const long long t1 = clock64();
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
  sink[blockIdx.x * blockDim.x + threadIdx.x] = acc;  // keeps the calls live
}

using RateKernel = void (*)(int, uint32_t, uint32_t, uint32_t*, long long*);

RateKernel kernel_of(int form) {
  return form == 0 ? philox_rate_kernel : (form == 1 ? philox_mask_rate_kernel : nullptr);
}

}  // namespace

// Resident blocks of `threads` threads an SM of form `form`, or -1 on an
// error.
extern "C" int vb_philox_blocks_per_sm(int form, int threads) {
  int n = 0;
  const RateKernel fn = kernel_of(form);
  if (fn == nullptr || cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, threads, 0) != cudaSuccess) return -1;
  return n;
}

// sink [blocks * threads] uint32 and cycles [blocks] int64 on the card.
extern "C" int vb_philox_rate(int form, int blocks, int threads, int calls, unsigned int seed, unsigned int thr,
                              void* sink, void* cycles, void* stream) {
  const RateKernel fn = kernel_of(form);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  fn<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(calls, seed, thr, static_cast<uint32_t*>(sink),
                                                                 static_cast<long long*>(cycles));
  return (int)cudaGetLastError();
}
