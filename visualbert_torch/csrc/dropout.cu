// K3: dropout keep mask. Replaces visualbert_tpu/ops/dropout.py::_mask_kernel.
//
// Element n of the mask is keep = (word (n & 3) of philox(ctr = (n >> 2 low,
// n >> 2 high, 0, 1), key = (seed, 0))) >= threshold, threshold =
// min(rate * 2^32, 2^32 - 1). The output is int8 {0, 1} (the caller
// rescales) or {0, scale} in bf16, fp16 or fp32.
//
// Bound on the H100: device-memory writes. At [96, 228, 768] the int8 mask is
// 16.8 MB, about 5 us of HBM time; Philox-10 costs ~100 integer instructions
// per 4 elements, below the store time at this size. Each thread makes one
// Philox call and writes its 4 elements with one vector store.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

enum MaskDtype { kInt8 = 0, kBf16 = 1, kFp16 = 2, kFp32 = 3 };

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ int8_t from_float<int8_t>(float x) { return (int8_t)x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) { return __float2bfloat16(x); }
template <>
__device__ __forceinline__ __half from_float<__half>(float x) { return __float2half(x); }
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

template <typename T>
__global__ void dropout_mask_kernel(T* __restrict__ out, long long n, uint32_t seed,
                                    uint32_t threshold, float scale) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x; q * 4 < n; q += stride) {
    const uint4 r = vb::philox4x32_10(
        make_uint4((uint32_t)q, (uint32_t)((unsigned long long)q >> 32), 0u, 1u),
        make_uint2(seed, 0u));
    const long long i0 = q * 4;
    T v[4];
    v[0] = from_float<T>(r.x >= threshold ? scale : 0.f);
    v[1] = from_float<T>(r.y >= threshold ? scale : 0.f);
    v[2] = from_float<T>(r.z >= threshold ? scale : 0.f);
    v[3] = from_float<T>(r.w >= threshold ? scale : 0.f);
    if (i0 + 4 <= n) {
      // 4 elements of T: 4, 8 or 16 bytes; i0 is a multiple of 4 and the
      // wrapper checks 16-byte alignment of `out`
      if constexpr (sizeof(T) == 1) {
        *reinterpret_cast<uint32_t*>(out + i0) = *reinterpret_cast<const uint32_t*>(v);
      } else if constexpr (sizeof(T) == 2) {
        *reinterpret_cast<uint2*>(out + i0) = *reinterpret_cast<const uint2*>(v);
      } else {
        *reinterpret_cast<uint4*>(out + i0) = *reinterpret_cast<const uint4*>(v);
      }
    } else {
      for (int k = 0; k < 4 && i0 + k < n; ++k) out[i0 + k] = v[k];
    }
  }
}

template <typename T>
void launch(void* out, long long n, uint32_t seed, uint32_t threshold, float scale,
            cudaStream_t stream) {
  const int threads = 256;
  const long long groups = (n + 3) / 4;
  long long blocks = (groups + threads - 1) / threads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride loop covers the rest
  if (blocks < 1) blocks = 1;
  dropout_mask_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<T*>(out), n, seed, threshold, scale);
}

}  // namespace

extern "C" const char* vb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int vb_dropout_mask(void* out, long long n, int dtype, unsigned int seed,
                               unsigned int threshold, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kInt8: launch<int8_t>(out, n, seed, threshold, 1.f, s); break;
    case kBf16: launch<__nv_bfloat16>(out, n, seed, threshold, scale, s); break;
    case kFp16: launch<__half>(out, n, seed, threshold, scale, s); break;
    case kFp32: launch<float>(out, n, seed, threshold, scale, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
