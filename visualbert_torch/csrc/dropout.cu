// K3, the dropout keep mask, and the fast_dropout site it serves, as three
// kernels on one Philox body. K3 (dropout_mask_kernel) replaces
// visualbert_tpu/ops/dropout.py::_mask_kernel (:61); the site's forward
// (dropout_fwd_kernel) and backward (dropout_bwd_kernel) replace that
// mask and the multiply XLA fuses after it in ::fast_dropout (:148-161).
//
// The keep bit of element e of the flattened tensor is word e % 4 of
// philox(ctr = (e / 4 low, e / 4 high, 0, 1), key = (seed, 0)) >=
// threshold, threshold = min(rate * 2^32, 2^32 - 1): the bits K9
// (csrc/layer_norm.cu) draws and ops/philox.py twins.
// - K3 writes the mask: int8 {0, 1} (the caller rescales) or {0, s} in
//   bf16, fp16 or fp32, s = 1 / (1 - rate) rounded to that dtype.
// - The site forward reads x (bf16, fp16 or fp32) and writes y = x * m,
//   m = keep ? s : 0 with s rounded to x's dtype, the product in fp32
//   rounded once to x's dtype: a multiply, so a NaN or inf of x stays NaN
//   where it is dropped, as in the eager composition and in JAX. It also
//   writes the keep bits, one an element: bit k of byte j is element
//   8 j + k of the flattened tensor, the tail byte padded with zeros
//   (ops/layer_norm.py::pack_bits's layout whenever rows hold a multiple
//   of 8 elements).
// - The site backward reads dy and those bits and writes dx = dy * m, the
//   same product; it draws nothing. Built with VB_DROPOUT_REGEN_MASK (for
//   tools/dropout_steps.py only) it draws the bits again from the seed: the
//   same bits, so the same dx. The shipped path, reading the bits, measured
//   the slower of the two at the main path's shape: 0.0353-0.0359 ms
//   against 0.0338-0.0345 ms for the redraw (H100 80GB HBM3, 700 W,
//   tools/dropout_steps.py); it stays while a step's saved bits and peak
//   memory are not weighed against the redraw (ROADMAP.md B7).
//
// Bound on the H100. K3 at [128, 228, 768] writes 22.4 MB of int8 (6.7 us
// of HBM time) but makes 5.6 M Philox calls, 20 32x32->64-bit multiplies
// each, whose pipe runs at about 62 cycles a warp call a sub-partition
// (csrc/bench/philox_rate.cu): about 10 us, so K3 is bound by its
// operations. The site kernels move x and y (or dy and dx), 44.8 MB each in
// bf16, and 2.8 MB of bits: 27.6 us of HBM time, above the forward's Philox
// time, so both are bound by their bytes as long as the Philox work hides
// under the loads.
//
// The design, against the first (one 4 B store and one Philox call a
// thread in 21,888 one-shot blocks, a 64-bit index loop):
// - 16 elements a thread: 4 independent Philox calls, whose rounds
//   interleave, and 16 B stores (one for the int8 mask, two or four for
//   bf16/fp16 or fp32); the site kernels issue their 16 B loads of x or dy
//   before they draw or use the bits, so the loads are in flight during the
//   Philox work, and store two bytes of bits a thread. Built with
//   VB_DROPOUT_ONE_CALL (tools/dropout_steps.py) K3 makes one call and one
//   4-element store a thread.
// - One grid rule for the three kernels, worked out at launch (grid_of):
//   one group of 16 a thread, 5,472 blocks at the main path. Each kernel
//   walks its groups with a grid-stride loop, so a build with
//   VB_DROPOUT_RESIDENT (tools/dropout_steps.py) runs them on a grid of
//   resident blocks instead (the occupancy query x the SMs, the fewest that
//   give every thread the same number of rounds). That grid bought K3
//   nothing (0.0191-0.0195 ms against 0.0193-0.0195 ms) and cost the site
//   kernels 8-14 % (0.038-0.040 against 0.035-0.036 ms; a copy of the same
//   bytes 0.034 ms) (H100 80GB HBM3, 700 W, tools/dropout_steps.py): a
//   resident thread's next loads wait for its stores, while fresh blocks
//   issue theirs at once.
// - 32-bit index arithmetic when n < 2^31 (every tensor of the main
//   path); 64-bit otherwise.
// - A tail path for n not a multiple of 16: the last group is written
//   element by element (and its bits byte by byte).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "philox.cuh"

namespace {

enum Dtype { kInt8 = 0, kBf16 = 1, kFp16 = 2, kFp32 = 3 };

constexpr int kThreads = 256;  // a block
constexpr int kSitePer = 16;   // site elements a thread: 4 Philox calls
#ifdef VB_DROPOUT_ONE_CALL
constexpr int kMaskPer = 4;    // K3 elements a thread: 1 Philox call
#else
constexpr int kMaskPer = 16;
#endif

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

__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(float x) { return x; }

// The bit pattern of a mask value of T, widened to 32 bits.
template <typename T>
__device__ __forceinline__ uint32_t bits_of(T v) {
  if constexpr (sizeof(T) == 4) {
    return __float_as_uint(v);
  } else if constexpr (sizeof(T) == 2) {
    return (uint32_t)*reinterpret_cast<const uint16_t*>(&v);
  } else {
    return (uint32_t)(uint8_t)v;
  }
}

// Bit 4 c + w set where element 4 (q0 + c) + w is kept, c < CALLS: CALLS
// independent Philox calls at counters q0 .. q0 + CALLS - 1.
template <int CALLS, typename Idx>
__device__ __forceinline__ unsigned keep_bits(Idx q0, uint32_t seed, uint32_t threshold) {
  uint4 r[CALLS];
#pragma unroll
  for (int c = 0; c < CALLS; ++c) {
    const Idx q = q0 + (Idx)c;
    uint32_t hi = 0u;
    if constexpr (sizeof(Idx) > 4) hi = (uint32_t)((unsigned long long)q >> 32);
    r[c] = vb::philox4x32_10(make_uint4((uint32_t)q, hi, 0u, 1u), make_uint2(seed, 0u));
  }
  unsigned bits = 0u;
#pragma unroll
  for (int c = 0; c < CALLS; ++c)
    bits |= ((unsigned)(r[c].x >= threshold) | (unsigned)(r[c].y >= threshold) << 1 |
             (unsigned)(r[c].z >= threshold) << 2 | (unsigned)(r[c].w >= threshold) << 3)
            << (4 * c);
  return bits;
}

// N mask values of T at p (N * sizeof(T) bytes, a multiple of 4, p aligned
// to min(that, 16)): value `one` where bit k of kb is set, else 0.
template <int N, typename T>
__device__ __forceinline__ void store_mask(T* p, unsigned kb, uint32_t one) {
  constexpr int WORDS = N * (int)sizeof(T) / 4;
  uint32_t w[WORDS];
#pragma unroll
  for (int i = 0; i < WORDS; ++i) {
    if constexpr (sizeof(T) == 1) {
      // nibble b3 b2 b1 b0 -> bytes b0, b1, b2, b3: the shifted copies 0,
      // 7, 14, 21 bits apart do not overlap, so the product is their OR
      w[i] = ((kb >> (4 * i)) & 0xFu) * 0x00204081u & 0x01010101u;
    } else if constexpr (sizeof(T) == 2) {
      w[i] = ((kb >> (2 * i) & 1u) ? one : 0u) | ((kb >> (2 * i + 1) & 1u) ? one << 16 : 0u);
    } else {
      w[i] = (kb >> i & 1u) ? one : 0u;
    }
  }
  if constexpr (WORDS >= 4) {
#pragma unroll
    for (int j = 0; j < WORDS / 4; ++j)
      reinterpret_cast<uint4*>(p)[j] = make_uint4(w[4 * j], w[4 * j + 1], w[4 * j + 2], w[4 * j + 3]);
  } else if constexpr (WORDS == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
    *reinterpret_cast<uint32_t*>(p) = w[0];
  }
}

template <typename T, typename Idx>
__global__ void __launch_bounds__(kThreads)
    dropout_mask_kernel(T* __restrict__ out, Idx n, uint32_t seed, uint32_t threshold, float scale) {
  const T one_v = from_float<T>(sizeof(T) == 1 ? 1.f : scale);
  const uint32_t one = bits_of(one_v);
  const Idx full = n / kMaskPer, groups = full + (n % kMaskPer != 0);
  const Idx stride = (Idx)gridDim.x * kThreads;
  for (Idx g = (Idx)blockIdx.x * kThreads + threadIdx.x; g < groups; g += stride) {
    const unsigned kb = keep_bits<kMaskPer / 4>(g * (Idx)(kMaskPer / 4), seed, threshold);
    T* p = out + g * (Idx)kMaskPer;
    if (g < full) {
      store_mask<kMaskPer>(p, kb, one);
    } else {
      const int left = (int)(n - g * (Idx)kMaskPer);
      for (int k = 0; k < left; ++k) p[k] = (kb >> k & 1u) ? one_v : from_float<T>(0.f);
    }
  }
}

// 16 values of T in 16 * sizeof(T) / 16 vectors: y = T(float(x) * m), m =
// s where bit k of kb is set, else 0.
template <typename T>
struct Site {
  static constexpr int kVecs = kSitePer * (int)sizeof(T) / 16;

  static __device__ __forceinline__ void scale(const uint4 (&in)[kVecs], uint4 (&out)[kVecs], unsigned kb,
                                               float s) {
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int v = 0; v < kVecs; ++v) {
        const uint32_t* a = reinterpret_cast<const uint32_t*>(&in[v]);
        uint32_t* b = reinterpret_cast<uint32_t*>(&out[v]);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          b[k] = __float_as_uint(__uint_as_float(a[k]) * ((kb >> (4 * v + k) & 1u) ? s : 0.f));
      }
    } else {
#pragma unroll
      for (int v = 0; v < kVecs; ++v) {
        const uint32_t* a = reinterpret_cast<const uint32_t*>(&in[v]);
        uint32_t* b = reinterpret_cast<uint32_t*>(&out[v]);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int e = 8 * v + 2 * k;
          const float m0 = (kb >> e & 1u) ? s : 0.f, m1 = (kb >> (e + 1) & 1u) ? s : 0.f;
          if constexpr (std::is_same<T, __nv_bfloat16>::value) {
            const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a[k]));
            const __nv_bfloat162 r = __floats2bfloat162_rn(f.x * m0, f.y * m1);
            b[k] = *reinterpret_cast<const uint32_t*>(&r);
          } else {
            const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&a[k]));
            const __half2 r = __floats2half2_rn(f.x * m0, f.y * m1);
            b[k] = *reinterpret_cast<const uint32_t*>(&r);
          }
        }
      }
    }
  }

  // the group's first `left` (< 16) elements one by one
  static __device__ __forceinline__ void scale_tail(const T* in, T* out, int left, unsigned kb, float s) {
    for (int k = 0; k < left; ++k) out[k] = from_float<T>(to_float(in[k]) * ((kb >> k & 1u) ? s : 0.f));
  }
};

// s = 1 / (1 - rate) rounded to T, as the product's fp32 operand
template <typename T>
__device__ __forceinline__ float site_scale(float scale) {
  return to_float(from_float<T>(scale));
}

template <typename T, typename Idx>
__global__ void __launch_bounds__(kThreads)
    dropout_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, uint8_t* __restrict__ bits, Idx n,
                       uint32_t seed, uint32_t threshold, float scale) {
  using S = Site<T>;
  const float s = site_scale<T>(scale);
  const Idx full = n / kSitePer, groups = full + (n % kSitePer != 0);
  const Idx stride = (Idx)gridDim.x * kThreads;
  for (Idx g = (Idx)blockIdx.x * kThreads + threadIdx.x; g < groups; g += stride) {
    const Idx e0 = g * (Idx)kSitePer;
    uint4 in[S::kVecs];
    if (g < full) {  // in flight while the bits are drawn
      const uint4* src = reinterpret_cast<const uint4*>(x + e0);
#pragma unroll
      for (int v = 0; v < S::kVecs; ++v) in[v] = src[v];
    }
    if (g < full) {
      uint4 out[S::kVecs];
      const unsigned kb = keep_bits<kSitePer / 4>(g * (Idx)(kSitePer / 4), seed, threshold);
      S::scale(in, out, kb, s);
      uint4* dst = reinterpret_cast<uint4*>(y + e0);
#pragma unroll
      for (int v = 0; v < S::kVecs; ++v) dst[v] = out[v];
      *reinterpret_cast<uint16_t*>(bits + 2 * g) = (uint16_t)kb;
    } else {
      const int left = (int)(n - e0);
      const unsigned kb = keep_bits<kSitePer / 4>(g * (Idx)(kSitePer / 4), seed, threshold) & ((1u << left) - 1u);
      S::scale_tail(x + e0, y + e0, left, kb, s);
      bits[2 * g] = (uint8_t)kb;
      if (left > 8) bits[2 * g + 1] = (uint8_t)(kb >> 8);
    }
  }
}

template <typename T, typename Idx>
__global__ void __launch_bounds__(kThreads)
    dropout_bwd_kernel(const T* __restrict__ dy, const uint8_t* __restrict__ bits, T* __restrict__ dx, Idx n,
                       uint32_t seed, uint32_t threshold, float scale) {
  using S = Site<T>;
  const float s = site_scale<T>(scale);
  const Idx full = n / kSitePer, groups = full + (n % kSitePer != 0);
  const Idx stride = (Idx)gridDim.x * kThreads;
  for (Idx g = (Idx)blockIdx.x * kThreads + threadIdx.x; g < groups; g += stride) {
    const Idx e0 = g * (Idx)kSitePer;
    uint4 in[S::kVecs];
    unsigned kb = 0u;
    if (g < full) {
      const uint4* src = reinterpret_cast<const uint4*>(dy + e0);
#pragma unroll
      for (int v = 0; v < S::kVecs; ++v) in[v] = src[v];
#ifdef VB_DROPOUT_REGEN_MASK
      kb = keep_bits<kSitePer / 4>(g * (Idx)(kSitePer / 4), seed, threshold);
#else
      kb = *reinterpret_cast<const uint16_t*>(bits + 2 * g);
#endif
    }
    if (g < full) {
      uint4 out[S::kVecs];
      S::scale(in, out, kb, s);
      uint4* dst = reinterpret_cast<uint4*>(dx + e0);
#pragma unroll
      for (int v = 0; v < S::kVecs; ++v) dst[v] = out[v];
    } else {
      const int left = (int)(n - e0);
#ifdef VB_DROPOUT_REGEN_MASK
      kb = keep_bits<kSitePer / 4>(g * (Idx)(kSitePer / 4), seed, threshold);
#else
      kb = (unsigned)bits[2 * g] | (left > 8 ? (unsigned)bits[2 * g + 1] << 8 : 0u);
#endif
      S::scale_tail(dy + e0, dx + e0, left, kb, s);
    }
  }
}

constexpr long long kMax32 = 0x7fffffffLL;  // n below this takes the 32-bit index kernels

// The grid of `kernel` over n elements, `per` a thread: one group a thread;
// built with VB_DROPOUT_RESIDENT, no more blocks than fit on the card at
// once, the fewest of those that give every thread the same rounds.
template <typename K>
int grid_of(K kernel, long long n, int per) {
  const long long groups = (n + per - 1) / per;
  long long blocks = (groups + kThreads - 1) / kThreads;
#ifdef VB_DROPOUT_RESIDENT
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  const long long fit = (long long)per_sm * sms;
  if (fit > 0) {
    const long long rounds = (blocks + fit - 1) / fit;
    blocks = (groups + kThreads * rounds - 1) / (kThreads * rounds);
  }
#else
  (void)kernel;
#endif
  return (int)(blocks < kMax32 ? blocks : kMax32);
}

template <typename T>
void launch_mask(void* out, long long n, uint32_t seed, uint32_t threshold, float scale, cudaStream_t st) {
  T* p = static_cast<T*>(out);
  if (n < kMax32) {
    auto k = dropout_mask_kernel<T, uint32_t>;
    k<<<grid_of(k, n, kMaskPer), kThreads, 0, st>>>(p, (uint32_t)n, seed, threshold, scale);
  } else {
    auto k = dropout_mask_kernel<T, unsigned long long>;
    k<<<grid_of(k, n, kMaskPer), kThreads, 0, st>>>(p, n, seed, threshold, scale);
  }
}

template <typename T>
void launch_fwd(const void* x, void* y, void* bits, long long n, uint32_t seed, uint32_t threshold, float scale,
                cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  uint8_t* bp = static_cast<uint8_t*>(bits);
  if (n < kMax32) {
    auto k = dropout_fwd_kernel<T, uint32_t>;
    k<<<grid_of(k, n, kSitePer), kThreads, 0, st>>>(xp, yp, bp, (uint32_t)n, seed, threshold, scale);
  } else {
    auto k = dropout_fwd_kernel<T, unsigned long long>;
    k<<<grid_of(k, n, kSitePer), kThreads, 0, st>>>(xp, yp, bp, n, seed, threshold, scale);
  }
}

template <typename T>
void launch_bwd(const void* dy, const void* bits, void* dx, long long n, uint32_t seed, uint32_t threshold,
                float scale, cudaStream_t st) {
  const T* dyp = static_cast<const T*>(dy);
  const uint8_t* bp = static_cast<const uint8_t*>(bits);
  T* dxp = static_cast<T*>(dx);
  if (n < kMax32) {
    auto k = dropout_bwd_kernel<T, uint32_t>;
    k<<<grid_of(k, n, kSitePer), kThreads, 0, st>>>(dyp, bp, dxp, (uint32_t)n, seed, threshold, scale);
  } else {
    auto k = dropout_bwd_kernel<T, unsigned long long>;
    k<<<grid_of(k, n, kSitePer), kThreads, 0, st>>>(dyp, bp, dxp, n, seed, threshold, scale);
  }
}

// The 32-bit index instantiation of kernel 0 (K3), 1 (site forward) or 2
// (site backward) for dtype, or null.
const void* kernel_of(int kernel, int dtype) {
  if (kernel == 0) {
    switch (dtype) {
      case kInt8: return (const void*)dropout_mask_kernel<int8_t, uint32_t>;
      case kBf16: return (const void*)dropout_mask_kernel<__nv_bfloat16, uint32_t>;
      case kFp16: return (const void*)dropout_mask_kernel<__half, uint32_t>;
      case kFp32: return (const void*)dropout_mask_kernel<float, uint32_t>;
      default: return nullptr;
    }
  }
  switch (dtype) {
    case kBf16:
      return kernel == 1 ? (const void*)dropout_fwd_kernel<__nv_bfloat16, uint32_t>
                         : (const void*)dropout_bwd_kernel<__nv_bfloat16, uint32_t>;
    case kFp16:
      return kernel == 1 ? (const void*)dropout_fwd_kernel<__half, uint32_t>
                         : (const void*)dropout_bwd_kernel<__half, uint32_t>;
    case kFp32:
      return kernel == 1 ? (const void*)dropout_fwd_kernel<float, uint32_t>
                         : (const void*)dropout_bwd_kernel<float, uint32_t>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" const char* vb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Kernel 0 (K3), 1 (site forward) or 2 (site backward) in dtype (K3: int8,
// bf16, fp16, fp32; the site: bf16, fp16, fp32), its 32-bit index build: 0
// registers a thread, 1 local (spilled) bytes a thread, 2 shared bytes a
// block, 3 blocks an SM; -1 for anything else.
extern "C" int vb_dropout_info(int kernel, int what, int dtype) {
  if (kernel < 0 || kernel > 2 || what < 0 || what > 3 || (kernel > 0 && dtype == kInt8)) return -1;
  const void* fn = kernel_of(kernel, dtype);
  if (fn == nullptr) return -1;
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, fn) != cudaSuccess) return -1;
  if (what == 0) return attr.numRegs;
  if (what == 1) return (int)attr.localSizeBytes;
  if (what == 2) return (int)attr.sharedSizeBytes;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, 0) != cudaSuccess) return -1;
  return per_sm;
}

// K3: the mask of n elements into out (16-byte aligned) as dtype.
extern "C" int vb_dropout_mask(void* out, long long n, int dtype, unsigned int seed, unsigned int threshold,
                               float scale, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kInt8: launch_mask<int8_t>(out, n, seed, threshold, 1.f, s); break;
    case kBf16: launch_mask<__nv_bfloat16>(out, n, seed, threshold, scale, s); break;
    case kFp16: launch_mask<__half>(out, n, seed, threshold, scale, s); break;
    case kFp32: launch_mask<float>(out, n, seed, threshold, scale, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The site forward: y = x * m and the keep bits (ceil(n / 8) bytes) of n
// elements; x and y 16-byte aligned, bits 2-byte aligned.
extern "C" int vb_dropout_fwd(const void* x, void* y, void* bits, long long n, int dtype, unsigned int seed,
                              unsigned int threshold, float scale, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kBf16: launch_fwd<__nv_bfloat16>(x, y, bits, n, seed, threshold, scale, s); break;
    case kFp16: launch_fwd<__half>(x, y, bits, n, seed, threshold, scale, s); break;
    case kFp32: launch_fwd<float>(x, y, bits, n, seed, threshold, scale, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The site backward: dx = dy * m from the forward's bits. seed and
// threshold are read only by a build with VB_DROPOUT_REGEN_MASK.
extern "C" int vb_dropout_bwd(const void* dy, const void* bits, void* dx, long long n, int dtype, unsigned int seed,
                              unsigned int threshold, float scale, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kBf16: launch_bwd<__nv_bfloat16>(dy, bits, dx, n, seed, threshold, scale, s); break;
    case kFp16: launch_bwd<__half>(dy, bits, dx, n, seed, threshold, scale, s); break;
    case kFp32: launch_bwd<float>(dy, bits, dx, n, seed, threshold, scale, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
