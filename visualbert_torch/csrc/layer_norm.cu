// K7, K8, K9, K10: the residual add + LayerNorm epilogue of every
// transformer sublayer, with and without dropout. Replace
// visualbert_tpu/ops/layer_norm.py::_fwd_kernel (K7) and ::_bwd_kernel (K8)
// of fused_add_layer_norm, ::_dfwd_kernel (K9) and ::_dbwd_kernel (K10) of
// fused_dropout_add_layer_norm.
//
// On rows of x, res [N, H] (bf16, fp16 or fp32, one dtype) with fp32 scale
// and bias [H]:
//   s    = where(keep, x / (1 - rate), 0) + res   (fp32; keep = 1 without dropout)
//   mu   = mean(s), rstd = rsqrt(mean((s - mu)^2) + eps)   (two passes, fp32)
//   y    = (s - mu) * rstd * scale + bias, stored in x's dtype; mu, rstd [N] fp32
// and the backward, from the saved inputs and mu, rstd:
//   xhat = (s - mu) * rstd, g = dy * scale
//   ds   = rstd * (g - mean(g) - xhat * mean(g * xhat))
//   dres = ds, dx = where(keep, ds / (1 - rate), 0) (= ds without dropout)
//   dscale = sum_rows dy * xhat, dbias = sum_rows dy   (fp32)
// The keep bit of element e of the flattened [N, H] tensor is K3's
// (csrc/dropout.cu): word e % 4 of philox(ctr = (e / 4 low, e / 4 high, 0,
// 1), key = (seed, 0)) >= threshold, so the plain version (ops/layer_norm.py)
// draws the same mask from ops/philox.py.
//
// Bound on the H100: device memory. Each element costs about ten fp32
// operations against 6 (K7, K9), 8 (K8) or 10 (K10) bytes moved at bf16; the
// card does 67 TFLOP/s of fp32 outside the tensor cores against 3.35 TB/s, so
// the bytes bound every kernel by far. At the main path's N = 128 * 228 =
// 29,184 rows and H = 768: K7 and K9 move 134.7 MB (40 us), K8 179.5 MB (54
// us), K10 224 MB (67 us). K9/K10's Philox (two calls per 8 elements) is what
// K3 spends on the same count.
//
// Design, right and simple first: one warp per row, each lane holding its
// 8-element chunks (three 16-byte loads a tensor at H = 768 in bf16) in
// registers; the row sums are warp shuffles, so the forward needs no shared
// memory. The backward runs a grid of BWD_BLOCKS_PER_SM blocks per SM that
// loops over rows; each warp keeps its dscale/dbias partials in registers,
// the block adds its warps' partials in warp order in shared memory and
// writes one fp32 partial row, and a second kernel sums the partial rows in a
// fixed order: deterministic, no atomics (as K2's qkv-bias gradient). Its
// launch bounds cap it at 128 registers so that 16 warps an SM are resident
// (a few spilled words): at 147 registers only 8 fit, and K10, whose Philox
// work needs warps in flight to hide, took 1.7x as long on an H100. Small
// blocks (4 warps) keep a block of the previous launch that still runs on an
// SM from taking half of it.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

enum LnDtype { kBf16 = 0, kFp16 = 1, kFp32 = 2 };
constexpr int WARPS = 4;          // rows in flight per block
constexpr int BWD_BLOCKS_PER_SM = 4;  // the backward's grid and launch bounds
constexpr int MAX_CHUNKS = 4;     // 8-element chunks per lane: H <= 32 * 8 * 4 = 1024
constexpr int REDUCE_ROWS = 16;    // thread rows of the partial-row sum

struct LnArgs {
  const void* x;
  const void* res;
  const float* scale;
  const float* bias;   // forward only
  const void* dy;      // backward only
  float* mu;
  float* rstd;
  void* y;             // forward: y; backward: dx
  void* dres;          // backward: dres, or null (K8 returns dx for both inputs)
  float* part;         // backward: [gridDim.x, 2, H] partial dscale, dbias
  int N;
  int H;
  float eps;
  uint32_t seed;
  uint32_t threshold;
  float keep_prob;     // 1 - rate
};

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const __half* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __half22float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(__half* p, const float* v) {
  uint4 u;
  __half2* h = reinterpret_cast<__half2*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2half2_rn(v[2 * k], v[2 * k + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ float warp_sum(float v) {
  // butterfly: every lane ends with the same value
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Bit k set when element e0 + k is kept; e0 is a multiple of 8, so the 8
// elements are words 0-3 of Philox at counters e0 / 4 and e0 / 4 + 1.
__device__ __forceinline__ unsigned keep_bits(long long e0, uint32_t seed, uint32_t threshold) {
  unsigned bits = 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const unsigned long long q = (unsigned long long)(e0 >> 2) + h;
    const uint4 r = vb::philox4x32_10(make_uint4((uint32_t)q, (uint32_t)(q >> 32), 0u, 1u), make_uint2(seed, 0u));
    bits |= ((unsigned)(r.x >= threshold) | (unsigned)(r.y >= threshold) << 1 |
             (unsigned)(r.z >= threshold) << 2 | (unsigned)(r.w >= threshold) << 3) << (4 * h);
  }
  return bits;
}

// s = where(keep, x / keep_prob, 0) + res for the 8 elements at `off`;
// returns the keep bits (all set without dropout).
template <typename T, bool DROPOUT>
__device__ __forceinline__ unsigned residual8(const LnArgs& a, long long off, float* s) {
  float xv[8], rv[8];
  load8(static_cast<const T*>(a.x) + off, xv);
  load8(static_cast<const T*>(a.res) + off, rv);
  const unsigned kb = DROPOUT ? keep_bits(off, a.seed, a.threshold) : 0xffu;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float v = DROPOUT ? ((kb >> k & 1u) ? xv[k] / a.keep_prob : 0.f) : xv[k];
    s[k] = v + rv[k];
  }
  return kb;
}

template <typename T, int NC, bool DROPOUT>
__global__ void __launch_bounds__(WARPS * 32) ln_fwd_kernel(const LnArgs a) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= a.N) return;  // the whole warp
  const int chunks = a.H >> 3;
  float s[NC][8];
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int ch = lane + 32 * c;
    if (ch < chunks) {
      residual8<T, DROPOUT>(a, row * a.H + ch * 8, s[c]);
#pragma unroll
      for (int k = 0; k < 8; ++k) sum += s[c][k];
    }
  }
  const float mu = warp_sum(sum) / a.H;
  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (lane + 32 * c < chunks) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float d = s[c][k] - mu;
        sq += d * d;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / a.H + a.eps);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int ch = lane + 32 * c;
    if (ch < chunks) {
      float sc[8], bi[8], out[8];
      load8(a.scale + ch * 8, sc);
      load8(a.bias + ch * 8, bi);
#pragma unroll
      for (int k = 0; k < 8; ++k) out[k] = (s[c][k] - mu) * rstd * sc[k] + bi[k];
      store8(static_cast<T*>(a.y) + row * a.H + ch * 8, out);
    }
  }
  if (lane == 0) {
    a.mu[row] = mu;
    a.rstd[row] = rstd;
  }
}

template <typename T, int NC, bool DROPOUT>
__global__ void __launch_bounds__(WARPS * 32, BWD_BLOCKS_PER_SM) ln_bwd_kernel(const LnArgs a) {
  extern __shared__ float red[];  // [2, H]: the block's dscale, dbias
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunks = a.H >> 3;
  float gs[NC][8], gb[NC][8];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int k = 0; k < 8; ++k) gs[c][k] = gb[c][k] = 0.f;

  for (long long row = (long long)blockIdx.x * WARPS + warp; row < a.N; row += (long long)gridDim.x * WARPS) {
    const float m = a.mu[row], r = a.rstd[row];
    float xh[NC][8], g[NC][8];
    unsigned kb[NC];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int ch = lane + 32 * c;
      if (ch < chunks) {
        const long long off = row * a.H + ch * 8;
        float s[8], dy[8], sc[8];
        kb[c] = residual8<T, DROPOUT>(a, off, s);
        load8(static_cast<const T*>(a.dy) + off, dy);
        load8(a.scale + ch * 8, sc);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          xh[c][k] = (s[k] - m) * r;
          g[c][k] = dy[k] * sc[k];
          s1 += g[c][k];
          s2 += g[c][k] * xh[c][k];
          gs[c][k] += dy[k] * xh[c][k];
          gb[c][k] += dy[k];
        }
      }
    }
    const float m1 = warp_sum(s1) / a.H, m2 = warp_sum(s2) / a.H;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int ch = lane + 32 * c;
      if (ch < chunks) {
        const long long off = row * a.H + ch * 8;
        float ds[8], dx[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          ds[k] = r * (g[c][k] - m1 - xh[c][k] * m2);
          dx[k] = DROPOUT ? ((kb[c] >> k & 1u) ? ds[k] / a.keep_prob : 0.f) : ds[k];
        }
        store8(static_cast<T*>(a.y) + off, dx);
        if (a.dres != nullptr) store8(static_cast<T*>(a.dres) + off, ds);
      }
    }
  }

  // the block's partial row: its warps' partials added in warp order
  for (int w = 0; w < WARPS; ++w) {
    if (warp == w) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int ch = lane + 32 * c;
        if (ch < chunks) {
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const int i = ch * 8 + k;
            red[i] = (w == 0 ? 0.f : red[i]) + gs[c][k];
            red[a.H + i] = (w == 0 ? 0.f : red[a.H + i]) + gb[c][k];
          }
        }
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < 2 * a.H; i += blockDim.x) a.part[(long long)blockIdx.x * 2 * a.H + i] = red[i];
}

// dscale, dbias: the P partial rows summed in a fixed order. A block owns 32
// columns; its REDUCE_ROWS thread rows each sum every REDUCE_ROWS-th partial
// row, then their sums are added in thread-row order.
__global__ void __launch_bounds__(32 * REDUCE_ROWS) ln_bwd_reduce_kernel(const float* __restrict__ part, int P, int H,
                                                                        float* __restrict__ dscale,
                                                                        float* __restrict__ dbias) {
  __shared__ float sums[REDUCE_ROWS][32];
  const int i = blockIdx.x * 32 + threadIdx.x;
  float acc = 0.f;
  if (i < 2 * H)
    for (int p = threadIdx.y; p < P; p += REDUCE_ROWS) acc += part[(long long)p * 2 * H + i];
  sums[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y != 0 || i >= 2 * H) return;
  acc = 0.f;
#pragma unroll
  for (int r = 0; r < REDUCE_ROWS; ++r) acc += sums[r][threadIdx.x];
  if (i < H)
    dscale[i] = acc;
  else
    dbias[i - H] = acc;
}

// Calls L<T, NC>::run(args...) with NC = the lanes' chunk count for H.
template <template <typename, int> class L, typename T, typename... Args>
int dispatch_nc(int H, Args... args) {
  switch ((H + 255) / 256) {
    case 1: L<T, 1>::run(args...); break;
    case 2: L<T, 2>::run(args...); break;
    case 3: L<T, 3>::run(args...); break;
    case 4: L<T, 4>::run(args...); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

template <typename T, int NC>
struct Fwd {
  static void run(const LnArgs& a, bool dropout, cudaStream_t st) {
    const unsigned blocks = (unsigned)((a.N + WARPS - 1) / WARPS);
    if (dropout)
      ln_fwd_kernel<T, NC, true><<<blocks, WARPS * 32, 0, st>>>(a);
    else
      ln_fwd_kernel<T, NC, false><<<blocks, WARPS * 32, 0, st>>>(a);
  }
};

template <typename T, int NC>
struct Bwd {
  static void run(const LnArgs& a, int P, bool dropout, cudaStream_t st) {
    const size_t smem = 2 * (size_t)a.H * sizeof(float);
    if (dropout)
      ln_bwd_kernel<T, NC, true><<<P, WARPS * 32, smem, st>>>(a);
    else
      ln_bwd_kernel<T, NC, false><<<P, WARPS * 32, smem, st>>>(a);
  }
};

template <template <typename, int> class L, typename... Args>
int dispatch(int dtype, int H, Args... args) {
  if (H <= 0 || H % 8 || H > 32 * 8 * MAX_CHUNKS) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case kBf16: return dispatch_nc<L, __nv_bfloat16>(H, args...);
    case kFp16: return dispatch_nc<L, __half>(H, args...);
    case kFp32: return dispatch_nc<L, float>(H, args...);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// What the wrapper needs to check inputs and size the backward's grid and
// partials: 0 the widest row the kernels take, 1 the rows (warps) of a
// block, 2 the backward's blocks per SM.
extern "C" int vb_ln_geometry(int which) {
  const int g[3] = {32 * 8 * MAX_CHUNKS, WARPS, BWD_BLOCKS_PER_SM};
  return which >= 0 && which < 3 ? g[which] : -1;
}

// K7 (dropout = 0) and K9 (dropout = 1): y, mu, rstd.
extern "C" int vb_ln_fwd(const void* x, const void* res, const void* scale, const void* bias, void* y, void* mu,
                         void* rstd, int N, int H, int dtype, float eps, int dropout, unsigned int seed,
                         unsigned int threshold, float keep_prob, void* stream) {
  LnArgs a{};
  a.x = x; a.res = res; a.scale = static_cast<const float*>(scale); a.bias = static_cast<const float*>(bias);
  a.y = y; a.mu = static_cast<float*>(mu); a.rstd = static_cast<float*>(rstd);
  a.N = N; a.H = H; a.eps = eps; a.seed = seed; a.threshold = threshold; a.keep_prob = keep_prob;
  const int code = dispatch<Fwd>(dtype, H, a, dropout != 0, static_cast<cudaStream_t>(stream));
  if (code != 0) return code;
  return (int)cudaGetLastError();
}

// K8 (dropout = 0, dres may be null) and K10 (dropout = 1): dx, dres, and
// dscale, dbias through P partial rows in `part` ([P, 2, H] fp32).
extern "C" int vb_ln_bwd(const void* x, const void* res, const void* scale, const void* mu, const void* rstd,
                         const void* dy, void* dx, void* dres, void* part, void* dscale, void* dbias, int N, int H,
                         int P, int dtype, int dropout, unsigned int seed, unsigned int threshold, float keep_prob,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  LnArgs a{};
  a.x = x; a.res = res; a.scale = static_cast<const float*>(scale); a.dy = dy;
  a.mu = const_cast<float*>(static_cast<const float*>(mu)); a.rstd = const_cast<float*>(static_cast<const float*>(rstd));
  a.y = dx; a.dres = dres; a.part = static_cast<float*>(part);
  a.N = N; a.H = H; a.seed = seed; a.threshold = threshold; a.keep_prob = keep_prob;
  if (P < 1) return (int)cudaErrorInvalidValue;
  const int code = dispatch<Bwd>(dtype, H, a, P, dropout != 0, st);
  if (code != 0) return code;
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ln_bwd_reduce_kernel<<<(2 * H + 31) / 32, dim3(32, REDUCE_ROWS), 0, st>>>(
      static_cast<const float*>(part), P, H, static_cast<float*>(dscale), static_cast<float*>(dbias));
  return (int)cudaGetLastError();
}
