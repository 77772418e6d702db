// K4, K5, K6 in fp32: the fused masked-LM softmax cross-entropy over the
// tied decoder on fp32 x and E, at any hidden width H <= 1024. Replace, for
// fp32 inputs, visualbert_tpu/ops/mlm_xent.py::_fwd_kernel (K4, :52),
// ::_dx_kernel (K5, :145) and ::_de_kernel (K6, :170).
//
// Function: mlm_xent.cu's contract in fp32. x [N, H], E [V, H], bias [V]
// and labels [N] int32 in [0, V); logits = x.E^T + bias with fp32 products
// and sums. The forward writes nll = lse - logits[label], lse and the
// first-max argmax; the backward, given lse and the cotangent g [N],
//   dx = g * ((p - onehot) . E)       [N, H]
//   dE = (g (p - onehot))^T . x       [V, H]
//   db = sum_rows g (p - onehot)      [V]
// with p = exp(logits - lse). No [N, V] tensor reaches device memory.
//
// Bound on the H100 at the main path's N = 3072, V = 30522, H = 768: one
// (K4) or two (K5, K6) N x V x H products of 144 GFLOP each, 2.1 / 4.3 ms at
// the 67 TFLOP/s of fp32 outside the tensor cores (E's 94 MB are 0.03 ms at
// 3.35 TB/s). wgmma's TF32 keeps a 10-bit mantissa and would not meet
// fp32's tolerance: these kernels are SIMT.
//
// Design (simple and right first; its speed is later work): one kernel on
// three roles. A block of 256 threads keeps 16 RESIDENT rows (K4, K5: of x;
// K6: of E) in shared memory and walks the STREAMED matrix (K4, K5: E; K6:
// x) in tiles of 32 rows, each row padded to H + 1 floats so that a thread
// reading its own row meets no bank conflict. Thread t owns resident row t /
// 16: for the logits, streamed rows t % 16 and t % 16 + 16 of the tile (H
// fused multiply-adds each); for K5/K6's second product, result columns t %
// 16 + 16 k, from the tile's 16 x 32 dlog in shared memory. Every result
// element is one thread's sum in streamed order, so nothing is split, no
// partial is merged and there are no atomics: two calls agree bit for bit.
// K4 keeps per thread an online (max, sum of exp, label logit, best value,
// best index) over its columns, which ascend (strict > keeps the first
// maximum); the 16 threads of a row merge in a fixed butterfly, the lower
// index winning on equal values.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NTH = 256;
constexpr int RR = 16;            // resident rows a block
constexpr int TR = 32;            // streamed rows a tile
constexpr int MAX_H = 1024;
constexpr int MAX_K = MAX_H / 16;  // result columns a thread (K5, K6)

enum Role { FWD = 0, DX = 1, DE = 2 };

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

size_t smem_bytes(int H) { return sizeof(float) * ((size_t)(RR + TR) * (H + 1) + RR * TR + 3 * TR); }

// rows [r0, r0 + n) of a [nvalid, H] matrix into dst (row stride H + 1);
// rows past nvalid are zero.
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, int r0, int n, int nvalid, int H) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < n; r += NTH / 32) {
    const int row = r0 + r;
    for (int k = lane; k < H; k += 32) dst[r * (H + 1) + k] = row < nvalid ? src[(size_t)row * H + k] : 0.f;
  }
}

__device__ __forceinline__ void lse_merge(float& m, float& l, float m2, float l2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;
  l = (m == -INFINITY ? 0.f : l * expf(m - mn)) + (m2 == -INFINITY ? 0.f : l2 * expf(m2 - mn));
  m = mn;
}

__device__ __forceinline__ void argmax_merge(float& bv, int& bi, float v2, int i2) {
  if (v2 > bv || (v2 == bv && i2 < bi)) {
    bv = v2;
    bi = i2;
  }
}

// grid: cdiv(N, 16) blocks (K4, K5) or cdiv(V, 16) (K6).
template <int ROLE>
__global__ void __launch_bounds__(NTH)
xent_f32_kernel(const float* __restrict__ x, const float* __restrict__ E, const float* __restrict__ bias,
                const int* __restrict__ labels, const float* __restrict__ lse_in, const float* __restrict__ gr, int N,
                int V, int H, float* __restrict__ nll, float* __restrict__ lse_out, int* __restrict__ am,
                float* __restrict__ out, float* __restrict__ db) {
  extern __shared__ float smem[];
  float* Rs = smem;                        // [RR][H + 1] resident rows
  float* Ss = Rs + RR * (H + 1);           // [TR][H + 1] streamed tile
  float* Ds = Ss + TR * (H + 1);           // [RR][TR] the tile's dlog
  float* cv = Ds + RR * TR;                // [3][TR] the streamed rows' values
  const int tid = threadIdx.x, r = tid / 16, j0 = tid % 16;
  const int r0 = blockIdx.x * RR, row = r0 + r;
  const int nres = ROLE == DE ? V : N, nstr = ROLE == DE ? N : V;
  const float* res = ROLE == DE ? E : x;
  const float* str = ROLE == DE ? x : E;
  load_rows(Rs, res, r0, RR, nres, H);
  // this thread's resident row: K4/K5 its label and lse; K6 its bias
  const bool rok = row < nres;
  const int rlab = ROLE != DE && rok ? labels[row] : -1;
  const float rv = !rok ? 0.f : ROLE == DE ? bias[row] : ROLE == DX ? lse_in[row] : 0.f;
  const int nk = cdiv(H, 16);

  float acc[MAX_K];
#pragma unroll
  for (int k = 0; k < MAX_K; ++k) acc[k] = 0.f;
  float m = -INFINITY, l = 0.f, ll = 0.f, bv = -INFINITY, dsum = 0.f;
  int bi = INT_MAX;

  for (int t0 = 0; t0 < nstr; t0 += TR) {
    __syncthreads();  // every thread is done with the last tile
    load_rows(Ss, str, t0, TR, nstr, H);
    if (tid < TR) {
      const int j = t0 + tid;
      const bool ok = j < nstr;
      if (ROLE == DE) {
        cv[tid] = ok ? lse_in[j] : 0.f;
        cv[TR + tid] = __int_as_float(ok ? labels[j] : -1);
        cv[2 * TR + tid] = ok ? gr[j] : 0.f;
      } else {
        cv[tid] = ok ? bias[j] : 0.f;
      }
    }
    __syncthreads();
    float z[2] = {0.f, 0.f};
    for (int k = 0; k < H; ++k) {
      const float a = Rs[r * (H + 1) + k];
      z[0] += a * Ss[j0 * (H + 1) + k];
      z[1] += a * Ss[(j0 + 16) * (H + 1) + k];
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int jj = j0 + 16 * e, j = t0 + jj;
      if (ROLE == FWD) {
        if (j < nstr) {
          const float v = z[e] + cv[jj];
          if (j == rlab) ll = v;
          if (v > bv) {
            bv = v;
            bi = j;
          }
          lse_merge(m, l, v, 1.f);
        }
      } else if (ROLE == DX) {
        Ds[r * TR + jj] = j < nstr && rok ? expf(z[e] + cv[jj] - rv) - (j == rlab ? 1.f : 0.f) : 0.f;
      } else {
        const int lab = __float_as_int(cv[TR + jj]);
        const float d = j < nstr && rok ? (expf(z[e] + rv - cv[jj]) - (lab == row ? 1.f : 0.f)) * cv[2 * TR + jj] : 0.f;
        Ds[r * TR + jj] = d;
        dsum += d;
      }
    }
    if (ROLE != FWD) {
      __syncthreads();  // the tile's dlog is whole
      const int nj = min(TR, nstr - t0);
      for (int jj = 0; jj < nj; ++jj) {
        const float d = Ds[r * TR + jj];
        const float* srow = Ss + jj * (H + 1);
#pragma unroll
        for (int k = 0; k < MAX_K; ++k)
          if (k < nk && j0 + 16 * k < H) acc[k] += d * srow[j0 + 16 * k];
      }
    }
  }

  if (ROLE == FWD) {
    // the 16 threads of a row: lanes of one half-warp, merged in a fixed butterfly
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, off), l2 = __shfl_xor_sync(0xffffffffu, l, off);
      const float ll2 = __shfl_xor_sync(0xffffffffu, ll, off), v2 = __shfl_xor_sync(0xffffffffu, bv, off);
      const int i2 = __shfl_xor_sync(0xffffffffu, bi, off);
      lse_merge(m, l, m2, l2);
      ll += ll2;
      argmax_merge(bv, bi, v2, i2);
    }
    if (j0 == 0 && rok) {
      const float zz = m + logf(l);
      lse_out[row] = zz;
      nll[row] = zz - ll;
      am[row] = bi;
    }
    return;
  }
  if (rok) {
    const float scale = ROLE == DX ? gr[row] : 1.f;
#pragma unroll
    for (int k = 0; k < MAX_K; ++k)
      if (k < nk && j0 + 16 * k < H) out[(size_t)row * H + j0 + 16 * k] = acc[k] * scale;
  }
  if (ROLE == DE) {
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) dsum += __shfl_xor_sync(0xffffffffu, dsum, off);
    if (j0 == 0 && rok) db[row] = dsum;
  }
}

const void* kernel_of(int kernel) {
  switch (kernel) {
    case 0: return (const void*)xent_f32_kernel<DX>;
    case 1: return (const void*)xent_f32_kernel<DE>;
    case 2: return (const void*)xent_f32_kernel<FWD>;
    default: return nullptr;
  }
}

template <int ROLE>
int launch(int blocks, const float* x, const float* E, const float* bias, const int* labels, const float* lse,
           const float* g, int N, int V, int H, float* nll, float* lse_out, int* am, float* out, float* db,
           void* stream) {
  if (H < 1 || H > MAX_H) return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(H);
  cudaError_t err = cudaFuncSetAttribute(xent_f32_kernel<ROLE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  if (blocks > 0)
    xent_f32_kernel<ROLE><<<blocks, NTH, bytes, static_cast<cudaStream_t>(stream)>>>(
        x, E, bias, labels, lse, g, N, V, H, nll, lse_out, am, out, db);
  return (int)cudaGetLastError();
}

}  // namespace

// K5 (kernel 0), K6 (kernel 1) or K4 (kernel 2) at width H: `what` 0 its
// registers a thread, 1 its local (spill) bytes a thread, 2 its dynamic
// shared memory, 3 its resident blocks per SM. -1 on an error.
extern "C" int vb_xent_f32_info(int kernel, int what, int H) {
  const void* fn = kernel_of(kernel);
  if (fn == nullptr || H < 1 || H > MAX_H) return -1;
  const size_t bytes = smem_bytes(H);
  if (what == 0 || what == 1) {
    cudaFuncAttributes attr;
    if (cudaFuncGetAttributes(&attr, fn) != cudaSuccess) return -1;
    return what == 0 ? attr.numRegs : (int)attr.localSizeBytes;
  }
  if (what == 2) return (int)bytes;
  if (what == 3) {
    int n = 0;
    if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes) != cudaSuccess) return -1;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, NTH, bytes) != cudaSuccess) return -1;
    return n;
  }
  return -1;
}

extern "C" int vb_xent_f32_fwd(const void* x, const void* E, const void* bias, const void* labels, int N, int V,
                               int H, void* nll, void* lse, void* am, void* stream) {
  return launch<FWD>(cdiv(N, RR), static_cast<const float*>(x), static_cast<const float*>(E),
                     static_cast<const float*>(bias), static_cast<const int*>(labels), nullptr, nullptr, N, V, H,
                     static_cast<float*>(nll), static_cast<float*>(lse), static_cast<int*>(am), nullptr, nullptr,
                     stream);
}

extern "C" int vb_xent_f32_dx(const void* x, const void* E, const void* bias, const void* labels, const void* lse,
                              const void* g, int N, int V, int H, void* dx, void* stream) {
  return launch<DX>(cdiv(N, RR), static_cast<const float*>(x), static_cast<const float*>(E),
                    static_cast<const float*>(bias), static_cast<const int*>(labels), static_cast<const float*>(lse),
                    static_cast<const float*>(g), N, V, H, nullptr, nullptr, nullptr, static_cast<float*>(dx),
                    nullptr, stream);
}

extern "C" int vb_xent_f32_de(const void* x, const void* E, const void* bias, const void* labels, const void* lse,
                              const void* g, int N, int V, int H, void* dE, void* db, void* stream) {
  return launch<DE>(cdiv(V, RR), static_cast<const float*>(x), static_cast<const float*>(E),
                    static_cast<const float*>(bias), static_cast<const int*>(labels), static_cast<const float*>(lse),
                    static_cast<const float*>(g), N, V, H, nullptr, nullptr, nullptr, static_cast<float*>(dE),
                    static_cast<float*>(db), stream);
}
