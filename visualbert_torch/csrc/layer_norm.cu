// K7, K8, K9, K10: the residual add + LayerNorm epilogue of every
// transformer sublayer, with and without dropout. Replace
// visualbert_tpu/ops/layer_norm.py::_fwd_kernel (K7, :28) and ::_bwd_kernel
// (K8, :40) of fused_add_layer_norm, ::_dfwd_kernel (K9, :171) and
// ::_dbwd_kernel (K10, :189) of fused_dropout_add_layer_norm.
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
// 1), key = (seed, 0)) >= threshold. K9 draws it and also writes it out,
// one bit an element: bits [N, H / 8] uint8, bit k of byte j of row n for
// element (n, 8 j + k). K10 reads those bits and draws nothing; the JAX
// kernel regenerates its mask from the seed, and the function is the same
// because the bits are. The plain versions (ops/layer_norm.py) draw the same
// mask from ops/philox.py and pack it the same way.
//
// Bound on the H100: device memory. Each element costs 10-20 fp32
// operations against 6 (K7, K9), 8 (K8) or 10 (K10) bytes moved at bf16;
// the card does 67 TFLOP/s of fp32 outside the tensor cores against 3.35
// TB/s, so the bytes bound every kernel by far. At the main path's N = 128 *
// 228 = 29,184 rows and H = 768 the JAX functions move: K7 and K9 134.7 MB
// (40 us), K8 179.5 MB (54 us), K10 224 MB (67 us). The keep bits add 2.8 MB
// to K9's writes and K10's reads (2 %).
//
// Forward (K7, K9): one warp per row, each lane holding its 8-element
// chunks (three 16-byte loads a tensor at H = 768 in bf16) in registers; the
// row sums are warp shuffles, so it needs no shared memory. K9 adds one byte
// store a chunk (its 8 keep bits) after its other stores: a byte store may
// alias the loads, and inside the load loop it held each chunk's loads back
// behind the previous chunk's Philox calls. K7's code has no such store.
//
// Backward (K8, K10), the Hopper design. The first design (one warp a row
// walking its rows with plain loads, two Philox calls a lane chunk drawing
// K10's mask again, 128 registers with a few spilled) read 0.14 ms for K10
// at the main path's shape, twice its bound: no bytes were in flight while a
// warp computed, and the Philox work needed warps in flight to hide it.
// - No Philox. K10 reads K9's bits (one byte a lane chunk) where the first
//   design made 5.6 M philox4x32_10 calls a launch. Built with
//   VB_LN_REGEN_MASK (for tools/ln_steps.py only) K10 draws them again from
//   the seed: the same bits, so the same results.
// - A ring of row copies. A block's grid-stride loop gives each warp its
//   own rows; each warp owns STAGES ring stages in shared memory, each one
//   row's x, res and dy, its mu and rstd and its keep bits. While a warp
//   computes row i, the copies of rows i + 1 .. i + STAGES - 1 are in flight
//   (cp.async: 16 bytes a lane for the rows, 4 for mu, rstd and the bits'
//   words; one commit group a row). A bits row is H / 8 bytes, a 16-byte
//   multiple only when H % 128 == 0, and starts at any byte offset; the warp
//   copies the 4-byte words that cover it (the last one cut at the tensor's
//   end) and reads each lane's byte at its offset. Each lane copies and
//   reads its own chunks of x, res and dy; the bits, mu and rstd cross lanes,
//   so a __syncwarp follows each wait and precedes each refill. By Little's
//   law the card needs 3.35 TB/s x ~1 us over 132 SMs, ~25 KB in flight an
//   SM; at H = 768 bf16 a stage holds 4.7 KB and each of an SM's 12 warps
//   keeps two ahead (~113 KB). Built with VB_LN_SYNC_LOADS (for
//   tools/ln_steps.py only) every copy is a plain load and store: the same
//   results, nothing in flight across rows. VB_LN_STAGES sets the depth.
// - Arithmetic. The division by 1 - rate is a product by its reciprocal
//   and one fma correction (div_by), which rounds as the division does, in
//   place of a reciprocal, its refinement and a range check with a branch
//   for every element.
// - Registers, no cap. A lane keeps its dscale/dbias partials (2 x 8 x NC
//   fp32: 48 at H = 768) and the row's xhat (8 x NC: 24) across the row's
//   two passes; g = dy * scale is recomputed in the second pass from the
//   staged dy and the block's copy of scale in shared memory. At H = 768 in
//   bf16 that is 128 registers (K8 119), no spill; with 59.9 KB of shared
//   memory a block, 3 blocks (12 warps) fit an SM. A 2- or 4-stage ring (4
//   or 2 blocks an SM) reads the same (tools/ln_steps.py).
// - Determinism, no atomics: each warp keeps its partials in registers, the
//   block adds its warps' partials in warp order in shared memory (over the
//   drained ring) and writes one fp32 partial row; a second kernel sums the
//   partial rows in a fixed order. The grid is the blocks that fit on the
//   card at once (vb_ln_info(kernel, 3, ...) x the SMs), so the partial-row
//   count is fixed for a given card and shape and repeats are bit for bit.
//   Small blocks (4 warps) keep a block of the previous launch that still
//   runs on an SM from taking a large share of it.
//
// Any width (the JAX kernels take any H as one row block). The design above
// takes H a multiple of 8 up to 1024 (its 16-byte loads need 16-byte rows;
// 32 lanes x 8 elements x MAX_CHUNKS), and those widths keep it and its
// machine code. Every other width up to MAX_WIDTH = 4096 (ALBERT-xxlarge's
// hidden width) runs the any-width pair (ln_fwd_any_kernel,
// ln_bwd_any_kernel), a first design that is right and simple:
// - H not a multiple of 8 up to 1024: a warp a row as above, each lane's
//   8-element chunks loaded and stored element by element with the row's
//   tail masked (rows are not 16-byte aligned, so the wrapper does not ask
//   for alignment); K9's keep bits are ceil(H / 8) bytes a row, byte j for
//   elements 8 j .. 8 j + 7 of the row, the tail's high bits 0, and each
//   chunk draws the Philox calls that cover its elements (up to three: a
//   chunk starts at any element of the flattened tensor).
// - H above 1024: the block's 4 warps own a row (ANY_CHUNKS chunks a
//   thread, the row sums through shared memory in warp order), with 16-byte
//   loads when H is a multiple of 8 and element loads otherwise.
// - The backward walks its rows with plain loads (no ring); each thread
//   keeps its chunks' dscale/dbias partials, the block writes one partial
//   row ([2, H] fp32: the warps' partials added in warp order when a warp
//   owns a row, each thread's own columns when the block does) and the
//   reduce pass sums the rows in a fixed order, as above.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "once_a_device.cuh"
#include "philox.cuh"

#ifndef VB_LN_STAGES
#define VB_LN_STAGES 3
#endif

namespace {

enum LnDtype { kBf16 = 0, kFp16 = 1, kFp32 = 2 };
constexpr int WARPS = 4;          // rows in flight per block (forward); warps per block (both)
constexpr int STAGES = VB_LN_STAGES;  // the backward's ring stages a warp
constexpr int MAX_CHUNKS = 4;     // 8-element chunks per lane: H <= 32 * 8 * 4 = 1024
constexpr int REDUCE_ROWS = 16;    // thread rows of the partial-row sum
constexpr int WARP_WIDTH = 32 * 8 * MAX_CHUNKS;  // the widest row a warp owns: 1024
constexpr int ANY_CHUNKS = 4;     // 8-element chunks a thread in the any-width forms
constexpr int MAX_WIDTH = WARPS * 32 * 8 * ANY_CHUNKS;  // the widest row: 4096
static_assert(STAGES >= 2, "the ring needs a stage to compute and one in flight");

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
  uint8_t* bits;       // [N, H / 8] keep bits: K9 writes them, K10 reads them
};

// Bytes of one backward ring stage: x, res, dy rows in the input dtype, mu
// and rstd (16 bytes), and with dropout the 4-byte words that cover a keep-bit
// row (H / 8 bytes at a byte offset of up to 3), rounded up to 16.
__host__ __device__ constexpr int stage_bytes(int H, int elt, bool dropout) {
  return 3 * H * elt + 16 + (dropout ? (H / 8 + 8 + 15) / 16 * 16 : 0);
}

// Dynamic shared memory of a backward block: scale [H] fp32 and the warps'
// rings (at least 4 x 2 x 6 H bytes, so the drained ring holds the block's
// [2, H] fp32 partials).
__host__ __device__ constexpr int bwd_smem_bytes(int H, int elt, bool dropout) {
  return 4 * H + WARPS * STAGES * stage_bytes(H, elt, dropout);
}

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
  unsigned kb[NC];
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int ch = lane + 32 * c;
    if (ch < chunks) {
      kb[c] = residual8<T, DROPOUT>(a, row * a.H + ch * 8, s[c]);
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
  if (DROPOUT) {
    // K9's keep bits, for K10: stored last, since a byte store may alias
    // the loads above and would hold back those that follow it
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int ch = lane + 32 * c;
      if (ch < chunks) a.bits[row * chunks + ch] = (uint8_t)kb[c];
    }
  }
  if (lane == 0) {
    a.mu[row] = mu;
    a.rstd[row] = rstd;
  }
}

// x / kp rounded as an IEEE division, given rcp = 1 / kp rounded: the
// product and Markstein's correction (the remainder is exact in an fma; for
// a correctly rounded rcp the result is the correctly rounded quotient
// outside the subnormal and overflow ranges). Three instructions where a
// division is a reciprocal, its refinement and a range check with a branch.
__device__ __forceinline__ float div_by(float x, float kp, float rcp) {
  const float q = __fmul_rn(x, rcp);
  return __fmaf_rn(__fmaf_rn(-q, kp, x), rcp, q);
}

// ------------------------------------------------ the backward's row copies

// cp16 copies 16 bytes, cp4 the first n (1-4) of 4 bytes and zeros the rest;
// each lane commits one group a row. Built with VB_LN_SYNC_LOADS a copy is a
// plain load and store that has landed when it returns, and commit and wait
// do nothing.
#ifdef VB_LN_SYNC_LOADS
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  *static_cast<uint4*>(dst) = *static_cast<const uint4*>(src);
}
__device__ __forceinline__ void cp4(void* dst, const void* src, int n) {
  uint8_t* d = static_cast<uint8_t*>(dst);
  const uint8_t* s = static_cast<const uint8_t*>(src);
  if (n == 4) {
    *reinterpret_cast<uint32_t*>(d) = *reinterpret_cast<const uint32_t*>(s);
    return;
  }
  for (int b = 0; b < 4; ++b) d[b] = b < n ? s[b] : 0;
}
__device__ __forceinline__ void cp_commit() {}
template <int N>
__device__ __forceinline__ void cp_wait() {}
#else
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"((uint32_t)__cvta_generic_to_shared(dst)),
               "l"(__cvta_generic_to_global(src))
               : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"((uint32_t)__cvta_generic_to_shared(dst)),
               "l"(__cvta_generic_to_global(src)), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
#endif

// Where a backward ring stage keeps each piece of its row.
template <typename T>
struct Stage {
  uint8_t* base;
  int H;
  __device__ __forceinline__ T* x() const { return reinterpret_cast<T*>(base); }
  __device__ __forceinline__ T* res() const { return x() + H; }
  __device__ __forceinline__ T* dy() const { return x() + 2 * H; }
  __device__ __forceinline__ float* stats() const { return reinterpret_cast<float*>(dy() + H); }  // mu, rstd
  __device__ __forceinline__ uint8_t* bits() const { return reinterpret_cast<uint8_t*>(stats() + 4); }
};

// Issue the copies of `row` (when it is a row) into stage `st`, and commit
// them as one group either way, so every lane counts one group a row.
template <typename T, int NC, bool DROPOUT>
__device__ __forceinline__ void issue_row(const LnArgs& a, long long row, const Stage<T>& st, int lane) {
  if (row < a.N) {
    const int chunks = a.H >> 3;
    const T* src[3] = {static_cast<const T*>(a.x), static_cast<const T*>(a.res), static_cast<const T*>(a.dy)};
    T* dst[3] = {st.x(), st.res(), st.dy()};
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int ch = lane + 32 * c;
      if (ch < chunks) {
#pragma unroll
        for (int t = 0; t < 3; ++t)
#pragma unroll
          for (int p = 0; p < (int)sizeof(T) / 2; ++p)  // 8 elements: 16 or 32 bytes
            cp16(dst[t] + ch * 8 + p * (16 / sizeof(T)), src[t] + row * a.H + ch * 8 + p * (16 / sizeof(T)));
      }
    }
    if (lane < 2) cp4(st.stats() + lane, (lane ? a.rstd : a.mu) + row, 4);
#ifndef VB_LN_REGEN_MASK
    if (DROPOUT) {
      // the words covering bytes [row * chunks, (row + 1) * chunks) of the bits
      const long long first = row * chunks, total = (long long)a.N * chunks;
      const long long w0 = first >> 2;
      const int words = (int)(((first + chunks + 3) >> 2) - w0);
      for (int w = lane; w < words; w += 32) {
        const long long at = (w0 + w) * 4;
        cp4(st.bits() + 4 * w, a.bits + at, (int)(total - at < 4 ? total - at : 4));
      }
    }
#endif
  }
  cp_commit();
}

// K8 (DROPOUT false) and K10: dx (and dres), and the block's partial row of
// dscale, dbias. Dynamic shared memory: bwd_smem_bytes(H, sizeof(T), DROPOUT).
template <typename T, int NC, bool DROPOUT>
__global__ void __launch_bounds__(WARPS * 32) ln_bwd_kernel(const LnArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunks = a.H >> 3;
  const int sb = stage_bytes(a.H, sizeof(T), DROPOUT);
  float* sc_s = reinterpret_cast<float*>(smem);     // [H] scale
  uint8_t* ring = smem + 4 * a.H + warp * STAGES * sb;
  const long long stride = (long long)gridDim.x * WARPS;
  const long long first = (long long)blockIdx.x * WARPS + warp;
  const float rcp = 1.f / a.keep_prob;

  // the ring's first STAGES - 1 rows go out before anything waits
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) issue_row<T, NC, DROPOUT>(a, first + k * stride, Stage<T>{ring + k * sb, a.H}, lane);
  for (int i = threadIdx.x; i < a.H; i += blockDim.x) sc_s[i] = a.scale[i];
  __syncthreads();

  float gs[NC][8], gb[NC][8];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int k = 0; k < 8; ++k) gs[c][k] = gb[c][k] = 0.f;

  int s = 0;  // the stage of `row`
  for (long long row = first; row < a.N; row += stride) {
    // refill the stage the previous row left (every lane has passed its
    // closing __syncwarp), then wait for this row's group
    const int fill = s == 0 ? STAGES - 1 : s - 1;
    issue_row<T, NC, DROPOUT>(a, row + (STAGES - 1) * stride, Stage<T>{ring + fill * sb, a.H}, lane);
    cp_wait<STAGES - 1>();
    __syncwarp();
    const Stage<T> st{ring + s * sb, a.H};
    const float m = st.stats()[0], r = st.stats()[1];
    float xh[NC][8];
    unsigned kb[NC];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int ch = lane + 32 * c;
      if (ch < chunks) {
        float xv[8], rv[8], dv[8], sc[8];
        load8(st.x() + ch * 8, xv);
        load8(st.res() + ch * 8, rv);
        load8(st.dy() + ch * 8, dv);
        load8(sc_s + ch * 8, sc);
#ifdef VB_LN_REGEN_MASK
        kb[c] = DROPOUT ? keep_bits(row * a.H + ch * 8, a.seed, a.threshold) : 0xffu;
#else
        // the row's bits start (row * chunks) % 4 bytes into its first word
        kb[c] = DROPOUT ? (unsigned)st.bits()[(int)((row * chunks) & 3) + ch] : 0xffu;
#endif
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float v = DROPOUT ? ((kb[c] >> k & 1u) ? div_by(xv[k], a.keep_prob, rcp) : 0.f) : xv[k];
          xh[c][k] = (v + rv[k] - m) * r;
          const float g = __fmul_rn(dv[k], sc[k]);  // rounded, as the plain version's g
          s1 += g;
          s2 += g * xh[c][k];
          gs[c][k] += dv[k] * xh[c][k];
          gb[c][k] += dv[k];
        }
      }
    }
    const float m1 = warp_sum(s1) / a.H, m2 = warp_sum(s2) / a.H;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int ch = lane + 32 * c;
      if (ch < chunks) {
        const long long off = row * a.H + ch * 8;
        float dv[8], sc[8], ds[8], dx[8];
        load8(st.dy() + ch * 8, dv);
        load8(sc_s + ch * 8, sc);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          ds[k] = r * (__fmul_rn(dv[k], sc[k]) - m1 - xh[c][k] * m2);
          dx[k] = DROPOUT ? ((kb[c] >> k & 1u) ? div_by(ds[k], a.keep_prob, rcp) : 0.f) : ds[k];
        }
        store8(static_cast<T*>(a.y) + off, dx);
        if (a.dres != nullptr) store8(static_cast<T*>(a.dres) + off, ds);
      }
    }
    __syncwarp();  // every lane is done with stage s before it is refilled
    s = s + 1 == STAGES ? 0 : s + 1;
  }

  // the block's partial row over the drained ring: its warps' partials
  // added in warp order
  cp_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem + 4 * a.H);  // [2, H]
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

// ------------------------------------------------------- the any-width forms

__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void from_f(__half* p, float v) { *p = __float2half(v); }
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }

// The n (<= 8) elements at p into v, zeros past n: one 16-byte load (two
// for fp32) with VEC (n == 8 on a 16-byte boundary), else element loads.
template <bool VEC, typename T>
__device__ __forceinline__ void load_n(const T* p, float* v, int n) {
  if (VEC) {
    load8(p, v);
    return;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = k < n ? to_f(p[k]) : 0.f;
}

template <bool VEC, typename T>
__device__ __forceinline__ void store_n(T* p, const float* v, int n) {
  if (VEC) {
    store8(p, v);
    return;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (k < n) from_f(p + k, v[k]);
}

// Bit k set when element e0 + k (k < n) of the flattened tensor is kept:
// word e % 4 of the Philox call at counter e / 4, for the up to three calls
// that cover [e0, e0 + n).
__device__ __forceinline__ unsigned keep_bits_at(long long e0, int n, uint32_t seed, uint32_t threshold) {
  unsigned bits = 0;
  const long long q1 = (e0 + n - 1) >> 2;
  for (long long q = e0 >> 2; q <= q1; ++q) {
    const uint4 r = vb::philox4x32_10(make_uint4((uint32_t)q, (uint32_t)(q >> 32), 0u, 1u), make_uint2(seed, 0u));
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long k = 4 * q + i - e0;
      if (k >= 0 && k < n && w[i] >= threshold) bits |= 1u << k;
    }
  }
  return bits;
}

// The sum of v over the WPR warps that own a row (WPR 1: the warp's shuffle
// sum; else through red[WARPS] in warp order, every thread of the block
// calling it together).
template <int WPR>
__device__ __forceinline__ float row_sum(float v, float* red) {
  v = warp_sum(v);
  if (WPR == 1) return v;
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // the last call's readers are done with red
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  const int w0 = warp / WPR * WPR;
#pragma unroll
  for (int w = 0; w < WPR; ++w) t += red[w0 + w];
  return t;
}

// Where a thread of the any-width forms works: WPR warps own a row, the
// block WARPS / WPR rows; t is the thread's place among its row's threads,
// its chunks t, t + 32 WPR, ...
template <int WPR>
struct AnyPlace {
  int t, group;
  __device__ __forceinline__ AnyPlace()
      : t((threadIdx.x >> 5) % WPR * 32 + (threadIdx.x & 31)), group((threadIdx.x >> 5) / WPR) {}
};

// K7 (DROPOUT false) and K9 at any width: WPR warps a row; VEC with H a
// multiple of 8 (16-byte rows).
template <typename T, bool DROPOUT, bool VEC, int WPR>
__global__ void __launch_bounds__(WARPS * 32) ln_fwd_any_kernel(const LnArgs a) {
  __shared__ float red[WARPS];
  const AnyPlace<WPR> at;
  const long long row = (long long)blockIdx.x * (WARPS / WPR) + at.group;
  if (row >= a.N) return;  // the whole row's warps
  const int chunks = (a.H + 7) >> 3;
  float s[ANY_CHUNKS][8];
  unsigned kb[ANY_CHUNKS];
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < ANY_CHUNKS; ++c) {
    const int ch = at.t + 32 * WPR * c;
    if (ch < chunks) {
      const int n = min(8, a.H - 8 * ch);
      const long long off = row * a.H + ch * 8;
      float xv[8], rv[8];
      load_n<VEC>(static_cast<const T*>(a.x) + off, xv, n);
      load_n<VEC>(static_cast<const T*>(a.res) + off, rv, n);
      kb[c] = DROPOUT ? keep_bits_at(off, n, a.seed, a.threshold) : 0xffu;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float v = DROPOUT ? ((kb[c] >> k & 1u) ? xv[k] / a.keep_prob : 0.f) : xv[k];
        s[c][k] = k < n ? v + rv[k] : 0.f;
        sum += s[c][k];
      }
    }
  }
  const float mu = row_sum<WPR>(sum, red) / a.H;
  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < ANY_CHUNKS; ++c) {
    const int ch = at.t + 32 * WPR * c;
    if (ch < chunks) {
      const int n = min(8, a.H - 8 * ch);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float d = k < n ? s[c][k] - mu : 0.f;
        sq += d * d;
      }
    }
  }
  const float rstd = rsqrtf(row_sum<WPR>(sq, red) / a.H + a.eps);
#pragma unroll
  for (int c = 0; c < ANY_CHUNKS; ++c) {
    const int ch = at.t + 32 * WPR * c;
    if (ch < chunks) {
      const int n = min(8, a.H - 8 * ch);
      float sc[8], bi[8], out[8];
      load_n<VEC>(a.scale + ch * 8, sc, n);
      load_n<VEC>(a.bias + ch * 8, bi, n);
#pragma unroll
      for (int k = 0; k < 8; ++k) out[k] = (s[c][k] - mu) * rstd * sc[k] + bi[k];
      store_n<VEC>(static_cast<T*>(a.y) + row * a.H + ch * 8, out, n);
    }
  }
  if (DROPOUT) {
#pragma unroll
    for (int c = 0; c < ANY_CHUNKS; ++c) {
      const int ch = at.t + 32 * WPR * c;
      if (ch < chunks) a.bits[row * chunks + ch] = (uint8_t)kb[c];
    }
  }
  if (at.t == 0) {
    a.mu[row] = mu;
    a.rstd[row] = rstd;
  }
}

// K8 (DROPOUT false) and K10 at any width: the block's row groups walk rows
// blockIdx.x * (WARPS / WPR) + group, then every gridDim.x * (WARPS / WPR)
// further, with plain loads; dx (and dres), and the block's partial row of
// dscale, dbias. Dynamic shared memory: any_bwd_smem_bytes(H, WPR).
template <typename T, bool DROPOUT, bool VEC, int WPR>
__global__ void __launch_bounds__(WARPS * 32) ln_bwd_any_kernel(const LnArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float red[WARPS];
  const AnyPlace<WPR> at;
  const int chunks = (a.H + 7) >> 3;
  const long long stride = (long long)gridDim.x * (WARPS / WPR);
  const float rcp = 1.f / a.keep_prob;
  float gs[ANY_CHUNKS][8], gb[ANY_CHUNKS][8];
#pragma unroll
  for (int c = 0; c < ANY_CHUNKS; ++c)
#pragma unroll
    for (int k = 0; k < 8; ++k) gs[c][k] = gb[c][k] = 0.f;

  // a block's row groups take the same number of turns when WPR == WARPS
  // (one group), so every thread reaches row_sum's barriers together
  for (long long row = (long long)blockIdx.x * (WARPS / WPR) + at.group; row < a.N; row += stride) {
    const float m = a.mu[row], r = a.rstd[row];
    float xh[ANY_CHUNKS][8];
    unsigned kb[ANY_CHUNKS];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int c = 0; c < ANY_CHUNKS; ++c) {
      const int ch = at.t + 32 * WPR * c;
      if (ch < chunks) {
        const int n = min(8, a.H - 8 * ch);
        const long long off = row * a.H + ch * 8;
        float xv[8], rv[8], dv[8], sc[8];
        load_n<VEC>(static_cast<const T*>(a.x) + off, xv, n);
        load_n<VEC>(static_cast<const T*>(a.res) + off, rv, n);
        load_n<VEC>(static_cast<const T*>(a.dy) + off, dv, n);
        load_n<VEC>(a.scale + ch * 8, sc, n);
        kb[c] = DROPOUT ? (unsigned)a.bits[row * chunks + ch] : 0xffu;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float v = DROPOUT ? ((kb[c] >> k & 1u) ? div_by(xv[k], a.keep_prob, rcp) : 0.f) : xv[k];
          xh[c][k] = k < n ? (v + rv[k] - m) * r : 0.f;
          const float g = __fmul_rn(dv[k], sc[k]);  // rounded, as the plain version's g
          s1 += g;
          s2 += g * xh[c][k];
          gs[c][k] += dv[k] * xh[c][k];
          gb[c][k] += dv[k];
        }
      }
    }
    const float m1 = row_sum<WPR>(s1, red) / a.H, m2 = row_sum<WPR>(s2, red) / a.H;
#pragma unroll
    for (int c = 0; c < ANY_CHUNKS; ++c) {
      const int ch = at.t + 32 * WPR * c;
      if (ch < chunks) {
        const int n = min(8, a.H - 8 * ch);
        const long long off = row * a.H + ch * 8;
        float dv[8], sc[8], ds[8], dx[8];
        load_n<VEC>(static_cast<const T*>(a.dy) + off, dv, n);
        load_n<VEC>(a.scale + ch * 8, sc, n);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          ds[k] = r * (__fmul_rn(dv[k], sc[k]) - m1 - xh[c][k] * m2);
          dx[k] = DROPOUT ? ((kb[c] >> k & 1u) ? div_by(ds[k], a.keep_prob, rcp) : 0.f) : ds[k];
        }
        store_n<VEC>(static_cast<T*>(a.y) + off, dx, n);
        if (a.dres != nullptr) store_n<VEC>(static_cast<T*>(a.dres) + off, ds, n);
      }
    }
  }

  float* part = a.part + (long long)blockIdx.x * 2 * a.H;
  if (WPR == WARPS) {
    // the block owns each row: every thread writes its own columns
#pragma unroll
    for (int c = 0; c < ANY_CHUNKS; ++c) {
      const int ch = at.t + 32 * WPR * c;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int i = ch * 8 + k;
        if (ch < chunks && i < a.H) {
          part[i] = gs[c][k];
          part[a.H + i] = gb[c][k];
        }
      }
    }
    return;
  }
  // the warps' partials added in warp order in shared memory ([2, H] fp32)
  float* acc = reinterpret_cast<float*>(smem);
  const int warp = threadIdx.x >> 5;
  for (int w = 0; w < WARPS; ++w) {
    if (warp == w) {
#pragma unroll
      for (int c = 0; c < ANY_CHUNKS; ++c) {
        const int ch = at.t + 32 * WPR * c;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int i = ch * 8 + k;
          if (ch < chunks && i < a.H) {
            acc[i] = (w == 0 ? 0.f : acc[i]) + gs[c][k];
            acc[a.H + i] = (w == 0 ? 0.f : acc[a.H + i]) + gb[c][k];
          }
        }
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < 2 * a.H; i += blockDim.x) part[i] = acc[i];
}

// The any-width backward's dynamic shared memory: the block's [2, H] fp32
// partial row when warps own rows, none when the block does.
__host__ __device__ constexpr int any_bwd_smem_bytes(int H, int wpr) { return wpr == 1 ? 2 * H * 4 : 0; }

// The form of width H: 0 the vector form (a warp a row, H a multiple of 8
// up to WARP_WIDTH), 1 a warp a row with element loads (other widths up to
// WARP_WIDTH), 2 a block a row with 16-byte loads (H a multiple of 8 above
// WARP_WIDTH), 3 a block a row with element loads; -1 outside 1..MAX_WIDTH.
int width_form(int H) {
  if (H < 1 || H > MAX_WIDTH) return -1;
  if (H <= WARP_WIDTH) return H % 8 ? 1 : 0;
  return H % 8 ? 3 : 2;
}

// Calls L<T, VEC, WPR>::run(args...) for the any-width form f (1-3) of dtype.
template <template <typename, bool, int> class L, typename... Args>
int dispatch_any(int dtype, int f, Args... args) {
#define VB_ANY(T)                                        \
  switch (f) {                                           \
    case 1: return L<T, false, 1>::run(args...);         \
    case 2: return L<T, true, WARPS>::run(args...);      \
    case 3: return L<T, false, WARPS>::run(args...);     \
    default: return (int)cudaErrorInvalidValue;          \
  }
  switch (dtype) {
    case kBf16: VB_ANY(__nv_bfloat16)
    case kFp16: VB_ANY(__half)
    case kFp32: VB_ANY(float)
    default: return (int)cudaErrorInvalidValue;
  }
#undef VB_ANY
}

template <typename T, bool VEC, int WPR>
struct FwdAny {
  static int run(const LnArgs& a, bool dropout, cudaStream_t st) {
    const unsigned blocks = (unsigned)((a.N + WARPS / WPR - 1) / (WARPS / WPR));
    if (dropout)
      ln_fwd_any_kernel<T, true, VEC, WPR><<<blocks, WARPS * 32, 0, st>>>(a);
    else
      ln_fwd_any_kernel<T, false, VEC, WPR><<<blocks, WARPS * 32, 0, st>>>(a);
    return 0;
  }
};

template <typename T, bool VEC, int WPR>
struct BwdAny {
  static int run(const LnArgs& a, int P, bool dropout, cudaStream_t st) {
    const size_t smem = any_bwd_smem_bytes(a.H, WPR);
    if (dropout)
      ln_bwd_any_kernel<T, true, VEC, WPR><<<P, WARPS * 32, smem, st>>>(a);
    else
      ln_bwd_any_kernel<T, false, VEC, WPR><<<P, WARPS * 32, smem, st>>>(a);
    return 0;
  }
};

// One of K7-K10 at width H in an any-width form: as Info below; `what` 4
// the rows a block owns.
template <typename T, bool VEC, int WPR>
struct InfoAny {
  static int run(int kernel, int what, int H) {
    const bool bwd = kernel == 8 || kernel == 10;
    const void* fn = kernel == 7    ? (const void*)ln_fwd_any_kernel<T, false, VEC, WPR>
                     : kernel == 8  ? (const void*)ln_bwd_any_kernel<T, false, VEC, WPR>
                     : kernel == 9  ? (const void*)ln_fwd_any_kernel<T, true, VEC, WPR>
                                    : (const void*)ln_bwd_any_kernel<T, true, VEC, WPR>;
    const int smem = bwd ? any_bwd_smem_bytes(H, WPR) : 0;
    if (what == 0 || what == 1) {
      cudaFuncAttributes attr;
      if (cudaFuncGetAttributes(&attr, fn) != cudaSuccess) return -1;
      return what == 0 ? attr.numRegs : (int)attr.localSizeBytes;
    }
    if (what == 2) return smem;
    if (what == 4) return WARPS / WPR;
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, WARPS * 32, smem) != cudaSuccess) return -1;
    return n;
  }
};

// Calls L<T, NC>::run(args...) with NC = the lanes' chunk count for H.
template <template <typename, int> class L, typename T, typename... Args>
int dispatch_nc(int H, Args... args) {
  switch ((H + 255) / 256) {
    case 1: return L<T, 1>::run(args...);
    case 2: return L<T, 2>::run(args...);
    case 3: return L<T, 3>::run(args...);
    case 4: return L<T, 4>::run(args...);
    default: return (int)cudaErrorInvalidValue;
  }
}

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

// The backward kernel's shared memory allowed above 48 KB, up to its widest
// row (H = 256 NC), with the SM's memory given to shared memory first: set
// once a device, since the launch's host time is of the order of its
// device time.
template <typename T, int NC, bool DROPOUT>
cudaError_t bwd_attributes() {
  return vb::once_a_device([] {
    const void* fn = (const void*)ln_bwd_kernel<T, NC, DROPOUT>;
    cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           bwd_smem_bytes(32 * 8 * NC, sizeof(T), DROPOUT));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
    return err;
  });
}

template <typename T, int NC>
struct Fwd {
  static int run(const LnArgs& a, bool dropout, cudaStream_t st) {
    const unsigned blocks = (unsigned)((a.N + WARPS - 1) / WARPS);
    if (dropout)
      ln_fwd_kernel<T, NC, true><<<blocks, WARPS * 32, 0, st>>>(a);
    else
      ln_fwd_kernel<T, NC, false><<<blocks, WARPS * 32, 0, st>>>(a);
    return 0;
  }
};

template <typename T, int NC>
struct Bwd {
  static int run(const LnArgs& a, int P, bool dropout, cudaStream_t st) {
    const size_t smem = bwd_smem_bytes(a.H, sizeof(T), dropout);
    const cudaError_t err = dropout ? bwd_attributes<T, NC, true>() : bwd_attributes<T, NC, false>();
    if (err != cudaSuccess) return (int)err;
    if (dropout)
      ln_bwd_kernel<T, NC, true><<<P, WARPS * 32, smem, st>>>(a);
    else
      ln_bwd_kernel<T, NC, false><<<P, WARPS * 32, smem, st>>>(a);
    return 0;
  }
};

// One of K7-K10 at width H in dtype: registers, local bytes, dynamic shared
// bytes or blocks an SM (`what` 0-3), -1 where there is no such kernel.
template <typename T, int NC>
struct Info {
  static int run(int kernel, int what, int H) {
    const bool bwd = kernel == 8 || kernel == 10, dropout = kernel == 9 || kernel == 10;
    const void* fn = kernel == 7    ? (const void*)ln_fwd_kernel<T, NC, false>
                     : kernel == 8  ? (const void*)ln_bwd_kernel<T, NC, false>
                     : kernel == 9  ? (const void*)ln_fwd_kernel<T, NC, true>
                                    : (const void*)ln_bwd_kernel<T, NC, true>;
    const int smem = bwd ? bwd_smem_bytes(H, sizeof(T), dropout) : 0;
    if (what == 0 || what == 1) {
      cudaFuncAttributes attr;
      if (cudaFuncGetAttributes(&attr, fn) != cudaSuccess) return -1;
      return what == 0 ? attr.numRegs : (int)attr.localSizeBytes;
    }
    if (what == 2) return smem;
    if (what == 3) {
      if (bwd && (dropout ? bwd_attributes<T, NC, true>() : bwd_attributes<T, NC, false>()) != cudaSuccess)
        return -1;
      int n = 0;
      if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, WARPS * 32, smem) != cudaSuccess) return -1;
      return n;
    }
    return -1;
  }
};

}  // namespace

// What the wrapper needs to check inputs and plan the backward: 0 the
// widest row a warp owns (wider rows are a block's), 1 the warps of a block
// (a warp-a-row form's rows a block), 2 the vector backward's ring stages a
// warp, 3 the widest row the kernels take.
extern "C" int vb_ln_geometry(int which) {
  const int g[4] = {WARP_WIDTH, WARPS, STAGES, MAX_WIDTH};
  return which >= 0 && which < 4 ? g[which] : -1;
}

// K7-K10 (kernel 7-10) at width H in dtype, in the form of that width: 0
// registers a thread, 1 local (spilled) bytes a thread, 2 dynamic shared
// bytes a block, 3 blocks an SM (the backward's grid is that times the
// SMs), 4 the rows a block owns; -1 for anything else.
extern "C" int vb_ln_info(int kernel, int what, int H, int dtype) {
  const int f = width_form(H);
  if (kernel < 7 || kernel > 10 || what < 0 || what > 4 || f < 0 || dtype < kBf16 || dtype > kFp32) return -1;
  if (f == 0) return what == 4 ? WARPS : dispatch<Info>(dtype, H, kernel, what, H);
  return dispatch_any<InfoAny>(dtype, f, kernel, what, H);
}

// K7 (dropout = 0) and K9 (dropout = 1): y, mu, rstd, and K9's keep bits
// [N, ceil(H / 8)] uint8.
extern "C" int vb_ln_fwd(const void* x, const void* res, const void* scale, const void* bias, void* y, void* mu,
                         void* rstd, void* bits, int N, int H, int dtype, float eps, int dropout, unsigned int seed,
                         unsigned int threshold, float keep_prob, void* stream) {
  LnArgs a{};
  a.x = x; a.res = res; a.scale = static_cast<const float*>(scale); a.bias = static_cast<const float*>(bias);
  a.y = y; a.mu = static_cast<float*>(mu); a.rstd = static_cast<float*>(rstd);
  a.N = N; a.H = H; a.eps = eps; a.seed = seed; a.threshold = threshold; a.keep_prob = keep_prob;
  a.bits = static_cast<uint8_t*>(bits);
  if (dropout != 0 && bits == nullptr) return (int)cudaErrorInvalidValue;
  const int f = width_form(H);
  const int code = f == 0 ? dispatch<Fwd>(dtype, H, a, dropout != 0, static_cast<cudaStream_t>(stream))
                          : dispatch_any<FwdAny>(dtype, f, a, dropout != 0, static_cast<cudaStream_t>(stream));
  if (code != 0) return code;
  return (int)cudaGetLastError();
}

// K8 (dropout = 0, dres may be null) and K10 (dropout = 1, K9's bits): dx,
// dres, and dscale, dbias through P partial rows in `part` ([P, 2, H] fp32).
// seed and threshold are read only by a build with VB_LN_REGEN_MASK.
extern "C" int vb_ln_bwd(const void* x, const void* res, const void* scale, const void* mu, const void* rstd,
                         const void* dy, const void* bits, void* dx, void* dres, void* part, void* dscale, void* dbias,
                         int N, int H, int P, int dtype, int dropout, unsigned int seed, unsigned int threshold,
                         float keep_prob, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  LnArgs a{};
  a.x = x; a.res = res; a.scale = static_cast<const float*>(scale); a.dy = dy;
  a.mu = const_cast<float*>(static_cast<const float*>(mu)); a.rstd = const_cast<float*>(static_cast<const float*>(rstd));
  a.y = dx; a.dres = dres; a.part = static_cast<float*>(part);
  a.N = N; a.H = H; a.seed = seed; a.threshold = threshold; a.keep_prob = keep_prob;
  a.bits = const_cast<uint8_t*>(static_cast<const uint8_t*>(bits));
  if (P < 1 || (dropout != 0 && bits == nullptr)) return (int)cudaErrorInvalidValue;
  const int f = width_form(H);
  const int code = f == 0 ? dispatch<Bwd>(dtype, H, a, P, dropout != 0, st)
                          : dispatch_any<BwdAny>(dtype, f, a, P, dropout != 0, st);
  if (code != 0) return code;
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ln_bwd_reduce_kernel<<<(2 * H + 31) / 32, dim3(32, REDUCE_ROWS), 0, st>>>(
      static_cast<const float*>(part), P, H, static_cast<float*>(dscale), static_cast<float*>(dbias));
  return (int)cudaGetLastError();
}
