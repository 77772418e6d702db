// Tile helpers of the attention experiment kernels K15/K16
// (flash_attention_exp.cu), the first design of K1/K2 kept as the instrument
// that scripts/attn_exp.py and scripts/attn_hgrid.py measured: mma.sync
// m16n8k16 with fragments read from padded shared memory. Every other
// attention kernel (K1/K2, K11/K12, K13/K14) is built on hopper_attn.cuh.
//
// Every kernel here works on one (batch b, head h) pair at a time (K15/K16
// walk several in one block), with D = 64 head dims, 64-row tiles and 4
// warps of 16 rows. PackedLayout says where the rows of (b, h)'s Q, K or V
// (j = 0, 1, 2) start in qkv [B, T, H*3*D] packed head-major [h0(q,k,v) |
// h1 ...] and where its rows of out / dout [B, T, H*D] start, and their row
// strides (elements).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"
#include "philox.cuh"

namespace vb_attn {

using vb::bf16;
using vb::pack_bf16;
using vb::round_bf16;

constexpr int D = 64;                 // head dim
constexpr int TILE = 64;              // rows per block
constexpr int QC = 32;                // query chunk of the key-tile passes
constexpr int LDS = D + 8;            // padded shared-memory row stride (elements)
constexpr int NTHREADS = 128;         // 4 warps x 16 rows
constexpr float LOG2E = 1.4426950408889634f;
constexpr float SCALE = 0.125f;       // 1 / sqrt(D)

struct PackedLayout {
  __device__ static size_t in_off(int b, int h, int j, int T, int H) {
    return (size_t)b * T * 3 * H * D + (size_t)(3 * h + j) * D;
  }
  __device__ static int ld_in(int H) { return 3 * H * D; }
  __device__ static size_t out_off(int b, int h, int T, int H) { return (size_t)b * T * H * D + (size_t)h * D; }
  __device__ static int ld_out(int H) { return H * D; }
};

__host__ __device__ __forceinline__ int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Dynamic shared memory of the three stats-carrying kernels (the forward,
// the backward's query-tile and key-tile passes).
inline size_t fwd_smem(int T) {
  const int Tp = round_up(T, TILE);
  return (size_t)(TILE + 2 * Tp) * LDS * sizeof(bf16) + Tp * sizeof(float);
}
inline size_t dq_smem(int T) {
  const int Tp = round_up(T, TILE);
  return (size_t)(2 * TILE + 2 * Tp) * LDS * sizeof(bf16) + (Tp + 2 * TILE + 4 * D) * sizeof(float);
}
inline size_t dkv_smem(int T) {
  const int Tp = round_up(T, TILE);
  return (size_t)(2 * TILE + 2 * Tp) * LDS * sizeof(bf16) + (2 * Tp + TILE + 4 * D) * sizeof(float);
}

// Copy rows [t0, t0 + nrows) of a D-wide row block (row t at src + t * ld)
// into shared memory, adding the deferred bias when one is given (bf16 add,
// rounded as the JAX kernel's bf16 `qkv + qb`); rows past T are zero.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src, const bf16* __restrict__ bias,
                                          int t0, int nrows, int T, int ld) {
  for (int idx = threadIdx.x; idx < nrows * (D / 8); idx += NTHREADS) {
    const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
    const int t = t0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (t < T) {
      v = *reinterpret_cast<const uint4*>(src + (size_t)t * ld + c);
      if (bias != nullptr) {
        const uint4 bv = *reinterpret_cast<const uint4*>(bias + c);
        const bf16* x = reinterpret_cast<const bf16*>(&v);
        const bf16* y = reinterpret_cast<const bf16*>(&bv);
        uint32_t w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          w[e] = pack_bf16(__bfloat162float(x[2 * e]) + __bfloat162float(y[2 * e]),
                           __bfloat162float(x[2 * e + 1]) + __bfloat162float(y[2 * e + 1]));
        v = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * LDS + c) = v;
  }
}

// Column sums over this block's 64 rows of a [16 rows/warp x 64] fragment
// accumulator (after `scale` and bf16 rounding, valid rows only); thread
// c < 64 of the block returns the sum for column c in *out.
__device__ __forceinline__ void block_colsum(const float acc[8][4], float scale, bool ok0, bool ok1,
                                             float* red /* [4][D] smem */, int warp, int g, int tq,
                                             float* out) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = (ok0 ? round_bf16(acc[nt][e] * scale) : 0.f) + (ok1 ? round_bf16(acc[nt][2 + e] * scale) : 0.f);
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (g == 0) red[warp * D + nt * 8 + 2 * tq + e] = v;
    }
  }
  __syncthreads();
  if (threadIdx.x < D) {
    const int c = threadIdx.x;
    *out = red[c] + red[D + c] + red[2 * D + c] + red[3 * D + c];
  }
  __syncthreads();
}

// Store a [16 rows/warp x 64] fragment accumulator times `scale` as bf16
// (row r at dst + r * ld).
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, const float acc[8][4], float scale,
                                           int row0, int row1, bool ok0, bool ok1, int ld, int tq) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int c = nt * 8 + 2 * tq;
    if (ok0) *reinterpret_cast<uint32_t*>(dst + (size_t)row0 * ld + c) = pack_bf16(acc[nt][0] * scale, acc[nt][1] * scale);
    if (ok1) *reinterpret_cast<uint32_t*>(dst + (size_t)row1 * ld + c) = pack_bf16(acc[nt][2] * scale, acc[nt][3] * scale);
  }
}

// delta = rowsum(dO * O) in fp32 for the 64 rows of query tile qt (two
// threads a row, 32 columns each), into dl_s[64] and, for rows < T, into
// delta_g[(b*H + h)*T + i]; dout and out in the layout's output rows.
__device__ __forceinline__ void row_delta(const bf16* __restrict__ dout, const bf16* __restrict__ out, int ld,
                                          float* dl_s, float* __restrict__ delta_g, int qt, int T) {
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1, i = qt * TILE + r;
  float acc = 0.f;
  if (i < T) {
    const bf16* pd = dout + (size_t)i * ld + half * 32;
    const bf16* po = out + (size_t)i * ld + half * 32;
#pragma unroll 8
    for (int k = 0; k < 32; ++k) acc += __bfloat162float(pd[k]) * __bfloat162float(po[k]);
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  if (half == 0) {
    dl_s[r] = acc;
    if (i < T) delta_g[i] = acc;
  }
}

}  // namespace vb_attn
