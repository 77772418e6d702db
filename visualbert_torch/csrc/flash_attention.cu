// K1 and K2: packed-QKV attention forward and backward. Replace
// visualbert_tpu/ops/flash_attention.py::_packed_fwd_kernel and
// ::_packed_bwd_kernel (reached through flash_attention_packed).
//
// Layout (the JAX package's): qkv [B, T, H*3*D] bf16 packed head-major
// [h0(q,k,v) | h1(q,k,v) | ...], each block D = 64 wide, WITHOUT the QKV
// projection bias; qb [H*3*D] bf16 is that bias, added here when a tile is
// loaded. key_bias [B, T] fp32 (0 or -10000). out [B, T, H*D] bf16,
// stats [B, H, T] fp32 with stats = max_j t + log2 sum_j exp2(t - max), where
// t = (q.k) * scale * log2(e) + key_bias * log2(e) (the base-2 convention of
// the JAX kernel). Dropout on the probabilities uses the Philox bits of
// philox.cuh::attn_philox, a pure function of (seed, b, h, i, j), so the
// three kernels below draw the identical mask although they tile differently.
//
// Bound on the H100: at B=96, T=228, H=12 the forward does 15 GFLOP per call
// on 40 MB of qkv, so it is bound by math and, with dropout on, by the
// integer work of Philox (one 10-round call per 2 probabilities). This first
// version uses mma.sync m16n8k16 (bf16 in, fp32 accumulate) with fragments
// read from padded shared memory (no bank conflicts, no ldmatrix, no TMA,
// no wgmma): correct and simple first; the fast Hopper path is later work.
//
// Forward (FlashAttention-2 style): one block of 4 warps per (64 query rows,
// head, batch); the head's whole K and V (T <= ~700) sit in shared memory;
// each warp owns 16 query rows and walks the keys in tiles of 64 with an
// online base-2 softmax. Scores past T are -inf before the max.
//
// Backward: shared memory cannot hold Q, K, V, dO and fp32 dK/dV
// accumulators for one (b, h) at T=228 (~234 KB), so the backward is two
// kernels with accumulators in registers: a query-tile pass (dQ, and
// delta = rowsum(dO * O) for its rows, which it also writes out) and a
// key-tile pass (dK, dV) that reads delta. Each recomputes P = exp2(t -
// stats). No atomics: every output element and every bias-gradient partial
// is written by exactly one block, so results do not depend on run order.
// The QKV-bias gradient is emitted as fp32 partials [B, ceil(T/64), F] of
// the column sums of the stored (bf16-rounded) dqkv; the caller sums them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int D = 64;                 // head dim
constexpr int TILE = 64;              // rows per block
constexpr int QC = 32;                // query chunk of the key-tile pass
constexpr int LDS = D + 8;            // padded shared-memory row stride (elements)
constexpr int NTHREADS = 128;         // 4 warps x 16 rows
constexpr float LOG2E = 1.4426950408889634f;
constexpr float SCALE = 0.125f;       // 1 / sqrt(D)

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment loads from a row-major shared-memory tile with row stride LDS.
// g = lane / 4, tq = lane % 4 (the mma.sync thread-group coordinates).

// A (16x16) = X[r0 .. r0+15][k0 .. k0+15]
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* X, int r0, int k0, int g, int tq) {
  a[0] = *reinterpret_cast<const uint32_t*>(X + (r0 + g) * LDS + k0 + 2 * tq);
  a[1] = *reinterpret_cast<const uint32_t*>(X + (r0 + g + 8) * LDS + k0 + 2 * tq);
  a[2] = *reinterpret_cast<const uint32_t*>(X + (r0 + g) * LDS + k0 + 2 * tq + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(X + (r0 + g + 8) * LDS + k0 + 2 * tq + 8);
}

// B (16x8) with B[k][n] = X[n0 + n][k0 + k]  (X's rows are B's columns)
__device__ __forceinline__ void load_b_rows(uint32_t& b0, uint32_t& b1, const bf16* X, int n0, int k0,
                                            int g, int tq) {
  b0 = *reinterpret_cast<const uint32_t*>(X + (n0 + g) * LDS + k0 + 2 * tq);
  b1 = *reinterpret_cast<const uint32_t*>(X + (n0 + g) * LDS + k0 + 2 * tq + 8);
}

// B (16x8) with B[k][n] = X[k0 + k][n0 + n]  (X's rows are B's rows)
__device__ __forceinline__ void load_b_cols(uint32_t& b0, uint32_t& b1, const bf16* X, int k0, int n0,
                                            int g, int tq) {
  const bf16* p = X + (k0 + 2 * tq) * LDS + n0 + g;
  b0 = pack_raw(p[0], p[LDS]);
  b1 = pack_raw(p[8 * LDS], p[9 * LDS]);
}

// Accumulator pair (n-tiles 2c, 2c+1 of a 16-row C) -> A fragment with k = those 16 columns.
__device__ __forceinline__ void c_to_a(uint32_t a[4], const float lo[4], const float hi[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// Copy rows [t0, t0 + nrows) of one D-wide column block of a [B*T, ld] bf16
// matrix into shared memory, adding the deferred bias (bf16 add, rounded as
// the JAX kernel's bf16 `qkv + qb`); rows past T are zero.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src, const bf16* __restrict__ bias,
                                          int t0, int nrows, int T, int ld, int col) {
  for (int idx = threadIdx.x; idx < nrows * (D / 8); idx += NTHREADS) {
    const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
    const int t = t0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (t < T) {
      v = *reinterpret_cast<const uint4*>(src + (size_t)t * ld + col + c);
      if (bias != nullptr) {
        const uint4 bv = *reinterpret_cast<const uint4*>(bias + col + c);
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

__host__ __device__ __forceinline__ int round_up(int x, int m) { return (x + m - 1) / m * m; }

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

// Store a [16 rows/warp x 64] fragment accumulator times `scale` as bf16.
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, const float acc[8][4], float scale,
                                           int row0, int row1, bool ok0, bool ok1, int ld, int col, int tq) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int c = col + nt * 8 + 2 * tq;
    if (ok0) *reinterpret_cast<uint32_t*>(dst + (size_t)row0 * ld + c) = pack_bf16(acc[nt][0] * scale, acc[nt][1] * scale);
    if (ok1) *reinterpret_cast<uint32_t*>(dst + (size_t)row1 * ld + c) = pack_bf16(acc[nt][2] * scale, acc[nt][3] * scale);
  }
}

// ---------------------------------------------------------------- forward

__global__ void __launch_bounds__(NTHREADS)
attn_fwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ qb, const float* __restrict__ key_bias,
                bf16* __restrict__ out, float* __restrict__ stats, int T, int H, uint32_t seed,
                uint32_t threshold, float inv, int dropout) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Tp = round_up(T, TILE);
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [TILE][LDS]
  bf16* Ks = Qs + TILE * LDS;                // [Tp][LDS]
  bf16* Vs = Ks + Tp * LDS;                  // [Tp][LDS]
  float* bias2 = reinterpret_cast<float*>(Vs + Tp * LDS);  // [Tp]

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int F = 3 * H * D, HD = H * D;
  const bf16* base = qkv + (size_t)b * T * F;
  load_tile(Qs, base, qb, qt * TILE, TILE, T, F, (3 * h + 0) * D);
  load_tile(Ks, base, qb, 0, Tp, T, F, (3 * h + 1) * D);
  load_tile(Vs, base, qb, 0, Tp, T, F, (3 * h + 2) * D);
  for (int j = threadIdx.x; j < Tp; j += NTHREADS)
    bias2[j] = j < T ? key_bias[(size_t)b * T + j] * LOG2E : -INFINITY;
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int r0 = warp * 16;
  const int row[2] = {qt * TILE + r0 + g, qt * TILE + r0 + g + 8};
  const uint32_t bh = (uint32_t)(b * H + h);
  const float c1 = SCALE * LOG2E;

  uint32_t qa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) load_a(qa[kk], Qs, r0, kk * 16, g, tq);

  float o[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < Tp; k0 += TILE) {
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t b0, b1;
        load_b_rows(b0, b1, Ks, k0 + nt * 8, kk * 16, g, tq);
        mma16816(s[nt], qa[kk], b0, b1);
      }
    }
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = k0 + nt * 8 + 2 * tq + (e & 1);
        s[nt][e] = s[nt][e] * c1 + bias2[j];
        mt[e >> 1] = fmaxf(mt[e >> 1], s[nt][e]);
      }
    }
    float alpha[2], mnew[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      mnew[r] = fmaxf(m[r], mt[r]);
      alpha[r] = exp2f(m[r] - mnew[r]);
      m[r] = mnew[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o[nt][e] *= alpha[e >> 1];
        const float p = exp2f(s[nt][e] - mnew[e >> 1]);
        l[e >> 1] += p;
        s[nt][e] = p;
      }
    }
    if (dropout) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int j = k0 + nt * 8 + 2 * tq;  // even: (j, j+1) share one Philox call
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint4 rnd = vb::attn_philox(seed, bh, row[r], j);
          const int w = (row[r] & 1) << 1;
          if (vb::philox_word(rnd, w) < threshold) s[nt][2 * r] = 0.f;
          if (vb::philox_word(rnd, w + 1) < threshold) s[nt][2 * r + 1] = 0.f;
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint32_t pa[4];
      c_to_a(pa, s[2 * c], s[2 * c + 1]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t b0, b1;
        load_b_cols(b0, b1, Vs, k0 + c * 16, nt * 8, g, tq);
        mma16816(o[nt], pa, b0, b1);
      }
    }
  }

  float sc[2];
  bool ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    sc[r] = inv / l[r];
    ok[r] = row[r] < T;
  }
  bf16* ob = out + (size_t)b * T * HD;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int c = h * D + nt * 8 + 2 * tq;
    if (ok[0]) *reinterpret_cast<uint32_t*>(ob + (size_t)row[0] * HD + c) = pack_bf16(o[nt][0] * sc[0], o[nt][1] * sc[0]);
    if (ok[1]) *reinterpret_cast<uint32_t*>(ob + (size_t)row[1] * HD + c) = pack_bf16(o[nt][2] * sc[1], o[nt][3] * sc[1]);
  }
  if (tq == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (ok[r]) stats[((size_t)b * H + h) * T + row[r]] = m[r] + log2f(l[r]);
  }
}

// ------------------------------------------------------- backward: dQ pass

__global__ void __launch_bounds__(NTHREADS)
attn_bwd_dq_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ qb, const float* __restrict__ key_bias,
                   const bf16* __restrict__ dout, const bf16* __restrict__ out, const float* __restrict__ stats,
                   bf16* __restrict__ dqkv, float* __restrict__ db_part, float* __restrict__ delta_g,
                   int T, int H, uint32_t seed, uint32_t threshold, float inv, int dropout) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Tp = round_up(T, TILE);
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [TILE][LDS]
  bf16* dOs = Qs + TILE * LDS;               // [TILE][LDS]
  bf16* Ks = dOs + TILE * LDS;               // [Tp][LDS]
  bf16* Vs = Ks + Tp * LDS;                  // [Tp][LDS]
  float* bias2 = reinterpret_cast<float*>(Vs + Tp * LDS);  // [Tp]
  float* st_s = bias2 + Tp;                  // [TILE]
  float* dl_s = st_s + TILE;                 // [TILE]
  float* red = dl_s + TILE;                  // [4][D]

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int F = 3 * H * D, HD = H * D, nt_tiles = Tp / TILE;
  const bf16* base = qkv + (size_t)b * T * F;
  load_tile(Qs, base, qb, qt * TILE, TILE, T, F, (3 * h + 0) * D);
  load_tile(dOs, dout + (size_t)b * T * HD, nullptr, qt * TILE, TILE, T, HD, h * D);
  load_tile(Ks, base, qb, 0, Tp, T, F, (3 * h + 1) * D);
  load_tile(Vs, base, qb, 0, Tp, T, F, (3 * h + 2) * D);
  for (int j = threadIdx.x; j < Tp; j += NTHREADS)
    bias2[j] = j < T ? key_bias[(size_t)b * T + j] * LOG2E : -INFINITY;
  {
    // delta = rowsum(dO * O) in fp32: two threads per row, 32 columns each
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1, i = qt * TILE + r;
    float acc = 0.f;
    if (i < T) {
      const bf16* pd = dout + ((size_t)b * T + i) * HD + h * D + half * 32;
      const bf16* po = out + ((size_t)b * T + i) * HD + h * D + half * 32;
#pragma unroll 8
      for (int k = 0; k < 32; ++k) acc += __bfloat162float(pd[k]) * __bfloat162float(po[k]);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      dl_s[r] = acc;
      st_s[r] = i < T ? stats[((size_t)b * H + h) * T + i] : 0.f;
      if (i < T) delta_g[((size_t)b * H + h) * T + i] = acc;
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int r0 = warp * 16;
  const int row[2] = {qt * TILE + r0 + g, qt * TILE + r0 + g + 8};
  const float strow[2] = {st_s[r0 + g], st_s[r0 + g + 8]};
  const float dlrow[2] = {dl_s[r0 + g], dl_s[r0 + g + 8]};
  const uint32_t bh = (uint32_t)(b * H + h);
  const float c1 = SCALE * LOG2E;

  uint32_t qa[4][4], da[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    load_a(qa[kk], Qs, r0, kk * 16, g, tq);
    load_a(da[kk], dOs, r0, kk * 16, g, tq);
  }
  float dq[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) dq[nt][0] = dq[nt][1] = dq[nt][2] = dq[nt][3] = 0.f;

  for (int k0 = 0; k0 < Tp; k0 += TILE) {
    float s[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t b0, b1;
        load_b_rows(b0, b1, Ks, k0 + nt * 8, kk * 16, g, tq);
        mma16816(s[nt], qa[kk], b0, b1);
        load_b_rows(b0, b1, Vs, k0 + nt * 8, kk * 16, g, tq);
        mma16816(dp[nt], da[kk], b0, b1);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      uint4 rnd[2];
      if (dropout) {
        rnd[0] = vb::attn_philox(seed, bh, row[0], k0 + nt * 8 + 2 * tq);
        rnd[1] = vb::attn_philox(seed, bh, row[1], k0 + nt * 8 + 2 * tq);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, j = k0 + nt * 8 + 2 * tq + (e & 1);
        const float p = exp2f(s[nt][e] * c1 + bias2[j] - strow[r]);
        float d = dp[nt][e];
        if (dropout) {
          const bool keep = vb::philox_word(rnd[r], ((row[r] & 1) << 1) | (e & 1)) >= threshold;
          d = keep ? d * inv : 0.f;
        }
        s[nt][e] = p * (d - dlrow[r]);  // dS (the scale goes on dQ)
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint32_t sa[4];
      c_to_a(sa, s[2 * c], s[2 * c + 1]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t b0, b1;
        load_b_cols(b0, b1, Ks, k0 + c * 16, nt * 8, g, tq);
        mma16816(dq[nt], sa, b0, b1);
      }
    }
  }

  const bool ok0 = row[0] < T, ok1 = row[1] < T;
  store_rows(dqkv + (size_t)b * T * F, dq, SCALE, row[0], row[1], ok0, ok1, F, (3 * h + 0) * D, tq);
  float colsum = 0.f;
  block_colsum(dq, SCALE, ok0, ok1, red, warp, g, tq, &colsum);
  if (threadIdx.x < D)
    db_part[((size_t)b * nt_tiles + qt) * F + (3 * h + 0) * D + threadIdx.x] = colsum;
}

// --------------------------------------------------- backward: dK, dV pass

__global__ void __launch_bounds__(NTHREADS)
attn_bwd_dkv_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ qb, const float* __restrict__ key_bias,
                    const bf16* __restrict__ dout, const float* __restrict__ stats,
                    const float* __restrict__ delta_g, bf16* __restrict__ dqkv, float* __restrict__ db_part,
                    int T, int H, uint32_t seed, uint32_t threshold, float inv, int dropout) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Tp = round_up(T, TILE);
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // [TILE][LDS] this block's keys
  bf16* Vs = Ks + TILE * LDS;                // [TILE][LDS]
  bf16* Qs = Vs + TILE * LDS;                // [Tp][LDS] all queries
  bf16* dOs = Qs + Tp * LDS;                 // [Tp][LDS]
  float* st_s = reinterpret_cast<float*>(dOs + Tp * LDS);  // [Tp]
  float* dl_s = st_s + Tp;                   // [Tp]
  float* kb_s = dl_s + Tp;                   // [TILE]
  float* red = kb_s + TILE;                  // [4][D]

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int F = 3 * H * D, HD = H * D, nt_tiles = Tp / TILE;
  const bf16* base = qkv + (size_t)b * T * F;
  load_tile(Ks, base, qb, kt * TILE, TILE, T, F, (3 * h + 1) * D);
  load_tile(Vs, base, qb, kt * TILE, TILE, T, F, (3 * h + 2) * D);
  load_tile(Qs, base, qb, 0, Tp, T, F, (3 * h + 0) * D);
  load_tile(dOs, dout + (size_t)b * T * HD, nullptr, 0, Tp, T, HD, h * D);
  for (int i = threadIdx.x; i < Tp; i += NTHREADS) {
    // padded queries: stats = +inf makes their probabilities exactly 0
    st_s[i] = i < T ? stats[((size_t)b * H + h) * T + i] : INFINITY;
    dl_s[i] = i < T ? delta_g[((size_t)b * H + h) * T + i] : 0.f;
  }
  for (int r = threadIdx.x; r < TILE; r += NTHREADS) {
    const int j = kt * TILE + r;
    kb_s[r] = j < T ? key_bias[(size_t)b * T + j] * LOG2E : -INFINITY;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int r0 = warp * 16;
  const int key[2] = {kt * TILE + r0 + g, kt * TILE + r0 + g + 8};
  const float kb[2] = {kb_s[r0 + g], kb_s[r0 + g + 8]};
  const uint32_t bh = (uint32_t)(b * H + h);
  const float c1 = SCALE * LOG2E;

  uint32_t ka[4][4], va[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    load_a(ka[kk], Ks, r0, kk * 16, g, tq);
    load_a(va[kk], Vs, r0, kk * 16, g, tq);
  }
  float dk[8][4], dv[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    dk[nt][0] = dk[nt][1] = dk[nt][2] = dk[nt][3] = 0.f;
    dv[nt][0] = dv[nt][1] = dv[nt][2] = dv[nt][3] = 0.f;
  }

  for (int q0 = 0; q0 < Tp; q0 += QC) {
    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x QC queries
    float st[QC / 8][4], dpt[QC / 8][4];
#pragma unroll
    for (int nt = 0; nt < QC / 8; ++nt) {
      st[nt][0] = st[nt][1] = st[nt][2] = st[nt][3] = 0.f;
      dpt[nt][0] = dpt[nt][1] = dpt[nt][2] = dpt[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t b0, b1;
        load_b_rows(b0, b1, Qs, q0 + nt * 8, kk * 16, g, tq);
        mma16816(st[nt], ka[kk], b0, b1);
        load_b_rows(b0, b1, dOs, q0 + nt * 8, kk * 16, g, tq);
        mma16816(dpt[nt], va[kk], b0, b1);
      }
    }
    // element (key[r], query i): st -> P_d (dropped, scaled), dpt -> dS
#pragma unroll
    for (int nt = 0; nt < QC / 8; ++nt) {
      const int i0 = q0 + nt * 8 + 2 * tq;  // even: (i0, i0+1) share one Philox call
      uint4 rnd[2];
      if (dropout) {
        rnd[0] = vb::attn_philox(seed, bh, i0, key[0]);
        rnd[1] = vb::attn_philox(seed, bh, i0, key[1]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, i = i0 + (e & 1);
        const float p = exp2f(st[nt][e] * c1 + kb[r] - st_s[i]);
        float pd = p, d = dpt[nt][e];
        if (dropout) {
          const bool keep = vb::philox_word(rnd[r], ((e & 1) << 1) | (key[r] & 1)) >= threshold;
          pd = keep ? p * inv : 0.f;
          d = keep ? d * inv : 0.f;
        }
        st[nt][e] = pd;
        dpt[nt][e] = p * (d - dl_s[i]);
      }
    }
#pragma unroll
    for (int c = 0; c < QC / 16; ++c) {
      uint32_t pa[4], sa[4];
      c_to_a(pa, st[2 * c], st[2 * c + 1]);
      c_to_a(sa, dpt[2 * c], dpt[2 * c + 1]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t b0, b1;
        load_b_cols(b0, b1, dOs, q0 + c * 16, nt * 8, g, tq);
        mma16816(dv[nt], pa, b0, b1);
        load_b_cols(b0, b1, Qs, q0 + c * 16, nt * 8, g, tq);
        mma16816(dk[nt], sa, b0, b1);
      }
    }
  }

  const bool ok0 = key[0] < T, ok1 = key[1] < T;
  bf16* dst = dqkv + (size_t)b * T * F;
  store_rows(dst, dk, SCALE, key[0], key[1], ok0, ok1, F, (3 * h + 1) * D, tq);
  store_rows(dst, dv, 1.f, key[0], key[1], ok0, ok1, F, (3 * h + 2) * D, tq);
  float colsum = 0.f;
  float* part = db_part + ((size_t)b * nt_tiles + kt) * F;
  block_colsum(dk, SCALE, ok0, ok1, red, warp, g, tq, &colsum);
  if (threadIdx.x < D) part[(3 * h + 1) * D + threadIdx.x] = colsum;
  block_colsum(dv, 1.f, ok0, ok1, red, warp, g, tq, &colsum);
  if (threadIdx.x < D) part[(3 * h + 2) * D + threadIdx.x] = colsum;
}

size_t fwd_smem(int T) {
  const int Tp = round_up(T, TILE);
  return (size_t)(TILE + 2 * Tp) * LDS * sizeof(bf16) + Tp * sizeof(float);
}
size_t dq_smem(int T) {
  const int Tp = round_up(T, TILE);
  return (size_t)(2 * TILE + 2 * Tp) * LDS * sizeof(bf16) + (Tp + 2 * TILE + 4 * D) * sizeof(float);
}
size_t dkv_smem(int T) {
  const int Tp = round_up(T, TILE);
  return (size_t)(2 * TILE + 2 * Tp) * LDS * sizeof(bf16) + (2 * Tp + TILE + 4 * D) * sizeof(float);
}

}  // namespace

extern "C" size_t vb_attn_smem_bytes(int T) {
  size_t a = fwd_smem(T), b = dq_smem(T), c = dkv_smem(T);
  size_t m = a > b ? a : b;
  return m > c ? m : c;
}

extern "C" int vb_attn_fwd(const void* qkv, const void* qb, const void* key_bias, void* out, void* stats,
                           int B, int T, int H, unsigned int seed, unsigned int threshold, float inv,
                           int dropout, void* stream) {
  const size_t smem = fwd_smem(T);
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + TILE - 1) / TILE, H, B);
  attn_fwd_kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(qb), static_cast<const float*>(key_bias),
      static_cast<bf16*>(out), static_cast<float*>(stats), T, H, seed, threshold, inv, dropout);
  return (int)cudaGetLastError();
}

extern "C" int vb_attn_bwd(const void* qkv, const void* qb, const void* key_bias, const void* dout,
                           const void* out, const void* stats, void* dqkv, void* db_part, void* delta,
                           int B, int T, int H, unsigned int seed, unsigned int threshold, float inv,
                           int dropout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((T + TILE - 1) / TILE, H, B);
  const size_t smem_dq = dq_smem(T), smem_dkv = dkv_smem(T);
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attn_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dkv);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dq_kernel<<<grid, NTHREADS, smem_dq, s>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(qb), static_cast<const float*>(key_bias),
      static_cast<const bf16*>(dout), static_cast<const bf16*>(out), static_cast<const float*>(stats),
      static_cast<bf16*>(dqkv), static_cast<float*>(db_part), static_cast<float*>(delta), T, H, seed,
      threshold, inv, dropout);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dkv_kernel<<<grid, NTHREADS, smem_dkv, s>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(qb), static_cast<const float*>(key_bias),
      static_cast<const bf16*>(dout), static_cast<const float*>(stats), static_cast<const float*>(delta),
      static_cast<bf16*>(dqkv), static_cast<float*>(db_part), T, H, seed, threshold, inv, dropout);
  return (int)cudaGetLastError();
}
