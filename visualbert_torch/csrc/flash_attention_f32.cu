// K1/K2, K11/K12 and K13/K14 in fp32: attention forward and backward on
// fp32 tensors, at any head dim D <= 128. Replace, for fp32 inputs,
// visualbert_tpu/ops/flash_attention.py::_packed_fwd_kernel (:249) and
// ::_packed_bwd_kernel (:307) (K1/K2), ::_fwd_kernel (:71) and ::_bwd_kernel
// (:93) (K11/K12, heads-major), ::_packed_fwd_sp_kernel (:409) and
// ::_packed_bwd_sp_kernel (:441) (K13/K14, save-probs), which compute in the
// input's dtype.
//
// Function: flash_attention_packed.cu's (K1/K2's) contract in fp32. qkv [B,
// T, H*3*D] packed head-major without the QKV projection bias; qb [H*3*D] is
// that bias, added here as rows reach shared memory; key_bias [B, T] (0 or
// -10000). The forward writes out [B, T, H*D] and the base-2 row statistic
// stats [B, H, T] = max_j t + log2 sum_j exp2(t - max), t = (q.k) * scale *
// log2(e) + key_bias * log2(e); the backward rebuilds p = exp2(t - stats)
// from them and writes dqkv, delta = rowsum(dO * O) [B, H, T] (scratch) and
// the QKV-bias gradient as per-batch-row partials db_part [B, H*3*D], each
// row written by one block (the caller sums the rows: no atomics).
// Dropout keeps probability (b, h, i, j) by philox.cuh::attn_philox's bit,
// word ((i & 1) << 1 | (j & 1)) of the call for (i, j): the masks equal the
// bf16 and fp16 kernels' at the same seed. The rows, keys and head are
// addressed through Layout's strides: K11/K12 run the same kernels on the
// heads-major [B, 3, H, T, D] qkv (its bias already added: no qb, no bias
// gradient) and [B, H, T, D] out. K13/K14 (save-probs, SP) take the packed
// qkv with its bias added; the forward walks the keys twice (the row
// statistic, then p = exp2(t - stat), written as bf16 into probs [B, H, T,
// ldp] before dropout, and P_d V) and writes no statistics; the backward's
// two passes read p back from those bf16 values in place of exp2(t - stats)
// and need neither the key bias nor the statistics: K14's contract in fp32.
//
// Bound on the H100 at the main path's B=128, T=228, H=12, D=64: 2 (forward)
// and 4 (backward) products of 2 B H T^2 D = 5.1 GFLOP each at the 67
// TFLOP/s of fp32 outside the tensor cores: 0.15 / 0.30 ms; the bytes (fp32:
// twice the bf16 kernels') take 0.11 / 0.22 ms at 3.35 TB/s. wgmma's TF32
// keeps a 10-bit mantissa and would not meet fp32's tolerance, and 3xTF32
// costs three products: these kernels are SIMT.
//
// Design (simple and right first; its speed is later work):
// - A block of 8 warps owns one (batch row, head) pair, so the bias-gradient
//   partials of a head are one block's and need no second pass; B * H
//   blocks (1,536 at the main path).
// - Forward and dQ pass: the block takes 32 query rows at a time (4 a warp)
//   and walks 32-key tiles in shared memory (K and V rows padded to D + 1
//   floats, so that a lane reading its own key's row meets no bank
//   conflict). Lane l owns key l of the tile for the scores (D fused
//   multiply-adds over shared memory, the 4 rows' query values broadcast)
//   and output columns l, l + 32, ... for the products with V or K (the
//   probability or dS of key jj broadcast by __shfl_sync). An online max
//   and sum of exp2 per row as in K1; the dropout bit of each (i, j) is
//   its own Philox call (four times the bf16 kernels' calls, which share
//   one between a 2 x 2 block).
// - dK/dV pass: the mirror image, 32 keys at a time (4 a warp) against
//   32-query tiles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int NW = 8;              // warps a block
constexpr int NTH = NW * 32;
constexpr int RW = 4;              // rows a warp holds at once
constexpr int CHUNK = NW * RW;     // rows the block holds at once
constexpr int KT = 32;             // rows of a streamed tile: one a lane
constexpr int MAX_D = 128;
constexpr float LOG2E = 1.4426950408889634f;
typedef __nv_bfloat16 bf16;

// Element strides: of q's (batch, head, row) and the distance from q to k
// (and k to v); of out's (batch, head, row); of a head's bias in qb and
// the distance from its q part to its k part.
struct Layout {
  long long qb, qh, qt, part;
  long long ob, oh, ot;
  long long bh, bpart;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ bool keep(uint32_t seed, uint32_t bh, int i, int j, uint32_t thr) {
  const uint4 r = vb::attn_philox(seed, bh, i, j);
  return vb::philox_word(r, ((i & 1) << 1) | (j & 1)) >= thr;
}

// rows [r0, r0 + n) of a D-wide matrix (row t at src + t * ld, plus bias
// when given) into dst with row stride lds; rows past T are zero.
__device__ __forceinline__ void load_rows(float* dst, int lds, const float* __restrict__ src, long long ld,
                                          const float* __restrict__ bias, int r0, int n, int T, int D) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < n; r += NW) {
    const int t = r0 + r;
    for (int d = lane; d < D; d += 32)
      dst[r * lds + d] = t < T ? src[(long long)t * ld + d] + (bias ? bias[d] : 0.f) : 0.f;
  }
}

size_t fwd_bytes(int D) { return sizeof(float) * ((size_t)CHUNK * D + KT * (D + 1) + KT * D + KT); }
size_t bwd_bytes(int D) { return sizeof(float) * ((size_t)2 * CHUNK * D + 2 * KT * (D + 1) + 3 * KT + NW * MAX_D); }

// grid (H, B): block (h, b) owns the pair (b, h).
template <int NC>
__global__ void __launch_bounds__(NTH)
attn_f32_fwd_kernel(const float* __restrict__ qkv, const float* __restrict__ qb, const float* __restrict__ key_bias,
                    float* __restrict__ out, float* __restrict__ stats, int T, int H, int D, Layout L, uint32_t seed,
                    uint32_t thr, float inv, int dropout, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                 // [CHUNK][D]
  float* Ks = Qs + CHUNK * D;       // [KT][D + 1]
  float* Vs = Ks + KT * (D + 1);    // [KT][D]
  float* kbs = Vs + KT * D;         // [KT] key bias * log2(e)
  const int h = blockIdx.x, b = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* q = qkv + b * L.qb + h * L.qh;
  const float* bq = qb ? qb + h * L.bh : nullptr;
  const uint32_t bh = (uint32_t)(b * H + h);
  const float c1 = scale * LOG2E;

  for (int r0 = 0; r0 < T; r0 += CHUNK) {
    __syncthreads();  // every warp is done with the last chunk's rows
    load_rows(Qs, D, q, L.qt, bq, r0, CHUNK, T, D);
    float o[RW][NC], m[RW], l[RW];
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) {
      m[rr] = -INFINITY;
      l[rr] = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) o[rr][c] = 0.f;
    }
    for (int k0 = 0; k0 < T; k0 += KT) {
      __syncthreads();  // every warp is done with the last tile
      load_rows(Ks, D + 1, q + L.part, L.qt, bq ? bq + L.bpart : nullptr, k0, KT, T, D);
      load_rows(Vs, D, q + 2 * L.part, L.qt, bq ? bq + 2 * L.bpart : nullptr, k0, KT, T, D);
      if (threadIdx.x < KT)
        kbs[threadIdx.x] = k0 + threadIdx.x < T ? key_bias[(long long)b * T + k0 + threadIdx.x] * LOG2E : -INFINITY;
      __syncthreads();
      const int j = k0 + lane;
      float s[RW] = {};
      for (int d = 0; d < D; ++d) {
        const float kv = Ks[lane * (D + 1) + d];
#pragma unroll
        for (int rr = 0; rr < RW; ++rr) s[rr] += Qs[(warp * RW + rr) * D + d] * kv;
      }
      float p[RW];
#pragma unroll
      for (int rr = 0; rr < RW; ++rr) {
        const int i = r0 + warp * RW + rr;
        const float t = j < T ? s[rr] * c1 + kbs[lane] : -INFINITY;
        const float mnew = fmaxf(m[rr], warp_max(t));
        const float alpha = exp2f(m[rr] - mnew);
        p[rr] = exp2f(t - mnew);
        l[rr] = l[rr] * alpha + warp_sum(p[rr]);
        m[rr] = mnew;
        if (dropout && j < T && i < T && !keep(seed, bh, i, j, thr)) p[rr] = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) o[rr][c] *= alpha;
      }
      const int nk = min(KT, T - k0);
      for (int jj = 0; jj < nk; ++jj) {
        float vv[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) vv[c] = lane + 32 * c < D ? Vs[jj * D + lane + 32 * c] : 0.f;
#pragma unroll
        for (int rr = 0; rr < RW; ++rr) {
          const float pj = __shfl_sync(0xffffffffu, p[rr], jj);
#pragma unroll
          for (int c = 0; c < NC; ++c) o[rr][c] += pj * vv[c];
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) {
      const int i = r0 + warp * RW + rr;
      if (i >= T) continue;
      const float sc = inv / l[rr];
      float* orow = out + b * L.ob + h * L.oh + i * L.ot;
#pragma unroll
      for (int c = 0; c < NC; ++c)
        if (lane + 32 * c < D) orow[lane + 32 * c] = o[rr][c] * sc;
      if (lane == 0) stats[(long long)bh * T + i] = m[rr] + log2f(l[rr]);
    }
  }
}

// grid (H, B): K13 in fp32 for pair (b, h): pass 1 takes each row's
// statistic over every key tile, pass 2 writes p = exp2(t - stat) as bf16
// (row i of the pair at probs + i * ldp) and accumulates the dropped p times
// V (p normalised: no final division).
template <int NC>
__global__ void __launch_bounds__(NTH)
attn_f32_sp_fwd_kernel(const float* __restrict__ qkv, const float* __restrict__ key_bias, float* __restrict__ out,
                       bf16* __restrict__ probs, int T, int H, int D, int ldp, Layout L, uint32_t seed, uint32_t thr,
                       float inv, int dropout, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                 // [CHUNK][D]
  float* Ks = Qs + CHUNK * D;       // [KT][D + 1]
  float* Vs = Ks + KT * (D + 1);    // [KT][D]
  float* kbs = Vs + KT * D;         // [KT] key bias * log2(e)
  const int h = blockIdx.x, b = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* q = qkv + b * L.qb + h * L.qh;
  const uint32_t bh = (uint32_t)(b * H + h);
  bf16* pb = probs + (long long)bh * T * ldp;
  const float c1 = scale * LOG2E;

  for (int r0 = 0; r0 < T; r0 += CHUNK) {
    __syncthreads();  // every warp is done with the last chunk's rows
    load_rows(Qs, D, q, L.qt, nullptr, r0, CHUNK, T, D);
    float m[RW], l[RW], o[RW][NC];
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) {
      m[rr] = -INFINITY;
      l[rr] = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) o[rr][c] = 0.f;
    }
    for (int pass = 0; pass < 2; ++pass) {
      for (int k0 = 0; k0 < T; k0 += KT) {
        __syncthreads();  // every warp is done with the last tile
        load_rows(Ks, D + 1, q + L.part, L.qt, nullptr, k0, KT, T, D);
        if (pass == 1) load_rows(Vs, D, q + 2 * L.part, L.qt, nullptr, k0, KT, T, D);
        if (threadIdx.x < KT)
          kbs[threadIdx.x] = k0 + threadIdx.x < T ? key_bias[(long long)b * T + k0 + threadIdx.x] * LOG2E : -INFINITY;
        __syncthreads();
        const int j = k0 + lane;
        float s[RW] = {};
        for (int d = 0; d < D; ++d) {
          const float kv = Ks[lane * (D + 1) + d];
#pragma unroll
          for (int rr = 0; rr < RW; ++rr) s[rr] += Qs[(warp * RW + rr) * D + d] * kv;
        }
        float p[RW];
#pragma unroll
        for (int rr = 0; rr < RW; ++rr) {
          const int i = r0 + warp * RW + rr;
          const float t = j < T ? s[rr] * c1 + kbs[lane] : -INFINITY;
          if (pass == 0) {
            const float mnew = fmaxf(m[rr], warp_max(t));
            l[rr] = l[rr] * exp2f(m[rr] - mnew) + warp_sum(exp2f(t - mnew));
            m[rr] = mnew;
            p[rr] = 0.f;
          } else {
            p[rr] = exp2f(t - m[rr]);  // m holds the row statistic in pass 2
            if (i < T && j < T) pb[(long long)i * ldp + j] = __float2bfloat16(p[rr]);
            if (dropout && j < T && i < T) p[rr] = keep(seed, bh, i, j, thr) ? p[rr] * inv : 0.f;
          }
        }
        if (pass == 0) continue;
        const int nk = min(KT, T - k0);
        for (int jj = 0; jj < nk; ++jj) {
          float vv[NC];
#pragma unroll
          for (int c = 0; c < NC; ++c) vv[c] = lane + 32 * c < D ? Vs[jj * D + lane + 32 * c] : 0.f;
#pragma unroll
          for (int rr = 0; rr < RW; ++rr) {
            const float pj = __shfl_sync(0xffffffffu, p[rr], jj);
#pragma unroll
            for (int c = 0; c < NC; ++c) o[rr][c] += pj * vv[c];
          }
        }
      }
      if (pass == 0) {
#pragma unroll
        for (int rr = 0; rr < RW; ++rr) m[rr] += log2f(l[rr]);
      }
    }
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) {
      const int i = r0 + warp * RW + rr;
      if (i >= T) continue;
      float* orow = out + b * L.ob + h * L.oh + i * L.ot;
#pragma unroll
      for (int c = 0; c < NC; ++c)
        if (lane + 32 * c < D) orow[lane + 32 * c] = o[rr][c];
    }
  }
}

// The block's column sums (each warp's lanes hold columns lane + 32 c of
// their rows) summed over the warps in order into dst[0 .. D).
template <int NC>
__device__ __forceinline__ void block_colsum(const float (&cs)[NC], float* red, float* __restrict__ dst, int D) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
#pragma unroll
  for (int c = 0; c < NC; ++c)
    if (lane + 32 * c < D) red[warp * MAX_D + lane + 32 * c] = cs[c];
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += NTH) {
    float v = 0.f;
    for (int w = 0; w < NW; ++w) v += red[w * MAX_D + d];
    dst[d] = v;
  }
}

// The saved probability of query i, key j of a pair (row i at pb + i *
// ldp), 0 past T.
__device__ __forceinline__ float saved_p(const bf16* __restrict__ pb, int ldp, int i, int j, int T) {
  return i < T && j < T ? __bfloat162float(pb[(long long)i * ldp + j]) : 0.f;
}

// grid (H, B): the dQ pass of pair (b, h); also writes delta. SP: p from
// the saved probabilities (probs, ldp) in place of exp2(t - stats).
template <int NC, bool SP>
__global__ void __launch_bounds__(NTH)
attn_f32_dq_kernel(const float* __restrict__ qkv, const float* __restrict__ qb, const float* __restrict__ key_bias,
                   const float* __restrict__ dout, const float* __restrict__ out, const float* __restrict__ stats,
                   const bf16* __restrict__ probs, int ldp, float* __restrict__ dqkv, float* __restrict__ db_part,
                   float* __restrict__ delta_g, int T, int H, int D, Layout L, uint32_t seed, uint32_t thr, float inv,
                   int dropout, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                    // [CHUNK][D]
  float* dOs = Qs + CHUNK * D;         // [CHUNK][D]
  float* Ks = dOs + CHUNK * D;         // [KT][D + 1]
  float* Vs = Ks + KT * (D + 1);       // [KT][D + 1]
  float* kbs = Vs + KT * (D + 1);      // [KT]
  float* red = kbs + 3 * KT;           // [NW][MAX_D]
  const int h = blockIdx.x, b = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* q = qkv + b * L.qb + h * L.qh;
  const float* bq = qb ? qb + h * L.bh : nullptr;
  const float* dob = dout + b * L.ob + h * L.oh;
  const float* ob = out + b * L.ob + h * L.oh;
  float* dq_out = dqkv + b * L.qb + h * L.qh;
  const uint32_t bh = (uint32_t)(b * H + h);
  const bf16* pb = SP ? probs + (long long)bh * T * ldp : nullptr;
  const float c1 = scale * LOG2E;
  float cs[NC] = {};

  for (int r0 = 0; r0 < T; r0 += CHUNK) {
    __syncthreads();
    load_rows(Qs, D, q, L.qt, bq, r0, CHUNK, T, D);
    load_rows(dOs, D, dob, L.ot, nullptr, r0, CHUNK, T, D);
    float st[RW], dl[RW], dq[RW][NC];
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) {
      const int i = r0 + warp * RW + rr;
      float a = 0.f;
      if (i < T)
        for (int d = lane; d < D; d += 32) a += dob[(long long)i * L.ot + d] * ob[(long long)i * L.ot + d];
      dl[rr] = warp_sum(a);
      st[rr] = !SP && i < T ? stats[(long long)bh * T + i] : 0.f;
      if (i < T && lane == 0) delta_g[(long long)bh * T + i] = dl[rr];
#pragma unroll
      for (int c = 0; c < NC; ++c) dq[rr][c] = 0.f;
    }
    for (int k0 = 0; k0 < T; k0 += KT) {
      __syncthreads();
      load_rows(Ks, D + 1, q + L.part, L.qt, bq ? bq + L.bpart : nullptr, k0, KT, T, D);
      load_rows(Vs, D + 1, q + 2 * L.part, L.qt, bq ? bq + 2 * L.bpart : nullptr, k0, KT, T, D);
      if (!SP && threadIdx.x < KT)
        kbs[threadIdx.x] = k0 + threadIdx.x < T ? key_bias[(long long)b * T + k0 + threadIdx.x] * LOG2E : 0.f;
      __syncthreads();
      const int j = k0 + lane;
      float s[RW] = {}, dp[RW] = {};
      for (int d = 0; d < D; ++d) {
        const float kv = Ks[lane * (D + 1) + d], vv = Vs[lane * (D + 1) + d];
#pragma unroll
        for (int rr = 0; rr < RW; ++rr) {
          if (!SP) s[rr] += Qs[(warp * RW + rr) * D + d] * kv;
          dp[rr] += dOs[(warp * RW + rr) * D + d] * vv;
        }
      }
      float ds[RW];
#pragma unroll
      for (int rr = 0; rr < RW; ++rr) {
        const int i = r0 + warp * RW + rr;
        const float p = SP ? saved_p(pb, ldp, i, j, T) : (j < T ? exp2f(s[rr] * c1 + kbs[lane] - st[rr]) : 0.f);
        float d = dp[rr];
        if (dropout && j < T && i < T) d = keep(seed, bh, i, j, thr) ? d * inv : 0.f;
        ds[rr] = p * (d - dl[rr]);  // dS (the scale goes on dQ)
      }
      const int nk = min(KT, T - k0);
      for (int jj = 0; jj < nk; ++jj) {
        float kk[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) kk[c] = lane + 32 * c < D ? Ks[jj * (D + 1) + lane + 32 * c] : 0.f;
#pragma unroll
        for (int rr = 0; rr < RW; ++rr) {
          const float v = __shfl_sync(0xffffffffu, ds[rr], jj);
#pragma unroll
          for (int c = 0; c < NC; ++c) dq[rr][c] += v * kk[c];
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) {
      const int i = r0 + warp * RW + rr;
      if (i >= T) continue;
#pragma unroll
      for (int c = 0; c < NC; ++c)
        if (lane + 32 * c < D) {
          const float v = dq[rr][c] * scale;
          dq_out[(long long)i * L.qt + lane + 32 * c] = v;
          cs[c] += v;
        }
    }
  }
  if (db_part) block_colsum(cs, red, db_part + (long long)b * 3 * H * D + h * L.bh, D);
}

// grid (H, B): the dK/dV pass of pair (b, h), on the dQ pass's delta; SP
// as the dQ pass's.
template <int NC, bool SP>
__global__ void __launch_bounds__(NTH)
attn_f32_dkv_kernel(const float* __restrict__ qkv, const float* __restrict__ qb, const float* __restrict__ key_bias,
                    const float* __restrict__ dout, const float* __restrict__ stats,
                    const bf16* __restrict__ probs, int ldp, const float* __restrict__ delta_g,
                    float* __restrict__ dqkv, float* __restrict__ db_part, int T, int H, int D, Layout L,
                    uint32_t seed, uint32_t thr, float inv, int dropout, float scale) {
  extern __shared__ float smem[];
  float* Kc = smem;                    // [CHUNK][D] this chunk's keys
  float* Vc = Kc + CHUNK * D;          // [CHUNK][D]
  float* Qt = Vc + CHUNK * D;          // [KT][D + 1] a query tile
  float* dOt = Qt + KT * (D + 1);      // [KT][D + 1]
  float* stt = dOt + KT * (D + 1);     // [KT] stats; +inf past T: p = 0
  float* dlt = stt + KT;               // [KT]
  float* kbc = dlt + KT;               // [KT] = [CHUNK] the chunk's key bias * log2(e)
  float* red = kbc + KT;               // [NW][MAX_D]
  const int h = blockIdx.x, b = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* q = qkv + b * L.qb + h * L.qh;
  const float* bq = qb ? qb + h * L.bh : nullptr;
  const float* dob = dout + b * L.ob + h * L.oh;
  float* dk_out = dqkv + b * L.qb + h * L.qh + L.part;
  const uint32_t bh = (uint32_t)(b * H + h);
  const bf16* pb = SP ? probs + (long long)bh * T * ldp : nullptr;
  const float c1 = scale * LOG2E;
  float csk[NC] = {}, csv[NC] = {};

  for (int r0 = 0; r0 < T; r0 += CHUNK) {
    __syncthreads();
    load_rows(Kc, D, q + L.part, L.qt, bq ? bq + L.bpart : nullptr, r0, CHUNK, T, D);
    load_rows(Vc, D, q + 2 * L.part, L.qt, bq ? bq + 2 * L.bpart : nullptr, r0, CHUNK, T, D);
    if (!SP && threadIdx.x < CHUNK)
      kbc[threadIdx.x] = r0 + threadIdx.x < T ? key_bias[(long long)b * T + r0 + threadIdx.x] * LOG2E : 0.f;
    float dk[RW][NC], dv[RW][NC];
#pragma unroll
    for (int rr = 0; rr < RW; ++rr)
#pragma unroll
      for (int c = 0; c < NC; ++c) dk[rr][c] = dv[rr][c] = 0.f;
    for (int q0 = 0; q0 < T; q0 += KT) {
      __syncthreads();
      load_rows(Qt, D + 1, q, L.qt, bq, q0, KT, T, D);
      load_rows(dOt, D + 1, dob, L.ot, nullptr, q0, KT, T, D);
      if (threadIdx.x < KT) {
        const int i = q0 + threadIdx.x;
        stt[threadIdx.x] = !SP && i < T ? stats[(long long)bh * T + i] : INFINITY;
        dlt[threadIdx.x] = i < T ? delta_g[(long long)bh * T + i] : 0.f;
      }
      __syncthreads();
      const int i = q0 + lane;
      float s[RW] = {}, dp[RW] = {};
      for (int d = 0; d < D; ++d) {
        const float qv = Qt[lane * (D + 1) + d], gv = dOt[lane * (D + 1) + d];
#pragma unroll
        for (int rr = 0; rr < RW; ++rr) {
          if (!SP) s[rr] += Kc[(warp * RW + rr) * D + d] * qv;
          dp[rr] += Vc[(warp * RW + rr) * D + d] * gv;
        }
      }
      float pd[RW], ds[RW];
#pragma unroll
      for (int rr = 0; rr < RW; ++rr) {
        const int j = r0 + warp * RW + rr;
        const float p = SP ? saved_p(pb, ldp, i, j, T) : exp2f(s[rr] * c1 + kbc[warp * RW + rr] - stt[lane]);
        float pdrop = p, d = dp[rr];
        if (dropout && j < T && i < T) {
          const bool k = keep(seed, bh, i, j, thr);
          pdrop = k ? p * inv : 0.f;
          d = k ? d * inv : 0.f;
        }
        pd[rr] = pdrop;
        ds[rr] = p * (d - dlt[lane]);
      }
      const int nq = min(KT, T - q0);
      for (int ii = 0; ii < nq; ++ii) {
        float qq[NC], gg[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const bool ok = lane + 32 * c < D;
          qq[c] = ok ? Qt[ii * (D + 1) + lane + 32 * c] : 0.f;
          gg[c] = ok ? dOt[ii * (D + 1) + lane + 32 * c] : 0.f;
        }
#pragma unroll
        for (int rr = 0; rr < RW; ++rr) {
          const float a = __shfl_sync(0xffffffffu, pd[rr], ii), e = __shfl_sync(0xffffffffu, ds[rr], ii);
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            dv[rr][c] += a * gg[c];
            dk[rr][c] += e * qq[c];
          }
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) {
      const int j = r0 + warp * RW + rr;
      if (j >= T) continue;
#pragma unroll
      for (int c = 0; c < NC; ++c)
        if (lane + 32 * c < D) {
          const float k = dk[rr][c] * scale, v = dv[rr][c];
          dk_out[(long long)j * L.qt + lane + 32 * c] = k;
          dk_out[(long long)j * L.qt + L.part + lane + 32 * c] = v;
          csk[c] += k;
          csv[c] += v;
        }
    }
  }
  if (db_part) {
    float* part = db_part + (long long)b * 3 * H * D + h * L.bh;
    block_colsum(csk, red, part + L.bpart, D);
    block_colsum(csv, red, part + 2 * L.bpart, D);
  }
}

template <int NC, bool SP>
const void* kernel_of(int which) {
  switch (which) {
    case 0: return SP ? (const void*)attn_f32_sp_fwd_kernel<NC> : (const void*)attn_f32_fwd_kernel<NC>;
    case 1: return (const void*)attn_f32_dq_kernel<NC, SP>;
    case 2: return (const void*)attn_f32_dkv_kernel<NC, SP>;
    default: return nullptr;
  }
}

template <bool SP>
const void* kernel_at(int which, int D) {
  switch ((D + 31) / 32) {
    case 1: return kernel_of<1, SP>(which);
    case 2: return kernel_of<2, SP>(which);
    case 3: return kernel_of<3, SP>(which);
    case 4: return kernel_of<4, SP>(which);
    default: return nullptr;
  }
}

size_t bytes_of(int which, int D) { return which == 0 ? fwd_bytes(D) : bwd_bytes(D); }

template <bool SP>
cudaError_t prepare(int which, int D) {
  return cudaFuncSetAttribute(kernel_at<SP>(which, D), cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes_of(which, D));
}

// The packed layout [B, T, H*3*D] (out [B, T, H*D], qb [H*3*D]).
Layout packed(int T, int H, int D) {
  const long long F = 3LL * H * D;
  return Layout{T * F, 3LL * D, F, D, (long long)T * H * D, D, (long long)H * D, 3LL * D, D};
}

// The heads-major layout [B, 3, H, T, D] (out [B, H, T, D]; no qb).
Layout heads_major(int T, int H, int D) {
  const long long HTD = (long long)H * T * D;
  return Layout{3 * HTD, (long long)T * D, D, HTD, HTD, (long long)T * D, D, 0, 0};
}

template <int NC>
void fwd_at(const float* qkv, const float* qb, const float* key_bias, float* out, float* stats, int B, int T, int H,
            int D, Layout L, uint32_t seed, uint32_t thr, float inv, int dropout, float scale, cudaStream_t s) {
  attn_f32_fwd_kernel<NC><<<dim3(H, B), NTH, fwd_bytes(D), s>>>(qkv, qb, key_bias, out, stats, T, H, D, L, seed, thr,
                                                                 inv, dropout, scale);
}

template <int NC>
void sp_fwd_at(const float* qkv, const float* key_bias, float* out, bf16* probs, int B, int T, int H, int D, int ldp,
               uint32_t seed, uint32_t thr, float inv, int dropout, float scale, cudaStream_t s) {
  attn_f32_sp_fwd_kernel<NC><<<dim3(H, B), NTH, fwd_bytes(D), s>>>(qkv, key_bias, out, probs, T, H, D, ldp,
                                                                    packed(T, H, D), seed, thr, inv, dropout, scale);
}

// Both passes; SP reads p from probs (ldp) and needs neither key_bias nor
// stats.
template <int NC, bool SP>
cudaError_t bwd_at(const float* qkv, const float* qb, const float* key_bias, const float* dout, const float* out,
                   const float* stats, const bf16* probs, int ldp, float* dqkv, float* db_part, float* delta, int B,
                   int T, int H, int D, Layout L, uint32_t seed, uint32_t thr, float inv, int dropout, float scale,
                   cudaStream_t s) {
  attn_f32_dq_kernel<NC, SP><<<dim3(H, B), NTH, bwd_bytes(D), s>>>(qkv, qb, key_bias, dout, out, stats, probs, ldp,
                                                                    dqkv, db_part, delta, T, H, D, L, seed, thr, inv,
                                                                    dropout, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_f32_dkv_kernel<NC, SP><<<dim3(H, B), NTH, bwd_bytes(D), s>>>(qkv, qb, key_bias, dout, stats, probs, ldp, delta,
                                                                     dqkv, db_part, T, H, D, L, seed, thr, inv,
                                                                     dropout, scale);
  return cudaGetLastError();
}

int info(const void* fn, int which, int what, int D, cudaError_t (*prep)(int, int)) {
  if (fn == nullptr) return -1;
  const size_t bytes = bytes_of(which, D);
  if (what == 0 || what == 1) {
    cudaFuncAttributes attr;
    if (cudaFuncGetAttributes(&attr, fn) != cudaSuccess) return -1;
    return what == 0 ? attr.numRegs : (int)attr.localSizeBytes;
  }
  if (what == 2) return (int)bytes;
  if (what == 3) {
    int n = 0;
    if (prep(which, D) != cudaSuccess) return -1;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, NTH, bytes) != cudaSuccess) return -1;
    return n;
  }
  return -1;
}

int fwd(const float* qkv, const float* qb, const float* key_bias, float* out, float* stats, int B, int T, int H,
        int D, Layout L, unsigned int seed, unsigned int threshold, float inv, int dropout, float scale,
        cudaStream_t s) {
  if (D < 1 || D > MAX_D) return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare<false>(0, D);
  if (err != cudaSuccess) return (int)err;
  auto* f = (D + 31) / 32 == 1 ? fwd_at<1> : (D + 31) / 32 == 2 ? fwd_at<2> : (D + 31) / 32 == 3 ? fwd_at<3> : fwd_at<4>;
  f(qkv, qb, key_bias, out, stats, B, T, H, D, L, seed, threshold, inv, dropout, scale, s);
  return (int)cudaGetLastError();
}

template <bool SP>
int bwd(const float* qkv, const float* qb, const float* key_bias, const float* dout, const float* out,
        const float* stats, const bf16* probs, int ldp, float* dqkv, float* db_part, float* delta, int B, int T, int H,
        int D, Layout L, unsigned int seed, unsigned int threshold, float inv, int dropout, float scale,
        cudaStream_t s) {
  if (D < 1 || D > MAX_D) return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare<SP>(1, D);
  if (err == cudaSuccess) err = prepare<SP>(2, D);
  if (err != cudaSuccess) return (int)err;
  auto* f = (D + 31) / 32 == 1   ? bwd_at<1, SP>
            : (D + 31) / 32 == 2 ? bwd_at<2, SP>
            : (D + 31) / 32 == 3 ? bwd_at<3, SP>
                                 : bwd_at<4, SP>;
  return (int)f(qkv, qb, key_bias, dout, out, stats, probs, ldp, dqkv, db_part, delta, B, T, H, D, L, seed, threshold,
                inv, dropout, scale, s);
}

}  // namespace

// Kernel `which` (0 forward, 1 dQ pass, 2 dK/dV pass) at head dim D:
// `what` 0 its registers a thread, 1 its local (spill) bytes, 2 its dynamic
// shared memory, 3 its resident blocks per SM. -1 on an error or a D
// outside 1..128. K11/K12 run these kernels on their own strides.
extern "C" int vb_attn_f32_info(int which, int what, int D) {
  return info(D >= 1 && D <= MAX_D ? kernel_at<false>(which, D) : nullptr, which, what, D, prepare<false>);
}

// The same of the save-probs kernels (K13/K14 in fp32).
extern "C" int vb_attn_f32_sp_info(int which, int what, int D) {
  return info(D >= 1 && D <= MAX_D ? kernel_at<true>(which, D) : nullptr, which, what, D, prepare<true>);
}

extern "C" int vb_attn_f32_fwd(const void* qkv, const void* qb, const void* key_bias, void* out, void* stats, int B,
                               int T, int H, int D, unsigned int seed, unsigned int threshold, float inv, int dropout,
                               float scale, void* stream) {
  return fwd(static_cast<const float*>(qkv), static_cast<const float*>(qb), static_cast<const float*>(key_bias),
             static_cast<float*>(out), static_cast<float*>(stats), B, T, H, D, packed(T, H, D), seed, threshold, inv,
             dropout, scale, static_cast<cudaStream_t>(stream));
}

// db_part [B, H*3*D] and delta [B, H, T] are scratch the caller allocates.
extern "C" int vb_attn_f32_bwd(const void* qkv, const void* qb, const void* key_bias, const void* dout,
                               const void* out, const void* stats, void* dqkv, void* db_part, void* delta, int B,
                               int T, int H, int D, unsigned int seed, unsigned int threshold, float inv, int dropout,
                               float scale, void* stream) {
  return bwd<false>(static_cast<const float*>(qkv), static_cast<const float*>(qb),
                    static_cast<const float*>(key_bias), static_cast<const float*>(dout),
                    static_cast<const float*>(out), static_cast<const float*>(stats), nullptr, 0,
                    static_cast<float*>(dqkv), static_cast<float*>(db_part), static_cast<float*>(delta), B, T, H, D,
                    packed(T, H, D), seed, threshold, inv, dropout, scale, static_cast<cudaStream_t>(stream));
}

// K11 in fp32: qkv [B, 3, H, T, D] (bias added), out [B, H, T, D], stats
// [B, H, T].
extern "C" int vb_attn_f32_hm_fwd(const void* qkv, const void* key_bias, void* out, void* stats, int B, int T, int H,
                                  int D, unsigned int seed, unsigned int threshold, float inv, int dropout,
                                  float scale, void* stream) {
  return fwd(static_cast<const float*>(qkv), nullptr, static_cast<const float*>(key_bias), static_cast<float*>(out),
             static_cast<float*>(stats), B, T, H, D, heads_major(T, H, D), seed, threshold, inv, dropout, scale,
             static_cast<cudaStream_t>(stream));
}

// K12 in fp32: dqkv [B, 3, H, T, D]; delta [B, H, T] is scratch.
extern "C" int vb_attn_f32_hm_bwd(const void* qkv, const void* key_bias, const void* dout, const void* out,
                                  const void* stats, void* dqkv, void* delta, int B, int T, int H, int D,
                                  unsigned int seed, unsigned int threshold, float inv, int dropout, float scale,
                                  void* stream) {
  return bwd<false>(static_cast<const float*>(qkv), nullptr, static_cast<const float*>(key_bias),
                    static_cast<const float*>(dout), static_cast<const float*>(out),
                    static_cast<const float*>(stats), nullptr, 0, static_cast<float*>(dqkv), nullptr,
                    static_cast<float*>(delta), B, T, H, D, heads_major(T, H, D), seed, threshold, inv, dropout,
                    scale, static_cast<cudaStream_t>(stream));
}

// K13 in fp32: qkv [B, T, H*3*D] with the bias added, out [B, T, H*D],
// probs [B, H, T, ldp] bf16 storage of the [B, H, T, T] probabilities.
extern "C" int vb_attn_f32_sp_fwd(const void* qkv, const void* key_bias, void* out, void* probs, int B, int T, int H,
                                  int D, int ldp, unsigned int seed, unsigned int threshold, float inv, int dropout,
                                  float scale, void* stream) {
  if (D < 1 || D > MAX_D || ldp < T) return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare<true>(0, D);
  if (err != cudaSuccess) return (int)err;
  auto* f = (D + 31) / 32 == 1   ? sp_fwd_at<1>
            : (D + 31) / 32 == 2 ? sp_fwd_at<2>
            : (D + 31) / 32 == 3 ? sp_fwd_at<3>
                                 : sp_fwd_at<4>;
  f(static_cast<const float*>(qkv), static_cast<const float*>(key_bias), static_cast<float*>(out),
    static_cast<bf16*>(probs), B, T, H, D, ldp, seed, threshold, inv, dropout, scale,
    static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// K14 in fp32: dqkv [B, T, H*3*D] from the saved probabilities (row stride
// ldp); delta [B, H, T] is scratch.
extern "C" int vb_attn_f32_sp_bwd(const void* qkv, const void* probs, const void* dout, const void* out, void* dqkv,
                                  void* delta, int B, int T, int H, int D, int ldp, unsigned int seed,
                                  unsigned int threshold, float inv, int dropout, float scale, void* stream) {
  if (ldp < T) return (int)cudaErrorInvalidValue;
  return bwd<true>(static_cast<const float*>(qkv), nullptr, nullptr, static_cast<const float*>(dout),
                   static_cast<const float*>(out), nullptr, static_cast<const bf16*>(probs), ldp,
                   static_cast<float*>(dqkv), nullptr, static_cast<float*>(delta), B, T, H, D, packed(T, H, D), seed,
                   threshold, inv, dropout, scale, static_cast<cudaStream_t>(stream));
}
