// K11/K12: heads-major attention forward and backward. Replace
// visualbert_tpu/ops/flash_attention.py::_fwd_kernel and ::_bwd_kernel
// (reached through flash_attention with heads_major=True, the encoder's
// packed_qkv=False path).
//
// The templates below take a layout (attn_common.cuh); only the heads-major
// one is instantiated here (the packed K1/K2 are flash_attention_packed.cu),
// so their packed-layout branches (the deferred bias qb and its gradient,
// L::kBiasGrad) compile to nothing. They stay as they were until K11/K12
// take K1/K2's design. K11/K12 read qkv [B, 3, H, T, D] bf16
// with the bias already added (q, k and v are slices of that one tensor: the
// kernels take its base pointer, never three copies) and K12 writes one
// [B, 3, H, T, D] gradient. key_bias [B, T] fp32 (0 or -10000). out [B, T,
// H*D] (K1) or [B, H, T, D] (K11) bf16, stats [B, H, T] fp32 with stats =
// max_j t + log2 sum_j exp2(t - max), where t = (q.k) * scale * log2(e) +
// key_bias * log2(e): the base-2 form of the JAX kernels' softmax (K11's
// natural-base exp is the same function). The TPU heads-major pair keeps no
// statistics and its backward recomputes max and sum; K11 writes the
// statistic as K1 does, so K12 rebuilds p = exp2(t - stats) in one pass and
// uses delta = rowsum(dO * O) for rowsum(dP * P): the same function, without
// a second pass over the keys. Dropout on the probabilities uses the Philox
// bits of philox.cuh::attn_philox, a pure function of (seed, b, h, i, j), so
// the kernels below draw the identical mask although they tile differently.
//
// Bound on the H100: at B=128, T=228, H=12 the forward does 20 GFLOP per
// call on 134 MB of q, k and v, so it is bound by math and, with dropout on,
// by the integer work of Philox (one 10-round call per 2 probabilities).
// This first version uses mma.sync m16n8k16 (bf16 in, fp32 accumulate) with
// fragments read from padded shared memory (no bank conflicts, no ldmatrix,
// no TMA, no wgmma): correct and simple first; the fast Hopper path is later
// work.
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
// K2's QKV-bias gradient is emitted as fp32 partials [B, ceil(T/64), F] of
// the column sums of the stored (bf16-rounded) dqkv; the caller sums them.
#include "attn_common.cuh"

namespace {

using namespace vb_attn;
using vb::c_to_a;
using vb::load_a;
using vb::load_b_cols;
using vb::load_b_rows;
using vb::mma16816;

// The deferred bias of (h, j) in the packed [H*3*D] order, or none.
__device__ __forceinline__ const bf16* bias_of(const bf16* qb, int h, int j) {
  return qb == nullptr ? nullptr : qb + (3 * h + j) * D;
}

// ---------------------------------------------------------------- forward

template <class L>
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
  const int ld = L::ld_in(H);
  load_tile(Qs, qkv + L::in_off(b, h, 0, T, H), bias_of(qb, h, 0), qt * TILE, TILE, T, ld);
  load_tile(Ks, qkv + L::in_off(b, h, 1, T, H), bias_of(qb, h, 1), 0, Tp, T, ld);
  load_tile(Vs, qkv + L::in_off(b, h, 2, T, H), bias_of(qb, h, 2), 0, Tp, T, ld);
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
  for (int kk = 0; kk < 4; ++kk) load_a<LDS>(qa[kk], Qs, r0, kk * 16, g, tq);

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
        load_b_rows<LDS>(b0, b1, Ks, k0 + nt * 8, kk * 16, g, tq);
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
        load_b_cols<LDS>(b0, b1, Vs, k0 + c * 16, nt * 8, g, tq);
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
  bf16* ob = out + L::out_off(b, h, T, H);
  const int ldo = L::ld_out(H);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int c = nt * 8 + 2 * tq;
    if (ok[0]) *reinterpret_cast<uint32_t*>(ob + (size_t)row[0] * ldo + c) = pack_bf16(o[nt][0] * sc[0], o[nt][1] * sc[0]);
    if (ok[1]) *reinterpret_cast<uint32_t*>(ob + (size_t)row[1] * ldo + c) = pack_bf16(o[nt][2] * sc[1], o[nt][3] * sc[1]);
  }
  if (tq == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (ok[r]) stats[((size_t)b * H + h) * T + row[r]] = m[r] + log2f(l[r]);
  }
}

// ------------------------------------------------------- backward: dQ pass

template <class L>
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
  const int ld = L::ld_in(H), ldo = L::ld_out(H), nt_tiles = Tp / TILE;
  const size_t oo = L::out_off(b, h, T, H);
  const size_t sb = ((size_t)b * H + h) * T;  // (b, h)'s rows of stats and delta
  load_tile(Qs, qkv + L::in_off(b, h, 0, T, H), bias_of(qb, h, 0), qt * TILE, TILE, T, ld);
  load_tile(dOs, dout + oo, nullptr, qt * TILE, TILE, T, ldo);
  load_tile(Ks, qkv + L::in_off(b, h, 1, T, H), bias_of(qb, h, 1), 0, Tp, T, ld);
  load_tile(Vs, qkv + L::in_off(b, h, 2, T, H), bias_of(qb, h, 2), 0, Tp, T, ld);
  for (int j = threadIdx.x; j < Tp; j += NTHREADS)
    bias2[j] = j < T ? key_bias[(size_t)b * T + j] * LOG2E : -INFINITY;
  row_delta(dout + oo, out + oo, ldo, dl_s, delta_g + sb, qt, T);
  for (int r = threadIdx.x; r < TILE; r += NTHREADS) {
    const int i = qt * TILE + r;
    st_s[r] = i < T ? stats[sb + i] : 0.f;
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
    load_a<LDS>(qa[kk], Qs, r0, kk * 16, g, tq);
    load_a<LDS>(da[kk], dOs, r0, kk * 16, g, tq);
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
        load_b_rows<LDS>(b0, b1, Ks, k0 + nt * 8, kk * 16, g, tq);
        mma16816(s[nt], qa[kk], b0, b1);
        load_b_rows<LDS>(b0, b1, Vs, k0 + nt * 8, kk * 16, g, tq);
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
        load_b_cols<LDS>(b0, b1, Ks, k0 + c * 16, nt * 8, g, tq);
        mma16816(dq[nt], sa, b0, b1);
      }
    }
  }

  const bool ok0 = row[0] < T, ok1 = row[1] < T;
  store_rows(dqkv + L::in_off(b, h, 0, T, H), dq, SCALE, row[0], row[1], ok0, ok1, ld, tq);
  if constexpr (L::kBiasGrad) {
    const int F = 3 * H * D;
    float colsum = 0.f;
    block_colsum(dq, SCALE, ok0, ok1, red, warp, g, tq, &colsum);
    if (threadIdx.x < D)
      db_part[((size_t)b * nt_tiles + qt) * F + (3 * h + 0) * D + threadIdx.x] = colsum;
  }
}

// --------------------------------------------------- backward: dK, dV pass

template <class L>
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
  const int ld = L::ld_in(H), nt_tiles = Tp / TILE;
  const size_t sb = ((size_t)b * H + h) * T;
  load_tile(Ks, qkv + L::in_off(b, h, 1, T, H), bias_of(qb, h, 1), kt * TILE, TILE, T, ld);
  load_tile(Vs, qkv + L::in_off(b, h, 2, T, H), bias_of(qb, h, 2), kt * TILE, TILE, T, ld);
  load_tile(Qs, qkv + L::in_off(b, h, 0, T, H), bias_of(qb, h, 0), 0, Tp, T, ld);
  load_tile(dOs, dout + L::out_off(b, h, T, H), nullptr, 0, Tp, T, L::ld_out(H));
  for (int i = threadIdx.x; i < Tp; i += NTHREADS) {
    // padded queries: stats = +inf makes their probabilities exactly 0
    st_s[i] = i < T ? stats[sb + i] : INFINITY;
    dl_s[i] = i < T ? delta_g[sb + i] : 0.f;
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
    load_a<LDS>(ka[kk], Ks, r0, kk * 16, g, tq);
    load_a<LDS>(va[kk], Vs, r0, kk * 16, g, tq);
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
        load_b_rows<LDS>(b0, b1, Qs, q0 + nt * 8, kk * 16, g, tq);
        mma16816(st[nt], ka[kk], b0, b1);
        load_b_rows<LDS>(b0, b1, dOs, q0 + nt * 8, kk * 16, g, tq);
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
        load_b_cols<LDS>(b0, b1, dOs, q0 + c * 16, nt * 8, g, tq);
        mma16816(dv[nt], pa, b0, b1);
        load_b_cols<LDS>(b0, b1, Qs, q0 + c * 16, nt * 8, g, tq);
        mma16816(dk[nt], sa, b0, b1);
      }
    }
  }

  const bool ok0 = key[0] < T, ok1 = key[1] < T;
  store_rows(dqkv + L::in_off(b, h, 1, T, H), dk, SCALE, key[0], key[1], ok0, ok1, ld, tq);
  store_rows(dqkv + L::in_off(b, h, 2, T, H), dv, 1.f, key[0], key[1], ok0, ok1, ld, tq);
  if constexpr (L::kBiasGrad) {
    const int F = 3 * H * D;
    float colsum = 0.f;
    float* part = db_part + ((size_t)b * nt_tiles + kt) * F;
    block_colsum(dk, SCALE, ok0, ok1, red, warp, g, tq, &colsum);
    if (threadIdx.x < D) part[(3 * h + 1) * D + threadIdx.x] = colsum;
    block_colsum(dv, 1.f, ok0, ok1, red, warp, g, tq, &colsum);
    if (threadIdx.x < D) part[(3 * h + 2) * D + threadIdx.x] = colsum;
  }
}

template <class L>
int launch_fwd(const void* qkv, const void* qb, const void* key_bias, void* out, void* stats, int B, int T,
               int H, unsigned int seed, unsigned int threshold, float inv, int dropout, void* stream) {
  const size_t smem = fwd_smem(T);
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + TILE - 1) / TILE, H, B);
  attn_fwd_kernel<L><<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(qb), static_cast<const float*>(key_bias),
      static_cast<bf16*>(out), static_cast<float*>(stats), T, H, seed, threshold, inv, dropout);
  return (int)cudaGetLastError();
}

template <class L>
int launch_bwd(const void* qkv, const void* qb, const void* key_bias, const void* dout, const void* out,
               const void* stats, void* dqkv, void* db_part, void* delta, int B, int T, int H, unsigned int seed,
               unsigned int threshold, float inv, int dropout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((T + TILE - 1) / TILE, H, B);
  const size_t smem_dq = dq_smem(T), smem_dkv = dkv_smem(T);
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_dq_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_dq);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attn_bwd_dkv_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dkv);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dq_kernel<L><<<grid, NTHREADS, smem_dq, s>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(qb), static_cast<const float*>(key_bias),
      static_cast<const bf16*>(dout), static_cast<const bf16*>(out), static_cast<const float*>(stats),
      static_cast<bf16*>(dqkv), static_cast<float*>(db_part), static_cast<float*>(delta), T, H, seed,
      threshold, inv, dropout);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dkv_kernel<L><<<grid, NTHREADS, smem_dkv, s>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(qb), static_cast<const float*>(key_bias),
      static_cast<const bf16*>(dout), static_cast<const float*>(stats), static_cast<const float*>(delta),
      static_cast<bf16*>(dqkv), static_cast<float*>(db_part), T, H, seed, threshold, inv, dropout);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" size_t vb_attn_smem_bytes(int T) {
  size_t a = fwd_smem(T), b = dq_smem(T), c = dkv_smem(T);
  size_t m = a > b ? a : b;
  return m > c ? m : c;
}

extern "C" int vb_attn_hm_fwd(const void* qkv, const void* key_bias, void* out, void* stats, int B, int T, int H,
                              unsigned int seed, unsigned int threshold, float inv, int dropout, void* stream) {
  return launch_fwd<HeadsMajorLayout>(qkv, nullptr, key_bias, out, stats, B, T, H, seed, threshold, inv, dropout,
                                      stream);
}

extern "C" int vb_attn_hm_bwd(const void* qkv, const void* key_bias, const void* dout, const void* out,
                              const void* stats, void* dqkv, void* delta, int B, int T, int H, unsigned int seed,
                              unsigned int threshold, float inv, int dropout, void* stream) {
  return launch_bwd<HeadsMajorLayout>(qkv, nullptr, key_bias, dout, out, stats, dqkv, nullptr, delta, B, T, H,
                                      seed, threshold, inv, dropout, stream);
}
