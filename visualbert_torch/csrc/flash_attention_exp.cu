// K15/K16: the attention experiment variants of K1/K2. K15 replaces
// scripts/attn_exp.py::make_variant (fwd_kernel :53, bwd_kernel :100, their
// pallas_calls :234 and :249); K16 replaces scripts/attn_hgrid.py::make_hgrid
// (fwd_kernel :56, bwd_kernel :90, pallas_calls :172 and :189).
//
// Both compute K1/K2's function (flash_attention_packed.cu) on packed qkv
// [B, T, H*3*D] bf16 with the deferred QKV bias qb [H*3*D], the key bias
// [B, T] fp32 and a dropout seed: out [B, T, H*D], the base-2 row statistic
// stats [B, H, T] (K16's [B, H/hg, hg, T] is the same memory), dqkv [B, T,
// H*3*D] and fp32 partial column sums of the bias gradient. They differ from
// K1/K2 only in
//
// * numerics, compile-time flags:
//   - PRESCALE: q becomes bf16(q * scale * log2(e)) before QK^T, for the
//     scores only; dK still takes the unscaled q (attn_exp.py:64-72,
//     117-125, 159-168, 210-217);
//   - NOMAX: the forward keeps no running max: p = exp2(t) and stats =
//     log2 sum_j exp2(t) (:73-76);
//   - FDROP: the backward's ds = f32(bf16(p * keep / (1 - rate))) * dP -
//     p * delta, with dropout on only (:198-201); at rate 0 it is the base
//     variant;
// * schedule, runtime counts: a block walks `rows` batch rows x `heads`
//   heads on a (ceil(B / rows), ceil(H / heads)) grid, every 64-query tile
//   of each (batch row, head) pair (every 64-key tile in the dK/dV pass),
//   and loads that pair's K and V (Q and dO in the dK/dV pass) into shared
//   memory once. K15's forward runs rows = bb, heads = H; its backward rows
//   = bb, heads = group (1 for nostack); K16 runs rows = 1, heads = hg in
//   both passes. K1/K2's first design ran one (64-query tile, head, batch
//   row) a block and reloaded the pair's K and V for every tile. The TPU's
//   backward head group and its 2-D (batch, head-group) grid are one knob
//   here, the heads of a block: K15 at bb = 1 and group = g runs K16 at
//   hg = g's backward.
//
// The TPU variants salt their dropout seed by head group. Here, as for
// K1-K14, the keep bit of probability (b, h, i, j) is
// philox.cuh::attn_philox's, a pure function of (seed, b, h, i, j): every
// variant draws K1's mask whatever its grouping.
//
// The bias gradient: block (x, y) writes the column sums over its batch rows
// of the (bf16-rounded) dqkv columns of its heads into row x of db_part
// [ceil(B / rows), H*3*D] (K15: [B / bb, 1, F], K16: [B, 1, F] in the TPU
// scripts), summing its tiles in a fixed order; no atomics, so results do
// not depend on run order. The caller sums the rows.
//
// Bound: the function is K1/K2's, bound by math and, with dropout on, by
// Philox's integer work. These kernels are K1/K2's tile code (mma.sync
// m16n8k16, fragments from padded shared memory, 4 warps of 16 rows) inside
// the variant's loops: correct and simple first. Few, coarse blocks leave
// SMs idle (K15 at bb = 8 and B = 96 is 12 blocks on 132 SMs); that is what
// the sweep measures.
#include "attn_common.cuh"

namespace {

using namespace vb_attn;
using vb::c_to_a;
using vb::load_a;
using vb::load_b_cols;
using vb::load_b_rows;
using vb::mma16816;
using L = PackedLayout;

// A bf16 pair times c, rounded back to a bf16 pair: PRESCALE's q.
__device__ __forceinline__ uint32_t scale_pair(uint32_t w, float c) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
  return pack_bf16(f.x * c, f.y * c);
}

// The (batch row, head) pairs of this block: rows [b0, b1) x heads [h0, h1).
struct Pairs {
  int b0, b1, h0, h1;
  __device__ Pairs(int B, int H, int rows, int heads)
      : b0(blockIdx.x * rows), b1(min(b0 + rows, B)), h0(blockIdx.y * heads), h1(min(h0 + heads, H)) {}
};

__device__ __forceinline__ void load_key_bias(float* dst, const float* __restrict__ key_bias, int j0, int n, int T) {
  for (int r = threadIdx.x; r < n; r += NTHREADS) {
    const int j = j0 + r;
    dst[r] = j < T ? key_bias[j] * LOG2E : -INFINITY;
  }
}

// ---------------------------------------------------------------- forward

// One 64-query tile of (b, h) against all keys in shared memory (K1's body):
// writes the tile's rows of out (row stride ldo from ob) and of stats (st).
template <bool PRESCALE, bool NOMAX>
__device__ __forceinline__ void fwd_tile(const bf16* Qs, const bf16* Ks, const bf16* Vs, const float* bias2,
                                         bf16* __restrict__ ob, int ldo, float* __restrict__ st, int T, int Tp,
                                         int qt, uint32_t bh, uint32_t seed, uint32_t threshold, float inv,
                                         int dropout) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int r0 = warp * 16;
  const int row[2] = {qt * TILE + r0 + g, qt * TILE + r0 + g + 8};
  const float c1 = SCALE * LOG2E;

  uint32_t qa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    load_a<LDS>(qa[kk], Qs, r0, kk * 16, g, tq);
    if constexpr (PRESCALE) {
#pragma unroll
      for (int e = 0; e < 4; ++e) qa[kk][e] = scale_pair(qa[kk][e], c1);
    }
  }
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
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = k0 + nt * 8 + 2 * tq + (e & 1);
        s[nt][e] = PRESCALE ? s[nt][e] + bias2[j] : s[nt][e] * c1 + bias2[j];
      }
    }
    if constexpr (NOMAX) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] = exp2f(s[nt][e]);
          l[e >> 1] += s[nt][e];
        }
      }
    } else {
      float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) mt[e >> 1] = fmaxf(mt[e >> 1], s[nt][e]);
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
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int c = nt * 8 + 2 * tq;
    if (ok[0]) *reinterpret_cast<uint32_t*>(ob + (size_t)row[0] * ldo + c) = pack_bf16(o[nt][0] * sc[0], o[nt][1] * sc[0]);
    if (ok[1]) *reinterpret_cast<uint32_t*>(ob + (size_t)row[1] * ldo + c) = pack_bf16(o[nt][2] * sc[1], o[nt][3] * sc[1]);
  }
  if (tq == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (ok[r]) st[row[r]] = NOMAX ? log2f(l[r]) : m[r] + log2f(l[r]);
  }
}

template <bool PRESCALE, bool NOMAX>
__global__ void __launch_bounds__(NTHREADS)
exp_fwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ qb, const float* __restrict__ key_bias,
               bf16* __restrict__ out, float* __restrict__ stats, int B, int T, int H, int rows, int heads,
               uint32_t seed, uint32_t threshold, float inv, int dropout) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Tp = round_up(T, TILE);
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [TILE][LDS]
  bf16* Ks = Qs + TILE * LDS;                // [Tp][LDS]
  bf16* Vs = Ks + Tp * LDS;                  // [Tp][LDS]
  float* bias2 = reinterpret_cast<float*>(Vs + Tp * LDS);  // [Tp]

  const Pairs w(B, H, rows, heads);
  const int ld = L::ld_in(H);
  for (int h = w.h0; h < w.h1; ++h) {
    for (int b = w.b0; b < w.b1; ++b) {
      __syncthreads();  // no warp still reads the last pair's K, V and key bias
      load_tile(Ks, qkv + L::in_off(b, h, 1, T, H), qb + (3 * h + 1) * D, 0, Tp, T, ld);
      load_tile(Vs, qkv + L::in_off(b, h, 2, T, H), qb + (3 * h + 2) * D, 0, Tp, T, ld);
      load_key_bias(bias2, key_bias + (size_t)b * T, 0, Tp, T);
      for (int qt = 0; qt < Tp / TILE; ++qt) {
        __syncthreads();  // every warp holds its fragments of the last Q tile
        load_tile(Qs, qkv + L::in_off(b, h, 0, T, H), qb + 3 * h * D, qt * TILE, TILE, T, ld);
        __syncthreads();
        fwd_tile<PRESCALE, NOMAX>(Qs, Ks, Vs, bias2, out + L::out_off(b, h, T, H), L::ld_out(H),
                                  stats + ((size_t)b * H + h) * T, T, Tp, qt, (uint32_t)(b * H + h), seed,
                                  threshold, inv, dropout);
      }
    }
  }
}

// ------------------------------------------------------- backward: dQ pass

// One 64-query tile of (b, h) against all keys (K2's query-tile body): dS
// into dq's rows; returns column threadIdx.x's (< D) sum over the tile's
// valid rows of the stored dq.
template <bool PRESCALE, bool FDROP>
__device__ __forceinline__ float dq_tile(const bf16* Qs, const bf16* dOs, const bf16* Ks, const bf16* Vs,
                                         const float* bias2, const float* st_s, const float* dl_s, float* red,
                                         bf16* __restrict__ dq_out, int ld, int T, int Tp, int qt, uint32_t bh,
                                         uint32_t seed, uint32_t threshold, float inv, int dropout) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int r0 = warp * 16;
  const int row[2] = {qt * TILE + r0 + g, qt * TILE + r0 + g + 8};
  const float strow[2] = {st_s[r0 + g], st_s[r0 + g + 8]};
  const float dlrow[2] = {dl_s[r0 + g], dl_s[r0 + g + 8]};
  const float c1 = SCALE * LOG2E;

  uint32_t qa[4][4], da[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    load_a<LDS>(qa[kk], Qs, r0, kk * 16, g, tq);
    if constexpr (PRESCALE) {
#pragma unroll
      for (int e = 0; e < 4; ++e) qa[kk][e] = scale_pair(qa[kk][e], c1);
    }
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
        const float t = PRESCALE ? s[nt][e] + bias2[j] : s[nt][e] * c1 + bias2[j];
        const float p = exp2f(t - strow[r]);
        const float d = dp[nt][e];
        if (dropout) {
          const bool keep = vb::philox_word(rnd[r], ((row[r] & 1) << 1) | (e & 1)) >= threshold;
          if constexpr (FDROP) {
            s[nt][e] = round_bf16(keep ? p * inv : 0.f) * d - p * dlrow[r];
          } else {
            s[nt][e] = p * ((keep ? d * inv : 0.f) - dlrow[r]);
          }
        } else {
          s[nt][e] = p * (d - dlrow[r]);  // dS (the scale goes on dQ)
        }
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
  store_rows(dq_out, dq, SCALE, row[0], row[1], ok0, ok1, ld, tq);
  float colsum = 0.f;
  block_colsum(dq, SCALE, ok0, ok1, red, warp, g, tq, &colsum);
  return colsum;
}

template <bool PRESCALE, bool FDROP>
__global__ void __launch_bounds__(NTHREADS)
exp_bwd_dq_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ qb, const float* __restrict__ key_bias,
                  const bf16* __restrict__ dout, const bf16* __restrict__ out, const float* __restrict__ stats,
                  bf16* __restrict__ dqkv, float* __restrict__ db_part, float* __restrict__ delta_g, int B, int T,
                  int H, int rows, int heads, uint32_t seed, uint32_t threshold, float inv, int dropout) {
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

  const Pairs w(B, H, rows, heads);
  const int ld = L::ld_in(H), ldo = L::ld_out(H), F = 3 * H * D;
  for (int h = w.h0; h < w.h1; ++h) {
    float colsum = 0.f;  // column threadIdx.x (< D) of h's dq, over this block's rows
    for (int b = w.b0; b < w.b1; ++b) {
      const size_t oo = L::out_off(b, h, T, H);
      const size_t sb = ((size_t)b * H + h) * T;  // (b, h)'s rows of stats and delta
      __syncthreads();  // no warp still reads the last pair's K, V and key bias
      load_tile(Ks, qkv + L::in_off(b, h, 1, T, H), qb + (3 * h + 1) * D, 0, Tp, T, ld);
      load_tile(Vs, qkv + L::in_off(b, h, 2, T, H), qb + (3 * h + 2) * D, 0, Tp, T, ld);
      load_key_bias(bias2, key_bias + (size_t)b * T, 0, Tp, T);
      for (int qt = 0; qt < Tp / TILE; ++qt) {
        __syncthreads();  // every warp holds its fragments, statistics and delta of the last tile
        load_tile(Qs, qkv + L::in_off(b, h, 0, T, H), qb + 3 * h * D, qt * TILE, TILE, T, ld);
        load_tile(dOs, dout + oo, nullptr, qt * TILE, TILE, T, ldo);
        row_delta(dout + oo, out + oo, ldo, dl_s, delta_g + sb, qt, T);
        for (int r = threadIdx.x; r < TILE; r += NTHREADS) {
          const int i = qt * TILE + r;
          st_s[r] = i < T ? stats[sb + i] : 0.f;
        }
        __syncthreads();
        colsum += dq_tile<PRESCALE, FDROP>(Qs, dOs, Ks, Vs, bias2, st_s, dl_s, red,
                                           dqkv + L::in_off(b, h, 0, T, H), ld, T, Tp, qt,
                                           (uint32_t)(b * H + h), seed, threshold, inv, dropout);
      }
    }
    if (threadIdx.x < D) db_part[(size_t)blockIdx.x * F + 3 * h * D + threadIdx.x] = colsum;
  }
}

// --------------------------------------------------- backward: dK, dV pass

// One 64-key tile of (b, h) against all queries (K2's key-tile body): dK
// and dV into their rows; adds column threadIdx.x's (< D) sums over the
// tile's valid keys of the stored dk and dv to *ck and *cv.
template <bool PRESCALE, bool FDROP>
__device__ __forceinline__ void dkv_tile(const bf16* Ks, const bf16* Vs, const bf16* Qs, const bf16* dOs,
                                         const float* st_s, const float* dl_s, const float* kb_s, float* red,
                                         bf16* __restrict__ dk_out, bf16* __restrict__ dv_out, int ld, int T,
                                         int Tp, int kt, uint32_t bh, uint32_t seed, uint32_t threshold, float inv,
                                         int dropout, float* ck, float* cv) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int r0 = warp * 16;
  const int key[2] = {kt * TILE + r0 + g, kt * TILE + r0 + g + 8};
  const float kb[2] = {kb_s[r0 + g], kb_s[r0 + g + 8]};
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
    // S^T = K Q^T (Q prescaled under PRESCALE) and dP^T = V dO^T for this
    // warp's 16 keys x QC queries
    float st[QC / 8][4], dpt[QC / 8][4];
#pragma unroll
    for (int nt = 0; nt < QC / 8; ++nt) {
      st[nt][0] = st[nt][1] = st[nt][2] = st[nt][3] = 0.f;
      dpt[nt][0] = dpt[nt][1] = dpt[nt][2] = dpt[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t b0, b1;
        load_b_rows<LDS>(b0, b1, Qs, q0 + nt * 8, kk * 16, g, tq);
        if constexpr (PRESCALE) {
          b0 = scale_pair(b0, c1);
          b1 = scale_pair(b1, c1);
        }
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
        const float t = PRESCALE ? st[nt][e] + kb[r] : st[nt][e] * c1 + kb[r];
        const float p = exp2f(t - st_s[i]);
        const float d = dpt[nt][e];
        if (dropout) {
          const bool keep = vb::philox_word(rnd[r], ((e & 1) << 1) | (key[r] & 1)) >= threshold;
          const float pd = keep ? p * inv : 0.f;
          st[nt][e] = pd;
          if constexpr (FDROP) {
            dpt[nt][e] = round_bf16(pd) * d - p * dl_s[i];
          } else {
            dpt[nt][e] = p * ((keep ? d * inv : 0.f) - dl_s[i]);
          }
        } else {
          st[nt][e] = p;
          dpt[nt][e] = p * (d - dl_s[i]);
        }
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
        load_b_cols<LDS>(b0, b1, Qs, q0 + c * 16, nt * 8, g, tq);  // dK takes the unscaled q
        mma16816(dk[nt], sa, b0, b1);
      }
    }
  }

  const bool ok0 = key[0] < T, ok1 = key[1] < T;
  store_rows(dk_out, dk, SCALE, key[0], key[1], ok0, ok1, ld, tq);
  store_rows(dv_out, dv, 1.f, key[0], key[1], ok0, ok1, ld, tq);
  float part = 0.f;
  block_colsum(dk, SCALE, ok0, ok1, red, warp, g, tq, &part);
  *ck += part;
  block_colsum(dv, 1.f, ok0, ok1, red, warp, g, tq, &part);
  *cv += part;
}

template <bool PRESCALE, bool FDROP>
__global__ void __launch_bounds__(NTHREADS)
exp_bwd_dkv_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ qb, const float* __restrict__ key_bias,
                   const bf16* __restrict__ dout, const float* __restrict__ stats, const float* __restrict__ delta_g,
                   bf16* __restrict__ dqkv, float* __restrict__ db_part, int B, int T, int H, int rows, int heads,
                   uint32_t seed, uint32_t threshold, float inv, int dropout) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Tp = round_up(T, TILE);
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // [TILE][LDS] this tile's keys
  bf16* Vs = Ks + TILE * LDS;                // [TILE][LDS]
  bf16* Qs = Vs + TILE * LDS;                // [Tp][LDS] all queries
  bf16* dOs = Qs + Tp * LDS;                 // [Tp][LDS]
  float* st_s = reinterpret_cast<float*>(dOs + Tp * LDS);  // [Tp]
  float* dl_s = st_s + Tp;                   // [Tp]
  float* kb_s = dl_s + Tp;                   // [TILE]
  float* red = kb_s + TILE;                  // [4][D]

  const Pairs w(B, H, rows, heads);
  const int ld = L::ld_in(H), F = 3 * H * D;
  for (int h = w.h0; h < w.h1; ++h) {
    float ck = 0.f, cv = 0.f;  // column threadIdx.x (< D) of h's dk and dv, over this block's rows
    for (int b = w.b0; b < w.b1; ++b) {
      const size_t sb = ((size_t)b * H + h) * T;
      __syncthreads();  // no warp still reads the last pair's Q, dO, statistics and delta
      load_tile(Qs, qkv + L::in_off(b, h, 0, T, H), qb + 3 * h * D, 0, Tp, T, ld);
      load_tile(dOs, dout + L::out_off(b, h, T, H), nullptr, 0, Tp, T, L::ld_out(H));
      for (int i = threadIdx.x; i < Tp; i += NTHREADS) {
        // padded queries: stats = +inf makes their probabilities exactly 0
        st_s[i] = i < T ? stats[sb + i] : INFINITY;
        dl_s[i] = i < T ? delta_g[sb + i] : 0.f;
      }
      for (int kt = 0; kt < Tp / TILE; ++kt) {
        __syncthreads();  // every warp holds its fragments of the last K and V tile
        load_tile(Ks, qkv + L::in_off(b, h, 1, T, H), qb + (3 * h + 1) * D, kt * TILE, TILE, T, ld);
        load_tile(Vs, qkv + L::in_off(b, h, 2, T, H), qb + (3 * h + 2) * D, kt * TILE, TILE, T, ld);
        load_key_bias(kb_s, key_bias + (size_t)b * T, kt * TILE, TILE, T);
        __syncthreads();
        dkv_tile<PRESCALE, FDROP>(Ks, Vs, Qs, dOs, st_s, dl_s, kb_s, red, dqkv + L::in_off(b, h, 1, T, H),
                                  dqkv + L::in_off(b, h, 2, T, H), ld, T, Tp, kt, (uint32_t)(b * H + h), seed,
                                  threshold, inv, dropout, &ck, &cv);
      }
    }
    if (threadIdx.x < D) {
      float* part = db_part + (size_t)blockIdx.x * F;
      part[(3 * h + 1) * D + threadIdx.x] = ck;
      part[(3 * h + 2) * D + threadIdx.x] = cv;
    }
  }
}

dim3 grid_of(int B, int H, int rows, int heads) { return dim3((B + rows - 1) / rows, (H + heads - 1) / heads); }

template <bool PRESCALE, bool NOMAX>
int launch_fwd(const void* qkv, const void* qb, const void* key_bias, void* out, void* stats, int B, int T, int H,
               int rows, int heads, unsigned int seed, unsigned int threshold, float inv, int dropout,
               cudaStream_t s) {
  const size_t smem = fwd_smem(T);
  cudaError_t err = cudaFuncSetAttribute(exp_fwd_kernel<PRESCALE, NOMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  exp_fwd_kernel<PRESCALE, NOMAX><<<grid_of(B, H, rows, heads), NTHREADS, smem, s>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(qb), static_cast<const float*>(key_bias),
      static_cast<bf16*>(out), static_cast<float*>(stats), B, T, H, rows, heads, seed, threshold, inv, dropout);
  return (int)cudaGetLastError();
}

template <bool PRESCALE, bool FDROP>
int launch_bwd(const void* qkv, const void* qb, const void* key_bias, const void* dout, const void* out,
               const void* stats, void* dqkv, void* db_part, void* delta, int B, int T, int H, int rows, int heads,
               unsigned int seed, unsigned int threshold, float inv, int dropout, cudaStream_t s) {
  const dim3 grid = grid_of(B, H, rows, heads);
  const size_t smem_dq = dq_smem(T), smem_dkv = dkv_smem(T);
  cudaError_t err = cudaFuncSetAttribute(exp_bwd_dq_kernel<PRESCALE, FDROP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(exp_bwd_dkv_kernel<PRESCALE, FDROP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dkv);
  if (err != cudaSuccess) return (int)err;
  exp_bwd_dq_kernel<PRESCALE, FDROP><<<grid, NTHREADS, smem_dq, s>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(qb), static_cast<const float*>(key_bias),
      static_cast<const bf16*>(dout), static_cast<const bf16*>(out), static_cast<const float*>(stats),
      static_cast<bf16*>(dqkv), static_cast<float*>(db_part), static_cast<float*>(delta), B, T, H, rows, heads,
      seed, threshold, inv, dropout);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  exp_bwd_dkv_kernel<PRESCALE, FDROP><<<grid, NTHREADS, smem_dkv, s>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(qb), static_cast<const float*>(key_bias),
      static_cast<const bf16*>(dout), static_cast<const float*>(stats), static_cast<const float*>(delta),
      static_cast<bf16*>(dqkv), static_cast<float*>(db_part), B, T, H, rows, heads, seed, threshold, inv, dropout);
  return (int)cudaGetLastError();
}

}  // namespace

// The largest dynamic shared memory of the three kernels at T (the same for
// every variant and head group).
extern "C" size_t vb_attn_exp_smem_bytes(int T) {
  size_t a = fwd_smem(T), b = dq_smem(T), c = dkv_smem(T);
  size_t m = a > b ? a : b;
  return m > c ? m : c;
}

// rows x heads (batch row, head) pairs a block; prescale and nomax select
// the instantiation.
extern "C" int vb_attn_exp_fwd(const void* qkv, const void* qb, const void* key_bias, void* out, void* stats,
                               int B, int T, int H, int rows, int heads, int prescale, int nomax, unsigned int seed,
                               unsigned int threshold, float inv, int dropout, void* stream) {
  auto* f = prescale ? (nomax ? launch_fwd<true, true> : launch_fwd<true, false>)
                     : (nomax ? launch_fwd<false, true> : launch_fwd<false, false>);
  return f(qkv, qb, key_bias, out, stats, B, T, H, rows, heads, seed, threshold, inv, dropout,
           static_cast<cudaStream_t>(stream));
}

// The two backward passes; db_part [ceil(B / rows), H*3*D] fp32 and delta
// [B, H, T] fp32 are scratch the caller allocates.
extern "C" int vb_attn_exp_bwd(const void* qkv, const void* qb, const void* key_bias, const void* dout,
                               const void* out, const void* stats, void* dqkv, void* db_part, void* delta, int B,
                               int T, int H, int rows, int heads, int prescale, int fdrop, unsigned int seed,
                               unsigned int threshold, float inv, int dropout, void* stream) {
  auto* f = prescale ? (fdrop ? launch_bwd<true, true> : launch_bwd<true, false>)
                     : (fdrop ? launch_bwd<false, true> : launch_bwd<false, false>);
  return f(qkv, qb, key_bias, dout, out, stats, dqkv, db_part, delta, B, T, H, rows, heads, seed, threshold, inv,
           dropout, static_cast<cudaStream_t>(stream));
}
