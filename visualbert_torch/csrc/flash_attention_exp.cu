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
//   both passes. The TPU's backward head group and its 2-D (batch,
//   head-group) grid are one knob here, the heads of a block: K15 at bb = 1
//   and group = g runs K16 at hg = g's backward.
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
// Bound on the H100 at the main path's B=128, T=228, H=12, D=64: K1/K2's,
// the same function: the bytes (qkv, out, stats; the backward also dout,
// out, stats in and dqkv out), 0.0540 / 0.1075 ms at 3.35 TB/s. The tensor
// products (2 forward, 4 backward, 20.4 GFLOP each) take 0.04 / 0.08 ms at
// 989 TFLOP/s; with dropout on, a pass's 25.2 M Philox calls (one a 2x2
// block over B*H*Tp^2 at Tp = 256) take about 0.042 ms at the 55.73 cycles
// a warp call a sub-partition that csrc/bench/philox_rate.cu measures on
// attention's counter form (132 SMs x 4 at 1980 MHz), below the bytes.
//
// The design, K1/K2's step by step (flash_attention_packed.cu) on
// hopper_attn.cuh's blocks, each kernel with a body of its own (a template
// shared with K1/K2 changed their machine code and cost K1 2-3 %):
// 1. Schedule. A block is one warpgroup (4 warps); it walks its (batch row,
//    head) pairs head by head, the batch rows of a head inner, and for each
//    pair does what K1/K2 do: loads K and V (Q and dO in the dK/dV pass)
//    once, adds the deferred bias as each tile lands, and walks every
//    64-query tile (64-key tile). The key bias is loaded again whenever the
//    batch row changes (once a block at rows = 1, as K1 does). The backward
//    keeps K2's two passes, dQ with delta, then dK/dV, and no atomics; a
//    block's bias-gradient sums run on over its batch rows and are written
//    once a head.
// 2. Philox once per 2x2 block: each lane computes the call of its row of
//    one parity and trades the other row's two bits with its partner
//    (keep_bits; key-major in the dK/dV pass).
// 3. Asynchronous copies: tiles arrive by cp.async, 16 bytes a thread, into
//    the 128 B swizzle; the first product waits only for its own key tile,
//    and the next query tile (key tile) is prefetched while this one
//    computes.
// 4. wgmma m64n64k16 for every product: S = Q K^T, dP = dO V^T, S^T = K
//    Q^T and dP^T = V dO^T with both operands in shared memory; O += P V,
//    dQ += dS K, dV += P^T dO, dK += dS^T Q with P or dS in registers.
// 5. The flags. PRESCALE scales a landed Q tile in place where q feeds the
//    scores only (the forward, the dQ pass); the dK/dV pass, whose dK takes
//    the unscaled q, keeps a second, scaled copy of every query beside it
//    (Tp x 128 B more: 32 KB at T = 228, a block an SM fewer, and T at most
//    448). NOMAX is the online softmax without its max and rescale. FDROP
//    rounds the dropped probability that the dK/dV pass already rounds for
//    P_d^T dO. With the flags off each pair runs K1/K2's arithmetic in K1/K2's
//    order, so out, stats and dqkv are K1/K2's bit for bit at any schedule.
#include "hopper_attn.cuh"

namespace {

using namespace vb_hopper;

// PRESCALE's q: add the bias to this thread's chunks of a landed Q tile and
// write bf16(bf16(q + qb) * scale * log2(e)) to the same chunks of
// `scaled`: in place when scaled == tile (the forward and the dQ pass read
// q only for the scores), else a second tile whose rows past T are zeroed
// (the dK/dV pass keeps the unscaled q for dK).
__device__ __forceinline__ void add_bias_scaled(unsigned char* tile, unsigned char* scaled, uint4 bias, int t0,
                                                int T) {
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&bias);
  const float c1 = SCALE * LOG2E;
#pragma unroll
  for (int idx = threadIdx.x; idx < TILE * 8; idx += NT) {
    const int r = idx >> 3, c = idx & 7;
    uint4* ps = reinterpret_cast<uint4*>(scaled + swz(r, c));
    if (t0 + r < T) {
      uint4* p = reinterpret_cast<uint4*>(tile + swz(r, c));
      uint4 v = *p;
      __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(&v);
      uint32_t w[4], ws[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = __bfloat1622float2(x[e]), b = __bfloat1622float2(y[e]);
        const float q0 = round_bf16(a.x + b.x), q1 = round_bf16(a.y + b.y);
        w[e] = pack_bf16(q0, q1);
        ws[e] = pack_bf16(q0 * c1, q1 * c1);
      }
      if (scaled != tile) *p = make_uint4(w[0], w[1], w[2], w[3]);
      *ps = make_uint4(ws[0], ws[1], ws[2], ws[3]);
    } else if (scaled != tile) {
      *ps = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// A landed Q tile of the forward or the dQ pass: the bias added, and under
// PRESCALE the scores' q in place.
template <bool PRESCALE>
__device__ __forceinline__ void land_q(unsigned char* tile, uint4 bias, int t0, int T) {
  if constexpr (PRESCALE) {
    add_bias_scaled(tile, tile, bias, t0, T);
  } else {
    add_bias(tile, bias, t0, T);
  }
}

// The pairs of block (blockIdx.x, blockIdx.y): batch rows [b0, b1) x heads
// [h0, h1).
struct Pairs {
  int b0, b1, h0, h1;
  __device__ Pairs(int B, int H, int rows, int heads)
      : b0(blockIdx.x * rows), b1(min(b0 + rows, B)), h0(blockIdx.y * heads), h1(min(h0 + heads, H)) {}
  // the key bias is loaded again when the batch row changes
  __device__ bool new_row(int h) const { return h == h0 || b1 - b0 > 1; }
};

// ---------------------------------------------------------------- forward

size_t fwd_bytes(int T) {
  const int Tp = round_up(T, TILE);
  return ALIGN + 2 * TILE_BYTES + (size_t)2 * Tp * ROW + Tp * sizeof(float);
}

template <bool PRESCALE, bool NOMAX>
__global__ void __launch_bounds__(NT)
exp_fwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ qb, const float* __restrict__ key_bias,
               bf16* __restrict__ out, float* __restrict__ stats, int B, int T, int H, int rows, int heads,
               uint32_t seed, uint32_t thr, float inv, int dropout) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = align_smem(smem_raw);
  const int Tp = round_up(T, TILE), ntl = Tp / TILE;
  unsigned char* Qs = sm;                        // [2][TILE] query tiles
  unsigned char* Ks = Qs + 2 * TILE_BYTES;       // [Tp] keys
  unsigned char* Vs = Ks + (size_t)Tp * ROW;     // [Tp] values
  float* kb = reinterpret_cast<float*>(Vs + (size_t)Tp * ROW);  // [Tp] key bias * log2(e)
  const uint32_t sQ = smem_addr(Qs), sK = smem_addr(Ks), sV = smem_addr(Vs);

  const Pairs w(B, H, rows, heads);
  const int F = 3 * H * D, ldo = H * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3, par = g & 1;
  const float c1 = SCALE * LOG2E;

  for (int h = w.h0; h < w.h1; ++h) {
    const uint4 bq = bias_chunk(qb, h, 0), bk = bias_chunk(qb, h, 1), bv = bias_chunk(qb, h, 2);
    for (int b = w.b0; b < w.b1; ++b) {
      const bf16 *qsrc = qkv + (size_t)b * T * F + 3 * h * D, *ksrc = qsrc + D, *vsrc = qsrc + 2 * D;
      const uint32_t bh = (uint32_t)(b * H + h);
      __syncthreads();  // no warp still reads the last pair's tiles or key bias
      issue_tile(sQ, qsrc, 0, T, F);
      cp_commit();
      for (int kt = 0; kt < ntl; ++kt) {
        issue_tile(sK + kt * TILE_BYTES, ksrc, kt * TILE, T, F);
        issue_tile(sV + kt * TILE_BYTES, vsrc, kt * TILE, T, F);
        cp_commit();
      }
      if (w.new_row(h)) load_key_bias(kb, key_bias + (size_t)b * T, T, Tp);  // read after the first landing

      for (int qt = 0; qt < ntl; ++qt) {
        const int buf = qt & 1;
        if (qt > 0) __syncthreads();  // every warp is done with the buffer the prefetch overwrites
        if (qt + 1 < ntl) issue_tile(sQ + (buf ^ 1) * TILE_BYTES, qsrc, (qt + 1) * TILE, T, F);
        cp_commit();
        if (qt > 0) {
          cp_wait<1>();
          land_q<PRESCALE>(Qs + buf * TILE_BYTES, bq, qt * TILE, T);
          fence_async();
          __syncthreads();
        }
        const int row[2] = {qt * TILE + warp * 16 + g, qt * TILE + warp * 16 + g + 8};
        float o[32];
        zero(o);
        float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

        for (int kt = 0; kt < ntl; ++kt) {
          if (qt == 0) {
            // pending after key tile kt: the later key tiles and the prefetch
            cp_wait_dyn(ntl - kt);
            if (kt == 0) land_q<PRESCALE>(Qs, bq, 0, T);
            add_bias(Ks + kt * TILE_BYTES, bk, kt * TILE, T);
            add_bias(Vs + kt * TILE_BYTES, bv, kt * TILE, T);
            fence_async();
            __syncthreads();
          }
          float s[32];
          wg_fence();
          product_ss(s, sQ + buf * TILE_BYTES, sK + kt * TILE_BYTES);
          wg_commit();
          wg_wait();
          reg_fence(s);

          const int k0 = kt * TILE;
          if constexpr (NOMAX) {
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float kbj = kb[k0 + nt * 8 + 2 * tq + (e & 1)];
                const float p = exp2f(PRESCALE ? s[4 * nt + e] + kbj : s[4 * nt + e] * c1 + kbj);
                l[e >> 1] += p;
                s[4 * nt + e] = p;
              }
            }
          } else {
            float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                if constexpr (PRESCALE) {
                  s[4 * nt + e] = s[4 * nt + e] + kb[k0 + nt * 8 + 2 * tq + (e & 1)];
                } else {
                  s[4 * nt + e] = s[4 * nt + e] * c1 + kb[k0 + nt * 8 + 2 * tq + (e & 1)];
                }
                mt[e >> 1] = fmaxf(mt[e >> 1], s[4 * nt + e]);
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
                o[4 * nt + e] *= alpha[e >> 1];
                const float p = exp2f(s[4 * nt + e] - mnew[e >> 1]);
                l[e >> 1] += p;
                s[4 * nt + e] = p;
              }
            }
          }
          if (dropout) {
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
              const int j = k0 + nt * 8 + 2 * tq;
              const uint32_t bits = keep_bits<false>(seed, bh, row[0], row[1], j, par, thr, j < T, T);
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (!((bits >> e) & 1u)) s[4 * nt + e] = 0.f;
            }
          }
          uint32_t pa[4][4];
          to_a(pa, s);
          wg_fence();
          product_rs(o, pa, sV + kt * TILE_BYTES);
          wg_commit();
          wg_wait();
          reg_fence(o);
          reg_fence(pa);
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
        bf16* ob = out + (size_t)b * T * ldo + h * D;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int c = nt * 8 + 2 * tq;
          if (ok[0])
            *reinterpret_cast<uint32_t*>(ob + (size_t)row[0] * ldo + c) = pack_bf16(o[4 * nt] * sc[0], o[4 * nt + 1] * sc[0]);
          if (ok[1])
            *reinterpret_cast<uint32_t*>(ob + (size_t)row[1] * ldo + c) =
                pack_bf16(o[4 * nt + 2] * sc[1], o[4 * nt + 3] * sc[1]);
        }
        if (tq == 0) {
#pragma unroll
          for (int r = 0; r < 2; ++r)
            if (ok[r]) stats[(size_t)bh * T + row[r]] = NOMAX ? log2f(l[r]) : m[r] + log2f(l[r]);
        }
      }
    }
  }
}

// ------------------------------------------------------- backward: dQ pass

size_t dq_bytes(int T) {
  const int Tp = round_up(T, TILE);
  return ALIGN + 4 * TILE_BYTES + (size_t)2 * Tp * ROW + (3 * Tp + 4 * D) * sizeof(float);
}

template <bool PRESCALE, bool FDROP>
__global__ void __launch_bounds__(NT)
exp_dq_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ qb, const float* __restrict__ key_bias,
              const bf16* __restrict__ dout, const bf16* __restrict__ out, const float* __restrict__ stats,
              bf16* __restrict__ dqkv, float* __restrict__ db_part, float* __restrict__ delta_g, int B, int T, int H,
              int rows, int heads, uint32_t seed, uint32_t thr, float inv, int dropout) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = align_smem(smem_raw);
  const int Tp = round_up(T, TILE), ntl = Tp / TILE;
  unsigned char* Qs = sm;                        // [2][TILE]
  unsigned char* dOs = Qs + 2 * TILE_BYTES;      // [2][TILE]
  unsigned char* Ks = dOs + 2 * TILE_BYTES;      // [Tp]
  unsigned char* Vs = Ks + (size_t)Tp * ROW;     // [Tp]
  float* kb = reinterpret_cast<float*>(Vs + (size_t)Tp * ROW);  // [Tp]
  float* st = kb + Tp;                           // [Tp] stats of the pair's rows
  float* dl = st + Tp;                           // [Tp] delta of the pair's rows
  float* red = dl + Tp;                          // [4][D] dq column sums over the block's rows
  const uint32_t sQ = smem_addr(Qs), sdO = smem_addr(dOs), sK = smem_addr(Ks), sV = smem_addr(Vs);

  const Pairs w(B, H, rows, heads);
  const int F = 3 * H * D, ldo = H * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3, par = g & 1;
  const float c1 = SCALE * LOG2E;

  for (int h = w.h0; h < w.h1; ++h) {
    const uint4 bq = bias_chunk(qb, h, 0), bk = bias_chunk(qb, h, 1), bv = bias_chunk(qb, h, 2);
    for (int b = w.b0; b < w.b1; ++b) {
      const bf16 *qsrc = qkv + (size_t)b * T * F + 3 * h * D, *ksrc = qsrc + D, *vsrc = qsrc + 2 * D;
      const bf16* dsrc = dout + (size_t)b * T * ldo + h * D;
      const uint32_t bh = (uint32_t)(b * H + h);
      const size_t sb = (size_t)bh * T;
      __syncthreads();  // no warp still reads the last pair's tiles, statistics or sums
      issue_tile(sQ, qsrc, 0, T, F);
      issue_tile(sdO, dsrc, 0, T, ldo);
      cp_commit();
      for (int kt = 0; kt < ntl; ++kt) {
        issue_tile(sK + kt * TILE_BYTES, ksrc, kt * TILE, T, F);
        issue_tile(sV + kt * TILE_BYTES, vsrc, kt * TILE, T, F);
        cp_commit();
      }
      // while the tiles land: the pair's statistics and delta (and key bias)
      if (w.new_row(h)) load_key_bias(kb, key_bias + (size_t)b * T, T, Tp);
      for (int i = threadIdx.x; i < Tp; i += NT) st[i] = i < T ? stats[sb + i] : 0.f;
      pair_delta(dsrc, out + (size_t)b * T * ldo + h * D, ldo, dl, delta_g + sb, T, Tp);
      if (b == w.b0) {
        red[threadIdx.x] = 0.f;
        red[threadIdx.x + NT] = 0.f;
      }
      __syncthreads();  // statistics and delta are read below before the first tile's barrier

      for (int qt = 0; qt < ntl; ++qt) {
        const int buf = qt & 1;
        if (qt > 0) __syncthreads();
        if (qt + 1 < ntl) {
          issue_tile(sQ + (buf ^ 1) * TILE_BYTES, qsrc, (qt + 1) * TILE, T, F);
          issue_tile(sdO + (buf ^ 1) * TILE_BYTES, dsrc, (qt + 1) * TILE, T, ldo);
        }
        cp_commit();
        if (qt > 0) {
          cp_wait<1>();
          land_q<PRESCALE>(Qs + buf * TILE_BYTES, bq, qt * TILE, T);
          fence_async();
          __syncthreads();
        }
        const int row[2] = {qt * TILE + warp * 16 + g, qt * TILE + warp * 16 + g + 8};
        const float strow[2] = {st[row[0]], st[row[1]]}, dlrow[2] = {dl[row[0]], dl[row[1]]};
        float dq[32];
        zero(dq);
        for (int kt = 0; kt < ntl; ++kt) {
          if (qt == 0) {
            cp_wait_dyn(ntl - kt);
            if (kt == 0) land_q<PRESCALE>(Qs, bq, 0, T);
            add_bias(Ks + kt * TILE_BYTES, bk, kt * TILE, T);
            add_bias(Vs + kt * TILE_BYTES, bv, kt * TILE, T);
            fence_async();
            __syncthreads();
          }
          float s[32], dp[32];
          wg_fence();
          product_ss(s, sQ + buf * TILE_BYTES, sK + kt * TILE_BYTES);
          product_ss(dp, sdO + buf * TILE_BYTES, sV + kt * TILE_BYTES);
          wg_commit();
          wg_wait();
          reg_fence(s);
          reg_fence(dp);

          const int k0 = kt * TILE;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const int j = k0 + nt * 8 + 2 * tq;
            uint32_t bits = 0xFu;
            if (dropout) bits = keep_bits<false>(seed, bh, row[0], row[1], j, par, thr, j < T, T);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e >> 1;
              float p;
              if constexpr (PRESCALE) {
                p = exp2f(s[4 * nt + e] + kb[j + (e & 1)] - strow[r]);
              } else {
                p = exp2f(s[4 * nt + e] * c1 + kb[j + (e & 1)] - strow[r]);
              }
              float d = dp[4 * nt + e];
              if constexpr (FDROP) {
                if (dropout) {
                  s[4 * nt + e] = round_bf16(((bits >> e) & 1u) ? p * inv : 0.f) * d - p * dlrow[r];
                } else {
                  s[4 * nt + e] = p * (d - dlrow[r]);
                }
              } else {
                if (dropout) d = ((bits >> e) & 1u) ? d * inv : 0.f;
                s[4 * nt + e] = p * (d - dlrow[r]);  // dS (the scale goes on dQ)
              }
            }
          }
          uint32_t sa[4][4];
          to_a(sa, s);
          wg_fence();
          product_rs(dq, sa, sK + kt * TILE_BYTES);
          wg_commit();
          wg_wait();
          reg_fence(dq);
          reg_fence(sa);
        }

        const bool ok0 = row[0] < T, ok1 = row[1] < T;
        store_rows(dqkv + (size_t)b * T * F + 3 * h * D, dq, SCALE, row[0], row[1], ok0, ok1, F, tq);
        colsum_add(dq, SCALE, ok0, ok1, red, warp, g, tq);
      }
    }
    __syncthreads();
    if (threadIdx.x < D) {
      const int c = threadIdx.x;
      db_part[(size_t)blockIdx.x * F + 3 * h * D + c] = red[c] + red[D + c] + red[2 * D + c] + red[3 * D + c];
    }
  }
}

// --------------------------------------------------- backward: dK, dV pass

template <bool PRESCALE>
size_t dkv_bytes(int T) {
  const int Tp = round_up(T, TILE);
  return ALIGN + 4 * TILE_BYTES + (size_t)(PRESCALE ? 3 : 2) * Tp * ROW + (3 * Tp + 8 * D) * sizeof(float);
}

template <bool PRESCALE, bool FDROP>
__global__ void __launch_bounds__(NT)
exp_dkv_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ qb, const float* __restrict__ key_bias,
               const bf16* __restrict__ dout, const float* __restrict__ stats, const float* __restrict__ delta_g,
               bf16* __restrict__ dqkv, float* __restrict__ db_part, int B, int T, int H, int rows, int heads,
               uint32_t seed, uint32_t thr, float inv, int dropout) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = align_smem(smem_raw);
  const int Tp = round_up(T, TILE), ntl = Tp / TILE;
  unsigned char* Ks = sm;                        // [2][TILE] key tiles
  unsigned char* Vs = Ks + 2 * TILE_BYTES;       // [2][TILE]
  unsigned char* Qs = Vs + 2 * TILE_BYTES;       // [Tp] all queries
  unsigned char* dOs = Qs + (size_t)Tp * ROW;    // [Tp]
  unsigned char* Qsc = dOs + (size_t)Tp * ROW;   // [Tp] PRESCALE's scaled queries (else empty)
  float* kb = reinterpret_cast<float*>(Qsc + (PRESCALE ? (size_t)Tp * ROW : 0));  // [Tp]
  float* st = kb + Tp;                           // [Tp]; padded queries +inf: p = 0
  float* dl = st + Tp;                           // [Tp]
  float* redk = dl + Tp;                         // [4][D]
  float* redv = redk + 4 * D;                    // [4][D]
  const uint32_t sK = smem_addr(Ks), sV = smem_addr(Vs), sQ = smem_addr(Qs), sdO = smem_addr(dOs);
  const uint32_t sS = PRESCALE ? smem_addr(Qsc) : sQ;  // the queries of the scores

  const Pairs w(B, H, rows, heads);
  const int F = 3 * H * D, ldo = H * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3, par = g & 1;
  const float c1 = SCALE * LOG2E;

  for (int h = w.h0; h < w.h1; ++h) {
    const uint4 bq = bias_chunk(qb, h, 0), bk = bias_chunk(qb, h, 1), bv = bias_chunk(qb, h, 2);
    for (int b = w.b0; b < w.b1; ++b) {
      const bf16 *qsrc = qkv + (size_t)b * T * F + 3 * h * D, *ksrc = qsrc + D, *vsrc = qsrc + 2 * D;
      const bf16* dsrc = dout + (size_t)b * T * ldo + h * D;
      const uint32_t bh = (uint32_t)(b * H + h);
      const size_t sb = (size_t)bh * T;
      __syncthreads();
      issue_tile(sK, ksrc, 0, T, F);
      issue_tile(sV, vsrc, 0, T, F);
      cp_commit();
      for (int qc = 0; qc < ntl; ++qc) {
        issue_tile(sQ + qc * TILE_BYTES, qsrc, qc * TILE, T, F);
        issue_tile(sdO + qc * TILE_BYTES, dsrc, qc * TILE, T, ldo);
        cp_commit();
      }
      for (int i = threadIdx.x; i < Tp; i += NT) {
        st[i] = i < T ? stats[sb + i] : INFINITY;
        dl[i] = i < T ? delta_g[sb + i] : 0.f;
      }
      if (b == w.b0) {
        redk[threadIdx.x] = redk[threadIdx.x + NT] = 0.f;
        redv[threadIdx.x] = redv[threadIdx.x + NT] = 0.f;
      }
      if (w.new_row(h)) {
        load_key_bias(kb, key_bias + (size_t)b * T, T, Tp);
        __syncthreads();  // each key tile reads its rows' key bias before the first tile lands
      }

      for (int kt = 0; kt < ntl; ++kt) {
        const int buf = kt & 1;
        if (kt > 0) __syncthreads();
        if (kt + 1 < ntl) {
          issue_tile(sK + (buf ^ 1) * TILE_BYTES, ksrc, (kt + 1) * TILE, T, F);
          issue_tile(sV + (buf ^ 1) * TILE_BYTES, vsrc, (kt + 1) * TILE, T, F);
        }
        cp_commit();
        if (kt > 0) {
          cp_wait<1>();
          add_bias(Ks + buf * TILE_BYTES, bk, kt * TILE, T);
          add_bias(Vs + buf * TILE_BYTES, bv, kt * TILE, T);
          fence_async();
          __syncthreads();
        }
        const int key[2] = {kt * TILE + warp * 16 + g, kt * TILE + warp * 16 + g + 8};
        const float kbr[2] = {kb[key[0]], kb[key[1]]};
        float dk[32], dv[32];
        zero(dk);
        zero(dv);

        for (int qc = 0; qc < ntl; ++qc) {
          if (kt == 0) {
            cp_wait_dyn(ntl - qc);
            if (qc == 0) {
              add_bias(Ks, bk, 0, T);
              add_bias(Vs, bv, 0, T);
            }
            if constexpr (PRESCALE) {
              add_bias_scaled(Qs + qc * TILE_BYTES, Qsc + qc * TILE_BYTES, bq, qc * TILE, T);
            } else {
              add_bias(Qs + qc * TILE_BYTES, bq, qc * TILE, T);
            }
            fence_async();
            __syncthreads();
          }
          // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries
          float s[32], dp[32];
          wg_fence();
          product_ss(s, sK + buf * TILE_BYTES, sS + qc * TILE_BYTES);
          product_ss(dp, sV + buf * TILE_BYTES, sdO + qc * TILE_BYTES);
          wg_commit();
          wg_wait();
          reg_fence(s);
          reg_fence(dp);

          const int q0 = qc * TILE;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const int i0 = q0 + nt * 8 + 2 * tq;  // queries i0, i0 + 1
            uint32_t bits = 0xFu;
            if (dropout) bits = keep_bits<true>(seed, bh, key[0], key[1], i0, par, thr, i0 < T, T);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = i0 + (e & 1);
              float p;
              if constexpr (PRESCALE) {
                p = exp2f(s[4 * nt + e] + kbr[e >> 1] - st[i]);
              } else {
                p = exp2f(s[4 * nt + e] * c1 + kbr[e >> 1] - st[i]);
              }
              float pd = p, d = dp[4 * nt + e];
              if (dropout) {
                const bool keep = (bits >> e) & 1u;
                pd = keep ? p * inv : 0.f;
                if constexpr (!FDROP) d = keep ? d * inv : 0.f;
              }
              s[4 * nt + e] = pd;
              if constexpr (FDROP) {
                dp[4 * nt + e] = dropout ? round_bf16(pd) * d - p * dl[i] : p * (d - dl[i]);
              } else {
                dp[4 * nt + e] = p * (d - dl[i]);
              }
            }
          }
          uint32_t pa[4][4], sa[4][4];
          to_a(pa, s);
          to_a(sa, dp);
          wg_fence();
          product_rs(dv, pa, sdO + qc * TILE_BYTES);
          product_rs(dk, sa, sQ + qc * TILE_BYTES);  // dK takes the unscaled q
          wg_commit();
          wg_wait();
          reg_fence(dv);
          reg_fence(dk);
          reg_fence(pa);
          reg_fence(sa);
        }

        const bool ok0 = key[0] < T, ok1 = key[1] < T;
        bf16* dst = dqkv + (size_t)b * T * F + 3 * h * D;
        store_rows(dst + D, dk, SCALE, key[0], key[1], ok0, ok1, F, tq);
        store_rows(dst + 2 * D, dv, 1.f, key[0], key[1], ok0, ok1, F, tq);
        colsum_add(dk, SCALE, ok0, ok1, redk, warp, g, tq);
        colsum_add(dv, 1.f, ok0, ok1, redv, warp, g, tq);
      }
    }
    __syncthreads();
    if (threadIdx.x < D) {
      const int c = threadIdx.x;
      float* part = db_part + (size_t)blockIdx.x * F;
      part[(3 * h + 1) * D + c] = redk[c] + redk[D + c] + redk[2 * D + c] + redk[3 * D + c];
      part[(3 * h + 2) * D + c] = redv[c] + redv[D + c] + redv[2 * D + c] + redv[3 * D + c];
    }
  }
}

// ---------------------------------------------------------------- launches

// Kernel `which` (0 the forward, 1 the dQ pass, 2 the dK/dV pass) of the
// instantiation (prescale, flag): flag is nomax for the forward, fdrop for
// the backward's passes.
const void* kernel_of(int which, int prescale, int flag) {
  switch (which * 4 + (prescale ? 2 : 0) + (flag ? 1 : 0)) {
    case 0: return (const void*)exp_fwd_kernel<false, false>;
    case 1: return (const void*)exp_fwd_kernel<false, true>;
    case 2: return (const void*)exp_fwd_kernel<true, false>;
    case 3: return (const void*)exp_fwd_kernel<true, true>;
    case 4: return (const void*)exp_dq_kernel<false, false>;
    case 5: return (const void*)exp_dq_kernel<false, true>;
    case 6: return (const void*)exp_dq_kernel<true, false>;
    case 7: return (const void*)exp_dq_kernel<true, true>;
    case 8: return (const void*)exp_dkv_kernel<false, false>;
    case 9: return (const void*)exp_dkv_kernel<false, true>;
    case 10: return (const void*)exp_dkv_kernel<true, false>;
    case 11: return (const void*)exp_dkv_kernel<true, true>;
    default: return nullptr;
  }
}

size_t bytes_of(int which, int T, int prescale) {
  if (which == 0) return fwd_bytes(T);
  if (which == 1) return dq_bytes(T);
  return prescale ? dkv_bytes<true>(T) : dkv_bytes<false>(T);
}

cudaError_t prepare(int which, int T, int prescale, int flag) {
  return cudaFuncSetAttribute(kernel_of(which, prescale, flag), cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes_of(which, T, prescale));
}

dim3 grid_of(int B, int H, int rows, int heads) { return dim3((B + rows - 1) / rows, (H + heads - 1) / heads); }

template <bool PRESCALE, bool NOMAX>
void launch_fwd(const void* qkv, const void* qb, const void* key_bias, void* out, void* stats, int B, int T, int H,
                int rows, int heads, unsigned int seed, unsigned int threshold, float inv, int dropout,
                cudaStream_t s) {
  exp_fwd_kernel<PRESCALE, NOMAX><<<grid_of(B, H, rows, heads), NT, fwd_bytes(T), s>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(qb), static_cast<const float*>(key_bias),
      static_cast<bf16*>(out), static_cast<float*>(stats), B, T, H, rows, heads, seed, threshold, inv, dropout);
}

template <bool PRESCALE, bool FDROP>
cudaError_t launch_bwd(const void* qkv, const void* qb, const void* key_bias, const void* dout, const void* out,
                       const void* stats, void* dqkv, void* db_part, void* delta, int B, int T, int H, int rows,
                       int heads, unsigned int seed, unsigned int threshold, float inv, int dropout, cudaStream_t s) {
  const dim3 grid = grid_of(B, H, rows, heads);
  exp_dq_kernel<PRESCALE, FDROP><<<grid, NT, dq_bytes(T), s>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(qb), static_cast<const float*>(key_bias),
      static_cast<const bf16*>(dout), static_cast<const bf16*>(out), static_cast<const float*>(stats),
      static_cast<bf16*>(dqkv), static_cast<float*>(db_part), static_cast<float*>(delta), B, T, H, rows, heads,
      seed, threshold, inv, dropout);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  exp_dkv_kernel<PRESCALE, FDROP><<<grid, NT, dkv_bytes<PRESCALE>(T), s>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(qb), static_cast<const float*>(key_bias),
      static_cast<const bf16*>(dout), static_cast<const float*>(stats), static_cast<const float*>(delta),
      static_cast<bf16*>(dqkv), static_cast<float*>(db_part), B, T, H, rows, heads, seed, threshold, inv, dropout);
  return cudaGetLastError();
}

}  // namespace

// The largest dynamic shared memory of the three kernels at T without
// PRESCALE (the forward and the dQ pass take the same with it; PRESCALE's
// dK/dV pass takes Tp x 128 bytes more, which vb_attn_exp_info reports).
extern "C" size_t vb_attn_exp_smem_bytes(int T) {
  size_t m = fwd_bytes(T);
  if (dq_bytes(T) > m) m = dq_bytes(T);
  return dkv_bytes<false>(T) > m ? dkv_bytes<false>(T) : m;
}

// Kernel `which` (0 forward, 1 dQ pass, 2 dK/dV pass) of the instantiation
// (prescale, flag; flag is nomax for the forward, fdrop for the passes):
// `what` 0 its registers a thread, 1 its local (spill) bytes a thread, 2 its
// dynamic shared memory at T, 3 its resident blocks per SM at T. -1 on an
// error.
extern "C" int vb_attn_exp_info(int which, int what, int T, int prescale, int flag) {
  return kernel_info(kernel_of(which, prescale, flag), bytes_of(which, T, prescale), what);
}

// rows x heads (batch row, head) pairs a block; prescale and nomax select
// the instantiation.
extern "C" int vb_attn_exp_fwd(const void* qkv, const void* qb, const void* key_bias, void* out, void* stats,
                               int B, int T, int H, int rows, int heads, int prescale, int nomax, unsigned int seed,
                               unsigned int threshold, float inv, int dropout, void* stream) {
  if (rows <= 0 || heads <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare(0, T, prescale, nomax);
  if (err != cudaSuccess) return (int)err;
  auto* f = prescale ? (nomax ? launch_fwd<true, true> : launch_fwd<true, false>)
                     : (nomax ? launch_fwd<false, true> : launch_fwd<false, false>);
  f(qkv, qb, key_bias, out, stats, B, T, H, rows, heads, seed, threshold, inv, dropout,
    static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// The two backward passes; db_part [ceil(B / rows), H*3*D] fp32 and delta
// [B, H, T] fp32 are scratch the caller allocates.
extern "C" int vb_attn_exp_bwd(const void* qkv, const void* qb, const void* key_bias, const void* dout,
                               const void* out, const void* stats, void* dqkv, void* db_part, void* delta, int B,
                               int T, int H, int rows, int heads, int prescale, int fdrop, unsigned int seed,
                               unsigned int threshold, float inv, int dropout, void* stream) {
  if (rows <= 0 || heads <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare(1, T, prescale, fdrop);
  if (err != cudaSuccess) return (int)err;
  err = prepare(2, T, prescale, fdrop);
  if (err != cudaSuccess) return (int)err;
  auto* f = prescale ? (fdrop ? launch_bwd<true, true> : launch_bwd<true, false>)
                     : (fdrop ? launch_bwd<false, true> : launch_bwd<false, false>);
  return (int)f(qkv, qb, key_bias, dout, out, stats, dqkv, db_part, delta, B, T, H, rows, heads, seed, threshold,
                inv, dropout, static_cast<cudaStream_t>(stream));
}
