// K13/K14, redesigned for Hopper on K1/K2's design: packed-QKV attention
// that saves its probabilities. Replace visualbert_tpu/ops/flash_attention.py
// ::_packed_fwd_sp_kernel (:409) and ::_packed_bwd_sp_kernel (:441)
// (flash_attention_packed(..., save_probs=True), the encoder's
// flash_save_probs).
//
// Function: qkv [B, T, H*3*D] bf16 packed head-major WITH the projection
// bias already added (the wrapper adds it eagerly before this pair, so
// autograd of that add gives the bias gradient and K14 writes none);
// key_bias [B, T] fp32; out, dout [B, T, H*D] bf16; probs [B, H, T, T] bf16
// with row stride ldp (a multiple of 8 >= T, so every row starts 16-byte
// aligned), the normalised pre-dropout probabilities p = softmax(q.k *
// scale + key_bias), always bf16, each rounded once from its fp32 value.
// K13 writes out and p, and drops p with the Philox bits of attn_philox
// (seed, b*H + h) before P_d . V, as K1 does. K14 reads p back (it
// recomputes neither QK^T nor the exponent): dV = P_d^T dO, dP = dO V^T
// with the same mask, delta = rowsum(dO * O), dS = p (dP - delta), dQ = dS
// K * scale, dK = dS^T Q * scale.
//
// Bound on the H100 at the main path's B=128, T=228, H=12, D=64: the bytes,
// above all the 160 MB of probabilities a layer that K13 writes once and
// K14 reads once per pass: 0.101 ms forward, 0.155 ms backward at 3.35
// TB/s (the tensor products, 2 forward and 4 backward of 20.4 GFLOP each,
// 0.04 / 0.08 ms at 989 TFLOP/s); with dropout on, Philox's integer work
// as in K1/K2.
//
// The design, K1/K2's (flash_attention_packed.cu, steps 1-4) with its
// building blocks from hopper_attn.cuh:
// 1. Schedule. One warpgroup a block owns one batch row x hg heads (hg from
//    the caller's wave model over vb_attn_sp_info's occupancy query) and,
//    for each head, loads K and V (K14's dK/dV pass: Q and dO) into shared
//    memory once and walks every 64-row tile. K14 keeps two passes (dQ with
//    delta, then dK/dV) and no atomics.
// 2. K13 makes two passes over the keys of a query tile: the first takes
//    the row statistic stat = max t + log2 sum exp2(t - max) of t = (q.k) *
//    scale * log2(e) + key_bias * log2(e) with QK^T only; the second
//    recomputes QK^T, writes p = exp2(t - stat) as bf16, drops it and
//    accumulates P_d . V. No unnormalised value is stored and rescaled.
// 3. Probability tiles through shared memory. K13 writes each warp's 16 x
//    64 p rows into its own swizzled 2 KB and stores whole rows from there,
//    16 bytes a lane and 8 lanes a row (the last chunk of a row element by
//    element where T cuts it), while that tile's P_d . V runs. K14 brings
//    each 64 x 64 p tile in by cp.async, 16 bytes a thread (the columns
//    past T zero-filled, never read), into a swizzled tile, committed and
//    prefetched a tile ahead of its use, and reads its fragments with
//    ldmatrix: transposed (.trans) in the dK/dV pass, whose fragment rows
//    are keys. A swizzled row's 16-byte chunks lie in distinct banks for
//    any 8 consecutive rows, so the writes, the row reads and ldmatrix
//    (plain or transposed) are free of bank conflicts.
// 4. Philox once per 2x2 block in all three kernels (keep_bits; key-major
//    in the dK/dV pass), the bits attn_philox's, as K1/K2's.
// 5. wgmma: S = Q K^T (K13's two passes), dP = dO V^T and dP^T = V dO^T
//    take both operands from shared memory; O += P_d V, dQ += dS K, dV +=
//    P_d^T dO, dK += dS^T Q take P_d or dS from registers.
// 6. Element types and head dims, as K1/K2's step 5 and K11/K12's: the
//    bodies are templates on E (bf16 or fp16) and DH (64 or 128), the heads
//    zero-padded by the wrapper to DH and the scale the unpadded D's. The
//    probabilities stay bf16 in every form (the JAX kernel writes them as
//    bf16 whatever the dtype) and a p tile is 64 keys wide whatever DH, so
//    steps 3 and 4 do not change; P_d and dS are rounded to E before their
//    products. FIXED is bf16 at DH = 64 with the scale 1 / 8 a constant,
//    and at bf16, DH = 64 the bodies call their former helpers
//    (hopper_attn.cuh's *_v): the main path's form (vb_attn_sp_fwd / _bwd)
//    compiles as before the templates; the other forms (vb_attn_sp_x_*)
//    take the scale as an argument. fp32 runs
//    flash_attention_f32.cu's save-probs SIMT kernels.
// 7. K13 and K14 at head dims 16 and 32 (bf16, fp16), unpadded, as K2's
//    step 6 (flash_attention_packed.cu): the same bodies on hopper_attn.cuh's
//    small-row tiles (rows of 32 or 64 bytes in the 32 B or 64 B swizzle; a
//    packed row's stride F = 3 H D and dO's H D keep every 16-byte chunk
//    aligned). K13's S = Q K^T (both passes) and K14's dP take D / 16
//    k-steps; K13's O += P_d V and K14's dQ, dK and dV are m64n16k16 or
//    m64n32k16 with D / 2 accumulators a thread. The p tile stays 64 keys
//    wide and bf16, so the stage, store_p, ldmatrix and Philox (steps 3 and
//    4) do not change. Padded to 64, K13 ran both passes' QK^T in 4 k-steps
//    and P_d V as m64n64 over zero columns, and held K and V rows of 128 B;
//    its shared memory now grows by 4 D bytes a key, so its T limit rises
//    with K14's (the larger of the three kernels' bytes bounds both). The
//    wrapper pads a head dim below 16 to 16 and one in (16, 32) to 32.
#include "hopper_attn.cuh"

namespace {

using namespace vb_hopper;

constexpr int STAGE_BYTES = 16 * ROW;  // one warp's 16 p rows of a tile (64 bf16 keys a row)

// Four 8 x 8 bf16 matrices from shared memory, lane l giving the address of
// row l % 8 of matrix l / 8; TRANS loads each transposed.
template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  if (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr)
                 : "memory");
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr)
                 : "memory");
}

// This lane's fragment of a 64 x 64 bf16 p tile (swizzled, rows of queries,
// columns of keys) at shared address tile: pr[nt][0] holds (row g, columns
// 2 tq, 2 tq + 1) of n-tile nt of the warp's 16 fragment rows, pr[nt][1]
// row g + 8. Fragment rows are the tile's rows (queries), or with TRANS
// its columns (keys; the columns of the fragment are then queries).
template <bool TRANS>
__device__ __forceinline__ void load_p_frag(uint32_t (&pr)[8][2], uint32_t tile, int warp, int lane) {
  const int m = lane >> 3, i = lane & 7;
#pragma unroll
  for (int ntp = 0; ntp < 4; ++ntp) {
    const int nt = 2 * ntp + (m >> 1);
    uint32_t r[4];
    ldsm_x4<TRANS>(r, tile + (TRANS ? swz(nt * 8 + i, 2 * warp + (m & 1)) : swz(warp * 16 + (m & 1) * 8 + i, nt)));
    pr[2 * ntp][0] = r[0];
    pr[2 * ntp][1] = r[1];
    pr[2 * ntp + 1][0] = r[2];
    pr[2 * ntp + 1][1] = r[3];
  }
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// Issue the copy of the p tile rows [q0, q0 + TILE) x columns [k0, k0 +
// TILE) of one (b, h) matrix (row i at pb + i * ldp) into the swizzled tile
// at shared address dst; rows and columns past T are zero and not read.
__device__ __forceinline__ void issue_p(uint32_t dst, const bf16* __restrict__ pb, int q0, int k0, int T, int ldp) {
#pragma unroll
  for (int idx = threadIdx.x; idx < TILE * 8; idx += NT) {
    const int r = idx >> 3, c = idx & 7, i = q0 + r, j = k0 + 8 * c;
    const int n = (i < T && j < T) ? 2 * min(T - j, 8) : 0;
    cp_async_n(dst + swz(r, c), pb + (n ? (size_t)i * ldp + j : 0), n);
  }
}

// Store a warp's 16 staged p rows (rows r0 .. r0 + 15 of the (b, h) matrix,
// columns k0 .. k0 + 63; row i at pb + i * ldp): 16 bytes a lane, 8 lanes a
// row, streaming (K14 reads them back much later); only columns < T.
__device__ __forceinline__ void store_p(bf16* __restrict__ pb, const unsigned char* stage, int r0, int k0, int T,
                                        int ldp, int lane) {
  const int c = lane & 7, j = k0 + 8 * c;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = 4 * k + (lane >> 3), i = r0 + r;
    if (i < T && j < T) {
      const uint4 v = *reinterpret_cast<const uint4*>(stage + swz(r, c));
      bf16* dst = pb + (size_t)i * ldp + j;
      if (j + 8 <= T) {
        __stcs(reinterpret_cast<uint4*>(dst), v);
      } else {
        const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (q < T - j) dst[q] = e[q];
      }
    }
  }
}

// The softmax scale: 1 / 8 folded in as a constant (FIXED, DH = 64), else
// the argument.
template <int DH, bool FIXED>
__device__ __forceinline__ float scale_of(float scale) {
  static_assert(!FIXED || DH == 64, "the fixed scale is D = 64's");
  return FIXED ? SCALE : scale;
}

// ---------------------------------------------------------------- K13

template <int DH>
size_t fwd_bytes(int T) {
  const int Tp = round_up(T, TILE);
  return ALIGN + 2 * Tile<DH>::BYTES + TILE_BYTES + (size_t)2 * Tp * Tile<DH>::ROWB + Tp * sizeof(float);
}

// grid (H / hg, B): block (x, b) owns heads [x * hg, (x + 1) * hg) of row b.
template <typename E, int DH, bool FIXED>
__global__ void __launch_bounds__(NT)
attn_sp_fwd_kernel(const E* __restrict__ qkv, const float* __restrict__ key_bias, E* __restrict__ out,
                   bf16* __restrict__ probs, int T, int H, int hg, int ldp, uint32_t seed, uint32_t thr, float inv,
                   int dropout, float scale) {
  using L = Tile<DH>;
  constexpr int TB = L::BYTES, NP = L::NP;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = align_smem(smem_raw);
  const int Tp = round_up(T, TILE), ntl = Tp / TILE;
  unsigned char* Qs = sm;                          // [2][TILE] query tiles
  unsigned char* Ks = Qs + 2 * TB;                 // [Tp] keys
  unsigned char* Vs = Ks + (size_t)Tp * L::ROWB;   // [Tp] values
  unsigned char* Ps = Vs + (size_t)Tp * L::ROWB;   // [4][16] each warp's staged p rows
  float* kb = reinterpret_cast<float*>(Ps + TILE_BYTES);  // [Tp] key bias * log2(e)
  const uint32_t sQ = smem_addr(Qs), sK = smem_addr(Ks), sV = smem_addr(Vs);

  const int b = blockIdx.y, F = 3 * H * DH, ldo = H * DH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3, par = g & 1;
  const float c1 = scale_of<DH, FIXED>(scale) * LOG2E;
  const E* base = qkv + (size_t)b * T * F;
  unsigned char* stage = Ps + warp * STAGE_BYTES;
  load_key_bias(kb, key_bias + (size_t)b * T, T, Tp);

  for (int h = blockIdx.x * hg; h < (blockIdx.x + 1) * hg; ++h) {
    const E *qsrc = base + 3 * h * DH, *ksrc = qsrc + DH, *vsrc = qsrc + 2 * DH;
    const uint32_t bh = (uint32_t)(b * H + h);
    bf16* pb = probs + (size_t)bh * T * ldp;
    __syncthreads();  // no warp still reads the last pair's tiles
    issue_tile_v<E, DH>(sQ, qsrc, 0, T, F);
    cp_commit();
    for (int kt = 0; kt < ntl; ++kt) {
      issue_tile_v<E, DH>(sK + kt * TB, ksrc, kt * TILE, T, F);
      issue_tile_v<E, DH>(sV + kt * TB, vsrc, kt * TILE, T, F);
      cp_commit();
    }

    for (int qt = 0; qt < ntl; ++qt) {
      const int buf = qt & 1;
      const uint32_t sq = sQ + buf * TB;
      if (qt > 0) __syncthreads();  // every warp is done with the buffer the prefetch overwrites
      if (qt + 1 < ntl) issue_tile_v<E, DH>(sQ + (buf ^ 1) * TB, qsrc, (qt + 1) * TILE, T, F);
      cp_commit();
      if (qt > 0) {
        cp_wait<1>();
        fence_async();
        __syncthreads();
      }
      const int r0 = qt * TILE + warp * 16;
      const int row[2] = {r0 + g, r0 + g + 8};

      // pass 1: the row statistic (the running max is shared by the row's
      // 4 lanes, the sum is per lane until the end)
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
      for (int kt = 0; kt < ntl; ++kt) {
        if (qt == 0) {
          // pending after key tile kt: the later key tiles and the prefetch
          cp_wait_dyn(ntl - kt);
          fence_async();
          __syncthreads();
        }
        float s[32];
        wg_fence();
        product_ss_v<E, DH>(s, sq, sK + kt * TB);
        wg_commit();
        wg_wait();
        reg_fence(s);
        const int k0 = kt * TILE;
        float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[4 * nt + e] = s[4 * nt + e] * c1 + kb[k0 + nt * 8 + 2 * tq + (e & 1)];
            mt[e >> 1] = fmaxf(mt[e >> 1], s[4 * nt + e]);
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
          mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
          const float mnew = fmaxf(m[r], mt[r]);
          l[r] *= exp2f(m[r] - mnew);
          m[r] = mnew;
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) l[e >> 1] += exp2f(s[4 * nt + e] - m[e >> 1]);
        }
      }
      float stat[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        stat[r] = m[r] + log2f(l[r]);
      }

      // pass 2: p, its bf16 store, dropout, P_d . V
      float o[NP][L::NA];
      zero_t(o);
      for (int kt = 0; kt < ntl; ++kt) {
        float s[32];
        wg_fence();
        product_ss_v<E, DH>(s, sq, sK + kt * TB);
        wg_commit();
        wg_wait();
        reg_fence(s);
        const int k0 = kt * TILE;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[4 * nt + e] = exp2f(s[4 * nt + e] * c1 + kb[k0 + nt * 8 + 2 * tq + (e & 1)] - stat[e >> 1]);
        }
        __syncwarp();  // the lanes are done reading the last tile's staged rows
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          *reinterpret_cast<uint32_t*>(stage + swz(g, nt) + 4 * tq) = pack_bf16(s[4 * nt], s[4 * nt + 1]);
          *reinterpret_cast<uint32_t*>(stage + swz(g + 8, nt) + 4 * tq) = pack_bf16(s[4 * nt + 2], s[4 * nt + 3]);
        }
        __syncwarp();
        if (dropout) {
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const int j = k0 + nt * 8 + 2 * tq;
            const uint32_t bits = keep_bits<false>(seed, bh, row[0], row[1], j, par, thr, j < T, T);
#pragma unroll
            for (int e = 0; e < 4; ++e) s[4 * nt + e] = ((bits >> e) & 1u) ? s[4 * nt + e] * inv : 0.f;
          }
        }
        uint32_t pa[4][4];
        to_a_v<E>(pa, s);
        wg_fence();
        product_rs_v<E, DH>(o, pa, sV + kt * TB);
        wg_commit();
        store_p(pb, stage, r0, k0, T, ldp, lane);  // while P_d . V runs
        wg_wait();
        reg_fence_t(o);
        reg_fence(pa);
      }
      store_rows_v<E, DH>(out + (size_t)b * T * ldo + h * DH, o, 1.f, row[0], row[1], row[0] < T, row[1] < T, ldo,
                          tq);
    }
  }
}

// ------------------------------------------------------- K14: dQ pass

template <int DH>
size_t dq_bytes(int T) {
  const int Tp = round_up(T, TILE);
  return ALIGN + 2 * Tile<DH>::BYTES + 2 * TILE_BYTES + (size_t)2 * Tp * Tile<DH>::ROWB + Tp * sizeof(float);
}

// Step n = qt * ntl + kt walks query tile qt against key tile kt; p tile n
// lands a step ahead (ring of two), key tile kt + 1 during step (0, kt),
// dO tile qt + 1 during step (qt, 0).
template <typename E, int DH, bool FIXED>
__global__ void __launch_bounds__(NT)
attn_sp_bwd_dq_kernel(const E* __restrict__ qkv, const bf16* __restrict__ probs, const E* __restrict__ dout,
                      const E* __restrict__ out, E* __restrict__ dqkv, float* __restrict__ delta_g, int T, int H,
                      int hg, int ldp, uint32_t seed, uint32_t thr, float inv, int dropout, float scale) {
  using L = Tile<DH>;
  constexpr int TB = L::BYTES, NP = L::NP;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = align_smem(smem_raw);
  const int Tp = round_up(T, TILE), ntl = Tp / TILE, nsteps = ntl * ntl;
  unsigned char* dOs = sm;                         // [2][TILE]
  unsigned char* Ps = dOs + 2 * TB;                // [2][TILE] p tiles
  unsigned char* Ks = Ps + 2 * TILE_BYTES;         // [Tp]
  unsigned char* Vs = Ks + (size_t)Tp * L::ROWB;   // [Tp]
  float* dl = reinterpret_cast<float*>(Vs + (size_t)Tp * L::ROWB);  // [Tp] delta of the pair's rows
  const uint32_t sdO = smem_addr(dOs), sP = smem_addr(Ps), sK = smem_addr(Ks), sV = smem_addr(Vs);

  const int b = blockIdx.y, F = 3 * H * DH, ldo = H * DH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3, par = g & 1;
  const float sc = scale_of<DH, FIXED>(scale);
  const E* base = qkv + (size_t)b * T * F;

  for (int h = blockIdx.x * hg; h < (blockIdx.x + 1) * hg; ++h) {
    const E *ksrc = base + (3 * h + 1) * DH, *vsrc = ksrc + DH;
    const E* dsrc = dout + (size_t)b * T * ldo + h * DH;
    const uint32_t bh = (uint32_t)(b * H + h);
    const bf16* pb = probs + (size_t)bh * T * ldp;
    __syncthreads();  // no warp still reads the last pair's tiles or delta
    issue_tile_v<E, DH>(sdO, dsrc, 0, T, ldo);
    issue_tile_v<E, DH>(sK, ksrc, 0, T, F);
    issue_tile_v<E, DH>(sV, vsrc, 0, T, F);
    issue_p(sP, pb, 0, 0, T, ldp);
    cp_commit();
    // while the tiles land: the pair's delta (read after the first barrier)
    pair_delta_v<E, DH>(dsrc, out + (size_t)b * T * ldo + h * DH, ldo, dl, delta_g + (size_t)bh * T, T, Tp);

    float dq[NP][L::NA];
    for (int n = 0; n < nsteps; ++n) {
      const int qt = n / ntl, kt = n - qt * ntl;
      __syncthreads();  // every warp is done with the buffers the copies below overwrite
      if (n + 1 < nsteps) {
        const int nq = (n + 1) / ntl;
        issue_p(sP + ((n + 1) & 1) * TILE_BYTES, pb, nq * TILE, (n + 1 - nq * ntl) * TILE, T, ldp);
      }
      if (qt == 0 && kt + 1 < ntl) {
        issue_tile_v<E, DH>(sK + (kt + 1) * TB, ksrc, (kt + 1) * TILE, T, F);
        issue_tile_v<E, DH>(sV + (kt + 1) * TB, vsrc, (kt + 1) * TILE, T, F);
      }
      if (kt == 0 && qt + 1 < ntl) issue_tile_v<E, DH>(sdO + ((qt + 1) & 1) * TB, dsrc, (qt + 1) * TILE, T, ldo);
      cp_commit();
      cp_wait<1>();  // everything but this step's copies
      fence_async();
      __syncthreads();

      const int row[2] = {qt * TILE + warp * 16 + g, qt * TILE + warp * 16 + g + 8};
      const float dlrow[2] = {dl[row[0]], dl[row[1]]};
      if (kt == 0) zero_t(dq);
      float dp[32];
      uint32_t pr[8][2];
      wg_fence();
      product_ss_v<E, DH>(dp, sdO + (qt & 1) * TB, sV + kt * TB);  // dP = dO V^T
      wg_commit();
      load_p_frag<false>(pr, sP + (n & 1) * TILE_BYTES, warp, lane);
      wg_wait();
      reg_fence(dp);

      const int k0 = kt * TILE;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int j = k0 + nt * 8 + 2 * tq;
        uint32_t bits = 0xFu;
        if (dropout) bits = keep_bits<false>(seed, bh, row[0], row[1], j, par, thr, j < T, T);
        const float2 p01 = unpack_bf16(pr[nt][0]), p23 = unpack_bf16(pr[nt][1]);
        const float p[4] = {p01.x, p01.y, p23.x, p23.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float d = dp[4 * nt + e];
          if (dropout) d = ((bits >> e) & 1u) ? d * inv : 0.f;
          dp[4 * nt + e] = p[e] * (d - dlrow[e >> 1]);  // dS (the scale goes on dQ)
        }
      }
      uint32_t sa[4][4];
      to_a_v<E>(sa, dp);
      wg_fence();
      product_rs_v<E, DH>(dq, sa, sK + kt * TB);
      wg_commit();
      wg_wait();
      reg_fence_t(dq);
      reg_fence(sa);
      if (kt == ntl - 1)
        store_rows_v<E, DH>(dqkv + (size_t)b * T * F + 3 * h * DH, dq, sc, row[0], row[1], row[0] < T, row[1] < T, F,
                            tq);
    }
  }
}

// --------------------------------------------------- K14: dK, dV pass

template <int DH>
size_t dkv_bytes(int T) {
  const int Tp = round_up(T, TILE);
  return ALIGN + 2 * Tile<DH>::BYTES + 2 * TILE_BYTES + (size_t)2 * Tp * Tile<DH>::ROWB + Tp * sizeof(float);
}

// Step n = kt * ntl + qc walks key tile kt against query tile qc; p tile
// (qc, kt) lands a step ahead (ring of two), query tile qc + 1 (Q and dO)
// during step (0, qc), value tile kt + 1 during step (kt, 0).
template <typename E, int DH, bool FIXED>
__global__ void __launch_bounds__(NT)
attn_sp_bwd_dkv_kernel(const E* __restrict__ qkv, const bf16* __restrict__ probs, const E* __restrict__ dout,
                       const float* __restrict__ delta_g, E* __restrict__ dqkv, int T, int H, int hg, int ldp,
                       uint32_t seed, uint32_t thr, float inv, int dropout, float scale) {
  using L = Tile<DH>;
  constexpr int TB = L::BYTES, NP = L::NP;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = align_smem(smem_raw);
  const int Tp = round_up(T, TILE), ntl = Tp / TILE, nsteps = ntl * ntl;
  unsigned char* Vs = sm;                          // [2][TILE] value tiles
  unsigned char* Ps = Vs + 2 * TB;                 // [2][TILE] p tiles
  unsigned char* Qs = Ps + 2 * TILE_BYTES;         // [Tp] all queries
  unsigned char* dOs = Qs + (size_t)Tp * L::ROWB;  // [Tp]
  float* dl = reinterpret_cast<float*>(dOs + (size_t)Tp * L::ROWB);  // [Tp] delta of every query
  const uint32_t sV = smem_addr(Vs), sP = smem_addr(Ps), sQ = smem_addr(Qs), sdO = smem_addr(dOs);

  const int b = blockIdx.y, F = 3 * H * DH, ldo = H * DH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3, par = g & 1;
  const float sc = scale_of<DH, FIXED>(scale);
  const E* base = qkv + (size_t)b * T * F;

  for (int h = blockIdx.x * hg; h < (blockIdx.x + 1) * hg; ++h) {
    const E *qsrc = base + 3 * h * DH, *vsrc = qsrc + 2 * DH;
    const E* dsrc = dout + (size_t)b * T * ldo + h * DH;
    const uint32_t bh = (uint32_t)(b * H + h);
    const bf16* pb = probs + (size_t)bh * T * ldp;
    __syncthreads();
    issue_tile_v<E, DH>(sV, vsrc, 0, T, F);
    issue_tile_v<E, DH>(sQ, qsrc, 0, T, F);
    issue_tile_v<E, DH>(sdO, dsrc, 0, T, ldo);
    issue_p(sP, pb, 0, 0, T, ldp);
    cp_commit();
    for (int i = threadIdx.x; i < Tp; i += NT) dl[i] = i < T ? delta_g[(size_t)bh * T + i] : 0.f;

    float dk[NP][L::NA], dv[NP][L::NA];
    for (int n = 0; n < nsteps; ++n) {
      const int kt = n / ntl, qc = n - kt * ntl;
      __syncthreads();
      if (n + 1 < nsteps) {
        const int nk = (n + 1) / ntl;
        issue_p(sP + ((n + 1) & 1) * TILE_BYTES, pb, (n + 1 - nk * ntl) * TILE, nk * TILE, T, ldp);
      }
      if (kt == 0 && qc + 1 < ntl) {
        issue_tile_v<E, DH>(sQ + (qc + 1) * TB, qsrc, (qc + 1) * TILE, T, F);
        issue_tile_v<E, DH>(sdO + (qc + 1) * TB, dsrc, (qc + 1) * TILE, T, ldo);
      }
      if (qc == 0 && kt + 1 < ntl) issue_tile_v<E, DH>(sV + ((kt + 1) & 1) * TB, vsrc, (kt + 1) * TILE, T, F);
      cp_commit();
      cp_wait<1>();
      fence_async();
      __syncthreads();

      const int key[2] = {kt * TILE + warp * 16 + g, kt * TILE + warp * 16 + g + 8};
      if (qc == 0) {
        zero_t(dk);
        zero_t(dv);
      }
      // dP^T = V dO^T: 64 keys x 64 queries
      float dp[32], s[32];
      uint32_t pr[8][2];
      wg_fence();
      product_ss_v<E, DH>(dp, sV + (kt & 1) * TB, sdO + qc * TB);
      wg_commit();
      load_p_frag<true>(pr, sP + (n & 1) * TILE_BYTES, warp, lane);
      wg_wait();
      reg_fence(dp);

      const int q0 = qc * TILE;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int i0 = q0 + nt * 8 + 2 * tq;  // queries i0, i0 + 1
        uint32_t bits = 0xFu;
        if (dropout) bits = keep_bits<true>(seed, bh, key[0], key[1], i0, par, thr, i0 < T, T);
        const float2 p01 = unpack_bf16(pr[nt][0]), p23 = unpack_bf16(pr[nt][1]);
        const float p[4] = {p01.x, p01.y, p23.x, p23.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pd = p[e], d = dp[4 * nt + e];
          if (dropout) {
            const bool keep = (bits >> e) & 1u;
            pd = keep ? pd * inv : 0.f;
            d = keep ? d * inv : 0.f;
          }
          s[4 * nt + e] = pd;
          dp[4 * nt + e] = p[e] * (d - dl[i0 + (e & 1)]);
        }
      }
      uint32_t pa[4][4], sa[4][4];
      to_a_v<E>(pa, s);
      to_a_v<E>(sa, dp);
      wg_fence();
      product_rs_v<E, DH>(dv, pa, sdO + qc * TB);
      product_rs_v<E, DH>(dk, sa, sQ + qc * TB);
      wg_commit();
      wg_wait();
      reg_fence_t(dv);
      reg_fence_t(dk);
      reg_fence(pa);
      reg_fence(sa);
      if (qc == ntl - 1) {
        const bool ok0 = key[0] < T, ok1 = key[1] < T;
        E* dst = dqkv + (size_t)b * T * F + 3 * h * DH;
        store_rows_v<E, DH>(dst + DH, dk, sc, key[0], key[1], ok0, ok1, F, tq);
        store_rows_v<E, DH>(dst + 2 * DH, dv, 1.f, key[0], key[1], ok0, ok1, F, tq);
      }
    }
  }
}

// ---------------------------------------------------------------- launches

template <typename E, int DH, bool FIXED>
const void* kernel_of(int which) {
  switch (which) {
    case 0: return (const void*)attn_sp_fwd_kernel<E, DH, FIXED>;
    case 1: return (const void*)attn_sp_bwd_dq_kernel<E, DH, FIXED>;
    case 2: return (const void*)attn_sp_bwd_dkv_kernel<E, DH, FIXED>;
    default: return nullptr;
  }
}

template <int DH>
size_t bytes_of(int which, int T) {
  return which == 0 ? fwd_bytes<DH>(T) : which == 1 ? dq_bytes<DH>(T) : dkv_bytes<DH>(T);
}

template <int DH>
size_t smem_bytes(int T) {
  size_t m = fwd_bytes<DH>(T);
  if (dq_bytes<DH>(T) > m) m = dq_bytes<DH>(T);
  return dkv_bytes<DH>(T) > m ? dkv_bytes<DH>(T) : m;
}

size_t bytes_at(int dh, int which, int T) {
  switch (dh) {
    case 16: return bytes_of<16>(which, T);
    case 32: return bytes_of<32>(which, T);
    case 64: return bytes_of<64>(which, T);
    case 128: return bytes_of<128>(which, T);
    default: return 0;
  }
}

template <typename E, int DH, bool FIXED>
cudaError_t prepare(int which, int T) {
  return cudaFuncSetAttribute(kernel_of<E, DH, FIXED>(which), cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes_of<DH>(which, T));
}

bool bad_layout(int T, int H, int hg, int ldp) { return hg <= 0 || H % hg || ldp < T || ldp % 8; }

template <typename E, int DH, bool FIXED>
int launch_fwd(const void* qkv, const void* key_bias, void* out, void* probs, int B, int T, int H, int hg, int ldp,
               unsigned int seed, unsigned int threshold, float inv, int dropout, float scale, cudaStream_t s) {
  if (bad_layout(T, H, hg, ldp)) return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare<E, DH, FIXED>(0, T);
  if (err != cudaSuccess) return (int)err;
  attn_sp_fwd_kernel<E, DH, FIXED><<<dim3(H / hg, B), NT, fwd_bytes<DH>(T), s>>>(
      static_cast<const E*>(qkv), static_cast<const float*>(key_bias), static_cast<E*>(out),
      static_cast<bf16*>(probs), T, H, hg, ldp, seed, threshold, inv, dropout, scale);
  return (int)cudaGetLastError();
}

template <typename E, int DH, bool FIXED>
int launch_bwd(const void* qkv, const void* probs, const void* dout, const void* out, void* dqkv, void* delta, int B,
               int T, int H, int hg_dq, int hg_dkv, int ldp, int passes, unsigned int seed, unsigned int threshold,
               float inv, int dropout, float scale, cudaStream_t s) {
  if (bad_layout(T, H, hg_dq, ldp) || bad_layout(T, H, hg_dkv, ldp) || passes < 1 || passes > 3)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare<E, DH, FIXED>(1, T);
  if (err != cudaSuccess) return (int)err;
  err = prepare<E, DH, FIXED>(2, T);
  if (err != cudaSuccess) return (int)err;
  if (passes & 1) {
    attn_sp_bwd_dq_kernel<E, DH, FIXED><<<dim3(H / hg_dq, B), NT, dq_bytes<DH>(T), s>>>(
        static_cast<const E*>(qkv), static_cast<const bf16*>(probs), static_cast<const E*>(dout),
        static_cast<const E*>(out), static_cast<E*>(dqkv), static_cast<float*>(delta), T, H, hg_dq, ldp, seed,
        threshold, inv, dropout, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (passes & 2) {
    attn_sp_bwd_dkv_kernel<E, DH, FIXED><<<dim3(H / hg_dkv, B), NT, dkv_bytes<DH>(T), s>>>(
        static_cast<const E*>(qkv), static_cast<const bf16*>(probs), static_cast<const E*>(dout),
        static_cast<const float*>(delta), static_cast<E*>(dqkv), T, H, hg_dkv, ldp, seed, threshold, inv, dropout,
        scale);
  }
  return (int)cudaGetLastError();
}

// Kernel `which` of form f (hopper_attn.cuh's attn_form numbers the forms).
const void* kernel_of_form(int f, int which) {
  switch (f) {
    case 0: return kernel_of<bf16, 64, false>(which);
    case 1: return kernel_of<bf16, 128, false>(which);
    case 2: return kernel_of<__half, 64, false>(which);
    case 3: return kernel_of<__half, 128, false>(which);
    case 4: return kernel_of<bf16, 16, false>(which);
    case 5: return kernel_of<bf16, 32, false>(which);
    case 6: return kernel_of<__half, 16, false>(which);
    case 7: return kernel_of<__half, 32, false>(which);
    default: return nullptr;
  }
}

}  // namespace

// The largest dynamic shared memory of the three kernels at T (bf16, D = 64).
extern "C" size_t vb_attn_sp_smem_bytes(int T) { return smem_bytes<64>(T); }

// Kernel `which` (0 K13, 1 K14's dQ pass, 2 its dK/dV pass) of bf16 at D =
// 64: `what` 0 its registers a thread, 1 its local (spill) bytes a thread, 2
// its dynamic shared memory at T, 3 its resident blocks per SM at T. -1 on
// an error.
extern "C" int vb_attn_sp_info(int which, int what, int T) {
  return kernel_info(kernel_of<bf16, 64, true>(which), bytes_of<64>(which, T), what);
}

// The bf16, D = 64 entry points (scale 1 / 8, a constant of the kernels);
// tools that build an earlier tree's source launch them with these
// signatures. probs: [B, H, T, ldp] storage of the [B, H, T, T]
// probabilities.
extern "C" int vb_attn_sp_fwd(const void* qkv, const void* key_bias, void* out, void* probs, int B, int T, int H,
                              int hg, int ldp, unsigned int seed, unsigned int threshold, float inv, int dropout,
                              void* stream) {
  return launch_fwd<bf16, 64, true>(qkv, key_bias, out, probs, B, T, H, hg, ldp, seed, threshold, inv, dropout,
                                    0.125f, static_cast<cudaStream_t>(stream));
}

// delta [B, H, T] fp32 is scratch the caller allocates, written by the dQ
// pass and read by the dK/dV pass; hg_dq and hg_dkv are the two passes'
// heads a block. passes: 1 the dQ pass alone, 2 the dK/dV pass alone (on
// the delta of an earlier dQ pass), 3 both.
extern "C" int vb_attn_sp_bwd(const void* qkv, const void* probs, const void* dout, const void* out, void* dqkv,
                              void* delta, int B, int T, int H, int hg_dq, int hg_dkv, int ldp, int passes,
                              unsigned int seed, unsigned int threshold, float inv, int dropout, void* stream) {
  return launch_bwd<bf16, 64, true>(qkv, probs, dout, out, dqkv, delta, B, T, H, hg_dq, hg_dkv, ldp, passes, seed,
                                    threshold, inv, dropout, 0.125f, static_cast<cudaStream_t>(stream));
}

// Every other form: dtype 0 bf16, 1 fp16; dh the kernel's head dim, 16, 32,
// 64 or 128 (the caller zero-pads the heads to it); scale the softmax scale
// of the unpadded head dim; the probabilities bf16 in every form. The
// largest dynamic shared memory of the three kernels at dh and T (0 for a
// dh not built).
extern "C" size_t vb_attn_sp_x_smem_bytes(int dh, int T) {
  switch (dh) {
    case 16: return smem_bytes<16>(T);
    case 32: return smem_bytes<32>(T);
    case 64: return smem_bytes<64>(T);
    case 128: return smem_bytes<128>(T);
    default: return 0;
  }
}

extern "C" int vb_attn_sp_x_info(int dtype, int dh, int which, int what, int T) {
  const int f = attn_form(dtype, dh);
  if (f < 0) return -1;
  return kernel_info(kernel_of_form(f, which), bytes_at(dh, which, T), what);
}

extern "C" int vb_attn_sp_x_fwd(const void* qkv, const void* key_bias, void* out, void* probs, int B, int T, int H,
                                int hg, int ldp, unsigned int seed, unsigned int threshold, float inv, int dropout,
                                int dtype, int dh, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VB_FWD(E, D) \
  launch_fwd<E, D, false>(qkv, key_bias, out, probs, B, T, H, hg, ldp, seed, threshold, inv, dropout, scale, s)
  switch (attn_form(dtype, dh)) {
    case 0: return VB_FWD(bf16, 64);
    case 1: return VB_FWD(bf16, 128);
    case 2: return VB_FWD(__half, 64);
    case 3: return VB_FWD(__half, 128);
    case 4: return VB_FWD(bf16, 16);
    case 5: return VB_FWD(bf16, 32);
    case 6: return VB_FWD(__half, 16);
    case 7: return VB_FWD(__half, 32);
    default: return (int)cudaErrorInvalidValue;
  }
#undef VB_FWD
}

extern "C" int vb_attn_sp_x_bwd(const void* qkv, const void* probs, const void* dout, const void* out, void* dqkv,
                                void* delta, int B, int T, int H, int hg_dq, int hg_dkv, int ldp, int passes,
                                unsigned int seed, unsigned int threshold, float inv, int dropout, int dtype, int dh,
                                float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VB_BWD(E, D)                                                                                                \
  launch_bwd<E, D, false>(qkv, probs, dout, out, dqkv, delta, B, T, H, hg_dq, hg_dkv, ldp, passes, seed, threshold, \
                          inv, dropout, scale, s)
  switch (attn_form(dtype, dh)) {
    case 0: return VB_BWD(bf16, 64);
    case 1: return VB_BWD(bf16, 128);
    case 2: return VB_BWD(__half, 64);
    case 3: return VB_BWD(__half, 128);
    case 4: return VB_BWD(bf16, 16);
    case 5: return VB_BWD(bf16, 32);
    case 6: return VB_BWD(__half, 16);
    case 7: return VB_BWD(__half, 32);
    default: return (int)cudaErrorInvalidValue;
  }
#undef VB_BWD
}
