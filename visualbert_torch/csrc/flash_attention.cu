// K11/K12, redesigned for Hopper on K1/K2's design: heads-major attention
// forward and backward. Replace visualbert_tpu/ops/flash_attention.py::
// _fwd_kernel (:71) and ::_bwd_kernel (:93) (reached through flash_attention
// with heads_major=True, the encoder's packed_qkv=False path).
//
// Function: K1/K2's (flash_attention_packed.cu) on another layout, without
// the deferred bias. qkv [B, 3, H, T, D] bf16 with the bias already added (q,
// k and v are slices of that one tensor: the kernels take its base pointer,
// never three copies); key_bias [B, T] fp32 (0 or -10000). The forward
// writes out [B, H, T, D] bf16 and the base-2 row statistic stats [B, H, T]
// fp32, stats = max_j t + log2 sum_j exp2(t - max) with t = (q.k) * scale *
// log2(e) + key_bias * log2(e): the TPU heads-major pair keeps no statistics
// and its backward recomputes max and sum; K11 writes the statistic as K1
// does, so K12 rebuilds p = exp2(t - stats) in one pass and uses delta =
// rowsum(dO * O) [B, H, T] (scratch the dK/dV pass reads) for rowsum(dP *
// P): the same function, without a second pass over the keys. K12 writes one
// [B, 3, H, T, D] gradient and no bias gradient. Dropout keeps probability
// (b, h, i, j) by philox.cuh::attn_philox's bit, as every attention kernel.
// On the same numbers K1/K2 with a zero bias give these kernels' outputs bit
// for bit: bf16 x + 0 is exact, and every other step is the same arithmetic.
//
// Bound on the H100 at the main path's B=128, T=228, H=12, D=64: as K1/K2's,
// bytes 0.054 / 0.108 ms at 3.35 TB/s (qkv, out, stats; the backward also
// dout, out, stats in and dqkv out), the tensor products 0.04 / 0.08 ms at
// 989 TFLOP/s, and with dropout on Philox's integer work, about 0.12 ms of
// the card's 32-bit multiply rate per pass that regenerates the mask.
//
// The design follows K1/K2's list of steps (flash_attention_packed.cu),
// numbered as there; step 7, K2's streamed passes at 128, is K2's alone.
// 1-4. K1/K2's steps 1-4, on
// hopper_attn.cuh's building blocks: one warpgroup a block owns one batch
// row x hg heads and loads each head's K and V (Q and dO in the dK/dV pass)
// once, walking every 64-row tile; Philox once per 2x2 block, shared by lane
// pairs; cp.async into 128 B-swizzled tiles, committed a key tile at a time,
// the next tile prefetched; wgmma m64n64k16 in all three kernels. In this
// layout a head's 64-row tile is one contiguous 8 KB run (row stride D). The
// bodies are K1/K2's with the bias adds and column sums left out, written
// here rather than shared with K1/K2 through a template: instantiated on the
// packed layout, such a template compiled K1/K2 to other machine code (on an
// H100: the dK/dV pass 248 registers instead of 250, K1 at dropout 0 2-3 %
// slower).
//
// 5. Element types and head dims (K1/K2's step 5): the bodies are templates on
// the element type E (bf16 or fp16) and the head dim DH (16, 32, 64 or 128),
// on hopper_attn.cuh's Tile<DH> and *_t helpers; the wrapper zero-pads a
// head dim to the next of them ([B, 3, H, T, D] -> [..., DH]) and passes the
// unpadded D's softmax scale. FIXED instantiates bf16 at DH = 64 with the
// scale 1 / 8 a constant, and at bf16, DH = 64 the bodies call the helpers
// they called before the templates (hopper_attn.cuh's *_v): the main
// path's form (vb_attn_hm_fwd / _bwd) compiles as it did before
// (tools/attn_ab.py compares its machine code with another checkout's). The other
// forms (vb_attn_hm_x_*) take the scale as an argument. fp32 runs
// flash_attention_f32.cu's SIMT kernels on this layout's strides.
//
// 6. K12 at head dims 16 and 32 (bf16, fp16), unpadded, as K2's step 6
// (flash_attention_packed.cu): the same two pass bodies on hopper_attn.cuh's
// small-row tiles (a heads-major row of 16 or 32 elements is 32 or 64
// contiguous bytes, one row of the 32 B or 64 B swizzle), S and dP in D /
// 16 k-steps, dQ, dK and dV m64n16k16 or m64n32k16 with D / 2 accumulators
// a thread. The wrapper pads a head dim below 16 to 16 and one in (16, 32)
// to 32 (ops/flash_attention.py::kernel_head_dim).
//
// 8. K11 at head dims 16 and 32 (bf16, fp16), unpadded, as K1's step 8
//    (flash_attention_packed.cu): the forward body on the small-row tiles,
//    S = QK^T in D / 16 k-steps, O += P_d V m64n16k16 or m64n32k16 into D /
//    2 accumulators a thread. As there, O is rescaled by alpha in a loop of
//    its own over its D / 8 n-tiles (hopper_attn.cuh::rescale_s; indexed by
//    S's 8 n-tiles it would run past the array into local memory), each row
//    is stored with its own inv / l (store_rows_s), and a head's K and V
//    rows take 2 D bytes each: T reaches about 3,300 at D = 16 and 1,660 at
//    D = 32, past K12's 2880 / 1536, which now bound the heads-major path
//    at these head dims (the wrapper checks the largest of the three
//    kernels' bytes). Padded to 64, K11 ran 4 k-steps of QK^T, m64n64 of P_d
//    V over zero columns and 128 B rows, and the wrapper padded qkv and cut
//    the output. A heads-major row of 16 or 32 elements is 32 or 64
//    contiguous bytes, so a 64-row tile is one contiguous run, as at D = 64.
#include "hopper_attn.cuh"

namespace {

using namespace vb_hopper;

// (b, h)'s first q row in qkv or dqkv [B, 3, H, T, DH]; its k and v rows are
// kv_step(T, H) and 2 kv_step(T, H) further.
template <int DH>
__device__ __forceinline__ size_t in_off(int b, int h, int T, int H) { return ((size_t)b * 3 * H + h) * T * DH; }
template <int DH>
__device__ __forceinline__ size_t kv_step(int T, int H) { return (size_t)H * T * DH; }
// (b, h)'s first row in out or dout [B, H, T, DH].
template <int DH>
__device__ __forceinline__ size_t out_off(int b, int h, int T, int H) { return ((size_t)b * H + h) * T * DH; }

// The softmax scale: 1 / 8 folded in as a constant (FIXED, DH = 64), else
// the argument.
template <int DH, bool FIXED>
__device__ __forceinline__ float scale_of(float scale) {
  static_assert(!FIXED || DH == 64, "the fixed scale is D = 64's");
  return FIXED ? SCALE : scale;
}

// ---------------------------------------------------------------- forward

template <int DH>
size_t fwd_bytes(int T) {
  const int Tp = round_up(T, TILE);
  return ALIGN + 2 * Tile<DH>::BYTES + (size_t)2 * Tp * Tile<DH>::ROWB + Tp * sizeof(float);
}

// grid (H / hg, B): block (x, b) owns heads [x * hg, (x + 1) * hg) of row b.
template <typename E, int DH, bool FIXED>
__global__ void __launch_bounds__(NT)
hm_fwd_kernel(const E* __restrict__ qkv, const float* __restrict__ key_bias, E* __restrict__ out,
              float* __restrict__ stats, int T, int H, int hg, uint32_t seed, uint32_t thr, float inv, int dropout,
              float scale) {
  using L = Tile<DH>;
  constexpr int TB = L::BYTES, NP = L::NP;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = align_smem(smem_raw);
  const int Tp = round_up(T, TILE), ntl = Tp / TILE;
  unsigned char* Qs = sm;                          // [2][TILE] query tiles
  unsigned char* Ks = Qs + 2 * TB;                 // [Tp] keys
  unsigned char* Vs = Ks + (size_t)Tp * L::ROWB;   // [Tp] values
  float* kb = reinterpret_cast<float*>(Vs + (size_t)Tp * L::ROWB);  // [Tp] key bias * log2(e)
  const uint32_t sQ = smem_addr(Qs), sK = smem_addr(Ks), sV = smem_addr(Vs);

  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3, par = g & 1;
  const float c1 = scale_of<DH, FIXED>(scale) * LOG2E;
  load_key_bias(kb, key_bias + (size_t)b * T, T, Tp);

  for (int h = blockIdx.x * hg; h < (blockIdx.x + 1) * hg; ++h) {
    const E *qsrc = qkv + in_off<DH>(b, h, T, H), *ksrc = qsrc + kv_step<DH>(T, H), *vsrc = ksrc + kv_step<DH>(T, H);
    const uint32_t bh = (uint32_t)(b * H + h);
    __syncthreads();  // no warp still reads the last pair's tiles
    issue_tile_v<E, DH>(sQ, qsrc, 0, T, DH);
    cp_commit();
    for (int kt = 0; kt < ntl; ++kt) {
      issue_tile_v<E, DH>(sK + kt * TB, ksrc, kt * TILE, T, DH);
      issue_tile_v<E, DH>(sV + kt * TB, vsrc, kt * TILE, T, DH);
      cp_commit();
    }

    for (int qt = 0; qt < ntl; ++qt) {
      const int buf = qt & 1;
      if (qt > 0) __syncthreads();  // every warp is done with the buffer the prefetch overwrites
      if (qt + 1 < ntl) issue_tile_v<E, DH>(sQ + (buf ^ 1) * TB, qsrc, (qt + 1) * TILE, T, DH);
      cp_commit();
      if (qt > 0) {
        cp_wait<1>();
        fence_async();
        __syncthreads();
      }
      const int row[2] = {qt * TILE + warp * 16 + g, qt * TILE + warp * 16 + g + 8};
      float o[NP][L::NA];
      zero_t(o);
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
        product_ss_v<E, DH>(s, sQ + buf * TB, sK + kt * TB);
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
        if constexpr (L::SMALL) rescale_s<DH>(o[0], alpha);  // step 8: O's D / 8 n-tiles, not S's 8
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if constexpr (!L::SMALL) {
#pragma unroll
              for (int p = 0; p < NP; ++p) o[p][4 * nt + e] *= alpha[e >> 1];
            }
            const float pr = exp2f(s[4 * nt + e] - mnew[e >> 1]);
            l[e >> 1] += pr;
            s[4 * nt + e] = pr;
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
        to_a_v<E>(pa, s);
        wg_fence();
        product_rs_v<E, DH>(o, pa, sV + kt * TB);
        wg_commit();
        wg_wait();
        reg_fence_t(o);
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
      E* ob = out + out_off<DH>(b, h, T, H);
      if constexpr (L::SMALL) {
        store_rows_s<E, DH>(ob, o[0], sc, row[0], row[1], ok[0], ok[1], DH, tq);
      } else {
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const int c = p * 64 + nt * 8 + 2 * tq;
            if (ok[0])
              *reinterpret_cast<uint32_t*>(ob + (size_t)row[0] * DH + c) =
                  vb::Elem<E>::pack(o[p][4 * nt] * sc[0], o[p][4 * nt + 1] * sc[0]);
            if (ok[1])
              *reinterpret_cast<uint32_t*>(ob + (size_t)row[1] * DH + c) =
                  vb::Elem<E>::pack(o[p][4 * nt + 2] * sc[1], o[p][4 * nt + 3] * sc[1]);
          }
      }
      if (tq == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (ok[r]) stats[(size_t)bh * T + row[r]] = m[r] + log2f(l[r]);
      }
    }
  }
}

// ------------------------------------------------------- backward: dQ pass

template <int DH>
size_t dq_bytes(int T) {
  const int Tp = round_up(T, TILE);
  return ALIGN + 4 * Tile<DH>::BYTES + (size_t)2 * Tp * Tile<DH>::ROWB + 3 * Tp * sizeof(float);
}

template <typename E, int DH, bool FIXED>
__global__ void __launch_bounds__(NT)
hm_dq_kernel(const E* __restrict__ qkv, const float* __restrict__ key_bias, const E* __restrict__ dout,
             const E* __restrict__ out, const float* __restrict__ stats, E* __restrict__ dqkv,
             float* __restrict__ delta_g, int T, int H, int hg, uint32_t seed, uint32_t thr, float inv, int dropout,
             float scale) {
  using L = Tile<DH>;
  constexpr int TB = L::BYTES, NP = L::NP;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = align_smem(smem_raw);
  const int Tp = round_up(T, TILE), ntl = Tp / TILE;
  unsigned char* Qs = sm;                          // [2][TILE]
  unsigned char* dOs = Qs + 2 * TB;                // [2][TILE]
  unsigned char* Ks = dOs + 2 * TB;                // [Tp]
  unsigned char* Vs = Ks + (size_t)Tp * L::ROWB;   // [Tp]
  float* kb = reinterpret_cast<float*>(Vs + (size_t)Tp * L::ROWB);  // [Tp]
  float* st = kb + Tp;                             // [Tp] stats of the pair's rows
  float* dl = st + Tp;                             // [Tp] delta of the pair's rows
  const uint32_t sQ = smem_addr(Qs), sdO = smem_addr(dOs), sK = smem_addr(Ks), sV = smem_addr(Vs);

  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3, par = g & 1;
  const float sc = scale_of<DH, FIXED>(scale), c1 = sc * LOG2E;
  load_key_bias(kb, key_bias + (size_t)b * T, T, Tp);

  for (int h = blockIdx.x * hg; h < (blockIdx.x + 1) * hg; ++h) {
    const E *qsrc = qkv + in_off<DH>(b, h, T, H), *ksrc = qsrc + kv_step<DH>(T, H), *vsrc = ksrc + kv_step<DH>(T, H);
    const E* dsrc = dout + out_off<DH>(b, h, T, H);
    const uint32_t bh = (uint32_t)(b * H + h);
    const size_t sb = (size_t)bh * T;
    __syncthreads();  // no warp still reads the last pair's tiles or statistics
    issue_tile_v<E, DH>(sQ, qsrc, 0, T, DH);
    issue_tile_v<E, DH>(sdO, dsrc, 0, T, DH);
    cp_commit();
    for (int kt = 0; kt < ntl; ++kt) {
      issue_tile_v<E, DH>(sK + kt * TB, ksrc, kt * TILE, T, DH);
      issue_tile_v<E, DH>(sV + kt * TB, vsrc, kt * TILE, T, DH);
      cp_commit();
    }
    // while the tiles land: the pair's statistics and delta
    for (int i = threadIdx.x; i < Tp; i += NT) st[i] = i < T ? stats[sb + i] : 0.f;
    pair_delta_v<E, DH>(dsrc, out + out_off<DH>(b, h, T, H), DH, dl, delta_g + sb, T, Tp);
    __syncthreads();  // statistics and delta are read below before the first tile's barrier

    for (int qt = 0; qt < ntl; ++qt) {
      const int buf = qt & 1;
      if (qt > 0) __syncthreads();
      if (qt + 1 < ntl) {
        issue_tile_v<E, DH>(sQ + (buf ^ 1) * TB, qsrc, (qt + 1) * TILE, T, DH);
        issue_tile_v<E, DH>(sdO + (buf ^ 1) * TB, dsrc, (qt + 1) * TILE, T, DH);
      }
      cp_commit();
      if (qt > 0) {
        cp_wait<1>();
        fence_async();
        __syncthreads();
      }
      const int row[2] = {qt * TILE + warp * 16 + g, qt * TILE + warp * 16 + g + 8};
      const float strow[2] = {st[row[0]], st[row[1]]}, dlrow[2] = {dl[row[0]], dl[row[1]]};
      float dq[NP][L::NA];
      zero_t(dq);
      for (int kt = 0; kt < ntl; ++kt) {
        if (qt == 0) {
          cp_wait_dyn(ntl - kt);
          fence_async();
          __syncthreads();
        }
        float s[32], dp[32];
        wg_fence();
        product_ss_v<E, DH>(s, sQ + buf * TB, sK + kt * TB);
        product_ss_v<E, DH>(dp, sdO + buf * TB, sV + kt * TB);
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
            const float p = exp2f(s[4 * nt + e] * c1 + kb[j + (e & 1)] - strow[r]);
            float d = dp[4 * nt + e];
            if (dropout) d = ((bits >> e) & 1u) ? d * inv : 0.f;
            s[4 * nt + e] = p * (d - dlrow[r]);  // dS (the scale goes on dQ)
          }
        }
        uint32_t sa[4][4];
        to_a_v<E>(sa, s);
        wg_fence();
        product_rs_v<E, DH>(dq, sa, sK + kt * TB);
        wg_commit();
        wg_wait();
        reg_fence_t(dq);
        reg_fence(sa);
      }

      store_rows_v<E, DH>(dqkv + in_off<DH>(b, h, T, H), dq, sc, row[0], row[1], row[0] < T, row[1] < T, DH, tq);
    }
  }
}

// --------------------------------------------------- backward: dK, dV pass

// The same tiles and row arrays as the dQ pass, arranged the other way.
template <int DH>
size_t dkv_bytes(int T) { return dq_bytes<DH>(T); }

template <typename E, int DH, bool FIXED>
__global__ void __launch_bounds__(NT)
hm_dkv_kernel(const E* __restrict__ qkv, const float* __restrict__ key_bias, const E* __restrict__ dout,
              const float* __restrict__ stats, const float* __restrict__ delta_g, E* __restrict__ dqkv, int T,
              int H, int hg, uint32_t seed, uint32_t thr, float inv, int dropout, float scale) {
  using L = Tile<DH>;
  constexpr int TB = L::BYTES, NP = L::NP;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = align_smem(smem_raw);
  const int Tp = round_up(T, TILE), ntl = Tp / TILE;
  unsigned char* Ks = sm;                          // [2][TILE] key tiles
  unsigned char* Vs = Ks + 2 * TB;                 // [2][TILE]
  unsigned char* Qs = Vs + 2 * TB;                 // [Tp] all queries
  unsigned char* dOs = Qs + (size_t)Tp * L::ROWB;  // [Tp]
  float* kb = reinterpret_cast<float*>(dOs + (size_t)Tp * L::ROWB);  // [Tp]
  float* st = kb + Tp;                             // [Tp]; padded queries +inf: p = 0
  float* dl = st + Tp;                             // [Tp]
  const uint32_t sK = smem_addr(Ks), sV = smem_addr(Vs), sQ = smem_addr(Qs), sdO = smem_addr(dOs);

  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3, par = g & 1;
  const float sc = scale_of<DH, FIXED>(scale), c1 = sc * LOG2E;
  load_key_bias(kb, key_bias + (size_t)b * T, T, Tp);

  for (int h = blockIdx.x * hg; h < (blockIdx.x + 1) * hg; ++h) {
    const E *qsrc = qkv + in_off<DH>(b, h, T, H), *ksrc = qsrc + kv_step<DH>(T, H), *vsrc = ksrc + kv_step<DH>(T, H);
    const E* dsrc = dout + out_off<DH>(b, h, T, H);
    const uint32_t bh = (uint32_t)(b * H + h);
    const size_t sb = (size_t)bh * T;
    __syncthreads();
    issue_tile_v<E, DH>(sK, ksrc, 0, T, DH);
    issue_tile_v<E, DH>(sV, vsrc, 0, T, DH);
    cp_commit();
    for (int qc = 0; qc < ntl; ++qc) {
      issue_tile_v<E, DH>(sQ + qc * TB, qsrc, qc * TILE, T, DH);
      issue_tile_v<E, DH>(sdO + qc * TB, dsrc, qc * TILE, T, DH);
      cp_commit();
    }
    for (int i = threadIdx.x; i < Tp; i += NT) {
      st[i] = i < T ? stats[sb + i] : INFINITY;
      dl[i] = i < T ? delta_g[sb + i] : 0.f;
    }

    for (int kt = 0; kt < ntl; ++kt) {
      const int buf = kt & 1;
      if (kt > 0) __syncthreads();
      if (kt + 1 < ntl) {
        issue_tile_v<E, DH>(sK + (buf ^ 1) * TB, ksrc, (kt + 1) * TILE, T, DH);
        issue_tile_v<E, DH>(sV + (buf ^ 1) * TB, vsrc, (kt + 1) * TILE, T, DH);
      }
      cp_commit();
      if (kt > 0) {
        cp_wait<1>();
        fence_async();
        __syncthreads();
      }
      const int key[2] = {kt * TILE + warp * 16 + g, kt * TILE + warp * 16 + g + 8};
      const float kbr[2] = {kb[key[0]], kb[key[1]]};
      float dk[NP][L::NA], dv[NP][L::NA];
      zero_t(dk);
      zero_t(dv);

      for (int qc = 0; qc < ntl; ++qc) {
        if (kt == 0) {
          cp_wait_dyn(ntl - qc);
          fence_async();
          __syncthreads();
        }
        // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries
        float s[32], dp[32];
        wg_fence();
        product_ss_v<E, DH>(s, sK + buf * TB, sQ + qc * TB);
        product_ss_v<E, DH>(dp, sV + buf * TB, sdO + qc * TB);
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
            const float p = exp2f(s[4 * nt + e] * c1 + kbr[e >> 1] - st[i]);
            float pd = p, d = dp[4 * nt + e];
            if (dropout) {
              const bool keep = (bits >> e) & 1u;
              pd = keep ? p * inv : 0.f;
              d = keep ? d * inv : 0.f;
            }
            s[4 * nt + e] = pd;
            dp[4 * nt + e] = p * (d - dl[i]);
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
      }

      const bool ok0 = key[0] < T, ok1 = key[1] < T;
      E* dst = dqkv + in_off<DH>(b, h, T, H) + kv_step<DH>(T, H);
      store_rows_v<E, DH>(dst, dk, sc, key[0], key[1], ok0, ok1, DH, tq);
      store_rows_v<E, DH>(dst + kv_step<DH>(T, H), dv, 1.f, key[0], key[1], ok0, ok1, DH, tq);
    }
  }
}

// ---------------------------------------------------------------- launches

template <typename E, int DH, bool FIXED>
const void* kernel_of(int which) {
  switch (which) {
    case 0: return (const void*)hm_fwd_kernel<E, DH, FIXED>;
    case 1: return (const void*)hm_dq_kernel<E, DH, FIXED>;
    case 2: return (const void*)hm_dkv_kernel<E, DH, FIXED>;
    default: return nullptr;
  }
}

template <int DH>
size_t bytes_of(int which, int T) {
  return which == 0 ? fwd_bytes<DH>(T) : which == 1 ? dq_bytes<DH>(T) : dkv_bytes<DH>(T);
}

template <int DH>
size_t smem_bytes(int T) {
  size_t m = bytes_of<DH>(0, T);
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

template <typename E, int DH, bool FIXED>
int launch_fwd(const void* qkv, const void* key_bias, void* out, void* stats, int B, int T, int H, int hg,
               unsigned int seed, unsigned int threshold, float inv, int dropout, float scale, cudaStream_t s) {
  if (hg <= 0 || H % hg) return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare<E, DH, FIXED>(0, T);
  if (err != cudaSuccess) return (int)err;
  hm_fwd_kernel<E, DH, FIXED><<<dim3(H / hg, B), NT, fwd_bytes<DH>(T), s>>>(
      static_cast<const E*>(qkv), static_cast<const float*>(key_bias), static_cast<E*>(out),
      static_cast<float*>(stats), T, H, hg, seed, threshold, inv, dropout, scale);
  return (int)cudaGetLastError();
}

template <typename E, int DH, bool FIXED>
int launch_bwd(const void* qkv, const void* key_bias, const void* dout, const void* out, const void* stats,
               void* dqkv, void* delta, int B, int T, int H, int hg_dq, int hg_dkv, unsigned int seed,
               unsigned int threshold, float inv, int dropout, float scale, cudaStream_t s) {
  if (hg_dq <= 0 || H % hg_dq || hg_dkv <= 0 || H % hg_dkv) return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare<E, DH, FIXED>(1, T);
  if (err != cudaSuccess) return (int)err;
  err = prepare<E, DH, FIXED>(2, T);
  if (err != cudaSuccess) return (int)err;
  hm_dq_kernel<E, DH, FIXED><<<dim3(H / hg_dq, B), NT, dq_bytes<DH>(T), s>>>(
      static_cast<const E*>(qkv), static_cast<const float*>(key_bias), static_cast<const E*>(dout),
      static_cast<const E*>(out), static_cast<const float*>(stats), static_cast<E*>(dqkv),
      static_cast<float*>(delta), T, H, hg_dq, seed, threshold, inv, dropout, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  hm_dkv_kernel<E, DH, FIXED><<<dim3(H / hg_dkv, B), NT, dkv_bytes<DH>(T), s>>>(
      static_cast<const E*>(qkv), static_cast<const float*>(key_bias), static_cast<const E*>(dout),
      static_cast<const float*>(stats), static_cast<const float*>(delta), static_cast<E*>(dqkv), T, H, hg_dkv,
      seed, threshold, inv, dropout, scale);
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
extern "C" size_t vb_attn_hm_smem_bytes(int T) { return smem_bytes<64>(T); }

// Kernel `which` (0 forward, 1 dQ pass, 2 dK/dV pass) of bf16 at D = 64:
// `what` 0 its registers a thread, 1 its local (spill) bytes a thread, 2
// its dynamic shared memory at T, 3 its resident blocks per SM at T. -1 on
// an error.
extern "C" int vb_attn_hm_info(int which, int what, int T) {
  return kernel_info(kernel_of<bf16, 64, true>(which), bytes_of<64>(which, T), what);
}

// The bf16, D = 64 entry points (scale 1 / 8, a constant of the kernels);
// tools that build an earlier tree's source launch them with these
// signatures.
extern "C" int vb_attn_hm_fwd(const void* qkv, const void* key_bias, void* out, void* stats, int B, int T, int H,
                              int hg, unsigned int seed, unsigned int threshold, float inv, int dropout,
                              void* stream) {
  return launch_fwd<bf16, 64, true>(qkv, key_bias, out, stats, B, T, H, hg, seed, threshold, inv, dropout, 0.125f,
                                    static_cast<cudaStream_t>(stream));
}

// delta [B, H, T] fp32 is scratch the caller allocates; hg_dq and hg_dkv
// are the two passes' heads a block.
extern "C" int vb_attn_hm_bwd(const void* qkv, const void* key_bias, const void* dout, const void* out,
                              const void* stats, void* dqkv, void* delta, int B, int T, int H, int hg_dq, int hg_dkv,
                              unsigned int seed, unsigned int threshold, float inv, int dropout, void* stream) {
  return launch_bwd<bf16, 64, true>(qkv, key_bias, dout, out, stats, dqkv, delta, B, T, H, hg_dq, hg_dkv, seed,
                                    threshold, inv, dropout, 0.125f, static_cast<cudaStream_t>(stream));
}

// Every other form: dtype 0 bf16, 1 fp16; dh the kernel's head dim, 16, 32,
// 64 or 128 (the caller zero-pads the heads to it); scale the softmax scale
// of the unpadded head dim. The largest dynamic shared memory of the three
// kernels at dh and T (0 for a dh not built).
extern "C" size_t vb_attn_hm_x_smem_bytes(int dh, int T) {
  switch (dh) {
    case 16: return smem_bytes<16>(T);
    case 32: return smem_bytes<32>(T);
    case 64: return smem_bytes<64>(T);
    case 128: return smem_bytes<128>(T);
    default: return 0;
  }
}

extern "C" int vb_attn_hm_x_info(int dtype, int dh, int which, int what, int T) {
  const int f = attn_form(dtype, dh);
  if (f < 0) return -1;
  return kernel_info(kernel_of_form(f, which), bytes_at(dh, which, T), what);
}

extern "C" int vb_attn_hm_x_fwd(const void* qkv, const void* key_bias, void* out, void* stats, int B, int T, int H,
                                int hg, unsigned int seed, unsigned int threshold, float inv, int dropout, int dtype,
                                int dh, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VB_FWD(E, D) \
  launch_fwd<E, D, false>(qkv, key_bias, out, stats, B, T, H, hg, seed, threshold, inv, dropout, scale, s)
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

extern "C" int vb_attn_hm_x_bwd(const void* qkv, const void* key_bias, const void* dout, const void* out,
                                const void* stats, void* dqkv, void* delta, int B, int T, int H, int hg_dq,
                                int hg_dkv, unsigned int seed, unsigned int threshold, float inv, int dropout,
                                int dtype, int dh, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VB_BWD(E, D)                                                                                              \
  launch_bwd<E, D, false>(qkv, key_bias, dout, out, stats, dqkv, delta, B, T, H, hg_dq, hg_dkv, seed, threshold, \
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
