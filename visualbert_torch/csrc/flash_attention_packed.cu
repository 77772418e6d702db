// K1/K2, redesigned for Hopper: packed-QKV attention forward and backward.
// Replace visualbert_tpu/ops/flash_attention.py::_packed_fwd_kernel (:249)
// and ::_packed_bwd_kernel (:307), reached through flash_attention_packed.
//
// Function (as flash_attention.cu's first design computed it): qkv [B, T,
// H*3*D] bf16 packed head-major WITHOUT the QKV projection bias; qb [H*3*D]
// bf16 is that bias, added here once a tile lands in shared memory (bf16
// add, rounded as the JAX kernel's `qkv + qb`); key_bias [B, T] fp32 (0 or
// -10000). (bf16 and D = 64 stand for the element type and head dim of
// step 5 below.) The forward writes out [B, T, H*D] bf16 and the base-2 row
// statistic stats [B, H, T] fp32, stats = max_j t + log2 sum_j exp2(t - max)
// with t = (q.k) * scale * log2(e) + key_bias * log2(e). The backward writes
// dqkv [B, T, H*3*D] bf16, delta = rowsum(dO * O) [B, H, T] fp32 (scratch
// the dK/dV pass reads) and the QKV-bias gradient as fp32 partials db_part
// [B, H*3*D]: row b holds the column sums over batch row b of the stored
// (bf16-rounded) dqkv, written by exactly one block each; the caller sums
// the rows. Dropout keeps probability (b, h, i, j) by philox.cuh::
// attn_philox's bit, so the mask is bit for bit K3's twin's and the plain
// version's.
//
// Bound on the H100 at the main path's B=128, T=228, H=12, D=64: bytes
// (qkv, out, stats; the backward also dout, out, stats in and dqkv out) are
// 0.054 / 0.108 ms at 3.35 TB/s; the tensor products (2 forward, 4
// backward, 20.4 GFLOP each) 0.04 / 0.08 ms at 989 TFLOP/s. With dropout on,
// the Philox integer work is larger than either: one Philox4x32-10 call
// (~70 integer instructions) per 2x2 block of probabilities, 25 M calls over
// B*H*Tp^2/4 at Tp = 256, about 0.12 ms of the card's 32-bit multiply rate
// once, per pass that regenerates the mask.
//
// The design, step by step, against that bound:
// 1. Schedule. A block of 4 warps (one warpgroup) owns one batch row x hg
//    heads; for each (b, h) pair it loads K and V (Q and dO in the dK/dV
//    pass) into shared memory once, adds the deferred bias once, and walks
//    every 64-query tile (every 64-key tile in the dK/dV pass). The first
//    design reloaded them, bias and all, for every 64-query tile. hg is
//    chosen by the caller from (B, H, SMs, resident blocks per SM); the key
//    bias of the batch row is loaded once per block. The backward keeps two
//    passes and no atomics.
// 2. Philox once per 2x2 block. Rows i and i^1 of a fragment sit in lanes 4
//    apart: each lane computes one call, for the row pair its own row of
//    parity (lane / 4) & 1 belongs to, keeps its two bits and sends the
//    other row's two to its partner by __shfl_xor_sync(.., 4). Blocks of
//    positions past T are skipped (their probabilities are 0 or unstored).
// 3. Asynchronous loads. Tiles arrive by cp.async, 16 bytes a thread, into
//    shared memory in the 128-byte swizzle (a D = 64 bf16 row is one 128 B
//    swizzle row: no padding). Loads are committed a key tile at a time, so
//    the first product starts when the first tile lands; the next query tile
//    (key tile in the dK/dV pass) is prefetched while the current one
//    computes. Each thread adds the bias to the chunks it copied itself.
// 4. wgmma. The warpgroup's 64-row tiles are wgmma's m64: S = Q K^T, dP =
//    dO V^T (and S^T = K Q^T, dP^T = V dO^T) take both operands from shared
//    memory; O += P V, dQ += dS K, dV += P^T dO, dK += dS^T Q take P or dS
//    from registers (the accumulator layout converts in place) and the
//    other operand, transposed, from shared memory. No ldmatrix is needed:
//    wgmma reads shared memory itself. The accumulators take 64-128 fp32
//    registers a thread.
// The building blocks of steps 2-4 (swizzle, cp.async, wgmma, Philox
// sharing, the bias add, the epilogue) live in hopper_attn.cuh, which
// K11-K16 share.
// 5. Element types and head dims. The kernels are templates on the element
//    type E (bf16 or fp16: wgmma's .bf16 or .f16, the same shapes and
//    swizzle; probabilities and dS are rounded to E before their products,
//    as the JAX kernel's p.astype(x.dtype)) and the head dim DH (64 or 128:
//    a row is DH / 64 swizzled 128 B panels, every product loops over them,
//    and the accumulators of O, dQ, dK and dV are DH / 64 m64n64 tiles).
//    The wrapper zero-pads a head dim in (32, 64) to 64 and one in (64,
//    128) to 128 (ops/flash_attention.py::pad_heads; below 32, steps 6 and
//    8) and passes the softmax
//    scale 1 / sqrt(D) of the unpadded D: zero columns add nothing to QK^T
//    and give zero output columns, and the dropout bits are indexed by (b,
//    h, i, j), not by D. At DH = 128 K1's K/V row takes 512 B of shared
//    memory a pair, so its T is limited to about half of DH = 64's (the
//    wrapper checks vb_attn_packed_x_smem_bytes; K2 streams there, step 7).
//    fp32 has its own kernels
//    (flash_attention_f32.cu): wgmma's TF32 would not hold fp32's tolerance.
// 6. The backward at head dims 16 and 32 (bf16, fp16), unpadded. Padded to
//    64, most of the backward's product work multiplied zeros (S and dP 4
//    k-steps where D / 16 do, dQ, dK, dV m64n64 where m64nD does), its
//    K/V (Q/dO) rows took 128 B of shared memory where 2 D bytes do, and
//    the wrapper's pads of qkv, qb, dout and out and cuts of dqkv and dqb
//    cost about a fifth of the call. The two passes are the same bodies on
//    hopper_attn.cuh's small-row tiles (its *_t helpers call the *_s ones
//    at these DH): rows of 32 or 64 bytes in the 32 B or 64 B swizzle, S
//    and dP in D / 16
//    k-steps, dQ, dK and dV m64n16k16 or m64n32k16 with D / 2 accumulators a
//    thread; the wrapper pads a D below 16 to 16 and one in (16, 32) to 32.
//    Smaller rows and registers fit more blocks an SM, and the T limit
//    rises. The Philox draw of each pass (about 0.11 ms at the main path's
//    shapes) does not shrink with D. vb_attn_packed_x_probe runs one product
//    of each kind alone.
// 7. The backward at head dim 128 (bf16, fp16), streamed through two
//    warpgroups. Held as steps 1-5 hold it, a pair's K and V (Q and dO) took 2
//    Tp x 256 B of shared memory, about 200 KB at T = 228: one 4-warp block an
//    SM, one warpgroup alone to hide its wgmma waits, the exp2 and the Philox
//    draw, T capped at 256, and the dK/dV pass spilled at the 255-register
//    cap. Now a block owns 128 rows of one (batch row, head): the dK/dV pass's
//    128 keys with their K and V, the dQ pass's 128 queries with their Q and
//    dO, resident (each warpgroup biases its own 64 rows once they land),
//    while the other operand's 64-row tiles (Q and dO with their stats and
//    delta; K and V with their key bias) stream through a SB_STAGES-stage ring
//    of TMA copies (3-D tensor maps [B, T, width], so rows past T land as
//    zeros). Each streamed tile serves two warpgroups' rows, and shared memory
//    no longer grows with T (no T limit; K1's forward bounds the path). Both
//    warpgroups bias a landed Q (K, V) tile, half each, and meet at the block
//    barrier before any wgmma reads it; right after it thread 0 refills the
//    stage every thread has left (the step before) with the step SB_STAGES on,
//    so the mbarriers need no empty side. Each warpgroup draws a step's keep
//    bits (step_keep_bits, Philox once per 2x2 block) between issuing its S
//    and dP products and waiting for them, so the integer work runs beside the
//    tensor cores, and while one warpgroup's products run the other does its
//    exp2. At T = 228 (4 steps) a block's fixed costs (its first copies, the
//    resident bias, the stores and column sums) are a large part of a pass
//    (tools/attn_streamed_steps.py splits them off); blocks that stayed on
//    their SM and walked several such items, their resident rows double-
//    buffered and so a ring of 2 stages, paid more a step and were no faster
//    at T = 228 and slower above it. Two warpgroups alone keep the
//    255-register cap: a block of more than 8 warps puts 3 warps on an SM sub-
//    partition, whose 16 K registers then allow 168 a thread, and ptxas
//    allocates to that cap whatever setmaxnreg asks later (with nvcc 12.9 a
//    producer warp or warpgroup with setmaxnreg left both passes spilling),
//    while the dK/dV pass's dK and dV (128 fp32 a thread), S^T and dP^T (64),
//    the two register operands and the keep bits take about 250: the streamed
//    tiles' bias chunks are read again each step (L1) rather than held. No
//    atomics: dQ, dK and dV rows are each written by one block, and the QKV-
//    bias gradient's partials are one row a (batch row, 128-row block),
//    db_part [B, cdiv(T, 128), H*3*D] (vb_attn_packed_x_bias_rows), which the
//    caller sums in a fixed order; Philox stays once per 2x2 block, key-major
//    in the dK/dV pass.
// 8. The forward at head dims 16 and 32 (bf16, fp16), unpadded, as step 6
//    made the backward. Padded to 64, K1 ran QK^T in 4 k-steps where D / 16
//    do, O += P_d V as m64n64 over zero columns where m64nD does, held K and
//    V rows of 128 B where 2 D bytes do, and the wrapper padded qkv and qb
//    and cut the output on every call. The body is the same one on the
//    small-row tiles: S = QK^T in D / 16 k-steps (64 keys wide whatever D,
//    so the softmax, Philox and P's register fragments do not change), O +=
//    P_d V m64n16k16 or m64n32k16 into D / 2 fp32 accumulators a thread.
//    Where it differs, and why:
//    - The online softmax. The body makes one pass over the keys and
//      rescales O by alpha = exp2(m_old - m_new) as each key tile raises a
//      row's max; at D = 64 that multiply rides in the loop over S's 8
//      n-tiles (O has 8 too), but at D / 2 accumulators O has D / 8, so
//      there it is a loop of its own over them (hopper_attn.cuh::rescale_s,
//      the row of element i being (i >> 1) & 1). Indexed by S's n-tiles it
//      would run past the array and land O in local memory: the card tests
//      and chip_smoke.py hold the forms' local bytes to 0.
//    - The epilogue stores D / 8 n-tiles a row, each row scaled by its own
//      inv / l (store_rows_s).
//    - The deferred bias: issue_tile_s and add_bias_s walk a tile's 32 B or
//      64 B rows in the same order (chunk idx % CH of row idx / CH, idx =
//      threadIdx.x + k * 128), and 128 is a multiple of CH, so the thread
//      that adds a chunk's bias (bias_chunk_t: chunk threadIdx.x % CH) is
//      the one whose cp.async copied it, and the first Q tile's add waits
//      on its own group as at D = 64 (the group order does not depend on D).
//    - Shared memory: 2 Tp (2 D) + 4 Tp bytes and two Q tiles, so T reaches
//      about 3,300 at D = 16 and 1,660 at D = 32; the backward's passes
//      (2880 / 1472) now bound the packed path at these head dims, and the
//      wrapper checks the largest of the three kernels' bytes. Fewer bytes
//      and registers also fit more blocks an SM, so head_group picks other
//      head groups than at D = 64.
// tools/attn_steps.py builds this source again with step 2 or step 3 left
// out (-DVB_PACKED_PHILOX_PER_ROW, -DVB_PACKED_SYNC_LOADS, switches of that
// header) and times each build beside this one; the library never defines
// either.
#include <cudaTypedefs.h>

#include "hopper_attn.cuh"

namespace {

using namespace vb_hopper;

// ---------------------------------------------------------------- forward

template <int DH>
size_t fwd_bytes(int T) {
  const int Tp = round_up(T, TILE);
  return ALIGN + 2 * Tile<DH>::BYTES + (size_t)2 * Tp * Tile<DH>::ROWB + Tp * sizeof(float);
}

// grid (H / hg, B): block (x, b) owns heads [x * hg, (x + 1) * hg) of row b.
template <typename E, int DH>
__global__ void __launch_bounds__(NT)
packed_fwd_kernel(const E* __restrict__ qkv, const E* __restrict__ qb, const float* __restrict__ key_bias,
                  E* __restrict__ out, float* __restrict__ stats, int T, int H, int hg, uint32_t seed,
                  uint32_t thr, float inv, int dropout, float scale) {
  using L = Tile<DH>;
  constexpr int TB = L::BYTES, NP = L::NP;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = align_smem(smem_raw);
  const int Tp = round_up(T, TILE), ntl = Tp / TILE;
  unsigned char* Qs = sm;                           // [2][TILE] query tiles
  unsigned char* Ks = Qs + 2 * TB;                  // [Tp] keys
  unsigned char* Vs = Ks + (size_t)Tp * L::ROWB;    // [Tp] values
  float* kb = reinterpret_cast<float*>(Vs + (size_t)Tp * L::ROWB);  // [Tp] key bias * log2(e)
  const uint32_t sQ = smem_addr(Qs), sK = smem_addr(Ks), sV = smem_addr(Vs);

  const int b = blockIdx.y, F = 3 * H * DH, ldo = H * DH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3, par = g & 1;
  const float c1 = scale * LOG2E;
  const E* base = qkv + (size_t)b * T * F;
  load_key_bias(kb, key_bias + (size_t)b * T, T, Tp);

  for (int h = blockIdx.x * hg; h < (blockIdx.x + 1) * hg; ++h) {
    const E *qsrc = base + 3 * h * DH, *ksrc = qsrc + DH, *vsrc = qsrc + 2 * DH;
    const uint4 bq = bias_chunk_t<E, DH>(qb, h, 0), bk = bias_chunk_t<E, DH>(qb, h, 1),
                bv = bias_chunk_t<E, DH>(qb, h, 2);
    const uint32_t bh = (uint32_t)(b * H + h);
    __syncthreads();  // no warp still reads the last pair's tiles
    issue_tile_t<E, DH>(sQ, qsrc, 0, T, F);
    cp_commit();
    for (int kt = 0; kt < ntl; ++kt) {
      issue_tile_t<E, DH>(sK + kt * TB, ksrc, kt * TILE, T, F);
      issue_tile_t<E, DH>(sV + kt * TB, vsrc, kt * TILE, T, F);
      cp_commit();
    }

    for (int qt = 0; qt < ntl; ++qt) {
      const int buf = qt & 1;
      if (qt > 0) __syncthreads();  // every warp is done with the buffer the prefetch overwrites
      if (qt + 1 < ntl) issue_tile_t<E, DH>(sQ + (buf ^ 1) * TB, qsrc, (qt + 1) * TILE, T, F);
      cp_commit();
      if (qt > 0) {
        cp_wait<1>();
        add_bias_t<E, DH>(Qs + buf * TB, bq, qt * TILE, T);
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
          if (kt == 0) add_bias_t<E, DH>(Qs, bq, 0, T);
          add_bias_t<E, DH>(Ks + kt * TB, bk, kt * TILE, T);
          add_bias_t<E, DH>(Vs + kt * TB, bv, kt * TILE, T);
          fence_async();
          __syncthreads();
        }
        float s[32];
        wg_fence();
        product_ss_t<E, DH>(s, sQ + buf * TB, sK + kt * TB);
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
        to_a_t<E>(pa, s);
        wg_fence();
        product_rs_t<E, DH>(o, pa, sV + kt * TB);
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
      E* ob = out + (size_t)b * T * ldo + h * DH;
      if constexpr (L::SMALL) {
        store_rows_s<E, DH>(ob, o[0], sc, row[0], row[1], ok[0], ok[1], ldo, tq);
      } else {
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const int c = p * 64 + nt * 8 + 2 * tq;
            if (ok[0])
              *reinterpret_cast<uint32_t*>(ob + (size_t)row[0] * ldo + c) =
                  vb::Elem<E>::pack(o[p][4 * nt] * sc[0], o[p][4 * nt + 1] * sc[0]);
            if (ok[1])
              *reinterpret_cast<uint32_t*>(ob + (size_t)row[1] * ldo + c) =
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
  return ALIGN + 4 * Tile<DH>::BYTES + (size_t)2 * Tp * Tile<DH>::ROWB + (3 * Tp + 4 * DH) * sizeof(float);
}

template <typename E, int DH>
__global__ void __launch_bounds__(NT)
packed_dq_kernel(const E* __restrict__ qkv, const E* __restrict__ qb, const float* __restrict__ key_bias,
                 const E* __restrict__ dout, const E* __restrict__ out, const float* __restrict__ stats,
                 E* __restrict__ dqkv, float* __restrict__ db_part, float* __restrict__ delta_g, int T, int H,
                 int hg, uint32_t seed, uint32_t thr, float inv, int dropout, float scale) {
  using L = Tile<DH>;
  constexpr int TB = L::BYTES, NP = L::NP, NA = L::NA;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = align_smem(smem_raw);
  const int Tp = round_up(T, TILE), ntl = Tp / TILE;
  unsigned char* Qs = sm;                           // [2][TILE]
  unsigned char* dOs = Qs + 2 * TB;                 // [2][TILE]
  unsigned char* Ks = dOs + 2 * TB;                 // [Tp]
  unsigned char* Vs = Ks + (size_t)Tp * L::ROWB;    // [Tp]
  float* kb = reinterpret_cast<float*>(Vs + (size_t)Tp * L::ROWB);  // [Tp]
  float* st = kb + Tp;                              // [Tp] stats of the pair's rows
  float* dl = st + Tp;                              // [Tp] delta of the pair's rows
  float* red = dl + Tp;                             // [4][DH] dq column sums
  const uint32_t sQ = smem_addr(Qs), sdO = smem_addr(dOs), sK = smem_addr(Ks), sV = smem_addr(Vs);

  const int b = blockIdx.y, F = 3 * H * DH, ldo = H * DH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3, par = g & 1;
  const float c1 = scale * LOG2E;
  const E* base = qkv + (size_t)b * T * F;
  load_key_bias(kb, key_bias + (size_t)b * T, T, Tp);

  for (int h = blockIdx.x * hg; h < (blockIdx.x + 1) * hg; ++h) {
    const E *qsrc = base + 3 * h * DH, *ksrc = qsrc + DH, *vsrc = qsrc + 2 * DH;
    const E* dsrc = dout + (size_t)b * T * ldo + h * DH;
    const uint4 bq = bias_chunk_t<E, DH>(qb, h, 0), bk = bias_chunk_t<E, DH>(qb, h, 1),
                bv = bias_chunk_t<E, DH>(qb, h, 2);
    const uint32_t bh = (uint32_t)(b * H + h);
    const size_t sb = (size_t)bh * T;
    __syncthreads();  // no warp still reads the last pair's tiles, statistics or sums
    issue_tile_t<E, DH>(sQ, qsrc, 0, T, F);
    issue_tile_t<E, DH>(sdO, dsrc, 0, T, ldo);
    cp_commit();
    for (int kt = 0; kt < ntl; ++kt) {
      issue_tile_t<E, DH>(sK + kt * TB, ksrc, kt * TILE, T, F);
      issue_tile_t<E, DH>(sV + kt * TB, vsrc, kt * TILE, T, F);
      cp_commit();
    }
    // while the tiles land: the pair's statistics and delta
    for (int i = threadIdx.x; i < Tp; i += NT) st[i] = i < T ? stats[sb + i] : 0.f;
    pair_delta_t<E, DH>(dsrc, out + (size_t)b * T * ldo + h * DH, ldo, dl, delta_g + sb, T, Tp);
    for (int i = threadIdx.x; i < 4 * DH; i += NT) red[i] = 0.f;
    __syncthreads();  // statistics and delta are read below before the first tile's barrier

    for (int qt = 0; qt < ntl; ++qt) {
      const int buf = qt & 1;
      if (qt > 0) __syncthreads();
      if (qt + 1 < ntl) {
        issue_tile_t<E, DH>(sQ + (buf ^ 1) * TB, qsrc, (qt + 1) * TILE, T, F);
        issue_tile_t<E, DH>(sdO + (buf ^ 1) * TB, dsrc, (qt + 1) * TILE, T, ldo);
      }
      cp_commit();
      if (qt > 0) {
        cp_wait<1>();
        add_bias_t<E, DH>(Qs + buf * TB, bq, qt * TILE, T);
        fence_async();
        __syncthreads();
      }
      const int row[2] = {qt * TILE + warp * 16 + g, qt * TILE + warp * 16 + g + 8};
      const float strow[2] = {st[row[0]], st[row[1]]}, dlrow[2] = {dl[row[0]], dl[row[1]]};
      float dq[NP][NA];
      zero_t(dq);
      for (int kt = 0; kt < ntl; ++kt) {
        if (qt == 0) {
          cp_wait_dyn(ntl - kt);
          if (kt == 0) add_bias_t<E, DH>(Qs, bq, 0, T);
          add_bias_t<E, DH>(Ks + kt * TB, bk, kt * TILE, T);
          add_bias_t<E, DH>(Vs + kt * TB, bv, kt * TILE, T);
          fence_async();
          __syncthreads();
        }
        float s[32], dp[32];
        wg_fence();
        product_ss_t<E, DH>(s, sQ + buf * TB, sK + kt * TB);
        product_ss_t<E, DH>(dp, sdO + buf * TB, sV + kt * TB);
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
        to_a_t<E>(sa, s);
        wg_fence();
        product_rs_t<E, DH>(dq, sa, sK + kt * TB);
        wg_commit();
        wg_wait();
        reg_fence_t(dq);
        reg_fence(sa);
      }

      const bool ok0 = row[0] < T, ok1 = row[1] < T;
      store_rows_t<E, DH>(dqkv + (size_t)b * T * F + 3 * h * DH, dq, scale, row[0], row[1], ok0, ok1, F, tq);
      colsum_add_t<E, DH>(dq, scale, ok0, ok1, red, warp, g, tq);
    }
    __syncthreads();
    if (threadIdx.x < DH) {
      const int c = threadIdx.x;
      db_part[(size_t)b * F + 3 * h * DH + c] = red[c] + red[DH + c] + red[2 * DH + c] + red[3 * DH + c];
    }
  }
}

// --------------------------------------------------- backward: dK, dV pass

template <int DH>
size_t dkv_bytes(int T) {
  const int Tp = round_up(T, TILE);
  return ALIGN + 4 * Tile<DH>::BYTES + (size_t)2 * Tp * Tile<DH>::ROWB + (3 * Tp + 8 * DH) * sizeof(float);
}

template <typename E, int DH>
__global__ void __launch_bounds__(NT)
packed_dkv_kernel(const E* __restrict__ qkv, const E* __restrict__ qb, const float* __restrict__ key_bias,
                  const E* __restrict__ dout, const float* __restrict__ stats, const float* __restrict__ delta_g,
                  E* __restrict__ dqkv, float* __restrict__ db_part, int T, int H, int hg, uint32_t seed,
                  uint32_t thr, float inv, int dropout, float scale) {
  using L = Tile<DH>;
  constexpr int TB = L::BYTES, NP = L::NP, NA = L::NA;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = align_smem(smem_raw);
  const int Tp = round_up(T, TILE), ntl = Tp / TILE;
  unsigned char* Ks = sm;                           // [2][TILE] key tiles
  unsigned char* Vs = Ks + 2 * TB;                  // [2][TILE]
  unsigned char* Qs = Vs + 2 * TB;                  // [Tp] all queries
  unsigned char* dOs = Qs + (size_t)Tp * L::ROWB;   // [Tp]
  float* kb = reinterpret_cast<float*>(dOs + (size_t)Tp * L::ROWB);  // [Tp]
  float* st = kb + Tp;                              // [Tp]; padded queries +inf: p = 0
  float* dl = st + Tp;                              // [Tp]
  float* redk = dl + Tp;                            // [4][DH]
  float* redv = redk + 4 * DH;                      // [4][DH]
  const uint32_t sK = smem_addr(Ks), sV = smem_addr(Vs), sQ = smem_addr(Qs), sdO = smem_addr(dOs);

  const int b = blockIdx.y, F = 3 * H * DH, ldo = H * DH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3, par = g & 1;
  const float c1 = scale * LOG2E;
  const E* base = qkv + (size_t)b * T * F;
  load_key_bias(kb, key_bias + (size_t)b * T, T, Tp);

  for (int h = blockIdx.x * hg; h < (blockIdx.x + 1) * hg; ++h) {
    const E *qsrc = base + 3 * h * DH, *ksrc = qsrc + DH, *vsrc = qsrc + 2 * DH;
    const E* dsrc = dout + (size_t)b * T * ldo + h * DH;
    const uint4 bq = bias_chunk_t<E, DH>(qb, h, 0), bk = bias_chunk_t<E, DH>(qb, h, 1),
                bv = bias_chunk_t<E, DH>(qb, h, 2);
    const uint32_t bh = (uint32_t)(b * H + h);
    const size_t sb = (size_t)bh * T;
    __syncthreads();
    issue_tile_t<E, DH>(sK, ksrc, 0, T, F);
    issue_tile_t<E, DH>(sV, vsrc, 0, T, F);
    cp_commit();
    for (int qc = 0; qc < ntl; ++qc) {
      issue_tile_t<E, DH>(sQ + qc * TB, qsrc, qc * TILE, T, F);
      issue_tile_t<E, DH>(sdO + qc * TB, dsrc, qc * TILE, T, ldo);
      cp_commit();
    }
    for (int i = threadIdx.x; i < Tp; i += NT) {
      st[i] = i < T ? stats[sb + i] : INFINITY;
      dl[i] = i < T ? delta_g[sb + i] : 0.f;
    }
    for (int i = threadIdx.x; i < 4 * DH; i += NT) redk[i] = redv[i] = 0.f;

    for (int kt = 0; kt < ntl; ++kt) {
      const int buf = kt & 1;
      if (kt > 0) __syncthreads();
      if (kt + 1 < ntl) {
        issue_tile_t<E, DH>(sK + (buf ^ 1) * TB, ksrc, (kt + 1) * TILE, T, F);
        issue_tile_t<E, DH>(sV + (buf ^ 1) * TB, vsrc, (kt + 1) * TILE, T, F);
      }
      cp_commit();
      if (kt > 0) {
        cp_wait<1>();
        add_bias_t<E, DH>(Ks + buf * TB, bk, kt * TILE, T);
        add_bias_t<E, DH>(Vs + buf * TB, bv, kt * TILE, T);
        fence_async();
        __syncthreads();
      }
      const int key[2] = {kt * TILE + warp * 16 + g, kt * TILE + warp * 16 + g + 8};
      const float kbr[2] = {kb[key[0]], kb[key[1]]};
      float dk[NP][NA], dv[NP][NA];
      zero_t(dk);
      zero_t(dv);

      for (int qc = 0; qc < ntl; ++qc) {
        if (kt == 0) {
          cp_wait_dyn(ntl - qc);
          if (qc == 0) {
            add_bias_t<E, DH>(Ks, bk, 0, T);
            add_bias_t<E, DH>(Vs, bv, 0, T);
          }
          add_bias_t<E, DH>(Qs + qc * TB, bq, qc * TILE, T);
          fence_async();
          __syncthreads();
        }
        // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries
        float s[32], dp[32];
        wg_fence();
        product_ss_t<E, DH>(s, sK + buf * TB, sQ + qc * TB);
        product_ss_t<E, DH>(dp, sV + buf * TB, sdO + qc * TB);
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
        to_a_t<E>(pa, s);
        to_a_t<E>(sa, dp);
        wg_fence();
        product_rs_t<E, DH>(dv, pa, sdO + qc * TB);
        product_rs_t<E, DH>(dk, sa, sQ + qc * TB);
        wg_commit();
        wg_wait();
        reg_fence_t(dv);
        reg_fence_t(dk);
        reg_fence(pa);
        reg_fence(sa);
      }

      const bool ok0 = key[0] < T, ok1 = key[1] < T;
      E* dst = dqkv + (size_t)b * T * F + 3 * h * DH;
      store_rows_t<E, DH>(dst + DH, dk, scale, key[0], key[1], ok0, ok1, F, tq);
      store_rows_t<E, DH>(dst + 2 * DH, dv, 1.f, key[0], key[1], ok0, ok1, F, tq);
      colsum_add_t<E, DH>(dk, scale, ok0, ok1, redk, warp, g, tq);
      colsum_add_t<E, DH>(dv, 1.f, ok0, ok1, redv, warp, g, tq);
    }
    __syncthreads();
    if (threadIdx.x < DH) {
      const int c = threadIdx.x;
      float* part = db_part + (size_t)b * F;
      part[(3 * h + 1) * DH + c] = redk[c] + redk[DH + c] + redk[2 * DH + c] + redk[3 * DH + c];
      part[(3 * h + 2) * DH + c] = redv[c] + redv[DH + c] + redv[2 * DH + c] + redv[3 * DH + c];
    }
  }
}

// ------------------------------------ backward at DH = 128: streamed (step 7)

constexpr int SB_DH = 128;                  // the streamed form's head dim
constexpr int SB_ROWS = 2 * TILE;           // a block's own rows: a 64-row tile a warpgroup
constexpr int SB_STAGES = 4;                // ring stages of streamed tiles
constexpr int SB_THREADS = 2 * NT;          // two warpgroups; thread 0 also issues the copies
constexpr int SB_TILE = Tile<SB_DH>::BYTES;  // a 64-row tile: two 8 KB panels (TMA boxes)
constexpr int SB_STAGE = 2 * SB_TILE;       // a stage: two streamed tiles
constexpr int SB_RES = 4 * SB_TILE;         // the resident rows: two operands x two warpgroups' tiles
constexpr int SB_VEC = 2 * TILE;            // floats of a stage's row vectors (two of 64)
constexpr int SB_RED = 2 * 8 * SB_DH;       // floats of the column sums: two outputs x 8 warps
constexpr int SB_BARS = SB_STAGES + 1;      // a full mbarrier a stage, the resident rows'
constexpr size_t SB_BYTES =
    ALIGN + SB_RES + SB_STAGES * SB_STAGE + (SB_STAGES * SB_VEC + SB_RED) * sizeof(float) + SB_BARS * sizeof(uint64_t);
static_assert(SB_BYTES <= 232448, "a streamed block must fit the H100's 227 KB of shared memory");

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// The shared memory of a streamed block: the resident tiles (operand k of
// warpgroup w at res + (2 k + w) * SB_TILE), the ring (stage s at ring + s *
// SB_STAGE, its two tiles SB_TILE apart), the stages' row vectors, the
// column sums and the mbarriers (full s, resident: one arrival each, which
// expects the bytes that land).
struct StreamedSmem {
  unsigned char* res;
  unsigned char* ring;
  float* vec;
  float* red;
  uint32_t bars;
  __device__ explicit StreamedSmem(unsigned char* sm)
      : res(sm),
        ring(sm + SB_RES),
        vec(reinterpret_cast<float*>(sm + SB_RES + SB_STAGES * SB_STAGE)),
        red(vec + SB_STAGES * SB_VEC),
        bars(smem_addr(red + SB_RED)) {}
  __device__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ uint32_t resident() const { return bars + 8 * SB_STAGES; }
};

// The streamed operands of a pass: two maps and the first element of the
// head's block in each, and the two row vectors a stage carries.
template <typename V0, typename V1>
struct Stream {
  const void* map[2];
  int col[2];
  V0 v0;
  V1 v1;
};

template <typename V0, typename V1>
__device__ __forceinline__ Stream<V0, V1> make_stream(const void* m0, int c0, const void* m1, int c1, V0 v0, V1 v1) {
  return Stream<V0, V1>{{m0, m1}, {c0, c1}, v0, v1};
}

// Step n's copies into stage n % SB_STAGES (nothing past the last step),
// once no thread reads that stage any more: its row vectors by the block's
// first 64 threads (vec(s)[i] = v0(64 n + i), vec(s)[64 + i] = v1(64 n +
// i); read at step n, after at least one more block barrier), its two
// tiles by thread 0 (operand k: elements col[k] .. + 127 of map[k], rows 64
// n .. of matrix b), counted on full(s).
template <typename S>
__device__ __forceinline__ void load_step(const StreamedSmem& sm, int n, int ntl, int b, const S& st) {
  if (n >= ntl) return;
  const int s = n % SB_STAGES;
  if (threadIdx.x < TILE) {
    float* v = sm.vec + s * SB_VEC;
    v[threadIdx.x] = st.v0(n * TILE + (int)threadIdx.x);
    v[TILE + threadIdx.x] = st.v1(n * TILE + (int)threadIdx.x);
  }
  if (threadIdx.x == 0) {
    const uint32_t dst = smem_addr(sm.ring) + s * SB_STAGE;
    mbar_expect(sm.full(s), SB_STAGE);
    for (int k = 0; k < 2; ++k)
      for (int p = 0; p < 2; ++p)
        tma_load_3d(dst + k * SB_TILE + p * TILE_BYTES, st.map[k], st.col[k] + 64 * p, n * TILE, b, sm.full(s));
  }
}

// The block's first copies: thread 0 makes the mbarriers (every thread
// waits for that at the block barrier inside), then the resident tiles
// (operand k: elements rc[k] .. + 127 of map rm[k], rows r0 .. r0 + 127 of
// matrix b) and the first SB_STAGES steps.
template <typename S>
__device__ __forceinline__ void load_first(const StreamedSmem& sm, const void* const (&rm)[2], const int (&rc)[2],
                                           int r0, int b, int ntl, const S& st) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < SB_STAGES; ++s) mbar_init(sm.full(s), 1);
    mbar_init(sm.resident(), 1);
    mbar_init_fence();
  }
  __syncthreads();  // the mbarriers are ready
  if (threadIdx.x == 0) {
    const uint32_t res = smem_addr(sm.res);
    mbar_expect(sm.resident(), SB_RES);
    for (int k = 0; k < 2; ++k)
      for (int w = 0; w < 2; ++w)
        for (int p = 0; p < 2; ++p)
          tma_load_3d(res + (2 * k + w) * SB_TILE + p * TILE_BYTES, rm[k], rc[k] + 64 * p, r0 + TILE * w, b,
                      sm.resident());
  }
  for (int n = 0; n < SB_STAGES; ++n) load_step(sm, n, ntl, b, st);
}

// The dQ pass at DH = 128. grid (cdiv(T, 128), H, B): block (x, h, b) owns
// queries [128 x, 128 x + 128) of head h of batch row b, their Q (biased)
// and dO resident, and streams every 64-key K and V tile (biased by both
// warpgroups once it lands) with its key bias. Writes dQ, delta of its rows
// and the Q part of db_part's row (b, x).
template <typename E>
__global__ void __launch_bounds__(SB_THREADS, 1)
streamed_dq_kernel(const __grid_constant__ CUtensorMap mqkv, const __grid_constant__ CUtensorMap mdo,
                   const E* __restrict__ qb, const float* __restrict__ key_bias, const E* __restrict__ dout,
                   const E* __restrict__ out, const float* __restrict__ stats, E* __restrict__ dqkv,
                   float* __restrict__ db_part, float* __restrict__ delta_g, int T, int H, uint32_t seed,
                   uint32_t thr, float inv, int dropout, float scale) {
  constexpr int DH = SB_DH;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const StreamedSmem sm(align_smem(smem_raw));
  const int x = blockIdx.x, h = blockIdx.y, b = blockIdx.z, F = 3 * H * DH, ldo = H * DH, ntl = cdiv(T, TILE);
  const uint32_t bh = (uint32_t)(b * H + h);
  const float* kbg = key_bias + (size_t)b * T;
  // resident: Q (k = 0) and dO (k = 1); streamed: K and V with the key bias
  const auto st = make_stream(
      &mqkv, (3 * h + 1) * DH, &mqkv, (3 * h + 2) * DH,
      [=](int t) { return t < T ? kbg[t] * LOG2E : -INFINITY; }, [](int) { return 0.f; });
  {
    const void* const rm[2] = {&mqkv, &mdo};
    const int rc[2] = {3 * h * DH, h * DH};
    load_first(sm, rm, rc, x * SB_ROWS, b, ntl, st);
  }
  const int w = threadIdx.x / NT, tid = threadIdx.x & (NT - 1);
  const int warp = tid >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3, par = g & 1;
  const int row[2] = {x * SB_ROWS + w * TILE + warp * 16 + g, x * SB_ROWS + w * TILE + warp * 16 + g + 8};
  const bool ok[2] = {row[0] < T, row[1] < T};
  const float c1 = scale * LOG2E;
  float strow[2], dlrow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // delta = rowsum(dO * O): the row's 4 lanes take 32 columns each
    float acc = 0.f;
    if (ok[r]) {
      const size_t at = ((size_t)b * T + row[r]) * ldo + h * DH + 32 * tq;
      const uint4* pd = reinterpret_cast<const uint4*>(dout + at);
      const uint4* po = reinterpret_cast<const uint4*>(out + at);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint4 a = pd[k], c = po[k];
        const uint32_t* u = reinterpret_cast<const uint32_t*>(&a);
        const uint32_t* v = reinterpret_cast<const uint32_t*>(&c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 p = vb::Elem<E>::unpack(u[e]), q = vb::Elem<E>::unpack(v[e]);
          acc += p.x * q.x;
          acc += p.y * q.y;
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    dlrow[r] = acc;
    strow[r] = ok[r] ? stats[(size_t)bh * T + row[r]] : 0.f;
    if (ok[r] && tq == 0) delta_g[(size_t)bh * T + row[r]] = acc;
  }
  for (int i = threadIdx.x; i < 8 * DH; i += SB_THREADS) sm.red[i] = 0.f;
  const uint4 bq = bias_chunk_by(qb, h, 0, tid);
  unsigned char* qs = sm.res + w * SB_TILE;
  const uint32_t sQ = smem_addr(qs), sdO = smem_addr(sm.res + (2 + w) * SB_TILE);
  mbar_wait(sm.resident(), 0);
  add_bias_by<E>(qs, bq, x * SB_ROWS + w * TILE, T, tid, NT);  // this warpgroup's own Q rows

  float dq[2][32];
  zero_t(dq);
  for (int n = 0; n < ntl; ++n) {
    const int s = n % SB_STAGES;
    unsigned char* ks = sm.ring + s * SB_STAGE;
    const uint32_t sK = smem_addr(ks), sV = sK + SB_TILE;
    mbar_wait(sm.full(s), (n / SB_STAGES) & 1);
    add_bias_by<E>(ks, bias_chunk_by(qb, h, 1, threadIdx.x), n * TILE, T, threadIdx.x, SB_THREADS);
    add_bias_by<E>(ks + SB_TILE, bias_chunk_by(qb, h, 2, threadIdx.x), n * TILE, T, threadIdx.x, SB_THREADS);
    fence_async();
    __syncthreads();  // the tiles are biased; every thread is done with step n - 1's stage
    if (n > 0) load_step(sm, n - 1 + SB_STAGES, ntl, b, st);
    float sc[32], dp[32];
    wg_fence();
    product_ss_t<E, DH>(sc, sQ, sK);   // S = Q K^T
    product_ss_t<E, DH>(dp, sdO, sV);  // dP = dO V^T
    wg_commit();
    const uint32_t keep = dropout ? step_keep_bits<false>(seed, bh, row[0], row[1], n * TILE + 2 * tq, par, thr, T)
                                  : 0xFFFFFFFFu;  // while the products run
    wg_wait();
    reg_fence(sc);
    reg_fence(dp);
    const float* kb = sm.vec + s * SB_VEC;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int jl = nt * 8 + 2 * tq;
      const uint32_t bits = keep >> (4 * nt);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = exp2f(sc[4 * nt + e] * c1 + kb[jl + (e & 1)] - strow[r]);
        float d = dp[4 * nt + e];
        if (dropout) d = ((bits >> e) & 1u) ? d * inv : 0.f;
        sc[4 * nt + e] = p * (d - dlrow[r]);  // dS (the scale goes on dQ)
      }
    }
    uint32_t sa[4][4];
    to_a_t<E>(sa, sc);
    wg_fence();
    product_rs_t<E, DH>(dq, sa, sK);
    wg_commit();
    wg_wait();
    reg_fence_t(dq);
    reg_fence(sa);
  }
  store_rows_t<E, DH>(dqkv + (size_t)b * T * F + 3 * h * DH, dq, scale, row[0], row[1], ok[0], ok[1], F, tq);
  colsum_add_t<E, DH>(dq, scale, ok[0], ok[1], sm.red, threadIdx.x >> 5, g, tq);
  __syncthreads();
  if (threadIdx.x < DH) {
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) v += sm.red[k * DH + threadIdx.x];
    db_part[((size_t)b * gridDim.x + x) * F + 3 * h * DH + threadIdx.x] = v;
  }
}

// The dK/dV pass at DH = 128. grid (cdiv(T, 128), H, B): block (x, h, b)
// owns keys [128 x, 128 x + 128), their K and V resident (each warpgroup
// biases its own 64), and streams every 64-query Q tile (biased by both
// warpgroups once it lands) and dO tile with their stats and delta. Writes
// dK, dV of its keys and their parts of db_part's row (b, x).
template <typename E>
__global__ void __launch_bounds__(SB_THREADS, 1)
streamed_dkv_kernel(const __grid_constant__ CUtensorMap mqkv, const __grid_constant__ CUtensorMap mdo,
                    const E* __restrict__ qb, const float* __restrict__ key_bias, const float* __restrict__ stats,
                    const float* __restrict__ delta_g, E* __restrict__ dqkv, float* __restrict__ db_part, int T,
                    int H, uint32_t seed, uint32_t thr, float inv, int dropout, float scale) {
  constexpr int DH = SB_DH;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const StreamedSmem sm(align_smem(smem_raw));
  const int x = blockIdx.x, h = blockIdx.y, b = blockIdx.z, F = 3 * H * DH, ntl = cdiv(T, TILE);
  const uint32_t bh = (uint32_t)(b * H + h);
  const float *stg = stats + (size_t)bh * T, *dlg = delta_g + (size_t)bh * T;
  // resident: K (k = 0) and V (k = 1); streamed: Q and dO with their stats
  // and delta (padded queries: stats +inf, so p = 0, and delta 0)
  const auto st = make_stream(
      &mqkv, 3 * h * DH, &mdo, h * DH, [=](int t) { return t < T ? stg[t] : INFINITY; },
      [=](int t) { return t < T ? dlg[t] : 0.f; });
  {
    const void* const rm[2] = {&mqkv, &mqkv};
    const int rc[2] = {(3 * h + 1) * DH, (3 * h + 2) * DH};
    load_first(sm, rm, rc, x * SB_ROWS, b, ntl, st);
  }
  const int w = threadIdx.x / NT, tid = threadIdx.x & (NT - 1);
  const int warp = tid >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3, par = g & 1;
  const int key[2] = {x * SB_ROWS + w * TILE + warp * 16 + g, x * SB_ROWS + w * TILE + warp * 16 + g + 8};
  const bool ok[2] = {key[0] < T, key[1] < T};
  const float c1 = scale * LOG2E;
  const float kbr[2] = {ok[0] ? key_bias[(size_t)b * T + key[0]] * LOG2E : -INFINITY,
                        ok[1] ? key_bias[(size_t)b * T + key[1]] * LOG2E : -INFINITY};
  for (int i = threadIdx.x; i < 2 * 8 * DH; i += SB_THREADS) sm.red[i] = 0.f;
  const uint4 bk = bias_chunk_by(qb, h, 1, tid), bv = bias_chunk_by(qb, h, 2, tid);
  unsigned char *ks = sm.res + w * SB_TILE, *vs = sm.res + (2 + w) * SB_TILE;
  const uint32_t sK = smem_addr(ks), sV = smem_addr(vs);
  mbar_wait(sm.resident(), 0);
  add_bias_by<E>(ks, bk, x * SB_ROWS + w * TILE, T, tid, NT);  // this warpgroup's own K and V rows
  add_bias_by<E>(vs, bv, x * SB_ROWS + w * TILE, T, tid, NT);

  float dk[2][32], dv[2][32];
  zero_t(dk);
  zero_t(dv);
  for (int n = 0; n < ntl; ++n) {
    const int s = n % SB_STAGES;
    unsigned char* qs = sm.ring + s * SB_STAGE;
    const uint32_t sQ = smem_addr(qs), sdO = sQ + SB_TILE;
    mbar_wait(sm.full(s), (n / SB_STAGES) & 1);
    add_bias_by<E>(qs, bias_chunk_by(qb, h, 0, threadIdx.x), n * TILE, T, threadIdx.x, SB_THREADS);
    fence_async();
    __syncthreads();  // the Q tile is biased; every thread is done with step n - 1's stage
    if (n > 0) load_step(sm, n - 1 + SB_STAGES, ntl, b, st);
    // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries
    float sc[32], dp[32];
    wg_fence();
    product_ss_t<E, DH>(sc, sK, sQ);
    product_ss_t<E, DH>(dp, sV, sdO);
    wg_commit();
    const uint32_t keep = dropout ? step_keep_bits<true>(seed, bh, key[0], key[1], n * TILE + 2 * tq, par, thr, T)
                                  : 0xFFFFFFFFu;  // while the products run
    wg_wait();
    reg_fence(sc);
    reg_fence(dp);
    const float *stv = sm.vec + s * SB_VEC, *dl = stv + TILE;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int il = nt * 8 + 2 * tq;  // queries n * 64 + il, + 1
      const uint32_t bits = keep >> (4 * nt);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = il + (e & 1);
        const float p = exp2f(sc[4 * nt + e] * c1 + kbr[e >> 1] - stv[i]);
        float pd = p, d = dp[4 * nt + e];
        if (dropout) {
          const bool kept = (bits >> e) & 1u;
          pd = kept ? p * inv : 0.f;
          d = kept ? d * inv : 0.f;
        }
        sc[4 * nt + e] = pd;
        dp[4 * nt + e] = p * (d - dl[i]);
      }
    }
    uint32_t pa[4][4], sa[4][4];
    to_a_t<E>(pa, sc);
    to_a_t<E>(sa, dp);
    wg_fence();
    product_rs_t<E, DH>(dv, pa, sdO);
    product_rs_t<E, DH>(dk, sa, sQ);
    wg_commit();
    wg_wait();
    reg_fence_t(dv);
    reg_fence_t(dk);
    reg_fence(pa);
    reg_fence(sa);
  }
  E* dst = dqkv + (size_t)b * T * F + 3 * h * DH;
  store_rows_t<E, DH>(dst + DH, dk, scale, key[0], key[1], ok[0], ok[1], F, tq);
  store_rows_t<E, DH>(dst + 2 * DH, dv, 1.f, key[0], key[1], ok[0], ok[1], F, tq);
  colsum_add_t<E, DH>(dk, scale, ok[0], ok[1], sm.red, threadIdx.x >> 5, g, tq);
  colsum_add_t<E, DH>(dv, 1.f, ok[0], ok[1], sm.red + 8 * DH, threadIdx.x >> 5, g, tq);
  __syncthreads();
  const int k = threadIdx.x / DH, c = threadIdx.x % DH;  // k 0: dK's column c, 1: dV's
  float v = 0.f;
#pragma unroll
  for (int q = 0; q < 8; ++q) v += sm.red[(8 * k + q) * DH + c];
  db_part[((size_t)b * gridDim.x + x) * F + (3 * h + 1 + k) * DH + c] = v;
}

// libcuda's cuTensorMapEncodeTiled, looked up once; nullptr where the
// lookup fails.
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = [] {
    cudaDriverEntryPointQueryResult found;
    void* fn = nullptr;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      fn = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }();
  return encode;
}

// The TMA map of B matrices of T rows x `width` elements of E (rows `width`
// elements apart, matrices T rows apart): boxes of 64 elements (128 B,
// swizzled as swz lays them out) x 64 rows of one matrix, zeros past row T.
template <typename E>
cudaError_t rows_map(CUtensorMap* map, const void* ptr, int B, int T, int width) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)width * sizeof(E), (cuuint64_t)T * width * sizeof(E)};
  const cuuint32_t box[3] = {64, (cuuint32_t)TILE, 1}, steps[3] = {1, 1, 1};
  const CUresult r = encode(map, std::is_same<E, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                                                 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                            3, const_cast<void*>(ptr), dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename E>
int launch_streamed_bwd(const void* qkv, const void* qb, const void* key_bias, const void* dout, const void* out,
                        const void* stats, void* dqkv, void* db_part, void* delta, int B, int T, int H,
                        unsigned int seed, unsigned int threshold, float inv, int dropout, float scale,
                        cudaStream_t s) {
  const void* fns[2] = {(const void*)streamed_dq_kernel<E>, (const void*)streamed_dkv_kernel<E>};
  for (const void* fn : fns) {
    const cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SB_BYTES);
    if (err != cudaSuccess) return (int)err;
  }
  CUtensorMap mqkv, mdo;
  cudaError_t err = rows_map<E>(&mqkv, qkv, B, T, 3 * H * SB_DH);
  if (err == cudaSuccess) err = rows_map<E>(&mdo, dout, B, T, H * SB_DH);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(cdiv(T, SB_ROWS), H, B);
  streamed_dq_kernel<E><<<grid, SB_THREADS, SB_BYTES, s>>>(
      mqkv, mdo, static_cast<const E*>(qb), static_cast<const float*>(key_bias), static_cast<const E*>(dout),
      static_cast<const E*>(out), static_cast<const float*>(stats), static_cast<E*>(dqkv),
      static_cast<float*>(db_part), static_cast<float*>(delta), T, H, seed, threshold, inv, dropout, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  streamed_dkv_kernel<E><<<grid, SB_THREADS, SB_BYTES, s>>>(
      mqkv, mdo, static_cast<const E*>(qb), static_cast<const float*>(key_bias), static_cast<const float*>(stats),
      static_cast<const float*>(delta), static_cast<E*>(dqkv), static_cast<float*>(db_part), T, H, seed, threshold,
      inv, dropout, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- launches

// At 128 the backward's passes are the streamed kernels.
template <typename E, int DH>
const void* kernel_of(int which) {
  switch (which) {
    case 0: return (const void*)packed_fwd_kernel<E, DH>;
    case 1:
      if constexpr (DH == SB_DH)
        return (const void*)streamed_dq_kernel<E>;
      else
        return (const void*)packed_dq_kernel<E, DH>;
    case 2:
      if constexpr (DH == SB_DH)
        return (const void*)streamed_dkv_kernel<E>;
      else
        return (const void*)packed_dkv_kernel<E, DH>;
    default: return nullptr;
  }
}

template <int DH>
size_t bytes_of(int which, int T) {
  if (which == 0) return fwd_bytes<DH>(T);
  if constexpr (DH == SB_DH) return SB_BYTES;
  return which == 1 ? dq_bytes<DH>(T) : dkv_bytes<DH>(T);
}

// Threads a block of kernel `which` at DH.
template <int DH>
int threads_of(int which) {
  return DH == SB_DH && which > 0 ? SB_THREADS : NT;
}

template <int DH>
size_t smem_bytes(int T) {
  size_t m = bytes_of<DH>(0, T);
  if (bytes_of<DH>(1, T) > m) m = bytes_of<DH>(1, T);
  return bytes_of<DH>(2, T) > m ? bytes_of<DH>(2, T) : m;
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

int threads_at(int dh, int which) { return dh == SB_DH ? threads_of<SB_DH>(which) : NT; }

template <typename E, int DH>
cudaError_t prepare(int which, int T) {
  return cudaFuncSetAttribute(kernel_of<E, DH>(which), cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes_of<DH>(which, T));
}

template <typename E, int DH>
int launch_fwd(const void* qkv, const void* qb, const void* key_bias, void* out, void* stats, int B, int T, int H,
               int hg, unsigned int seed, unsigned int threshold, float inv, int dropout, float scale,
               cudaStream_t s) {
  if (hg <= 0 || H % hg) return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare<E, DH>(0, T);
  if (err != cudaSuccess) return (int)err;
  packed_fwd_kernel<E, DH><<<dim3(H / hg, B), NT, fwd_bytes<DH>(T), s>>>(
      static_cast<const E*>(qkv), static_cast<const E*>(qb), static_cast<const float*>(key_bias),
      static_cast<E*>(out), static_cast<float*>(stats), T, H, hg, seed, threshold, inv, dropout, scale);
  return (int)cudaGetLastError();
}

template <typename E, int DH>
int launch_bwd(const void* qkv, const void* qb, const void* key_bias, const void* dout, const void* out,
               const void* stats, void* dqkv, void* db_part, void* delta, int B, int T, int H, int hg_dq, int hg_dkv,
               unsigned int seed, unsigned int threshold, float inv, int dropout, float scale, cudaStream_t s) {
  if (hg_dq <= 0 || H % hg_dq || hg_dkv <= 0 || H % hg_dkv) return (int)cudaErrorInvalidValue;
  if constexpr (DH == SB_DH) {  // a block a (128 rows, head, batch row): the head groups are not used
    return launch_streamed_bwd<E>(qkv, qb, key_bias, dout, out, stats, dqkv, db_part, delta, B, T, H, seed,
                                  threshold, inv, dropout, scale, s);
  } else {
    cudaError_t err = prepare<E, DH>(1, T);
    if (err != cudaSuccess) return (int)err;
    err = prepare<E, DH>(2, T);
    if (err != cudaSuccess) return (int)err;
    packed_dq_kernel<E, DH><<<dim3(H / hg_dq, B), NT, dq_bytes<DH>(T), s>>>(
        static_cast<const E*>(qkv), static_cast<const E*>(qb), static_cast<const float*>(key_bias),
        static_cast<const E*>(dout), static_cast<const E*>(out), static_cast<const float*>(stats),
        static_cast<E*>(dqkv), static_cast<float*>(db_part), static_cast<float*>(delta), T, H, hg_dq, seed,
        threshold, inv, dropout, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    packed_dkv_kernel<E, DH><<<dim3(H / hg_dkv, B), NT, dkv_bytes<DH>(T), s>>>(
        static_cast<const E*>(qkv), static_cast<const E*>(qb), static_cast<const float*>(key_bias),
        static_cast<const E*>(dout), static_cast<const float*>(stats), static_cast<const float*>(delta),
        static_cast<E*>(dqkv), static_cast<float*>(db_part), T, H, hg_dkv, seed, threshold, inv, dropout, scale);
    return (int)cudaGetLastError();
  }
}

// Kernel `which` of form f (hopper_attn.cuh's attn_form numbers the forms).
const void* kernel_of_form(int f, int which) {
  switch (f) {
    case 0: return kernel_of<bf16, 64>(which);
    case 1: return kernel_of<bf16, 128>(which);
    case 2: return kernel_of<__half, 64>(which);
    case 3: return kernel_of<__half, 128>(which);
    case 4: return kernel_of<bf16, 16>(which);
    case 5: return kernel_of<bf16, 32>(which);
    case 6: return kernel_of<__half, 16>(which);
    case 7: return kernel_of<__half, 32>(which);
    default: return nullptr;
  }
}

// The small-row products alone (one block): d1 [64 x DH] fp32 = a b through
// product_rs_s (a [64 x 64] from registers, b [64 x DH] the MN-major
// operand) and d2 [64 x 64] fp32 = q b^T through product_ss_s (q, b K-major);
// a, b, q in E with contiguous rows.
template <typename E, int DH>
__global__ void __launch_bounds__(NT)
small_product_kernel(const E* __restrict__ a, const E* __restrict__ b, const E* __restrict__ q, float* __restrict__ d1,
                     float* __restrict__ d2) {
  __shared__ unsigned char smem_raw[ALIGN + 2 * Tile<DH>::BYTES];
  unsigned char* sm = align_smem(smem_raw);
  const uint32_t sB = smem_addr(sm), sQ = sB + Tile<DH>::BYTES;
  issue_tile_s<E, DH>(sB, b, 0, TILE, DH);
  issue_tile_s<E, DH>(sQ, q, 0, TILE, DH);
  cp_commit();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int row[2] = {warp * 16 + g, warp * 16 + g + 8};
  float s[32];  // a's rows in the accumulator layout
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float2 v = vb::Elem<E>::unpack(*reinterpret_cast<const uint32_t*>(a + row[r] * TILE + nt * 8 + 2 * tq));
      s[4 * nt + 2 * r] = v.x;
      s[4 * nt + 2 * r + 1] = v.y;
    }
  uint32_t fa[4][4];
  to_a_t<E>(fa, s);
  cp_wait<0>();
  fence_async();
  __syncthreads();
  float o[DH / 2], st[32];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  wg_fence();
  product_rs_s<E, DH>(o, fa, sB);
  product_ss_s<E, DH>(st, sQ, sB);
  wg_commit();
  wg_wait();
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) asm volatile("" : "+f"(o[i])::"memory");
  reg_fence(st);
  reg_fence(fa);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int nt = 0; nt < DH / 8; ++nt) {
      d1[row[r] * DH + nt * 8 + 2 * tq] = o[4 * nt + 2 * r];
      d1[row[r] * DH + nt * 8 + 2 * tq + 1] = o[4 * nt + 2 * r + 1];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      d2[row[r] * TILE + nt * 8 + 2 * tq] = st[4 * nt + 2 * r];
      d2[row[r] * TILE + nt * 8 + 2 * tq + 1] = st[4 * nt + 2 * r + 1];
    }
  }
}

}  // namespace

// The largest dynamic shared memory of the three kernels at T (bf16, D = 64).
extern "C" size_t vb_attn_packed_smem_bytes(int T) { return smem_bytes<64>(T); }

// Kernel `which` (0 forward, 1 dQ pass, 2 dK/dV pass) of bf16 at D = 64:
// `what` 0 its registers a thread, 1 its local (spill) bytes a thread, 2 its
// dynamic shared memory at T, 3 its resident blocks per SM at T. -1 on an
// error.
extern "C" int vb_attn_packed_info(int which, int what, int T) {
  return kernel_info(kernel_of<bf16, 64>(which), bytes_of<64>(which, T), what);
}

// The bf16, D = 64 entry points (scale 1 / 8); tools that build an earlier
// tree's source launch them with these signatures.
extern "C" int vb_attn_packed_fwd(const void* qkv, const void* qb, const void* key_bias, void* out, void* stats,
                                  int B, int T, int H, int hg, unsigned int seed, unsigned int threshold, float inv,
                                  int dropout, void* stream) {
  return launch_fwd<bf16, 64>(qkv, qb, key_bias, out, stats, B, T, H, hg, seed, threshold, inv, dropout, 0.125f,
                              static_cast<cudaStream_t>(stream));
}

// db_part [B, H*3*D] fp32 and delta [B, H, T] fp32 are scratch the caller
// allocates; hg_dq and hg_dkv are the two passes' heads a block.
extern "C" int vb_attn_packed_bwd(const void* qkv, const void* qb, const void* key_bias, const void* dout,
                                  const void* out, const void* stats, void* dqkv, void* db_part, void* delta, int B,
                                  int T, int H, int hg_dq, int hg_dkv, unsigned int seed, unsigned int threshold,
                                  float inv, int dropout, void* stream) {
  return launch_bwd<bf16, 64>(qkv, qb, key_bias, dout, out, stats, dqkv, db_part, delta, B, T, H, hg_dq, hg_dkv, seed,
                              threshold, inv, dropout, 0.125f, static_cast<cudaStream_t>(stream));
}

// Every form: dtype 0 bf16, 1 fp16; dh the kernel's head dim, 16, 32, 64 or
// 128 (the caller zero-pads the heads to it); scale the softmax scale of
// the unpadded head dim. The largest dynamic shared memory of the three
// kernels at dh and T (0 for a dh not built). At 128 the backward's passes
// (step 7) take the same bytes at every T and 384 threads a block; their hg
// arguments are not used.
extern "C" size_t vb_attn_packed_x_smem_bytes(int dh, int T) {
  switch (dh) {
    case 16: return smem_bytes<16>(T);
    case 32: return smem_bytes<32>(T);
    case 64: return smem_bytes<64>(T);
    case 128: return smem_bytes<128>(T);
    default: return 0;
  }
}

extern "C" int vb_attn_packed_x_info(int dtype, int dh, int which, int what, int T) {
  const int f = attn_form(dtype, dh);
  if (f < 0) return -1;
  return kernel_info(kernel_of_form(f, which), bytes_at(dh, which, T), what, threads_at(dh, which));
}

// Rows of fp32 bias-gradient partials the backward at head dim dh writes a
// batch row at T: one a 128-row block of either pass at 128 (the streamed
// passes), else one (db_part [B, rows, H*3*dh]); 0 for a dh not built.
extern "C" int vb_attn_packed_x_bias_rows(int dh, int T) {
  if (attn_form(0, dh) < 0) return 0;
  return dh == SB_DH ? cdiv(T, SB_ROWS) : 1;
}

// One m64nDHk16 product of each kind the dh 16 and 32 backward runs, alone
// (small_product_kernel), for a card test of the small-row layouts.
extern "C" int vb_attn_packed_x_probe(const void* a, const void* b, const void* q, void* d1, void* d2, int dtype,
                                      int dh, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VB_PROBE(E, D)                                                                             \
  small_product_kernel<E, D><<<1, NT, 0, s>>>(static_cast<const E*>(a), static_cast<const E*>(b), \
                                              static_cast<const E*>(q), static_cast<float*>(d1),  \
                                              static_cast<float*>(d2))
  switch (attn_form(dtype, dh)) {
    case 4: VB_PROBE(bf16, 16); break;
    case 5: VB_PROBE(bf16, 32); break;
    case 6: VB_PROBE(__half, 16); break;
    case 7: VB_PROBE(__half, 32); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef VB_PROBE
  return (int)cudaGetLastError();
}

extern "C" int vb_attn_packed_x_fwd(const void* qkv, const void* qb, const void* key_bias, void* out, void* stats,
                                    int B, int T, int H, int hg, unsigned int seed, unsigned int threshold, float inv,
                                    int dropout, int dtype, int dh, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VB_FWD(E, D) launch_fwd<E, D>(qkv, qb, key_bias, out, stats, B, T, H, hg, seed, threshold, inv, dropout, scale, s)
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

extern "C" int vb_attn_packed_x_bwd(const void* qkv, const void* qb, const void* key_bias, const void* dout,
                                    const void* out, const void* stats, void* dqkv, void* db_part, void* delta, int B,
                                    int T, int H, int hg_dq, int hg_dkv, unsigned int seed, unsigned int threshold,
                                    float inv, int dropout, int dtype, int dh, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VB_BWD(E, D)                                                                                                \
  launch_bwd<E, D>(qkv, qb, key_bias, dout, out, stats, dqkv, db_part, delta, B, T, H, hg_dq, hg_dkv, seed, threshold, \
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
