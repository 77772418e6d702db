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
// the QKV-bias gradient as partials db_part [B, ceil(T / 64), H*3*D], one
// row a (batch row, 64-row tile), each written by one block (the caller sums
// the rows in a fixed order: no atomics).
// Dropout keeps probability (b, h, i, j) by philox.cuh::attn_philox's bit,
// word ((i & 1) << 1 | (j & 1)) of the call for (i, j): the masks equal the
// bf16 and fp16 kernels' at the same seed. The rows, keys and head are
// addressed through Layout's strides: K11/K12 run the same kernels on the
// heads-major [B, 3, H, T, D] qkv (its bias already added: no qb, no bias
// gradient) and [B, H, T, D] out. K13/K14 (save-probs, SP) take the packed
// qkv with its bias added; the forward walks the keys twice (the row
// statistic, then p = exp2(t - stat), written as bf16 into probs [B, H, T,
// ldp] (ldp a multiple of 8) before dropout, and P_d V) and writes no
// statistics; the backward's two passes read p back from those bf16 values
// in place of exp2(t - stats) and need neither the key bias nor the
// statistics: K14's contract in fp32.
//
// Bound on the H100 at the main path's B=128, T=228, H=12, D=64: 2 (K1), 3
// (K13: the statistic pass, then the scores again and P V) and 4 (backward)
// products of 2 B H T^2 D = 5.1 GFLOP each, against a bound of 2 and 4 at
// the 67 TFLOP/s of fp32 outside the tensor cores: 0.15 / 0.30 ms; the bytes
// (fp32: twice the bf16 kernels') take 0.11 / 0.22 ms at 3.35 TB/s. wgmma's
// TF32 keeps a 10-bit mantissa and would not meet fp32's tolerance, and
// 3xTF32 costs three products: these kernels are SIMT.
//
// Every kernel is register-tiled, on the model of mlm_xent_f32.cu's GEMM
// tile:
// - A block of 256 threads owns a 64-row tile of one (batch row, head) pair:
//   queries in the forward and the dQ pass, keys in the dK/dV pass; grid
//   (ceil(T / 64), H, B): 6,144 blocks at the main path. Its rows stay in
//   shared memory; the other side's rows stream through, 64 a tile (32 in
//   the dK/dV pass at D > 16, so that two blocks fit an SM at D = 64). The
//   head dim is padded to DP = 16, 64 or 128 in shared memory and in the
//   products' output columns only: the scores sum over D rounded up to 4.
// - Every product runs on one 16 x 16 grid of threads. A score tile (q.k,
//   dO.v and their transposes) gives each thread a 4 x 4 micro-tile (4 x 2
//   on 32-row tiles): rows 2 ty + {0, 1, 32, 33}, columns 2 tx + {0, 1, 32,
//   33}, so that each thread owns whole 2 x 2 blocks of (i, j), and one
//   attn_philox call serves four keep bits, as in the bf16 kernels. Rows are
//   staged as they lie (row stride DP + 4 floats, 16-byte aligned): per 4
//   steps of d a thread reads one float4 of each of its rows and columns,
//   8 float4 for 64 fused multiply-adds (2 for 16), where one key a lane
//   over rows padded to D + 1 floats read 5 floats for 4; 4-row column
//   groups a phase hit 4 distinct bank quads. P V, dS K, dS^T Q and P^T dO take the tile's p, dS (fp32) from
//   shared memory, [row][column] as the thread wrote them, and multiply
//   them into 4 rows x D/16 output columns a thread (columns 4 tx + {0..3} +
//   64 g): one float4 of 4 columns of P and a float4 of the streamed rows
//   per step, no shuffles.
// - Copies: rows arrive by cp.async, 16 bytes a piece where D % 4 == 0
//   (every row of every layout then 16-byte aligned), 4 bytes otherwise,
//   zero past T and past D (to D rounded up to 4), so that any D <= 128 and
//   a ragged last tile run unpadded; the streamed tiles through a ring of
//   two slots, the next tile's copies in flight during this tile's
//   arithmetic (V, which a tile uses once, through one slot: the forward
//   copies it during the scores, the dQ pass during the last tile's dS K).
//   The QKV bias of K2 is added to each tile by the threads that copied it,
//   once their copies landed; K1's forward adds Q's and folds K's and V's
//   into its row constants (below).
// - Row statistics: K13's first pass keeps an online max and sum per
//   thread and row, merged at its end over the 16 threads of a row by a
//   fixed butterfly of shuffles; the dQ pass sums delta over 4 threads a
//   row from dO (shared) and O.
// - K1/K11's forward walks the keys once: each key tile's row max is merged
//   over the row's 16 threads by that butterfly (every thread of a row then
//   holds the same max), the thread's share of the row sum and its O rows
//   are scaled by exp2(m_old - m_new), and the tile's dropped p goes
//   through shared memory into P V; at the end the 16 shares of the sum are
//   merged the same way, out = O inv / l and stats = m + log2 l. Two
//   products, where K13 makes three.
// - K13 stages the tile's bf16 probabilities in shared memory and writes
//   them as 16-byte pieces, 128 contiguous bytes a row of the tile.
// - The bias gradient: each block sums its output columns (its 4 rows, the
//   lane pair of a column, the 8 warps in order) into its own db_part row.
// Every sum runs in a fixed order and nothing is atomic: two calls agree bit
// for bit. Flops: K13 3 products; the backward 7 (the dQ pass computes the
// scores, dP and dQ, the dK/dV pass the scores and dP again, dV and dK: 5
// with K14's saved p), against the bound's 4. A 4 x 4 micro-tile reads 2
// bytes of shared memory a fused multiply-add: at an SM's 128 bytes a clock
// that, not the fp32 rate, bounds these kernels.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int NW = 8;              // warps a block
constexpr int NTH = NW * 32;
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

// ---------------------------------------------------------------------------
// The register-tiled kernels: K13's forward and the backward's two passes.

constexpr int BR = 64;    // rows of a block's own tile: queries (forward, dQ pass) or keys (dK/dV pass)
constexpr int LDPB = 72;  // bf16 elements a row of a staged probability tile: 64 keys + 8 (144 bytes)
constexpr int RM = 4;     // rows of a thread's score micro-tile, on a 16 x 16 grid of the NTH threads

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// The padded head dim a D runs at: 16 (the JAX package's tiny()), 64 or 128.
int dp_of(int D) { return D <= 16 ? 16 : D <= 64 ? 64 : 128; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 4 or 16 bytes, or zeros where !valid (src must still be a valid address)
__device__ __forceinline__ void cp4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + NR) of a D-wide matrix (row t at src + t * ld) into dst
// (row stride LD): 16-byte pieces where vec (D % 4 == 0), else 4-byte ones;
// zero past T and in the columns [D, D rounded up to 4). Thread t copies
// pieces t, t + NTH, ...
template <int NR>
__device__ __forceinline__ void copy_rows(float* dst, int LD, const float* __restrict__ src, long long ld, int r0,
                                          int T, int D, bool vec) {
  if (vec) {
    const int per = D >> 2;
    for (int c = threadIdx.x; c < NR * per; c += NTH) {
      const int r = c / per, k = (c - r * per) << 2;
      const bool ok = r0 + r < T;
      cp16(smem_u32(dst + r * LD + k), ok ? src + (long long)(r0 + r) * ld + k : src, ok);
    }
  } else {
    const int per = (D + 3) & ~3;
    for (int e = threadIdx.x; e < NR * per; e += NTH) {
      const int r = e / per, k = e - r * per;
      const bool ok = r0 + r < T && k < D;
      cp4(smem_u32(dst + r * LD + k), ok ? src + (long long)(r0 + r) * ld + k : src, ok);
    }
  }
}

// bias[0, D) added to the rows below T of the pieces this thread copied by
// copy_rows (called once they landed: cp.async's writes are the copying
// thread's to read after its wait).
template <int NR>
__device__ __forceinline__ void add_bias(float* dst, int LD, const float* __restrict__ bias, int r0, int T, int D,
                                         bool vec) {
  if (vec) {
    const int per = D >> 2;
    for (int c = threadIdx.x; c < NR * per; c += NTH) {
      const int r = c / per, k = (c - r * per) << 2;
      if (r0 + r >= T) continue;
      float4* p = reinterpret_cast<float4*>(dst + r * LD + k);
      float4 v = *p;
      v.x += bias[k];
      v.y += bias[k + 1];
      v.z += bias[k + 2];
      v.w += bias[k + 3];
      *p = v;
    }
  } else {
    const int per = (D + 3) & ~3;
    for (int e = threadIdx.x; e < NR * per; e += NTH) {
      const int r = e / per, k = e - r * per;
      if (r0 + r < T && k < D) dst[r * LD + k] += bias[k];
    }
  }
}

// N values [r0, r0 + N) of a vector (key bias, stats, delta) into dst; zero
// past T.
template <int N>
__device__ __forceinline__ void copy_vec(float* dst, const float* __restrict__ src, int r0, int T) {
  for (int r = threadIdx.x; r < N; r += NTH) {
    const bool ok = r0 + r < T;
    cp4(smem_u32(dst + r), ok ? src + r0 + r : src, ok);
  }
}

// The saved probabilities of rows [r0, r0 + NR) and keys [c0, c0 + 64)
// (row i at pb + i * ldp, ldp a multiple of 8) into dst (row stride LDPB),
// 16 bytes a piece; zero past T (a piece that starts below T may hold keys
// of the row's padding: the kernels mask keys past T).
template <int NR>
__device__ __forceinline__ void copy_probs(bf16* dst, const bf16* __restrict__ pb, int ldp, int r0, int c0, int T) {
  for (int c = threadIdx.x; c < NR * 8; c += NTH) {
    const int r = c >> 3, k = (c & 7) << 3;
    const bool ok = r0 + r < T && c0 + k < T;
    cp16(smem_u32(dst + r * LDPB + k), ok ? pb + (long long)(r0 + r) * ldp + c0 + k : pb, ok);
  }
}

// This thread's place in the 16 x 16 grid: lane l of warp w is (tx,
// ty) = ((l & 3) | (l bits 3-4) << 2, (l bit 2) | w << 1), so that each
// group of 8 lanes (a phase of a 16-byte shared load) spans 4 tx and 2 ty.
// The lanes of a row (one ty) differ in lane bits 0, 1, 3, 4; the two lanes
// of a column pair in warp w differ in bit 2.
struct Place {
  int tx, ty;
  __device__ __forceinline__ Place() {
    const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
    tx = (l & 3) | ((l >> 1) & 12);
    ty = ((l >> 2) & 1) | (w << 1);
  }
  // rows and columns of a score micro-tile (a < 4: pairs 32 apart; b
  // < 4, b < 2 on 32-row tiles)
  __device__ __forceinline__ int row(int a) const { return 2 * ty + (a & 1) + 32 * (a >> 1); }
  __device__ __forceinline__ int col(int b) const { return 2 * tx + (b & 1) + 32 * (b >> 1); }
  // column n of a product's NC = DP / 16 output columns: W = min(NC, 4)
  // adjacent columns from W tx, in groups 64 apart
  template <int NC>
  __device__ __forceinline__ int pcol(int n) const {
    constexpr int W = NC < 4 ? NC : 4;
    return W * tx + n % W + 64 * (n / W);
  }
};

template <int R, int N>
__device__ __forceinline__ void zero(float (&acc)[R][N]) {
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int n = 0; n < N; ++n) acc[a][n] = 0.f;
}

__device__ __forceinline__ float comp(const float4& v, int k) { return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w; }

// s[a][b] = sum_d A[row a][d] B[col b][d] over d < d4, d ascending (rows of
// both LD floats apart, zero from D to d4).
template <int NCOL>
__device__ __forceinline__ void score(float (&s)[RM][NCOL], const float* A, const float* Bm, int LD, int d4,
                                      const Place& pl) {
  zero(s);
#pragma unroll 2
  for (int d = 0; d < d4; d += 4) {
    float4 x[RM], y[NCOL];
#pragma unroll
    for (int a = 0; a < RM; ++a) x[a] = *reinterpret_cast<const float4*>(A + pl.row(a) * LD + d);
#pragma unroll
    for (int b = 0; b < NCOL; ++b) y[b] = *reinterpret_cast<const float4*>(Bm + pl.col(b) * LD + d);
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int a = 0; a < RM; ++a)
#pragma unroll
        for (int b = 0; b < NCOL; ++b) s[a][b] = fmaf(comp(x[a], k), comp(y[b], k), s[a][b]);
  }
}

// acc[a][n] += sum_c X[row a][c] Bs[c][pcol n] over the tile's 16 NCOL
// columns, c ascending (X's rows 16 NCOL + 4 floats apart, Bs's LD).
template <int NCOL, int NC>
__device__ __forceinline__ void product(float (&acc)[RM][NC], const float* X, const float* Bs, int LD,
                                        const Place& pl) {
  constexpr int BC = 16 * NCOL, LDX = BC + 4, W = NC < 4 ? NC : 4;
#pragma unroll 2
  for (int c = 0; c < BC; c += 4) {
    float4 x[RM];
#pragma unroll
    for (int a = 0; a < RM; ++a) x[a] = *reinterpret_cast<const float4*>(X + pl.row(a) * LDX + c);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float* brow = Bs + (c + k) * LD + W * pl.tx;
      float v[NC];
      if (W == 4) {
#pragma unroll
        for (int g = 0; g < NC / 4; ++g) {
          const float4 u = *reinterpret_cast<const float4*>(brow + 64 * g);
          v[4 * g] = u.x;
          v[4 * g + 1] = u.y;
          v[4 * g + 2] = u.z;
          v[4 * g + 3] = u.w;
        }
      } else if (W == 2) {
        const float2 u = *reinterpret_cast<const float2*>(brow);
        v[0] = u.x;
        v[W - 1] = u.y;
      } else {
        v[0] = brow[0];
      }
#pragma unroll
      for (int a = 0; a < RM; ++a)
#pragma unroll
        for (int n = 0; n < NC; ++n) acc[a][n] = fmaf(comp(x[a], k), v[n], acc[a][n]);
    }
  }
}

// The keep bits of the 2 x 2 block (i + e, j + f), e, f in {0, 1}, i and j
// even: bit (e << 1 | f), from one attn_philox call.
__device__ __forceinline__ uint32_t keep4(uint32_t seed, uint32_t bh, int i, int j, uint32_t thr) {
  const uint4 r = vb::attn_philox(seed, bh, i, j);
  return (r.x >= thr ? 1u : 0u) | (r.y >= thr ? 2u : 0u) | (r.z >= thr ? 4u : 0u) | (r.w >= thr ? 8u : 0u);
}

// The rows below T of acc (RM rows x NC columns a thread, rows r0 +
// row(a)) into dst (row t at dst + t * ld), columns below D.
template <int NC>
__device__ __forceinline__ void store_rows(float* __restrict__ dst, long long ld, const float (&acc)[RM][NC], int r0,
                                           int T, int D, bool vec, const Place& pl) {
  constexpr int W = NC < 4 ? NC : 4;
#pragma unroll
  for (int a = 0; a < RM; ++a) {
    const int t = r0 + pl.row(a);
    if (t >= T) continue;
    float* o = dst + (long long)t * ld;
#pragma unroll
    for (int g = 0; g < NC / W; ++g) {
      const int c = pl.pcol<NC>(W * g);
      if (W == 4 && vec) {
        if (c < D) *reinterpret_cast<float4*>(o + c) = make_float4(acc[a][4 * g], acc[a][4 * g + 1],
                                                                    acc[a][4 * g + 2], acc[a][4 * g + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < W; ++e)
          if (c + e < D) o[c + e] = acc[a][W * g + e];
      }
    }
  }
}

// The block's column sums of acc over its rows below T into dst[0, D), in a
// fixed order: a thread's RM rows, the two lanes of a column pair, the
// warps in order. red: a warp's 16 NC floats of shared memory each, reused
// once every thread passed the first barrier.
template <int NC>
__device__ __forceinline__ void col_sums(const float (&acc)[RM][NC], int r0, int T, float* red,
                                         float* __restrict__ dst, int D, const Place& pl) {
  constexpr int DP = 16 * NC;
  float cs[NC];
#pragma unroll
  for (int n = 0; n < NC; ++n) {
    float v = 0.f;
#pragma unroll
    for (int a = 0; a < RM; ++a)
      if (r0 + pl.row(a) < T) v += acc[a][n];
    cs[n] = v + __shfl_xor_sync(0xffffffffu, v, 4);
  }
  __syncthreads();  // every thread is done with what red holds
  if (((threadIdx.x >> 2) & 1) == 0) {
#pragma unroll
    for (int n = 0; n < NC; ++n) red[(threadIdx.x >> 5) * DP + pl.pcol<NC>(n)] = cs[n];
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += NTH) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) v += red[w * DP + d];
    dst[d] = v;
  }
}

// Shared memory of the three kernels, in floats (the bf16 probability
// tiles last). LD: a staged row of D <= DP floats; a tile of 64 rows.
template <int DP>
struct FwdSmem {  // Q, K (2 slots), V, the p tile, the key bias (2 slots); K13: the bf16 probabilities
  static constexpr int LD = DP + 4, TILE = BR * LD, LDX = BR + 4;
  static constexpr int Q = 0, K = TILE, V = 3 * TILE, X = 4 * TILE, KB = X + BR * LDX, PB = KB + 2 * BR;
  static constexpr size_t BYTES = sizeof(float) * PB + sizeof(bf16) * BR * LDPB;
  static constexpr size_t K1_BYTES = sizeof(float) * PB;  // K1/K11's forward: no probabilities
};

template <int DP, bool SP>
struct DqSmem {  // dO, Q (not SP), K (2 slots), V, dS, the key bias (2 slots), delta; SP: probabilities (2 slots)
  static constexpr int LD = DP + 4, TILE = BR * LD, LDX = BR + 4;
  static constexpr int DO = 0, Q = TILE, K = SP ? TILE : 2 * TILE, V = K + 2 * TILE, X = V + TILE,
                       KB = X + BR * LDX, DL = KB + 2 * BR, PB = DL + BR;
  static constexpr size_t BYTES = sizeof(float) * PB + (SP ? sizeof(bf16) * 2 * BR * LDPB : 0);
};

template <int DP, bool SP>
struct DkvSmem {  // K, V; Q, dO, stats, delta (2 slots of BC rows); P_d^T, dS^T; SP: probabilities (2 slots)
  static constexpr int NCOL = DP == 16 ? 4 : 2, BC = 16 * NCOL, LD = DP + 4, LDX = BC + 4;
  static constexpr int K = 0, V = BR * LD, Q = 2 * BR * LD, DO = Q + 2 * BC * LD, XP = DO + 2 * BC * LD,
                       XS = XP + BR * LDX, ST = XS + BR * LDX, DL = ST + 2 * BC, PB = DL + 2 * BC;
  static constexpr size_t BYTES = sizeof(float) * PB + (SP ? sizeof(bf16) * 2 * BC * LDPB : 0);
};

// K13 in fp32. grid (ceil(T / 64), H, B): block (x, h, b) owns queries [64 x,
// 64 x + 64) of the pair (b, h). Steps 0 .. nt - 1 take the rows' statistic
// over every key tile, steps nt .. 2 nt - 1 write p = exp2(t - stat) as bf16
// (row i of the pair at probs + i * ldp) and accumulate the dropped p times
// V (p normalised: no final division).
template <int DP>
__global__ void __launch_bounds__(NTH, DP <= 64 ? 2 : 1)
attn_f32_tiled_sp_fwd_kernel(const float* __restrict__ qkv, const float* __restrict__ key_bias,
                             float* __restrict__ out, bf16* __restrict__ probs, int T, int H, int D, int ldp, Layout L,
                             uint32_t seed, uint32_t thr, float inv, int dropout, float scale) {
  using S = FwdSmem<DP>;
  constexpr int NC = DP / 16, LD = S::LD, LDX = S::LDX;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* Qs = sm + S::Q;
  float* Vs = sm + S::V;
  float* X = sm + S::X;
  bf16* Pb = reinterpret_cast<bf16*>(sm + S::PB);
  const Place pl;
  const int r0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z;
  const float* q = qkv + b * L.qb + h * L.qh;
  const float* kbg = key_bias + (long long)b * T;
  const uint32_t bh = (uint32_t)(b * H + h);
  bf16* pbg = probs + (long long)bh * T * ldp;
  const bool vec = (D & 3) == 0;
  const int d4 = (D + 3) & ~3, nt = cdiv(T, BR);
  const float c1 = scale * LOG2E;
  auto issue_k = [&](int step) {  // key tile step % nt and its key bias into slot step & 1
    const int c0 = (step % nt) * BR;
    copy_rows<BR>(sm + S::K + (step & 1) * S::TILE, LD, q + L.part, L.qt, c0, T, D, vec);
    copy_vec<BR>(sm + S::KB + (step & 1) * BR, kbg, c0, T);
  };
  copy_rows<BR>(Qs, LD, q, L.qt, r0, T, D, vec);
  issue_k(0);
  cp_commit();
  float m[RM], l[RM], o[RM][NC];
#pragma unroll
  for (int a = 0; a < RM; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.f;
  }
  zero(o);
  for (int step = 0; step < 2 * nt; ++step) {
    const int c0 = (step % nt) * BR, slot = step & 1;
    cp_wait<0>();
    __syncthreads();  // key tile `step` landed; every thread is done with the last step's tiles
    if (step >= nt) copy_rows<BR>(Vs, LD, q + 2 * L.part, L.qt, c0, T, D, vec);
    cp_commit();
    if (step + 1 < 2 * nt) issue_k(step + 1);
    cp_commit();
    float s[RM][4];
    score(s, Qs, sm + S::K + slot * S::TILE, LD, d4, pl);
    const float* kb = sm + S::KB + slot * BR;
    if (step < nt) {  // the statistic: an online max and sum of exp2 per row over this thread's keys
#pragma unroll
      for (int a = 0; a < RM; ++a) {
        float t[4], tm = -INFINITY;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          t[c] = c0 + pl.col(c) < T ? fmaf(s[a][c], c1, kb[pl.col(c)] * LOG2E) : -INFINITY;
          tm = fmaxf(tm, t[c]);
        }
        if (tm == -INFINITY) continue;  // every key past T
        const float mn = fmaxf(m[a], tm);
        float sum = l[a] * exp2f(m[a] - mn);  // m = -inf only while l = 0
#pragma unroll
        for (int c = 0; c < 4; ++c) sum += exp2f(t[c] - mn);
        l[a] = sum;
        m[a] = mn;
      }
      if (step == nt - 1) {  // merge the 16 threads of a row (a symmetric butterfly: all agree bit for bit)
#pragma unroll
        for (int a = 0; a < RM; ++a) {
#pragma unroll
          for (int off = 1; off < 32; off <<= 1) {
            if (off == 4) continue;
            const float m2 = __shfl_xor_sync(0xffffffffu, m[a], off), l2 = __shfl_xor_sync(0xffffffffu, l[a], off);
            const float mn = fmaxf(m[a], m2);
            if (mn == -INFINITY) continue;
            l[a] = (m[a] == -INFINITY ? 0.f : l[a] * exp2f(m[a] - mn)) + (m2 == -INFINITY ? 0.f : l2 * exp2f(m2 - mn));
            m[a] = mn;
          }
          m[a] += log2f(l[a]);  // m holds the row statistic from here
        }
      }
      continue;
    }
    float p[RM][4];
#pragma unroll
    for (int a = 0; a < RM; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        p[a][c] = c0 + pl.col(c) < T ? exp2f(fmaf(s[a][c], c1, kb[pl.col(c)] * LOG2E) - m[a]) : 0.f;
#pragma unroll
    for (int a = 0; a < RM; ++a)
#pragma unroll
      for (int c = 0; c < 4; c += 2)
        *reinterpret_cast<__nv_bfloat162*>(Pb + pl.row(a) * LDPB + pl.col(c)) =
            __floats2bfloat162_rn(p[a][c], p[a][c + 1]);
#pragma unroll
    for (int A = 0; A < RM / 2; ++A)
#pragma unroll
      for (int C = 0; C < 2; ++C) {
        const int i = r0 + pl.row(2 * A), j = c0 + pl.col(2 * C);
        const uint32_t bits = !dropout ? 15u : (i < T && j < T ? keep4(seed, bh, i, j, thr) : 0u);
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int f = 0; f < 2; ++f) {
            float& v = p[2 * A + e][2 * C + f];
            v = (bits >> ((e << 1) | f)) & 1u ? v * inv : 0.f;
          }
      }
#pragma unroll
    for (int a = 0; a < RM; ++a)
#pragma unroll
      for (int c = 0; c < 4; c += 2)
        *reinterpret_cast<float2*>(X + pl.row(a) * LDX + pl.col(c)) = make_float2(p[a][c], p[a][c + 1]);
    cp_wait<1>();
    __syncthreads();  // V landed; the p tile and the bf16 probabilities are whole
    for (int c = threadIdx.x; c < BR * 8; c += NTH) {
      const int r = c >> 3, k = (c & 7) << 3, i = r0 + r;
      if (i < T && c0 + k < T)
        *reinterpret_cast<uint4*>(pbg + (long long)i * ldp + c0 + k) =
            *reinterpret_cast<const uint4*>(Pb + r * LDPB + k);
    }
    product<4, NC>(o, X, Vs, LD, pl);
  }
  store_rows(out + b * L.ob + h * L.oh, L.ot, o, r0, T, D, vec, pl);
}

// The max over the 16 threads of a score row (the lanes that differ in bits
// 0, 1, 3 and 4), or their sum: a symmetric butterfly, so that every thread
// of the row holds the same bits.
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1)
    if (off != 4) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1)
    if (off != 4) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// K1 and K11 in fp32 (K1's contract; qb null for K11's biased heads-major
// qkv). grid (ceil(T / 64), H, B): block (x, h, b) owns queries [64 x, 64 x
// + 64) of the pair (b, h) and walks the key tiles once with an online max
// and sum: per tile the row max over the row's 16 threads, O and the
// thread's share l of the row sum scaled by exp2(m_old - m_new), p =
// exp2(t - m_new), the dropped p into P V. out = O inv / l over the row's
// merged l, stats = m + log2 l. K1's QKV bias: Q's is added to the query
// tile once; K's and V's take no pass over the key tiles (a pass a tile
// stalled the block between a tile's landing and its barrier: at DP = 128,
// one block an SM, 22 % of the call). q.(k + bk) = q.k + q.bk, the second
// term a constant of the row, added to each score before it is scaled (so
// that t rounds once at the key bias's magnitude, as with the biased k);
// sum_j p_j (v_j + bv) = P V + (sum_j p_j) bv, with the kept p under
// dropout, whose sum the threads keep in shares beside l.
template <int DP>
__global__ void __launch_bounds__(NTH, DP <= 64 ? 2 : 1)
attn_f32_tiled_fwd_kernel(const float* __restrict__ qkv, const float* __restrict__ qb,
                          const float* __restrict__ key_bias, float* __restrict__ out, float* __restrict__ stats, int T,
                          int H, int D, Layout L, uint32_t seed, uint32_t thr, float inv, int dropout, float scale) {
  using S = FwdSmem<DP>;
  constexpr int NC = DP / 16, LD = S::LD, LDX = S::LDX;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* Qs = sm + S::Q;
  float* Vs = sm + S::V;
  float* X = sm + S::X;
  const Place pl;
  const int r0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z;
  const float* q = qkv + b * L.qb + h * L.qh;
  const float* bq = qb ? qb + h * L.bh : nullptr;
  const float* kbg = key_bias + (long long)b * T;
  const uint32_t bh = (uint32_t)(b * H + h);
  const bool vec = (D & 3) == 0;
  const int d4 = (D + 3) & ~3, nt = cdiv(T, BR);
  const float c1 = scale * LOG2E;
  auto issue_k = [&](int t) {  // key tile t and its key bias into slot t & 1
    copy_rows<BR>(sm + S::K + (t & 1) * S::TILE, LD, q + L.part, L.qt, t * BR, T, D, vec);
    copy_vec<BR>(sm + S::KB + (t & 1) * BR, kbg, t * BR, T);
  };
  copy_rows<BR>(Qs, LD, q, L.qt, r0, T, D, vec);
  issue_k(0);
  cp_commit();
  const bool kept_sum = bq && dropout;  // the shares lk of sum_j kept p_j, for V's bias
  float m[RM], l[RM], lk[RM], qk[RM], o[RM][NC];
#pragma unroll
  for (int a = 0; a < RM; ++a) {
    m[a] = -INFINITY;
    l[a] = lk[a] = qk[a] = 0.f;
  }
  zero(o);
  for (int t = 0; t < nt; ++t) {
    const int c0 = t * BR, slot = t & 1;
    float* Ks = sm + S::K + slot * S::TILE;
    cp_wait<0>();
    if (bq && t == 0) add_bias<BR>(Qs, LD, bq, r0, T, D, vec);
    __syncthreads();  // key tile t landed (the query tile biased); every thread is done with the last tile's V and p
    if (bq && t == 0) {  // q.bk of each of the thread's rows: the row's 16 threads take every 16th column
      const float* bk = bq + L.bpart;
#pragma unroll
      for (int a = 0; a < RM; ++a) {
        float v = 0.f;
        for (int d = pl.tx; d < D; d += 16) v = fmaf(Qs[pl.row(a) * LD + d], bk[d], v);
        qk[a] = row_sum(v);
      }
    }
    copy_rows<BR>(Vs, LD, q + 2 * L.part, L.qt, c0, T, D, vec);
    cp_commit();
    if (t + 1 < nt) issue_k(t + 1);
    cp_commit();
    float s[RM][4];
    score(s, Qs, Ks, LD, d4, pl);
    const float* kb = sm + S::KB + slot * BR;
    float alpha[RM];
#pragma unroll
    for (int a = 0; a < RM; ++a) {
      float tm = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[a][c] = c0 + pl.col(c) < T ? fmaf(s[a][c] + qk[a], c1, kb[pl.col(c)] * LOG2E) : -INFINITY;
        tm = fmaxf(tm, s[a][c]);
      }
      const float mn = fmaxf(m[a], row_max(tm));
      const float ms = mn == -INFINITY ? 0.f : mn;  // a row with no finite score yet: p = 0, alpha = 0
      alpha[a] = exp2f(m[a] - ms);
      m[a] = mn;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[a][c] = exp2f(s[a][c] - ms);
        sum += s[a][c];
      }
      l[a] = fmaf(l[a], alpha[a], sum);
    }
    if (dropout) {
#pragma unroll
      for (int A = 0; A < RM / 2; ++A)
#pragma unroll
        for (int C = 0; C < 2; ++C) {
          const int i = r0 + pl.row(2 * A), j = c0 + pl.col(2 * C);
          const uint32_t bits = i < T && j < T ? keep4(seed, bh, i, j, thr) : 0u;
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int f = 0; f < 2; ++f)
              if (!((bits >> ((e << 1) | f)) & 1u)) s[2 * A + e][2 * C + f] = 0.f;
        }
    }
    if (kept_sum) {
#pragma unroll
      for (int a = 0; a < RM; ++a) lk[a] = fmaf(lk[a], alpha[a], (s[a][0] + s[a][1]) + (s[a][2] + s[a][3]));
    }
#pragma unroll
    for (int a = 0; a < RM; ++a) {
#pragma unroll
      for (int c = 0; c < 4; c += 2)
        *reinterpret_cast<float2*>(X + pl.row(a) * LDX + pl.col(c)) = make_float2(s[a][c], s[a][c + 1]);
#pragma unroll
      for (int n = 0; n < NC; ++n) o[a][n] *= alpha[a];
    }
    cp_wait<1>();
    __syncthreads();  // V landed; the p tile is whole
    product<4, NC>(o, X, Vs, LD, pl);
  }
  float* st = stats + (long long)bh * T;
  const float* bv = bq ? bq + 2 * L.bpart : nullptr;
#pragma unroll
  for (int a = 0; a < RM; ++a) {
    l[a] = row_sum(l[a]);
    if (bq) {
      const float w = kept_sum ? row_sum(lk[a]) : l[a];
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const int c = pl.pcol<NC>(n);
        if (c < D) o[a][n] = fmaf(w, bv[c], o[a][n]);
      }
    }
    const float sc = inv / l[a];
#pragma unroll
    for (int n = 0; n < NC; ++n) o[a][n] *= sc;
    const int i = r0 + pl.row(a);
    if (pl.tx == 0 && i < T) st[i] = m[a] + log2f(l[a]);
  }
  store_rows(out + b * L.ob + h * L.oh, L.ot, o, r0, T, D, vec, pl);
}

// grid (ceil(T / 64), H, B): the dQ pass of queries [64 x, 64 x + 64) of the
// pair (b, h); also writes their delta and, given db_part, its row (b, x)'s
// q part. SP: p from the saved probabilities (probs, ldp) in place of
// exp2(t - stats).
template <int DP, bool SP>
__global__ void __launch_bounds__(NTH, DP <= 64 ? 2 : 1)
attn_f32_tiled_dq_kernel(const float* __restrict__ qkv, const float* __restrict__ qb,
                         const float* __restrict__ key_bias, const float* __restrict__ dout,
                         const float* __restrict__ out, const float* __restrict__ stats,
                         const bf16* __restrict__ probs, int ldp, float* __restrict__ dqkv,
                         float* __restrict__ db_part, float* __restrict__ delta_g, int T, int H, int D, Layout L,
                         uint32_t seed, uint32_t thr, float inv, int dropout, float scale) {
  using S = DqSmem<DP, SP>;
  constexpr int NC = DP / 16, LD = S::LD, LDX = S::LDX;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* dOs = sm + S::DO;
  float* Qs = sm + S::Q;
  float* Vs = sm + S::V;
  float* X = sm + S::X;
  float* dls = sm + S::DL;
  bf16* Pbs = reinterpret_cast<bf16*>(sm + S::PB);
  const Place pl;
  const int r0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z;
  const float* q = qkv + b * L.qb + h * L.qh;
  const float* bq = qb ? qb + h * L.bh : nullptr;
  const float* dob = dout + b * L.ob + h * L.oh;
  const float* ob = out + b * L.ob + h * L.oh;
  const uint32_t bh = (uint32_t)(b * H + h);
  const bf16* pbg = SP ? probs + (long long)bh * T * ldp : nullptr;
  const bool vec = (D & 3) == 0;
  const int d4 = (D + 3) & ~3, nt = cdiv(T, BR);
  const float c1 = scale * LOG2E;
  auto issue_k = [&](int t) {  // key tile t (K, and the key bias or the probabilities) into slot t & 1
    copy_rows<BR>(sm + S::K + (t & 1) * S::TILE, LD, q + L.part, L.qt, t * BR, T, D, vec);
    if (SP)
      copy_probs<BR>(Pbs + (t & 1) * BR * LDPB, pbg, ldp, r0, t * BR, T);
    else
      copy_vec<BR>(sm + S::KB + (t & 1) * BR, key_bias + (long long)b * T, t * BR, T);
  };
  copy_rows<BR>(dOs, LD, dob, L.ot, r0, T, D, vec);
  if (!SP) copy_rows<BR>(Qs, LD, q, L.qt, r0, T, D, vec);
  cp_commit();
  issue_k(0);
  copy_rows<BR>(Vs, LD, q + 2 * L.part, L.qt, 0, T, D, vec);
  cp_commit();
  cp_wait<1>();
  if (!SP && bq) add_bias<BR>(Qs, LD, bq, r0, T, D, vec);
  __syncthreads();  // dO whole
  {                 // delta = rowsum(dO * O): 4 adjacent threads a row
    constexpr int PER = NTH / BR;
    const int r = threadIdx.x / PER, part = threadIdx.x % PER, i = r0 + r;
    float a = 0.f;
    if (i < T) {
      const float* orow = ob + (long long)i * L.ot;
      for (int d = part; d < D; d += PER) a = fmaf(dOs[r * LD + d], orow[d], a);
    }
#pragma unroll
    for (int off = 1; off < PER; off <<= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
    if (part == 0) {
      dls[r] = a;
      if (i < T) delta_g[(long long)bh * T + i] = a;
    }
  }
  float st[RM], dl[RM], dq[RM][NC];
#pragma unroll
  for (int a = 0; a < RM; ++a) {
    const int i = r0 + pl.row(a);
    st[a] = !SP && i < T ? stats[(long long)bh * T + i] : 0.f;
  }
  zero(dq);
  for (int t = 0; t < nt; ++t) {
    const int c0 = t * BR, slot = t & 1;
    float* Ks = sm + S::K + slot * S::TILE;
    cp_wait<0>();
    if (bq) {
      add_bias<BR>(Ks, LD, bq + L.bpart, c0, T, D, vec);
      add_bias<BR>(Vs, LD, bq + 2 * L.bpart, c0, T, D, vec);
    }
    __syncthreads();  // key tile t landed and is biased; every thread is done with the last tile
    if (t == 0) {
#pragma unroll
      for (int a = 0; a < RM; ++a) dl[a] = dls[pl.row(a)];
    }
    if (t + 1 < nt) issue_k(t + 1);
    cp_commit();
    float s[RM][4], dp[RM][4];
    if (!SP) score(s, Qs, Ks, LD, d4, pl);
    score(dp, dOs, Vs, LD, d4, pl);
    const float* kb = sm + S::KB + slot * BR;
    const bf16* pt = Pbs + slot * BR * LDPB;
#pragma unroll
    for (int A = 0; A < RM / 2; ++A)
#pragma unroll
      for (int C = 0; C < 2; ++C) {
        const int i = r0 + pl.row(2 * A), j = c0 + pl.col(2 * C);
        const uint32_t bits = !dropout ? 15u : (i < T && j < T ? keep4(seed, bh, i, j, thr) : 0u);
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int f = 0; f < 2; ++f) {
            const int a = 2 * A + e, c = 2 * C + f;
            const bool ok = i + e < T && j + f < T;
            float p;
            if (SP)
              p = ok ? __bfloat162float(pt[pl.row(a) * LDPB + pl.col(c)]) : 0.f;
            else
              p = ok ? exp2f(fmaf(s[a][c], c1, kb[pl.col(c)] * LOG2E) - st[a]) : 0.f;
            const float d = (bits >> ((e << 1) | f)) & 1u ? dp[a][c] * inv : 0.f;
            dp[a][c] = p * (d - dl[a]);  // dS (the scale goes on dQ)
          }
      }
#pragma unroll
    for (int a = 0; a < RM; ++a)
#pragma unroll
      for (int c = 0; c < 4; c += 2)
        *reinterpret_cast<float2*>(X + pl.row(a) * LDX + pl.col(c)) = make_float2(dp[a][c], dp[a][c + 1]);
    __syncthreads();  // dS whole; every thread is done with V
    if (t + 1 < nt) copy_rows<BR>(Vs, LD, q + 2 * L.part, L.qt, c0 + BR, T, D, vec);
    cp_commit();
    product<4, NC>(dq, X, Ks, LD, pl);
  }
#pragma unroll
  for (int a = 0; a < RM; ++a)
#pragma unroll
    for (int n = 0; n < NC; ++n) dq[a][n] *= scale;
  store_rows(dqkv + b * L.qb + h * L.qh, L.qt, dq, r0, T, D, vec, pl);
  if (db_part)
    col_sums(dq, r0, T, X, db_part + ((long long)b * gridDim.x + blockIdx.x) * 3 * H * D + h * L.bh, D, pl);
}

// grid (ceil(T / 64), H, B): the dK/dV pass of keys [64 x, 64 x + 64) of the
// pair (b, h), on the dQ pass's delta; given db_part, writes its row (b,
// x)'s k and v parts. SP as the dQ pass's.
template <int DP, bool SP>
__global__ void __launch_bounds__(NTH, DP <= 64 ? 2 : 1)
attn_f32_tiled_dkv_kernel(const float* __restrict__ qkv, const float* __restrict__ qb,
                          const float* __restrict__ key_bias, const float* __restrict__ dout,
                          const float* __restrict__ stats, const bf16* __restrict__ probs, int ldp,
                          const float* __restrict__ delta_g, float* __restrict__ dqkv, float* __restrict__ db_part,
                          int T, int H, int D, Layout L, uint32_t seed, uint32_t thr, float inv, int dropout,
                          float scale) {
  using S = DkvSmem<DP, SP>;
  constexpr int NC = DP / 16, NCOL = S::NCOL, BC = S::BC, LD = S::LD, LDX = S::LDX;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* Ks = sm + S::K;
  float* Vs = sm + S::V;
  float* Xp = sm + S::XP;
  float* Xs = sm + S::XS;
  bf16* Pbs = reinterpret_cast<bf16*>(sm + S::PB);
  const Place pl;
  const int j0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z;
  const float* q = qkv + b * L.qb + h * L.qh;
  const float* bq = qb ? qb + h * L.bh : nullptr;
  const float* dob = dout + b * L.ob + h * L.oh;
  const uint32_t bh = (uint32_t)(b * H + h);
  const bf16* pbg = SP ? probs + (long long)bh * T * ldp : nullptr;
  const bool vec = (D & 3) == 0;
  const int d4 = (D + 3) & ~3, nq = cdiv(T, BC);
  const float c1 = scale * LOG2E;
  auto issue = [&](int t) {  // query tile t (Q, dO, stats or probabilities, delta) into slot t & 1
    const int i0 = t * BC, slot = t & 1;
    copy_rows<BC>(sm + S::Q + slot * BC * LD, LD, q, L.qt, i0, T, D, vec);
    copy_rows<BC>(sm + S::DO + slot * BC * LD, LD, dob, L.ot, i0, T, D, vec);
    copy_vec<BC>(sm + S::DL + slot * BC, delta_g + (long long)bh * T, i0, T);
    if (SP)
      copy_probs<BC>(Pbs + slot * BC * LDPB, pbg, ldp, i0, j0, T);
    else
      copy_vec<BC>(sm + S::ST + slot * BC, stats + (long long)bh * T, i0, T);
  };
  copy_rows<BR>(Ks, LD, q + L.part, L.qt, j0, T, D, vec);
  copy_rows<BR>(Vs, LD, q + 2 * L.part, L.qt, j0, T, D, vec);
  issue(0);
  cp_commit();
  float kbr[RM], dk[RM][NC], dv[RM][NC];
#pragma unroll
  for (int a = 0; a < RM; ++a) {
    const int j = j0 + pl.row(a);
    kbr[a] = !SP && j < T ? key_bias[(long long)b * T + j] * LOG2E : 0.f;
  }
  zero(dk);
  zero(dv);
  for (int t = 0; t < nq; ++t) {
    const int i0 = t * BC, slot = t & 1;
    const float* Qs = sm + S::Q + slot * BC * LD;
    const float* dOs = sm + S::DO + slot * BC * LD;
    cp_wait<0>();
    if (bq) {
      if (t == 0) {
        add_bias<BR>(Ks, LD, bq + L.bpart, j0, T, D, vec);
        add_bias<BR>(Vs, LD, bq + 2 * L.bpart, j0, T, D, vec);
      }
      add_bias<BC>(sm + S::Q + slot * BC * LD, LD, bq, i0, T, D, vec);
    }
    __syncthreads();  // query tile t landed and is biased; every thread is done with the last tile
    if (t + 1 < nq) issue(t + 1);
    cp_commit();
    float s[RM][NCOL], dp[RM][NCOL];
    if (!SP) score(s, Ks, Qs, LD, d4, pl);
    score(dp, Vs, dOs, LD, d4, pl);
    const float* st = sm + S::ST + slot * BC;
    const float* dlt = sm + S::DL + slot * BC;
    const bf16* pt = Pbs + slot * BC * LDPB;
#pragma unroll
    for (int A = 0; A < RM / 2; ++A)
#pragma unroll
      for (int C = 0; C < NCOL / 2; ++C) {
        const int j = j0 + pl.row(2 * A), i = i0 + pl.col(2 * C);  // rows are keys, columns queries
        const uint32_t bits = !dropout ? 15u : (i < T && j < T ? keep4(seed, bh, i, j, thr) : 0u);
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int f = 0; f < 2; ++f) {
            const int a = 2 * A + e, c = 2 * C + f;
            const bool ok = i + f < T && j + e < T;
            float p;
            if (SP)
              p = ok ? __bfloat162float(pt[pl.col(c) * LDPB + pl.row(a)]) : 0.f;
            else
              p = ok ? exp2f(fmaf(s[a][c], c1, kbr[a]) - st[pl.col(c)]) : 0.f;
            const bool kept = (bits >> ((f << 1) | e)) & 1u;
            const float d = kept ? dp[a][c] * inv : 0.f;
            dp[a][c] = p * (d - dlt[pl.col(c)]);  // dS^T (the scale goes on dK)
            s[a][c] = kept ? p * inv : 0.f;       // P_d^T
          }
      }
#pragma unroll
    for (int a = 0; a < RM; ++a)
#pragma unroll
      for (int c = 0; c < NCOL; c += 2) {
        *reinterpret_cast<float2*>(Xp + pl.row(a) * LDX + pl.col(c)) = make_float2(s[a][c], s[a][c + 1]);
        *reinterpret_cast<float2*>(Xs + pl.row(a) * LDX + pl.col(c)) = make_float2(dp[a][c], dp[a][c + 1]);
      }
    __syncthreads();  // P_d^T and dS^T whole
    product<NCOL, NC>(dv, Xp, dOs, LD, pl);
    product<NCOL, NC>(dk, Xs, Qs, LD, pl);
  }
#pragma unroll
  for (int a = 0; a < RM; ++a)
#pragma unroll
    for (int n = 0; n < NC; ++n) dk[a][n] *= scale;
  float* dk_out = dqkv + b * L.qb + h * L.qh + L.part;
  store_rows(dk_out, L.qt, dk, j0, T, D, vec, pl);
  store_rows(dk_out + L.part, L.qt, dv, j0, T, D, vec, pl);
  if (db_part) {
    float* part = db_part + ((long long)b * gridDim.x + blockIdx.x) * 3 * H * D + h * L.bh;
    col_sums(dk, j0, T, Xp, part + L.bpart, D, pl);
    col_sums(dv, j0, T, Xp, part + 2 * L.bpart, D, pl);
  }
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

// A tiled kernel (0 the forward: K13's (SP) or K1/K11's, 1 the dQ pass, 2
// the dK/dV pass) at padded head dim DP, its dynamic shared memory and
// threads.
template <int DP, bool SP>
const void* tiled_kernel(int which, size_t* bytes, int* threads) {
  *threads = NTH;
  switch (which) {
    case 0:
      *bytes = SP ? FwdSmem<DP>::BYTES : FwdSmem<DP>::K1_BYTES;
      return SP ? (const void*)attn_f32_tiled_sp_fwd_kernel<DP> : (const void*)attn_f32_tiled_fwd_kernel<DP>;
    case 1: *bytes = DqSmem<DP, SP>::BYTES; return (const void*)attn_f32_tiled_dq_kernel<DP, SP>;
    case 2: *bytes = DkvSmem<DP, SP>::BYTES; return (const void*)attn_f32_tiled_dkv_kernel<DP, SP>;
    default: return nullptr;
  }
}

// Kernel `which` (0 forward, 1 dQ pass, 2 dK/dV pass) at head dim D (1..128)
// its dynamic shared memory and threads: the forward of K1/K11 (not SP) or
// K13 (SP), the backward.
template <bool SP>
const void* kernel_at(int which, int D, size_t* bytes, int* threads) {
  if (D < 1 || D > MAX_D) return nullptr;
  switch (dp_of(D)) {
    case 16: return tiled_kernel<16, SP>(which, bytes, threads);
    case 64: return tiled_kernel<64, SP>(which, bytes, threads);
    default: return tiled_kernel<128, SP>(which, bytes, threads);
  }
}

template <bool SP>
cudaError_t prepare(int which, int D) {
  size_t bytes = 0;
  int threads = 0;
  const void* fn = kernel_at<SP>(which, D, &bytes, &threads);
  if (fn == nullptr) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int DP>
void fwd_at(const float* qkv, const float* qb, const float* key_bias, float* out, float* stats, int B, int T, int H,
            int D, Layout L, uint32_t seed, uint32_t thr, float inv, int dropout, float scale, cudaStream_t s) {
  attn_f32_tiled_fwd_kernel<DP><<<dim3(cdiv(T, BR), H, B), NTH, FwdSmem<DP>::K1_BYTES, s>>>(
      qkv, qb, key_bias, out, stats, T, H, D, L, seed, thr, inv, dropout, scale);
}

template <int DP>
void sp_fwd_at(const float* qkv, const float* key_bias, float* out, bf16* probs, int B, int T, int H, int D, int ldp,
               uint32_t seed, uint32_t thr, float inv, int dropout, float scale, cudaStream_t s) {
  attn_f32_tiled_sp_fwd_kernel<DP><<<dim3(cdiv(T, BR), H, B), NTH, FwdSmem<DP>::BYTES, s>>>(
      qkv, key_bias, out, probs, T, H, D, ldp, packed(T, H, D), seed, thr, inv, dropout, scale);
}

// Both passes; SP reads p from probs (ldp) and needs neither key_bias nor
// stats.
template <int DP, bool SP>
cudaError_t bwd_at(const float* qkv, const float* qb, const float* key_bias, const float* dout, const float* out,
                   const float* stats, const bf16* probs, int ldp, float* dqkv, float* db_part, float* delta, int B,
                   int T, int H, int D, Layout L, uint32_t seed, uint32_t thr, float inv, int dropout, float scale,
                   cudaStream_t s) {
  const dim3 grid(cdiv(T, BR), H, B);
  attn_f32_tiled_dq_kernel<DP, SP><<<grid, NTH, DqSmem<DP, SP>::BYTES, s>>>(
      qkv, qb, key_bias, dout, out, stats, probs, ldp, dqkv, db_part, delta, T, H, D, L, seed, thr, inv, dropout,
      scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_f32_tiled_dkv_kernel<DP, SP><<<grid, NTH, DkvSmem<DP, SP>::BYTES, s>>>(
      qkv, qb, key_bias, dout, stats, probs, ldp, delta, dqkv, db_part, T, H, D, L, seed, thr, inv, dropout, scale);
  return cudaGetLastError();
}

int info(const void* fn, size_t bytes, int threads, int which, int what, int D, cudaError_t (*prep)(int, int)) {
  if (fn == nullptr) return -1;
  if (what == 0 || what == 1) {
    cudaFuncAttributes attr;
    if (cudaFuncGetAttributes(&attr, fn) != cudaSuccess) return -1;
    return what == 0 ? attr.numRegs : (int)attr.localSizeBytes;
  }
  if (what == 2) return (int)bytes;
  if (what == 3) {
    int n = 0;
    if (prep(which, D) != cudaSuccess) return -1;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, threads, bytes) != cudaSuccess) return -1;
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
  auto* f = dp_of(D) == 16 ? fwd_at<16> : dp_of(D) == 64 ? fwd_at<64> : fwd_at<128>;
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
  auto* f = dp_of(D) == 16 ? bwd_at<16, SP> : dp_of(D) == 64 ? bwd_at<64, SP> : bwd_at<128, SP>;
  return (int)f(qkv, qb, key_bias, dout, out, stats, probs, ldp, dqkv, db_part, delta, B, T, H, D, L, seed, threshold,
                inv, dropout, scale, s);
}

template <bool SP>
int info_of(int which, int what, int D) {
  size_t bytes = 0;
  int threads = 0;
  const void* fn = kernel_at<SP>(which, D, &bytes, &threads);
  return info(fn, bytes, threads, which, what, D, prepare<SP>);
}

}  // namespace

// Kernel `which` (0 forward, 1 dQ pass, 2 dK/dV pass) at head dim D:
// `what` 0 its registers a thread, 1 its local (spill) bytes, 2 its dynamic
// shared memory, 3 its resident blocks per SM. -1 on an error or a D
// outside 1..128. K11/K12 run these kernels on their own strides.
extern "C" int vb_attn_f32_info(int which, int what, int D) { return info_of<false>(which, what, D); }

// The same of the save-probs kernels (K13/K14 in fp32).
extern "C" int vb_attn_f32_sp_info(int which, int what, int D) { return info_of<true>(which, what, D); }

// The tiling the wrapper sizes db_part with: 0 the rows of a backward
// block's tile (db_part holds ceil(T / that) rows a batch row). -1 otherwise.
extern "C" int vb_attn_f32_geometry(int which) { return which == 0 ? BR : -1; }

extern "C" int vb_attn_f32_fwd(const void* qkv, const void* qb, const void* key_bias, void* out, void* stats, int B,
                               int T, int H, int D, unsigned int seed, unsigned int threshold, float inv, int dropout,
                               float scale, void* stream) {
  return fwd(static_cast<const float*>(qkv), static_cast<const float*>(qb), static_cast<const float*>(key_bias),
             static_cast<float*>(out), static_cast<float*>(stats), B, T, H, D, packed(T, H, D), seed, threshold, inv,
             dropout, scale, static_cast<cudaStream_t>(stream));
}

// db_part [B, ceil(T / 64), H*3*D] and delta [B, H, T] are scratch the
// caller allocates.
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
// probs [B, H, T, ldp] bf16 storage of the [B, H, T, T] probabilities (ldp
// a multiple of 8, at least T).
extern "C" int vb_attn_f32_sp_fwd(const void* qkv, const void* key_bias, void* out, void* probs, int B, int T, int H,
                                  int D, int ldp, unsigned int seed, unsigned int threshold, float inv, int dropout,
                                  float scale, void* stream) {
  if (D < 1 || D > MAX_D || ldp < T || ldp % 8) return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare<true>(0, D);
  if (err != cudaSuccess) return (int)err;
  auto* f = dp_of(D) == 16 ? sp_fwd_at<16> : dp_of(D) == 64 ? sp_fwd_at<64> : sp_fwd_at<128>;
  f(static_cast<const float*>(qkv), static_cast<const float*>(key_bias), static_cast<float*>(out),
    static_cast<bf16*>(probs), B, T, H, D, ldp, seed, threshold, inv, dropout, scale,
    static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// K14 in fp32: dqkv [B, T, H*3*D] from the saved probabilities (row stride
// ldp, a multiple of 8); delta [B, H, T] is scratch.
extern "C" int vb_attn_f32_sp_bwd(const void* qkv, const void* probs, const void* dout, const void* out, void* dqkv,
                                  void* delta, int B, int T, int H, int D, int ldp, unsigned int seed,
                                  unsigned int threshold, float inv, int dropout, float scale, void* stream) {
  if (ldp < T || ldp % 8) return (int)cudaErrorInvalidValue;
  return bwd<true>(static_cast<const float*>(qkv), nullptr, nullptr, static_cast<const float*>(dout),
                   static_cast<const float*>(out), nullptr, static_cast<const bf16*>(probs), ldp,
                   static_cast<float*>(dqkv), nullptr, static_cast<float*>(delta), B, T, H, D, packed(T, H, D), seed,
                   threshold, inv, dropout, scale, static_cast<cudaStream_t>(stream));
}
