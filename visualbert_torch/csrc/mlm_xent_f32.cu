// K4, K5, K6 in fp32: the fused masked-LM softmax cross-entropy over the
// tied decoder on fp32 x and E, at any hidden width H. Replace, for fp32
// inputs, visualbert_tpu/ops/mlm_xent.py::_fwd_kernel (K4, :52),
// ::_dx_kernel (K5, :145) and ::_de_kernel (K6, :170).
//
// Function: mlm_xent.cu's contract in fp32. x [N, H], E [V, H], bias [V]
// and labels [N] int32 in [0, V); logits = x.E^T + bias with fp32 products
// and sums. The forward writes nll = lse - logits[label], lse and the
// first-max argmax; the backward, given lse and the cotangent g [N],
//   dx = g * ((p - onehot) . E)       [N, H]
//   dE = (g (p - onehot))^T . x       [V, H]
//   db = sum_rows g (p - onehot)      [V]
// with p = exp(logits - lse). No [N, V] tensor reaches device memory.
//
// Bound on the H100 at the main path's N = 3072, V = 30522, H = 768: one
// (K4) or two (K5, K6) N x V x H products of 144 GFLOP each, 2.1 / 4.3 ms at
// the 67 TFLOP/s of fp32 outside the tensor cores (E's 94 MB are 0.03 ms at
// 3.35 TB/s). wgmma's TF32 keeps a 10-bit mantissa and would not meet
// fp32's tolerance: these kernels are SIMT.
//
// Design: a register-blocked SIMT GEMM tile, so that one shared-memory load
// feeds several fused multiply-adds. A block of 256 threads owns a 128 x 256
// tile of logits (K4, K5: x rows by vocabulary rows; K6: vocabulary rows
// by x rows) and walks H in chunks of 8 columns through a ring of 3 slots
// an operand, filled by 4-byte cp.async (transposed on the way in, [8][128
// + 4] and [8][256 + 4], so that any H, N and V runs with no padding copy
// and the ragged tails load as zeros); one barrier a chunk. Each thread
// holds an 8 x 16 block of logits: per step of k it reads 2 + 4 float4 (a
// warp: 128 bytes of A, 64 of B) for 128 fused multiply-adds, where an 8 x
// 8 block reads 4 for 64. The bias, the online statistics and dlog are
// computed on those registers; the values of the tile's columns (K5: bias;
// K6: lse, label, g) and rows come from shared memory, so that no thread
// holds them beside its 128 logits.
// - K4: each thread keeps, per row of its 8, an online (max, sum of exp,
//   label logit, best index) over its columns, which ascend (strict > keeps
//   the first maximum; the max is the best value). The 4 lanes of a row
//   merge in a fixed butterfly and the four warps of a row in order, the
//   lower index winning on equal values; the block writes its split's
//   partials and f32_fwd_merge_kernel combines the splits in vocabulary
//   order.
// - K5 (grid: row blocks x vocabulary splits): per vocabulary tile the
//   logits, then dlog = p - onehot into a shared [256 vocab][128 + 4] tile;
//   the second product walks H in 128-column chunks, each the tile's dlog
//   times a 256 x 128 slab of E (16-row slices through a ring of three in
//   the same space, running on across chunks) into an 8 x 8 block of
//   results a thread (its own registers: the logits' are dead by then; an 8
//   x 16 block here spills), added to the block's fp32 partial of dx in
//   device memory (stored at the split's first tile). The block owns its
//   (rows, split) partial alone; f32_dx_reduce_kernel sums the splits in
//   order and scales by g.
// - K6 (grid: vocabulary blocks): the same with the roles swapped: per row
//   tile of x the logits E_b x_t^T, dlog times g, db summed over the tile
//   (lanes, then warps, in order) into a running sum in shared memory, and
//   dE accumulated in place (dE is fp32: its rows belong to this block
//   alone).
// Flops: the logits once (N V H fused multiply-adds) and the second product
// once, 2 N V H in K5 and K6: no logit is recomputed; the price is K5's and
// K6's read-modify-write of their 128-row partials once a 256-row tile, N
// H x 8 bytes a tile (2.25 GB at the main path).
// Every reduction runs in a fixed order (H ascending in a logit, the tile's
// rows ascending in a product, tiles ascending, fixed merges), nothing is
// atomic: two calls agree bit for bit.
// Switches for tools/xent_f32_steps.py (the library never defines them):
// VB_F32_NTH=128, 64-row tiles of 4 warps, two blocks an SM;
// VB_F32_STAGES, the ring's slots.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

#ifndef VB_F32_NTH
#define VB_F32_NTH 256
#endif
#ifndef VB_F32_STAGES
#define VB_F32_STAGES 3
#endif
constexpr int NTH = VB_F32_NTH;        // 8 warps, 2 x 4 over the tile, one block an SM (128: 4 warps, two)
constexpr int BLOCKS = 256 / NTH;      // blocks an SM
constexpr int BM = NTH / 2;            // tile rows: K4, K5 x rows; K6 vocabulary rows
constexpr int BN = 256;                // tile columns: K4, K5 vocabulary rows; K6 x rows
constexpr int TM = 8, TN = 16;         // a thread's logits: rows x columns
constexpr int PN = 128, PTN = 8;       // a second product's column chunk, a thread's columns of it
constexpr int PK = 16;                 // rows of a second product's slice
constexpr int BK = 8;                  // depth of a chunk of the logits
constexpr int STAGES = VB_F32_STAGES;  // ring slots of each operand: STAGES - 1 chunks in flight
constexpr int LDA = BM + 4;            // row of an A chunk [BK][LDA] and of the dlog tile [BN][LDA] (floats)
constexpr int LDB = BN + 4;            // row of a B chunk [BK][LDB]
constexpr int LDP = PN + 4;            // row of a product slice [PK][LDP]
constexpr int CA = BK * LDA, CB = BK * LDB, CP = PK * LDP;  // floats of a ring slot of A, of B, of a slice
static_assert(3 * CP <= STAGES * (CA + CB), "a product's ring of three slices fits in the logits' ring");
constexpr float LOG2E_F = 1.4426950408889634f;

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// shared memory: the ring (STAGES slots of A, then of B), then K4: the
// merge space of the four warps of a row (4 values a row); K5 / K6: the
// dlog tile, the merge space of K6's db, the block rows' values (K5: lse,
// label; K6: bias, db so far), the tile columns' values (K5: bias; K6:
// lse, label, g)
constexpr size_t SMEM_FWD = sizeof(float) * (STAGES * (CA + CB) + 4 * BM * 4);
constexpr size_t SMEM_BWD = sizeof(float) * (STAGES * (CA + CB) + BN * LDA + 6 * BM + 3 * BN);
static_assert(BLOCKS * (SMEM_BWD + 1024) <= 233472, "K5 / K6's blocks must fit an SM's shared memory");
static_assert(NTH >= BM, "a thread a row of the block's tile loads the rows' values");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 4 bytes, or zeros where !valid (src must still be a valid address)
__device__ __forceinline__ void cp4(uint32_t dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Chunk [k0, k0 + BK) of rows [r0, r0 + ROWS) of a row-major [nrows, H]
// matrix into dst[k][m] (transposed, row stride LDM); zero past nrows and
// past H. Thread t copies column t % BK of rows t / BK + (NTH / BK) i: a
// warp reads pieces of BK columns of 32 / BK rows.
template <int ROWS, int LDM>
__device__ __forceinline__ void load_t(float* dst, const float* __restrict__ src, int r0, int nrows, int k0, int H) {
  constexpr int RP = NTH / BK;  // rows a pass
  const int k = threadIdx.x % BK, m0 = threadIdx.x / BK;
  const bool kok = k0 + k < H;
  const uint32_t d = smem_addr(dst + k * LDM + m0);
  const float* p = src + (size_t)(r0 + m0) * H + k0 + k;
  const size_t step = (size_t)RP * H;
#pragma unroll
  for (int i = 0; i < ROWS / RP; ++i) {
    const bool ok = kok && r0 + m0 + RP * i < nrows;
    cp4(d + 4 * RP * i, ok ? p + i * step : src, ok);
  }
}

// Chunk [c0, c0 + PN) of rows [r0, r0 + PK) of a row-major [nrows, H]
// matrix into dst[k][n] (row stride LDP) as it lies; zero past nrows and
// past H. A warp reads 128 contiguous bytes of a row.
__device__ __forceinline__ void load_n(float* dst, const float* __restrict__ src, int r0, int nrows, int c0, int H) {
  constexpr int RP = NTH / PN;  // rows a pass
  const int n = threadIdx.x % PN, k0 = threadIdx.x / PN;
  const bool cok = c0 + n < H;
  const uint32_t d = smem_addr(dst + k0 * LDP + n);
  const float* p = src + (size_t)(r0 + k0) * H + c0 + n;
#pragma unroll
  for (int i = 0; i < PK / RP; ++i) {
    const bool ok = cok && r0 + k0 + RP * i < nrows;
    cp4(d + 4 * LDP * RP * i, ok ? p + (size_t)RP * i * H : src, ok);
  }
}

// This thread's place in a 128 x 256 tile of logits: warp w covers rows
// [64 (w / 4), +64) and columns [64 (w % 4), +64); lane (ty, tx) = (l / 4,
// l % 4) holds rows ra + {0..3, 32..35} and columns cb + {0..3, 16..19,
// 32..35, 48..51}, ascending with i and j. Per step of k a warp reads 128
// bytes of A and 64 of B (each thread 8 + 16 floats) for 128 fused
// multiply-adds a thread. In a second product's 128 x 128 chunk the warps
// are 32 columns apart and a thread holds the same rows and the columns pb
// + {0..3, 16..19}.
struct Place {
  int ra, cb, pb, wn;
  __device__ __forceinline__ Place() {
    const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
    wn = w & 3;
    ra = (w >> 2) * 64 + (l >> 2) * 4;
    cb = wn * 64 + (l & 3) * 4;
    pb = wn * 32 + (l & 3) * 4;
  }
  __device__ __forceinline__ int row(int i) const { return ra + (i & 3) + (i >> 2) * 32; }
  __device__ __forceinline__ int col(int j) const { return cb + (j & 3) + (j >> 2) * 16; }
};

template <int N>
__device__ __forceinline__ void zero(float (&acc)[TM][N]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) acc[i][j] = 0.f;
}

// acc[i][j] += sum_k A[k][ra + row i] B[k][cb + col j] over K steps, k
// ascending; A's rows LDA apart, B's LDM (N: 16 for the logits, 8 for a
// product).
template <int N, int LDM, int K>
__device__ __forceinline__ void fma_chunk(float (&acc)[TM][N], const float* A, const float* B, int ra, int cb) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float a[TM], b[N];
#pragma unroll
    for (int h = 0; h < TM / 4; ++h) {
      const float4 v = *reinterpret_cast<const float4*>(A + k * LDA + ra + 32 * h);
      a[4 * h] = v.x;
      a[4 * h + 1] = v.y;
      a[4 * h + 2] = v.z;
      a[4 * h + 3] = v.w;
    }
#pragma unroll
    for (int h = 0; h < N / 4; ++h) {
      const float4 v = *reinterpret_cast<const float4*>(B + k * LDM + cb + 16 * h);
      b[4 * h] = v.x;
      b[4 * h + 1] = v.y;
      b[4 * h + 2] = v.z;
      b[4 * h + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// The logits tile: acc[i][j] = sum_k R[r0 + row i][k] S[s0 + col j][k],
// R [nr, H] (the tile's rows), S [ns, H] (its columns), H walked in chunks
// of BK through the ring (sA, sB: STAGES slots each). One barrier a chunk,
// one at the end (the next pass refills the ring at once).
__device__ __forceinline__ void logits_tile(float (&acc)[TM][TN], float* sA, float* sB, const float* __restrict__ R,
                                            int r0, int nr, const float* __restrict__ S, int s0, int ns, int H,
                                            const Place& pl) {
  const int nk = cdiv(H, BK);
  auto issue = [&](int c) {
    load_t<BM, LDA>(sA + (c % STAGES) * CA, R, r0, nr, c * BK, H);
    load_t<BN, LDB>(sB + (c % STAGES) * CB, S, s0, ns, c * BK, H);
  };
  zero<TN>(acc);
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < nk) issue(c);
    cp_commit();
  }
  for (int c = 0; c < nk; ++c) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // chunk c landed in every thread's copies; every thread is done with chunk c - 1
    if (c + STAGES - 1 < nk) issue(c + STAGES - 1);
    cp_commit();
    fma_chunk<TN, LDB, BK>(acc, sA + (c % STAGES) * CA, sB + (c % STAGES) * CB, pl.ra, pl.cb);
  }
  __syncthreads();
}

// acc = out[(r0 + ra + row i) H + c0 + pb + col j] (0 where !add or outside
// nrows x H), all the loads issued before any is used; store_acc writes it
// back.
__device__ __forceinline__ void load_acc(float (&acc)[TM][PTN], const float* __restrict__ out, int r0, int nrows,
                                         int c0, int H, bool add, const Place& pl) {
  const bool vec = (H & 3) == 0;
  const float* o = out + (size_t)(r0 + pl.ra) * H + c0 + pl.pb;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int di = (i & 3) + (i >> 2) * 32;
    const bool rok = add && r0 + pl.ra + di < nrows;
#pragma unroll
    for (int h = 0; h < PTN / 4; ++h) {
      const int c = c0 + pl.pb + 16 * h;
      if (vec) {
        const float4 u = rok && c < H ? *reinterpret_cast<const float4*>(o + di * H + 16 * h)
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
        acc[i][4 * h] = u.x;
        acc[i][4 * h + 1] = u.y;
        acc[i][4 * h + 2] = u.z;
        acc[i][4 * h + 3] = u.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][4 * h + e] = rok && c + e < H ? o[di * H + 16 * h + e] : 0.f;
      }
    }
  }
}

__device__ __forceinline__ void store_acc(float* __restrict__ out, const float (&acc)[TM][PTN], int r0, int nrows,
                                          int c0, int H, const Place& pl) {
  const bool vec = (H & 3) == 0;  // 16-byte rows: a column group of 4 is in or out as one
  float* o = out + (size_t)(r0 + pl.ra) * H + c0 + pl.pb;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int di = (i & 3) + (i >> 2) * 32;
    if (r0 + pl.ra + di >= nrows) continue;
#pragma unroll
    for (int h = 0; h < PTN / 4; ++h) {
      const int c = c0 + pl.pb + 16 * h;
      if (vec) {
        if (c < H)
          *reinterpret_cast<float4*>(o + di * H + 16 * h) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < H) o[di * H + 16 * h + e] = acc[i][4 * h + e];
      }
    }
  }
}

// The second product, every column chunk of H in one pass of a ring of
// three slices (in the logits' ring space, sR): out[r0 + row][c0 + col]
// (+)= sum_k P[k][row] Q[q0 + k][c0 + col], k over the tile's BN columns
// (P, the dlog tile, in shared memory; Q [nq, H] streamed in PK-row slices
// of each PN-column chunk c0, the copies running on across chunks), an 8 x
// 8 block of results a thread. The block's rows of out (nrows of them,
// width H) are loaded at a chunk's first slice (where add) and stored
// after its last.
__device__ __forceinline__ void product(const float* P, float* sR, const float* __restrict__ Q, int q0, int nq,
                                        int H, float* __restrict__ out, int r0, int nrows, bool add,
                                        const Place& pl) {
  constexpr int kc = BN / PK;
  const int nsteps = cdiv(H, PN) * kc;
  auto issue = [&](int q) { load_n(sR + (q % 3) * CP, Q, q0 + (q % kc) * PK, nq, (q / kc) * PN, H); };
  float acc[TM][PTN];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    if (q < nsteps) issue(q);
    cp_commit();
  }
  for (int q = 0; q < nsteps; ++q) {
    const int c = q % kc, c0 = (q / kc) * PN;
    if (c == 0) load_acc(acc, out, r0, nrows, c0, H, add, pl);
    cp_wait<1>();
    __syncthreads();  // slice q landed (and, at q = 0, the dlog tile is whole); slice q - 1 is done with
    if (q + 2 < nsteps) issue(q + 2);
    cp_commit();
    fma_chunk<PTN, LDP, PK>(acc, P + c * PK * LDA, sR + (q % 3) * CP, pl.ra, pl.pb);
    if (c == kc - 1) store_acc(out, acc, r0, nrows, c0, H, pl);
  }
  __syncthreads();
}

// The dlog tile into P[col j][row i] (transposed: the second product's
// reduction runs over the tile's columns).
__device__ __forceinline__ void store_tile(float* P, const float (&d)[TM][TN], const Place& pl) {
#pragma unroll
  for (int j = 0; j < TN; ++j)
#pragma unroll
    for (int h = 0; h < TM / 4; ++h)
      *reinterpret_cast<float4*>(P + pl.col(j) * LDA + pl.ra + 32 * h) =
          make_float4(d[4 * h][j], d[4 * h + 1][j], d[4 * h + 2][j], d[4 * h + 3][j]);
}

__device__ __forceinline__ void lse_merge(float& m, float& l, float m2, float l2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;
  l = (m == -INFINITY ? 0.f : l * exp2f((m - mn) * LOG2E_F)) + (m2 == -INFINITY ? 0.f : l2 * exp2f((m2 - mn) * LOG2E_F));
  m = mn;
}

// merge (m2, l2, ll2, i2) into (m, l, ll, i): the max is the best value, the
// lower index wins on equal maxima
__device__ __forceinline__ void stats_merge(float& m, float& l, float& ll, int& bi, float m2, float l2, float ll2,
                                            int i2) {
  if (m2 > m || (m2 == m && i2 < bi)) bi = i2;
  lse_merge(m, l, m2, l2);
  ll += ll2;
}

// K4. grid (cdiv(N, BM), S): row blocks x vocabulary splits of `vbs`
// tiles of BN rows. Writes its split's partials pf [4][S][N] (max, sum of
// exp, label logit, best value) and pi [S][N] (best index).
__global__ void __launch_bounds__(NTH, BLOCKS)
f32_fwd_kernel(const float* __restrict__ x, const float* __restrict__ E, const float* __restrict__ bias,
               const int* __restrict__ labels, int N, int V, int H, int vbs, float* __restrict__ pf,
               int* __restrict__ pi) {
  extern __shared__ float4 smem4[];
  float* sA = reinterpret_cast<float*>(smem4);
  float* sB = sA + STAGES * CA;
  float* red = sB + STAGES * CB;  // [4 warps of a row][BM][4]
  const Place pl;
  const int r0 = blockIdx.x * BM, ntiles = cdiv(V, BN);
  const int t0 = blockIdx.y * vbs, t1 = min(ntiles, t0 + vbs);
  float m[TM], l[TM], ll[TM];
  int bi[TM], lab[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = r0 + pl.row(i);
    m[i] = -INFINITY;
    l[i] = ll[i] = 0.f;
    bi[i] = INT_MAX;
    lab[i] = row < N ? labels[row] : -1;
  }
  float acc[TM][TN];
  for (int t = t0; t < t1; ++t) {
    const int v0 = t * BN;
    logits_tile(acc, sA, sB, x, r0, N, E, v0, V, H, pl);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int v = v0 + pl.col(j);
      const float b = v < V ? bias[v] : 0.f;
#pragma unroll
      for (int i = 0; i < TM; ++i) acc[i][j] = v < V ? acc[i][j] + b : -INFINITY;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float tm = -INFINITY;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        tm = fmaxf(tm, acc[i][j]);
        if (v0 + pl.col(j) == lab[i]) ll[i] = acc[i][j];
      }
      if (tm == -INFINITY) continue;  // every column past V
      if (tm > m[i]) {
#pragma unroll
        for (int j = TN - 1; j >= 0; --j)
          if (acc[i][j] == tm) bi[i] = v0 + pl.col(j);
      }
      const float mn = fmaxf(m[i], tm);
      float sum = l[i] * exp2f((m[i] - mn) * LOG2E_F);  // m = -inf only while l = 0
#pragma unroll
      for (int j = 0; j < TN; ++j) sum += exp2f((acc[i][j] - mn) * LOG2E_F);
      l[i] = sum;
      m[i] = mn;
    }
  }
  // the 4 lanes of a row (tx: lane bits 0-1) in a butterfly, then the four
  // warps of a row in order
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[i], off), l2 = __shfl_xor_sync(0xffffffffu, l[i], off);
      const float ll2 = __shfl_xor_sync(0xffffffffu, ll[i], off);
      const int i2 = __shfl_xor_sync(0xffffffffu, bi[i], off);
      stats_merge(m[i], l[i], ll[i], bi[i], m2, l2, ll2, i2);
    }
    if ((threadIdx.x & 3) == 0) {
      float* o = red + (pl.wn * BM + pl.row(i)) * 4;
      o[0] = m[i];
      o[1] = l[i];
      o[2] = ll[i];
      reinterpret_cast<int*>(o)[3] = bi[i];
    }
  }
  __syncthreads();
  const int r = threadIdx.x, row = r0 + r;
  if (r < BM && row < N) {
    float mm = -INFINITY, ls = 0.f, lls = 0.f;
    int ii = INT_MAX;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float* o = red + (w * BM + r) * 4;
      stats_merge(mm, ls, lls, ii, o[0], o[1], o[2], reinterpret_cast<const int*>(o)[3]);
    }
    const size_t plane = (size_t)gridDim.y * N, at = (size_t)blockIdx.y * N + row;
    pf[at] = mm;
    pf[plane + at] = ls;
    pf[2 * plane + at] = lls;
    pf[3 * plane + at] = mm;
    pi[at] = ii;
  }
}

// One thread per row: combine the S splits in vocabulary order.
__global__ void f32_fwd_merge_kernel(const float* __restrict__ pf, const int* __restrict__ pi, int N, int S,
                                     float* __restrict__ nll, float* __restrict__ lse, int* __restrict__ am) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  const size_t plane = (size_t)S * N;
  float m = -INFINITY, l = 0.f, ll = 0.f;
  int bi = INT_MAX;
  for (int s = 0; s < S; ++s) {
    const size_t at = (size_t)s * N + row;
    stats_merge(m, l, ll, bi, pf[at], pf[plane + at], pf[2 * plane + at], pi[at]);
  }
  const float z = m + logf(l);
  lse[row] = z;
  nll[row] = z - ll;
  am[row] = bi;
}

// K5. grid (cdiv(N, BM), S): block (x, s) owns rows [x BM, x BM + BM) and
// the vocabulary tiles [s vbs, s vbs + vbs) of BN rows, and writes part[s]
// [N][H] of those rows.
__global__ void __launch_bounds__(NTH, BLOCKS)
f32_dx_kernel(const float* __restrict__ x, const float* __restrict__ E, const float* __restrict__ bias,
              const int* __restrict__ labels, const float* __restrict__ lse, int N, int V, int H, int vbs,
              float* __restrict__ part) {
  extern __shared__ float4 smem4[];
  float* sA = reinterpret_cast<float*>(smem4);
  float* sB = sA + STAGES * CA;
  float* P = sB + STAGES * CB;                 // [BN vocab][LDA]: the tile's dlog
  float* rl = P + BN * LDA + 4 * BM;           // [BM]: the rows' lse
  int* lab = reinterpret_cast<int*>(rl + BM);  // [BM]: their labels
  float* cb = rl + 2 * BM;                     // [BN]: the tile columns' bias
  const Place pl;
  const int r0 = blockIdx.x * BM, ntiles = cdiv(V, BN);
  const int t0 = blockIdx.y * vbs, t1 = min(ntiles, t0 + vbs);
  float* out = part + (size_t)blockIdx.y * N * H;
  if (threadIdx.x < BM) {  // read after the barriers of logits_tile
    const int row = r0 + threadIdx.x;
    rl[threadIdx.x] = row < N ? lse[row] : INFINITY;  // rows past N: p = 0
    lab[threadIdx.x] = row < N ? labels[row] : -1;
  }
  float acc[TM][TN];
  for (int t = t0; t < t1; ++t) {
    const int v0 = t * BN;
    for (int c = threadIdx.x; c < BN; c += NTH) {  // read after logits_tile's barriers; the last tile's
      const int v = v0 + c;                            // readers passed the product's
      cb[c] = v < V ? bias[v] : 0.f;
    }
    logits_tile(acc, sA, sB, x, r0, N, E, v0, V, H, pl);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int v = v0 + pl.col(j);
      const float b = cb[pl.col(j)];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = pl.row(i);
        acc[i][j] = v < V ? exp2f((acc[i][j] + b - rl[r]) * LOG2E_F) - (v == lab[r] ? 1.f : 0.f) : 0.f;
      }
    }
    store_tile(P, acc, pl);  // P's last readers passed the barriers of logits_tile
    product(P, sA, E, v0, V, H, out, r0, N, t > t0, pl);  // its first barrier also publishes P
  }
}

// dx[n, :] = g[n] * sum_s part[s, n, :], the splits summed in order.
__global__ void f32_dx_reduce_kernel(const float* __restrict__ part, const float* __restrict__ gr, int N, int H,
                                     int S, float* __restrict__ dx) {
  const size_t total = (size_t)N * H;
  for (size_t q = (size_t)blockIdx.x * blockDim.x + threadIdx.x; q < total; q += (size_t)gridDim.x * blockDim.x) {
    float sum = 0.f;
    for (int s = 0; s < S; ++s) sum += part[(size_t)s * total + q];
    dx[q] = sum * gr[q / H];
  }
}

// K6. grid cdiv(V, BM): block x owns vocabulary rows [x BM, x BM + BM),
// walks every row tile of x, and writes those rows of dE and db.
__global__ void __launch_bounds__(NTH, BLOCKS)
f32_de_kernel(const float* __restrict__ x, const float* __restrict__ E, const float* __restrict__ bias,
              const int* __restrict__ labels, const float* __restrict__ lse, const float* __restrict__ gr, int N,
              int V, int H, float* __restrict__ dE, float* __restrict__ db) {
  extern __shared__ float4 smem4[];
  float* sA = reinterpret_cast<float*>(smem4);
  float* sB = sA + STAGES * CA;
  float* P = sB + STAGES * CB;  // [BN x rows][LDA]: g dlog of the tile
  float* red = P + BN * LDA;    // [4 warps of a row][BM]: a tile's db by warp
  float* b = red + 4 * BM;      // [BM]: the rows' bias
  float* dbs = b + BM;          // [BM]: db over the tiles so far
  float* cz = dbs + BM;         // [3][BN]: the tile columns' lse, label, g
  const Place pl;
  const int v0 = blockIdx.x * BM, ntiles = max(1, cdiv(N, BN));
  if (threadIdx.x < BM) {  // read after logits_tile's barriers
    b[threadIdx.x] = v0 + (int)threadIdx.x < V ? bias[v0 + threadIdx.x] : 0.f;
    dbs[threadIdx.x] = 0.f;
  }
  float acc[TM][TN];
  for (int t = 0; t < ntiles; ++t) {
    const int n0 = t * BN;
    for (int c = threadIdx.x; c < BN; c += NTH) {  // read after logits_tile's barriers; the last tile's
      const int n = n0 + c;                            // readers passed the product's
      const bool ok = n < N;
      cz[c] = ok ? lse[n] : 0.f;
      cz[BN + c] = __int_as_float(ok ? labels[n] : -1);
      cz[2 * BN + c] = ok ? gr[n] : 0.f;
    }
    logits_tile(acc, sA, sB, E, v0, V, x, n0, N, H, pl);
    float dsum[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) dsum[i] = 0.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = pl.col(j);
      const bool ok = n0 + c < N;
      const float zl = cz[c], g = cz[2 * BN + c];
      const int lb = __float_as_int(cz[BN + c]);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int v = v0 + pl.row(i);
        const float d = ok && v < V ? (exp2f((acc[i][j] + b[pl.row(i)] - zl) * LOG2E_F) - (lb == v ? 1.f : 0.f)) * g
                                    : 0.f;
        acc[i][j] = d;
        dsum[i] += d;
      }
    }
    // the tile's db: the 4 lanes of a row in a butterfly, then the four
    // warps of a row in order, added to the running db
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) dsum[i] += __shfl_xor_sync(0xffffffffu, dsum[i], off);
      if ((threadIdx.x & 3) == 0) red[pl.wn * BM + pl.row(i)] = dsum[i];
    }
    store_tile(P, acc, pl);
    __syncthreads();
    if (threadIdx.x < BM) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) sum += red[w * BM + threadIdx.x];
      dbs[threadIdx.x] += sum;
    }
    product(P, sA, x, n0, N, H, dE, v0, V, t > 0, pl);
  }
  if (threadIdx.x < BM && v0 + (int)threadIdx.x < V) db[v0 + threadIdx.x] = dbs[threadIdx.x];
}

const void* kernel_of(int kernel) {
  switch (kernel) {
    case 0: return (const void*)f32_dx_kernel;
    case 1: return (const void*)f32_de_kernel;
    case 2: return (const void*)f32_fwd_kernel;
    default: return nullptr;
  }
}

size_t smem_of(int kernel) { return kernel == 2 ? SMEM_FWD : SMEM_BWD; }

cudaError_t set_smem(const void* fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// The tiling the wrapper plans the grids with: 0 the rows of a block's
// tile (K4, K5: x rows; K6: vocabulary rows), 1 the vocabulary rows of a
// K4 / K5 tile (a split is a run of them). -1 otherwise.
extern "C" int vb_xent_f32_geometry(int which) { return which == 0 ? BM : which == 1 ? BN : -1; }

// K5 (kernel 0), K6 (kernel 1) or K4 (kernel 2), at any width H >= 1:
// `what` 0 its registers a thread, 1 its local (spill) bytes a thread, 2 its
// dynamic shared memory, 3 its resident blocks per SM. -1 on an error.
extern "C" int vb_xent_f32_info(int kernel, int what, int H) {
  const void* fn = kernel_of(kernel);
  if (fn == nullptr || H < 1) return -1;
  const size_t bytes = smem_of(kernel);
  if (what == 0 || what == 1) {
    cudaFuncAttributes attr;
    if (cudaFuncGetAttributes(&attr, fn) != cudaSuccess) return -1;
    return what == 0 ? attr.numRegs : (int)attr.localSizeBytes;
  }
  if (what == 2) return (int)bytes;
  if (what == 3) {
    int n = 0;
    if (set_smem(fn, bytes) != cudaSuccess) return -1;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, NTH, bytes) != cudaSuccess) return -1;
    return n;
  }
  return -1;
}

// pf [4][S][N] fp32 and pi [S][N] int32 are scratch the caller allocates: S
// vocabulary splits of vbs tiles each.
extern "C" int vb_xent_f32_fwd(const void* x, const void* E, const void* bias, const void* labels, int N, int V,
                               int H, int S, int vbs, void* pf, void* pi, void* nll, void* lse, void* am,
                               void* stream) {
  if (H < 1 || S < 1 || vbs < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = set_smem((const void*)f32_fwd_kernel, SMEM_FWD);
  if (err != cudaSuccess) return (int)err;
  f32_fwd_kernel<<<dim3(cdiv(N, BM), S), NTH, SMEM_FWD, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(E), static_cast<const float*>(bias),
      static_cast<const int*>(labels), N, V, H, vbs, static_cast<float*>(pf), static_cast<int*>(pi));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  f32_fwd_merge_kernel<<<cdiv(N, 128), 128, 0, st>>>(static_cast<const float*>(pf), static_cast<const int*>(pi), N,
                                                      S, static_cast<float*>(nll), static_cast<float*>(lse),
                                                      static_cast<int*>(am));
  return (int)cudaGetLastError();
}

// part [S][N][H] fp32 is scratch the caller allocates: S vocabulary splits
// of vbs tiles each.
extern "C" int vb_xent_f32_dx(const void* x, const void* E, const void* bias, const void* labels, const void* lse,
                              const void* g, int N, int V, int H, int S, int vbs, void* part, void* dx,
                              void* stream) {
  if (H < 1 || S < 1 || vbs < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = set_smem((const void*)f32_dx_kernel, SMEM_BWD);
  if (err != cudaSuccess) return (int)err;
  f32_dx_kernel<<<dim3(cdiv(N, BM), S), NTH, SMEM_BWD, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(E), static_cast<const float*>(bias),
      static_cast<const int*>(labels), static_cast<const float*>(lse), N, V, H, vbs, static_cast<float*>(part));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)N * H;
  const int blocks = (int)(total / 256 + 1 < 4096 ? total / 256 + 1 : 4096);
  f32_dx_reduce_kernel<<<blocks, 256, 0, st>>>(static_cast<const float*>(part), static_cast<const float*>(g), N, H,
                                               S, static_cast<float*>(dx));
  return (int)cudaGetLastError();
}

extern "C" int vb_xent_f32_de(const void* x, const void* E, const void* bias, const void* labels, const void* lse,
                              const void* g, int N, int V, int H, void* dE, void* db, void* stream) {
  if (H < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem((const void*)f32_de_kernel, SMEM_BWD);
  if (err != cudaSuccess) return (int)err;
  f32_de_kernel<<<cdiv(V, BM), NTH, SMEM_BWD, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(E), static_cast<const float*>(bias),
      static_cast<const int*>(labels), static_cast<const float*>(lse), static_cast<const float*>(g), N, V, H,
      static_cast<float*>(dE), static_cast<float*>(db));
  return (int)cudaGetLastError();
}
