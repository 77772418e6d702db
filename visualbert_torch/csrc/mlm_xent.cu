// K4, K5, K6: the fused masked-LM softmax cross-entropy over the tied
// decoder. Replace visualbert_tpu/ops/mlm_xent.py::_fwd_kernel (K4),
// ::_dx_kernel (K5) and ::_de_kernel (K6), reached through mlm_xent.
//
// Inputs, at hidden width HID of 768 (bert-base) or 1024 (bert-large), one
// instantiation each: x [N, HID] bf16 (the MLM transform's output rows), E [V, HID] bf16
// (the word-embedding table in the compute dtype, as the decoder weight),
// bias [V] fp32, labels [N] int32 in [0, V) (the caller maps -1 to 0 and
// masks those rows), and for the backward lse [N] fp32 and the cotangent
// g [N] fp32 of the per-row nll. logits = x.E^T + bias are bf16 products
// accumulated in fp32 plus the fp32 bias. The forward writes nll = lse -
// logits[label], lse and the first-max argmax; the backward writes
//   dx = bf16(g * (bf16(p - onehot) . E))             [N, HID] bf16
//   dE = bf16(sum_rows bf16(g * (p - onehot))^T . x)  [V, HID] bf16
//   db = sum_rows g * (p - onehot)                     [V] fp32
// with p = exp(logits - lse): dlog is rounded to bf16 before each product,
// as the JAX kernels do. No [N, V] tensor is ever written to device memory:
// each kernel recomputes its logits tile in registers.
//
// Bound on the H100. At the main path's N = 128 * 24 = 3072 rows, V = 30522
// and HID = 768 each of the five N x V x HID products (K4: 1, K5: 2, K6: 2)
// is 144 GFLOP, against 4.7 MB of x and 47 MB of E: all three kernels are
// bound by math. This first version uses mma.sync m16n8k16 with fragments
// read 32 bits at a time from padded shared memory (rows 4 banks apart, no
// bank conflicts; no ldmatrix, cp.async, TMA or wgmma), and loads each tile
// synchronously: right and simple first.
//
// What the TPU kernels keep in VMEM does not fit an SM (227 KB of shared
// memory, 255 registers a thread), and an H100 runs its blocks in parallel
// in no order, where the TPU runs its grid in sequence. So:
// - K4 splits the vocabulary across blocks as well as the rows (one block of
//   8 warps per 64 rows x one vocabulary split): at N = 3072 a row split
//   alone gives 48 blocks for 132 SMs. Each block writes, per row, its
//   partial (max, sum of exp, label logit, best value, best index); a merge
//   kernel combines the splits in vocabulary order, so on equal values the
//   lower index wins (first-max, as the TPU kernel and torch.argmax).
// - K5's fp32 [rows, 768] accumulator, resident across the whole vocabulary
//   loop on the TPU (2.4 MB at 768 rows), is cut to 32 rows per block (96
//   fp32 registers a thread over 8 warps). To keep enough blocks in flight
//   the vocabulary is split as well, and each block writes an fp32 partial
//   dx of its split; a second kernel sums the partials in split order,
//   scales by g and rounds. Nothing is recomputed beyond the logits tile the
//   TPU kernel recomputes too; the partials cost S * N * HID * 4 bytes.
// - K6: each block owns 32 vocabulary rows of dE (all 768 columns, in
//   registers) and of db, and walks over every row block itself. No atomics
//   and no partials: the result does not depend on the order blocks run in.
// - Ragged edges (V = 30522 is not a multiple of 64, N need not be either)
//   are masked here: rows of x and E past the end are zero in shared memory,
//   columns past V take no part in the max, the sum or the argmax, rows past
//   N are never stored. E is read in place; it is never copied to a padded
//   30720-row tensor.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

using vb::bf16;
using vb::load_a;
using vb::load_b_cols;
using vb::load_b_rows;
using vb::mma16816;
using vb::pack_bf16;

constexpr int NTHREADS = 256;     // 8 warps
constexpr int VB = 64;            // vocabulary rows per logits tile (K4, K5)
constexpr int DX_ROWS = 32;       // K5 rows per block
constexpr int DE_ROWS = 64;       // K6 rows per step of its row loop
constexpr int DE_VOCAB = 32;      // K6 vocabulary rows per block
constexpr int LDD = 64 + 8;       // row stride of the bf16 dlog tiles

// The tiling at hidden width HID (768, bert-base, and 1024, bert-large; the
// wrapper checks). Shared memory holds [rows, HID] tiles with a padded row
// stride: K4's 64 x-rows and 64 vocabulary rows fit at 768 (198 KB) but not
// at 1024 (264 KB of 227), so K4 takes 32 rows a block there.
template <int HID>
struct Geo {
  static constexpr int LDH = HID + 8;                   // padded row stride of [*, HID] tiles (elements)
  static constexpr int KSTEPS = HID / 16;               // k-steps of a logits product
  static constexpr int FWD_ROWS = HID <= 768 ? 64 : 32;  // K4 rows per block
  static constexpr int FWD_MT = FWD_ROWS / 32;          // K4 m16 tiles per warp (2 x 4 warps)
  static constexpr int HW = HID / 8;                    // dx / dE columns owned by each warp (96, 128)
  static constexpr int HT = HW / 8;                     // ... in n8 tiles (12, 16)
};

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// Copy rows [r0, r0 + nrows) of a [nvalid, HID] bf16 matrix into shared
// memory with row stride LDH; rows past nvalid are zero.
template <int HID>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* __restrict__ src, int r0, int nrows,
                                          int nvalid) {
  constexpr int VEC = HID / 8, LDH = Geo<HID>::LDH;  // 16-byte vectors per row
  for (int idx = threadIdx.x; idx < nrows * VEC; idx += NTHREADS) {
    const int r = idx / VEC, c = (idx % VEC) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < nvalid) v = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * HID + c);
    *reinterpret_cast<uint4*>(dst + r * LDH + c) = v;
  }
}

// One warp's logits tile: C[MT m16 tiles][NT n8 tiles] = A[a0 + ..] . B[b0 + ..]^T
// over K = HID, both operands row-major [*, HID] in shared memory.
template <int HID, int MT, int NT>
__device__ __forceinline__ void logits_tile(float c[MT][NT][4], const bf16* A, int a0, const bf16* B, int b0,
                                            int g, int tq) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) c[i][j][0] = c[i][j][1] = c[i][j][2] = c[i][j][3] = 0.f;
  constexpr int LDH = Geo<HID>::LDH;
#pragma unroll 4
  for (int kk = 0; kk < Geo<HID>::KSTEPS; ++kk) {
    uint32_t a[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) load_a<LDH>(a[i], A, a0 + 16 * i, kk * 16, g, tq);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t b0r, b1r;
      load_b_rows<LDH>(b0r, b1r, B, b0 + 8 * j, kk * 16, g, tq);
#pragma unroll
      for (int i = 0; i < MT; ++i) mma16816(c[i][j], a[i], b0r, b1r);
    }
  }
}

// Online (max, sum of exp) merge of (m2, l2) into (m, l); -inf means empty.
__device__ __forceinline__ void lse_merge(float& m, float& l, float m2, float l2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;
  l = (m == -INFINITY ? 0.f : l * expf(m - mn)) + (m2 == -INFINITY ? 0.f : l2 * expf(m2 - mn));
  m = mn;
}

// First-max merge: the larger value wins; on equal values, the lower index.
__device__ __forceinline__ void argmax_merge(float& bv, int& bi, float v2, int i2) {
  if (v2 > bv || (v2 == bv && i2 < bi)) {
    bv = v2;
    bi = i2;
  }
}

// ------------------------------------------------------------------ K4

// grid (cdiv(N, FWD_ROWS), S): rows x vocabulary splits of `vbs` tiles of
// 64. Partials: pf [4][S][N] fp32 (max, sum of exp, label logit, best
// value), pi [S][N] int32 (best index).
template <int HID>
__global__ void __launch_bounds__(NTHREADS, 1)
xent_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ E, const float* __restrict__ bias,
                const int* __restrict__ labels, int N, int V, int vbs, float* __restrict__ pf,
                int* __restrict__ pi) {
  constexpr int LDH = Geo<HID>::LDH, FWD_ROWS = Geo<HID>::FWD_ROWS, MT = Geo<HID>::FWD_MT, RW = FWD_ROWS / 2;
  constexpr int NR = 2 * MT;  // rows a thread holds
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Xs = reinterpret_cast<bf16*>(smem);          // [FWD_ROWS][LDH]
  bf16* Es = Xs + FWD_ROWS * LDH;                    // [VB][LDH]
  float* bias_s = reinterpret_cast<float*>(Es + VB * LDH);  // [VB]
  int* lab_s = reinterpret_cast<int*>(bias_s + VB);  // [FWD_ROWS]
  float* red = reinterpret_cast<float*>(lab_s + FWD_ROWS);  // [4 warp columns][FWD_ROWS][5]: m, l, ll, bv, bi (int)

  const int rb = blockIdx.x, s = blockIdx.y, S = gridDim.y;
  const int row0 = rb * FWD_ROWS;
  const int nvb = cdiv(V, VB);
  const int vb0 = s * vbs, vb1 = min(nvb, vb0 + vbs);

  load_rows<HID>(Xs, x, row0, FWD_ROWS, N);
  for (int r = threadIdx.x; r < FWD_ROWS; r += NTHREADS) lab_s[r] = row0 + r < N ? labels[row0 + r] : -1;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps over a FWD_ROWS x 64 tile: RW rows x 16 columns each

  // per-thread state of its NR rows (m-tile i, half h -> r = 2 i + h)
  float m[NR], l[NR], ll[NR], bv[NR];
  int bi[NR], lab[NR];
  __syncthreads();
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
    ll[r] = 0.f;
    bv[r] = -INFINITY;
    bi[r] = INT_MAX;
    lab[r] = lab_s[wm * RW + (r >> 1) * 16 + g + 8 * (r & 1)];
  }

  for (int vb = vb0; vb < vb1; ++vb) {
    const int v0 = vb * VB;
    __syncthreads();  // the previous tile is consumed
    load_rows<HID>(Es, E, v0, VB, V);
    for (int c = threadIdx.x; c < VB; c += NTHREADS) bias_s[c] = v0 + c < V ? bias[v0 + c] : 0.f;
    __syncthreads();

    float c[MT][2][4];
    logits_tile<HID, MT, 2>(c, Xs, wm * RW, Es, wn * 16, g, tq);

#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int i = r >> 1, h = r & 1;
      float tm = -INFINITY;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int lc = wn * 16 + j * 8 + 2 * tq + e, col = v0 + lc;
          float& z = c[i][j][2 * h + e];
          if (col < V) {
            z += bias_s[lc];
            tm = fmaxf(tm, z);
            if (col == lab[r]) ll[r] += z;
            if (z > bv[r]) {  // columns ascend within the thread: strict > keeps the first
              bv[r] = z;
              bi[r] = col;
            }
          } else {
            z = -INFINITY;
          }
        }
      if (tm == -INFINITY) continue;
      const float mn = fmaxf(m[r], tm);
      float acc = l[r] * expf(m[r] - mn);  // m = -inf only while l = 0
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float z = c[i][j][2 * h + e];
          if (z != -INFINITY) acc += expf(z - mn);
        }
      l[r] = acc;
      m[r] = mn;
    }
  }

  // merge the 4 threads of a row (tq), then the 4 warp columns (wn)
#pragma unroll
  for (int r = 0; r < NR; ++r) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[r], off), l2 = __shfl_xor_sync(0xffffffffu, l[r], off);
      const float ll2 = __shfl_xor_sync(0xffffffffu, ll[r], off), v2 = __shfl_xor_sync(0xffffffffu, bv[r], off);
      const int i2 = __shfl_xor_sync(0xffffffffu, bi[r], off);
      lse_merge(m[r], l[r], m2, l2);
      ll[r] += ll2;
      argmax_merge(bv[r], bi[r], v2, i2);
    }
    if (tq == 0) {
      float* o = red + ((size_t)wn * FWD_ROWS + wm * RW + (r >> 1) * 16 + g + 8 * (r & 1)) * 5;
      o[0] = m[r];
      o[1] = l[r];
      o[2] = ll[r];
      o[3] = bv[r];
      reinterpret_cast<int*>(o)[4] = bi[r];
    }
  }
  __syncthreads();
  if (threadIdx.x < FWD_ROWS) {
    const int r = threadIdx.x, row = row0 + r;
    float mm = -INFINITY, sl = 0.f, sll = 0.f, best = -INFINITY;
    int besti = INT_MAX;
    for (int w = 0; w < 4; ++w) {
      const float* o = red + ((size_t)w * FWD_ROWS + r) * 5;
      lse_merge(mm, sl, o[0], o[1]);
      sll += o[2];
      argmax_merge(best, besti, o[3], reinterpret_cast<const int*>(o)[4]);
    }
    if (row < N) {
      const size_t at = (size_t)s * N + row, plane = (size_t)S * N;
      pf[at] = mm;
      pf[plane + at] = sl;
      pf[2 * plane + at] = sll;
      pf[3 * plane + at] = best;
      pi[at] = besti;
    }
  }
}

// One thread per row: combine the S splits in vocabulary order.
__global__ void xent_fwd_merge_kernel(const float* __restrict__ pf, const int* __restrict__ pi, int N, int S,
                                      float* __restrict__ nll, float* __restrict__ lse, int* __restrict__ am) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  const size_t plane = (size_t)S * N;
  float m = -INFINITY, l = 0.f, ll = 0.f, bv = -INFINITY;
  int bi = INT_MAX;
  for (int s = 0; s < S; ++s) {
    const size_t at = (size_t)s * N + row;
    lse_merge(m, l, pf[at], pf[plane + at]);
    ll += pf[2 * plane + at];
    argmax_merge(bv, bi, pf[3 * plane + at], pi[at]);
  }
  const float z = m + logf(l);
  lse[row] = z;
  nll[row] = z - ll;
  am[row] = bi;
}

// ------------------------------------------------------------------ K5

// grid (cdiv(N, 32), S): rows x vocabulary splits. part [S][N][HID] fp32.
template <int HID>
__global__ void __launch_bounds__(NTHREADS, 1)
xent_dx_kernel(const bf16* __restrict__ x, const bf16* __restrict__ E, const float* __restrict__ bias,
               const int* __restrict__ labels, const float* __restrict__ lse, int N, int V, int vbs,
               float* __restrict__ part) {
  constexpr int LDH = Geo<HID>::LDH, HW = Geo<HID>::HW, HT = Geo<HID>::HT;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Xs = reinterpret_cast<bf16*>(smem);  // [DX_ROWS][LDH]
  bf16* Es = Xs + DX_ROWS * LDH;             // [VB][LDH]
  bf16* Ds = Es + VB * LDH;                  // [DX_ROWS][LDD] bf16(p - onehot)
  float* bias_s = reinterpret_cast<float*>(Ds + DX_ROWS * LDD);  // [VB]
  float* lse_s = bias_s + VB;                // [DX_ROWS]
  int* lab_s = reinterpret_cast<int*>(lse_s + DX_ROWS);  // [DX_ROWS]

  const int rb = blockIdx.x, s = blockIdx.y;
  const int row0 = rb * DX_ROWS;
  const int nvb = cdiv(V, VB);
  const int vb0 = s * vbs, vb1 = min(nvb, vb0 + vbs);

  load_rows<HID>(Xs, x, row0, DX_ROWS, N);
  for (int r = threadIdx.x; r < DX_ROWS; r += NTHREADS) {
    const bool ok = row0 + r < N;
    lse_s[r] = ok ? lse[row0 + r] : INFINITY;  // padded rows: p = 0
    lab_s[r] = ok ? labels[row0 + r] : -1;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // logits: 2 x 4 warps over 32 x 64, 16 x 16 each

  float acc[2][HT][4];  // dx partial, rows 0..31, columns warp * HW ..
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < HT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int vb = vb0; vb < vb1; ++vb) {
    const int v0 = vb * VB;
    __syncthreads();  // Es and Ds are consumed
    load_rows<HID>(Es, E, v0, VB, V);
    for (int c = threadIdx.x; c < VB; c += NTHREADS) bias_s[c] = v0 + c < V ? bias[v0 + c] : 0.f;
    __syncthreads();

    float c[1][2][4];
    logits_tile<HID, 1, 2>(c, Xs, wm * 16, Es, wn * 16, g, tq);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int lr = wm * 16 + g + 8 * (q >> 1), lc = wn * 16 + j * 8 + 2 * tq + (q & 1), col = v0 + lc;
        float d = 0.f;
        if (col < V) d = expf(c[0][j][q] + bias_s[lc] - lse_s[lr]) - (col == lab_s[lr] ? 1.f : 0.f);
        Ds[lr * LDD + lc] = __float2bfloat16(d);
      }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < VB / 16; ++kk) {
      uint32_t a[2][4];
      load_a<LDD>(a[0], Ds, 0, kk * 16, g, tq);
      load_a<LDD>(a[1], Ds, 16, kk * 16, g, tq);
#pragma unroll
      for (int j = 0; j < HT; ++j) {
        uint32_t b0, b1;
        load_b_cols<LDH>(b0, b1, Es, kk * 16, warp * HW + j * 8, g, tq);
        mma16816(acc[0][j], a[0], b0, b1);
        mma16816(acc[1][j], a[1], b0, b1);
      }
    }
  }

  float* dst = part + (size_t)blockIdx.y * N * HID;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + i * 16 + g + 8 * h;
      if (row >= N) continue;
#pragma unroll
      for (int j = 0; j < HT; ++j)
        *reinterpret_cast<float2*>(dst + (size_t)row * HID + warp * HW + j * 8 + 2 * tq) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
    }
}

// dx[n, :] = bf16(g[n] * sum_s part[s, n, :]), the splits summed in order.
template <int HID>
__global__ void xent_dx_reduce_kernel(const float* __restrict__ part, const float* __restrict__ gr, int N,
                                      int S, bf16* __restrict__ dx) {
  const size_t total = (size_t)N * HID / 4;
  for (size_t q = (size_t)blockIdx.x * blockDim.x + threadIdx.x; q < total; q += (size_t)gridDim.x * blockDim.x) {
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < S; ++s) {
      const float4 v = reinterpret_cast<const float4*>(part + (size_t)s * N * HID)[q];
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    const float gn = gr[q * 4 / HID];
    uint2 out;
    out.x = pack_bf16(sum.x * gn, sum.y * gn);
    out.y = pack_bf16(sum.z * gn, sum.w * gn);
    reinterpret_cast<uint2*>(dx)[q] = out;
  }
}

// ------------------------------------------------------------------ K6

// grid (cdiv(V, 32)): each block owns 32 vocabulary rows of dE and db.
template <int HID>
__global__ void __launch_bounds__(NTHREADS, 1)
xent_de_kernel(const bf16* __restrict__ x, const bf16* __restrict__ E, const float* __restrict__ bias,
               const int* __restrict__ labels, const float* __restrict__ lse, const float* __restrict__ gr,
               int N, int V, bf16* __restrict__ dE, float* __restrict__ db) {
  constexpr int LDH = Geo<HID>::LDH, HW = Geo<HID>::HW, HT = Geo<HID>::HT;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Es = reinterpret_cast<bf16*>(smem);  // [DE_VOCAB][LDH]
  bf16* Xs = Es + DE_VOCAB * LDH;            // [DE_ROWS][LDH]
  bf16* Dt = Xs + DE_ROWS * LDH;             // [DE_VOCAB][LDD] bf16(g * (p - onehot)), transposed
  float* bias_s = reinterpret_cast<float*>(Dt + DE_VOCAB * LDD);  // [DE_VOCAB]
  float* lse_s = bias_s + DE_VOCAB;          // [DE_ROWS]
  float* g_s = lse_s + DE_ROWS;              // [DE_ROWS]
  int* lab_s = reinterpret_cast<int*>(g_s + DE_ROWS);  // [DE_ROWS]
  float* red = reinterpret_cast<float*>(lab_s + DE_ROWS);  // [4 m-tiles][DE_VOCAB]

  const int v0 = blockIdx.x * DE_VOCAB;
  load_rows<HID>(Es, E, v0, DE_VOCAB, V);
  for (int c = threadIdx.x; c < DE_VOCAB; c += NTHREADS) bias_s[c] = v0 + c < V ? bias[v0 + c] : 0.f;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;  // logits: 4 x 2 warps over 64 x 32, 16 x 16 each

  float acc[2][HT][4];  // dE rows 0..31, columns warp * HW ..
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < HT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  float db_acc = 0.f;  // thread c < DE_VOCAB: db of column c

  for (int row0 = 0; row0 < N; row0 += DE_ROWS) {
    __syncthreads();  // Xs, Dt and red are consumed
    load_rows<HID>(Xs, x, row0, DE_ROWS, N);
    for (int r = threadIdx.x; r < DE_ROWS; r += NTHREADS) {
      const bool ok = row0 + r < N;
      lse_s[r] = ok ? lse[row0 + r] : INFINITY;  // padded rows: p = 0 and g = 0
      g_s[r] = ok ? gr[row0 + r] : 0.f;
      lab_s[r] = ok ? labels[row0 + r] : -1;
    }
    __syncthreads();

    float c[1][2][4];
    logits_tile<HID, 1, 2>(c, Xs, wm * 16, Es, wn * 16, g, tq);
    float colsum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int lr = wm * 16 + g + 8 * (q >> 1), lc = wn * 16 + j * 8 + 2 * tq + (q & 1), col = v0 + lc;
        float d = 0.f;
        if (col < V)
          d = (expf(c[0][j][q] + bias_s[lc] - lse_s[lr]) - (col == lab_s[lr] ? 1.f : 0.f)) * g_s[lr];
        colsum[j][q & 1] += d;
        Dt[lc * LDD + lr] = __float2bfloat16(d);
      }
    // db: column sums over the warp's 16 rows (the 8 g lanes), then over the 4 m-tile warps
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = colsum[j][e];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (g == 0) red[wm * DE_VOCAB + wn * 16 + j * 8 + 2 * tq + e] = v;
      }
    __syncthreads();
    if (threadIdx.x < DE_VOCAB) {
      const int cl = threadIdx.x;
      db_acc += red[cl] + red[DE_VOCAB + cl] + red[2 * DE_VOCAB + cl] + red[3 * DE_VOCAB + cl];
    }

#pragma unroll
    for (int kk = 0; kk < DE_ROWS / 16; ++kk) {
      uint32_t a[2][4];
      load_a<LDD>(a[0], Dt, 0, kk * 16, g, tq);
      load_a<LDD>(a[1], Dt, 16, kk * 16, g, tq);
#pragma unroll
      for (int j = 0; j < HT; ++j) {
        uint32_t b0, b1;
        load_b_cols<LDH>(b0, b1, Xs, kk * 16, warp * HW + j * 8, g, tq);
        mma16816(acc[0][j], a[0], b0, b1);
        mma16816(acc[1][j], a[1], b0, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int v = v0 + i * 16 + g + 8 * h;
      if (v >= V) continue;
#pragma unroll
      for (int j = 0; j < HT; ++j)
        *reinterpret_cast<uint32_t*>(dE + (size_t)v * HID + warp * HW + j * 8 + 2 * tq) =
            pack_bf16(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
    }
  if (threadIdx.x < DE_VOCAB && v0 + threadIdx.x < V) db[v0 + threadIdx.x] = db_acc;
}

template <int HID>
constexpr size_t fwd_smem() {
  constexpr int LDH = Geo<HID>::LDH, FWD_ROWS = Geo<HID>::FWD_ROWS;
  return (size_t)(FWD_ROWS + VB) * LDH * sizeof(bf16) + VB * sizeof(float) + FWD_ROWS * sizeof(int) +
         4 * FWD_ROWS * 5 * sizeof(float);
}
template <int HID>
constexpr size_t dx_smem() {
  return (size_t)(DX_ROWS + VB) * Geo<HID>::LDH * sizeof(bf16) + DX_ROWS * LDD * sizeof(bf16) +
         VB * sizeof(float) + DX_ROWS * (sizeof(float) + sizeof(int));
}
template <int HID>
constexpr size_t de_smem() {
  return (size_t)(DE_VOCAB + DE_ROWS) * Geo<HID>::LDH * sizeof(bf16) + DE_VOCAB * LDD * sizeof(bf16) +
         DE_VOCAB * sizeof(float) + DE_ROWS * (2 * sizeof(float) + sizeof(int)) + 4 * DE_VOCAB * sizeof(float);
}
static_assert(fwd_smem<1024>() <= 232448 && dx_smem<1024>() <= 232448 && de_smem<1024>() <= 232448,
              "a K4-K6 block must fit the H100's 227 KB of shared memory");

template <int HID>
int launch_fwd(const void* x, const void* E, const void* bias, const void* labels, int N, int V, int S, int vbs,
               void* pf, void* pi, void* nll, void* lse, void* am, cudaStream_t st) {
  constexpr size_t smem = fwd_smem<HID>();
  cudaError_t err = cudaFuncSetAttribute(xent_fwd_kernel<HID>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  xent_fwd_kernel<HID><<<dim3(cdiv(N, Geo<HID>::FWD_ROWS), S), NTHREADS, smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(E), static_cast<const float*>(bias),
      static_cast<const int*>(labels), N, V, vbs, static_cast<float*>(pf), static_cast<int*>(pi));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  xent_fwd_merge_kernel<<<cdiv(N, 128), 128, 0, st>>>(static_cast<const float*>(pf), static_cast<const int*>(pi),
                                                       N, S, static_cast<float*>(nll), static_cast<float*>(lse),
                                                       static_cast<int*>(am));
  return (int)cudaGetLastError();
}

template <int HID>
int launch_dx(const void* x, const void* E, const void* bias, const void* labels, const void* lse, const void* g,
              int N, int V, int S, int vbs, void* part, void* dx, cudaStream_t st) {
  constexpr size_t smem = dx_smem<HID>();
  cudaError_t err = cudaFuncSetAttribute(xent_dx_kernel<HID>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  xent_dx_kernel<HID><<<dim3(cdiv(N, DX_ROWS), S), NTHREADS, smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(E), static_cast<const float*>(bias),
      static_cast<const int*>(labels), static_cast<const float*>(lse), N, V, vbs, static_cast<float*>(part));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int quads = cdiv(N * (HID / 4), 256);
  xent_dx_reduce_kernel<HID><<<quads < 4096 ? quads : 4096, 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<const float*>(g), N, S, static_cast<bf16*>(dx));
  return (int)cudaGetLastError();
}

template <int HID>
int launch_de(const void* x, const void* E, const void* bias, const void* labels, const void* lse, const void* g,
              int N, int V, void* dE, void* db, cudaStream_t st) {
  constexpr size_t smem = de_smem<HID>();
  cudaError_t err = cudaFuncSetAttribute(xent_de_kernel<HID>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  xent_de_kernel<HID><<<cdiv(V, DE_VOCAB), NTHREADS, smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(E), static_cast<const float*>(bias),
      static_cast<const int*>(labels), static_cast<const float*>(lse), static_cast<const float*>(g), N, V,
      static_cast<bf16*>(dE), static_cast<float*>(db));
  return (int)cudaGetLastError();
}

}  // namespace

// The tiling the wrapper needs to check inputs and size the split partials,
// at hidden width hid: 0 hid itself if the kernels take it (else -1), 1 K4's
// rows per block, 2 K5's rows per block, 3 the vocabulary rows per tile.
extern "C" int vb_xent_geometry(int which, int hid) {
  if (hid != 768 && hid != 1024) return -1;
  const int g[4] = {hid, hid == 768 ? Geo<768>::FWD_ROWS : Geo<1024>::FWD_ROWS, DX_ROWS, VB};
  return which >= 0 && which < 4 ? g[which] : -1;
}

extern "C" int vb_xent_fwd(const void* x, const void* E, const void* bias, const void* labels, int N, int V,
                           int hid, int S, int vbs, void* pf, void* pi, void* nll, void* lse, void* am, void* stream) {
  auto* f = hid == 1024 ? launch_fwd<1024> : (hid == 768 ? launch_fwd<768> : nullptr);
  if (f == nullptr) return (int)cudaErrorInvalidValue;
  return f(x, E, bias, labels, N, V, S, vbs, pf, pi, nll, lse, am, static_cast<cudaStream_t>(stream));
}

extern "C" int vb_xent_dx(const void* x, const void* E, const void* bias, const void* labels, const void* lse,
                          const void* g, int N, int V, int hid, int S, int vbs, void* part, void* dx, void* stream) {
  auto* f = hid == 1024 ? launch_dx<1024> : (hid == 768 ? launch_dx<768> : nullptr);
  if (f == nullptr) return (int)cudaErrorInvalidValue;
  return f(x, E, bias, labels, lse, g, N, V, S, vbs, part, dx, static_cast<cudaStream_t>(stream));
}

extern "C" int vb_xent_de(const void* x, const void* E, const void* bias, const void* labels, const void* lse,
                          const void* g, int N, int V, int hid, void* dE, void* db, void* stream) {
  auto* f = hid == 1024 ? launch_de<1024> : (hid == 768 ? launch_de<768> : nullptr);
  if (f == nullptr) return (int)cudaErrorInvalidValue;
  return f(x, E, bias, labels, lse, g, N, V, dE, db, static_cast<cudaStream_t>(stream));
}
