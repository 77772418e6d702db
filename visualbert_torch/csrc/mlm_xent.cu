// K4, K5, K6: the fused masked-LM softmax cross-entropy over the tied
// decoder. Replace visualbert_tpu/ops/mlm_xent.py::_fwd_kernel (K4, :52),
// ::_dx_kernel (K5, :145) and ::_de_kernel (K6, :170), reached through
// mlm_xent.
//
// Inputs, at hidden width HID of 768 (bert-base) or 1024 (bert-large), one
// instantiation each (and 128, 256, 512, and the wide form above 1024: see
// "Widths and element types" below): x [N, HID] bf16 (the MLM transform's output rows), E [V, HID] bf16
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
// each kernel recomputes its logits tile on chip.
//
// Bound on the H100. At the main path's N = 128 * 24 = 3072 rows, V = 30522
// and HID = 768 each of the five N x V x HID products (K4: 1, K5: 2, K6: 2)
// is 144 GFLOP, against 4.7 MB of x and 47 MB of E: all three kernels are
// bound by math, K4 by 144 GFLOP (0.146 ms at 989 TFLOP/s), K5 and K6 by 288
// GFLOP each (0.29 ms).
//
// K4 (xent_fwd_kernel) is built on K5's tiling: the same 128 B-swizzled
// streamed tiles of T = 32 vocabulary rows, issued by cp.async ahead of use
// with their bias beside them (cp_async4), and the logits S = X E_t^T + b
// from wgmma, a block of two warpgroups. In place of K5's dlog
// math and second product each thread keeps an online (max, sum of exp,
// label logit, best value, best index) over its columns. Per tile it takes
// the max of its values first; only a max above the best so far looks for
// its first column (columns ascend within a thread: the first maximum, as
// a strict > over them), and the label's column and the edge at V are
// checked once a tile.
// - Registers. K4 holds no 64 x HID accumulator, so its registers hold x
//   instead: each warpgroup keeps its 64 rows as wgmma A fragments (64 x 768
//   bf16 = 192 registers a thread) and multiplies the whole of K from them
//   (m64n32k16 with A in registers, 48 k-steps). The two warpgroups own
//   different rows and share every E tile, so a block keeps 128 rows: E is
//   read from L2 once for every 128 rows of x, not every 64 (1.1 GB in all at
//   the main path, not K5's 2.25 GB), and no partial logits cross between
//   the warpgroups. The shared memory that x no longer takes holds a deeper
//   ring: 4 tiles of 48 KB, three in flight.
//   The x rows arrive first, by cp.async into the ring's space (swizzled
//   panels of all the block's rows), and ldmatrix turns them into the
//   fragments; loaded from device memory one word a register, each with its
//   own 64-bit address, they spilled.
// - At 1024 the fragments of 64 x 1024 would need 256 registers, so both
//   warpgroups keep the same 64 rows, each half of K (128 registers), and
//   form the logits exactly as K5 does: each multiplies its half into the
//   whole 64 x T tile, hands the other warpgroup its partial sums of that
//   warpgroup's half of the columns through shared memory and finishes its
//   own half; the two warpgroups' statistics of a row meet at the end. The
//   ring is 3 tiles of 64 KB. Built with VB_XENT_FWD_SPLIT_K (for
//   tools/xent_steps.py), 768 takes this form too: 64 rows a block.
// - The same numbers as K5? No: the design gives that up for registers. A
//   logit here is the bias plus one chain of products (at 1024, the bias
//   plus one half-K chain, then the other half's), where K5 adds two
//   half-K chains and then the bias: the same fp32 products in another
//   order, so K4's lse may differ from K5's recomputed logits in the last
//   bits (K5's dlog rounds to bf16 anyway).
// - Ring. Tile t + 3 (t + 2 at 1024) is issued right after the barrier that
//   opens tile t, into the slot tile t - 1 has freed; cp_wait, fence_async,
//   __syncthreads as in K5; past the last tile the commit groups are empty.
//   Thread x copies chunk x % 8 of row x / 8 of every 64-column panel of a
//   tile, its addresses a constant apart (issue_rows' loop over a thread's
//   chunks keeps more addresses in registers than K4 has to spare).
// - Bias. Each tile's products start from its bias in the accumulator
//   (wgmma's scale-d 1 from the first k-step), so no register holds it.
// - Splits. An H100 runs its blocks in parallel in no order, so K4 splits
//   the vocabulary across blocks as well as the rows (24 row blocks at the
//   main path for 132 SMs; ops/mlm_xent.py::fwd_plan chooses the splits
//   that give the fewest tiles on the busiest SM: 11 there, two waves).
//   Each block writes, per row, its partial (max, sum of exp, label logit,
//   best value, best index); xent_fwd_merge_kernel combines the splits in
//   vocabulary order, and every merge (the 4 threads of a row, the two
//   warpgroups, the splits) takes the lower index on equal values:
//   first-max, as the TPU kernel and torch.argmax.
// - Ragged edges. x rows past N are zero fragments and write nothing;
//   vocabulary rows past V are zero in shared memory and their columns
//   -inf, so they count in no statistic.
// Switches for tools/xent_steps.py, which the kernel library never defines
// (wrong results, timing only unless said): VB_XENT_FWD_SYNC_LOADS, plain
// loads and stores in place of cp.async, so each thread waits for its copy
// of a tile before its next products (right results);
// VB_XENT_FWD_SPLIT_K, 768 on the 1024 form (right results);
// VB_XENT_FWD_NO_STATS, the logits only; VB_XENT_FWD_NO_LOGITS, the
// statistics of the bias alone, no wgmma.
//
// K5 and K6 are one Hopper kernel on two roles (xent_bwd_kernel, DE false /
// true); they are mirror images. A block of two warpgroups keeps a
// RESIDENT tile of 64 rows (wgmma's m64) x HID in shared memory and walks a
// STREAMED matrix in tiles of T rows:
//   K5: resident = 64 rows of x, streamed = E (the vocabulary tiles of one
//       split); S = X E_t^T, then dX += bf16(p - onehot) . E_t.
//   K6: resident = 64 vocabulary rows of E, streamed = every row tile of x;
//       S^T = E X_t^T, then dE += bf16(g (p - onehot))^T . X_t, db += the
//       fp32 values before rounding.
// - Tiles. Every [rows, HID] tile is HID / 64 panels of rows x 128 B in the
//   128 B swizzle (one 64-column panel is hopper_attn.cuh's tile layout), so
//   one copy serves both products: the logits read it K-major (B = the
//   streamed rows), the second product MN-major (B transposed, N = its
//   columns). Copies are cp.async, 16 bytes a thread.
// - Ring. Shared memory holds the resident tile (96 KB at 768) and two
//   streamed tiles of T = 32 rows (2 x 48 KB at 768), 210 KB in all. Tile
//   t + 1 is issued right
//   after the barrier that opens tile t, with its rows' values (K5: bias;
//   K6: lse, label, g, by 4-byte cp.async), so its copy runs under both of
//   tile t's products and no register holds them during the logits.
// - Products, all wgmma from shared memory. The logits are split by K: each
//   warpgroup multiplies half of HID's panels into the whole 64 x T tile
//   (m64n32), hands the other warpgroup its partial
//   sums of that warpgroup's half of the columns through shared memory, and
//   finishes its own half. It writes their bf16 dlog into one shared 64 x T
//   tile (K-major, swizzled), and after a barrier both warpgroups multiply
//   that whole tile by the streamed tile, each into its own columns: the
//   logits are computed once, in half as many, twice as wide, instructions
//   as a split by columns (m64n16 a warpgroup), which also read the
//   resident tile twice.
// - Accumulator. 64 rows x 768 fp32 is 384 registers a thread for one
//   warpgroup: each of the two owns 384 columns, six m64n64 accumulators
//   (192 registers). At 1024 that would be 256 registers a warpgroup, which
//   do not fit: width 1024 runs on a kernel of its own, a cluster of two
//   blocks of 512 columns (the 1024 form, below).
// - Grid. K5: x = 64-row blocks, y = 1, z = vocabulary splits of
//   `vbs` tiles (blocks run in index order, so the blocks in flight read the
//   same E range and E comes from L2); each writes an fp32 partial dx of its
//   split and xent_dx_reduce_kernel sums the partials in split order, scales
//   by g and rounds. K6: x = 64-vocabulary-row blocks (477 at the main path),
//   y = 1; no splits, no partials: x (4.7 MB) stays in L2.
// What bounds this design (tools/xent_steps.py: the source built with a
// step left out, timed beside the kernels as built): the logits' chain of
// dependent wgmmas and the one streamed tile in flight per SM take about
// the same time alone, and overlap; the products add the rest. The four
// switches of that tool (VB_XENT_NO_COPY: no tile after the first is
// copied; VB_XENT_NO_LOGITS: the logits are zeros; VB_XENT_NO_PRODUCT: no
// second product; VB_XENT_NO_DLOG: no dlog math and no dlog tile) give
// wrong results, for timing only; the kernel library never defines them.
// No atomics anywhere: the results do not depend on the order in which
// blocks run, and two calls agree bit for bit. Ragged edges (V = 30522 is not
// a multiple of 64, N need not be either) are masked here: rows past the end
// are zero in shared memory, columns past V and rows past N give dlog 0, and
// nothing past them is stored. E is read in place; it is never copied to a
// padded tensor.
//
// Widths and element types. Every kernel is a template on HID and on the
// element type ET (bf16 or fp16: wgmma's .bf16 or .f16 with the same shapes
// and swizzle, dlog and the outputs rounded to ET). Below 768 the tiling is
// 768's: K4 keeps 128 rows of x a block as A fragments (HID / 4 registers a
// thread: 32, 64, 128 at 128, 256, 512) and a 4-tile ring of 32 rows (the
// ring's space is the block's x rows, 256 HID bytes); K5/K6 stream 32-row
// tiles (m64n32 logits, each warpgroup over HID / 128 panels) and a block
// owns every column (HID / 128 m64n64 accumulators a warpgroup). At 1024
// K5/K6 run on the 1024 form (a cluster of two blocks, the section before
// the wide form's). The
// wrapper zero-pads any other width up to 1024 to the next instantiated one
// (ops/mlm_xent.py::pad_width; a zero column adds nothing to a logit) and
// drops the padded columns of dx and dE. Above 1024 the wide form (the
// last section of this file) takes bf16 and fp16 at any multiple of 64 up
// to 8192 at run time, other widths padded to the next; fp32, and wider
// rows, run on their own kernels (mlm_xent_f32.cu).
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "hopper_attn.cuh"
#include "mma.cuh"
#include "once_a_device.cuh"

namespace {

using vb::bf16;
using vb_hopper::smem_addr;
using vb_hopper::swz;

constexpr int NTHREADS = 256;     // 8 warps: two warpgroups (K4, K5, K6)

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

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

// ------------------------------------------------------------------ K5, K6

constexpr int RES = 64;           // resident rows a block: wgmma's m64
constexpr int PANEL = RES * 128;  // bytes of a resident panel (64 columns)
constexpr int P_BYTES = 64 * 128; // the dlog tile: 64 rows x T (<= 64) columns, swizzled
constexpr int NV = 3;             // values of a streamed row: K5 the bias; K6 lse, label, g

// K5/K6's tiling at hidden width HID up to 768 (see the header comment;
// 1024 has a kernel of its own, xent_h1024_bwd_kernel).
template <int HID>
struct Bwd {
  static constexpr int NP = HID / 64;                  // 128 B panels of a [*, HID] row
  static constexpr int KP = NP / 2;                    // ... in each warpgroup's half of the logits
  static constexpr int T = 32;                         // streamed rows a tile: the logits' n
  static constexpr int COLS = HID;                     // result columns a block owns: all
  static constexpr int CW = COLS / 2;                  // ... a warpgroup owns
  static constexpr int NC = CW / 64;                   // ... in m64n64 accumulators (1, 2, 4, 6)
  static constexpr int TN = T / 2;                     // logits columns a warpgroup finishes
  static constexpr int XV = TN / 2;                    // partial logits a thread hands the other warpgroup
  static constexpr int RES_BYTES = RES * HID * 2;
  static constexpr int TILE_BYTES = T * HID * 2;       // one streamed tile: NP panels of T rows
  static constexpr size_t SMEM = vb_hopper::ALIGN + RES_BYTES + 2 * TILE_BYTES + P_BYTES +
                                 (2 * XV * 128 + 2 * NV * T + 2 * RES) * sizeof(float);
};
static_assert(Bwd<128>::SMEM <= 232448 && Bwd<256>::SMEM <= 232448 && Bwd<512>::SMEM <= 232448 &&
                  Bwd<768>::SMEM <= 232448,
              "a K5/K6 block must fit the H100's 227 KB of shared memory");

// Issue the copy of rows [r0, r0 + NR) of a [nvalid, HID] bf16 matrix into NP
// swizzled panels of NR rows at shared address dst (panel p at dst + p * NR
// * 128); rows past nvalid are zero. Neighbouring threads copy neighbouring
// 16-byte chunks of a row.
template <int HID, int NR, typename ET>
__device__ __forceinline__ void issue_rows(uint32_t dst, const ET* __restrict__ src, int r0, int nvalid) {
  constexpr int CH = HID / 8;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < NR * CH; idx += NTHREADS) {
    const int r = idx / CH, c = idx - r * CH, row = r0 + r;
    const bool ok = row < nvalid;
    vb_hopper::cp_async16(dst + (c >> 3) * (NR * 128) + swz(r, c & 7), src + (size_t)(ok ? row : 0) * HID + c * 8,
                          ok);
  }
}

// 4 bytes, or zeros where !valid.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

// wgmma forms of K5/K6 (hopper_attn.cuh has n64 with both operands K-major
// or A in registers; those are the attention kernels' machine code and stay
// as they are). d (64 x N fp32) = (acc ? d : 0) + A B^T, both K-major in
// shared memory.
// Each form in bf16 (ET = bf16) or fp16 (ET = __half): the same shapes.
#define VB_XENT_N32(TY)                                                                                           \
  asm volatile(                                                                                                   \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                                                                \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, " \
      "%12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"                                                          \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),  \
        "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])                    \
      : "l"(a), "l"(b), "r"(acc))
template <typename ET>
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t a, uint64_t b, int acc) {
  if constexpr (std::is_same<ET, __half>::value)
    VB_XENT_N32("f16");
  else
    VB_XENT_N32("bf16");
}
#undef VB_XENT_N32
// d (64 x 64) += A B, A [64 x 16] K-major and B [16 x 64] MN-major (16 rows
// of 64 contiguous columns: imm-trans-b), both in shared memory.
template <typename ET>
__device__ __forceinline__ void wgmma_n64_tb(float (&d)[32], uint64_t a, uint64_t b) {
  if constexpr (std::is_same<ET, __half>::value)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " VB_R32 ", %32, %33, p, 1, 1, 0, 1;\n}\n"
        : VB_D32
        : "l"(a), "l"(b), "r"(1));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " VB_R32 ", %32, %33, p, 1, 1, 0, 1;\n}\n"
        : VB_D32
        : "l"(a), "l"(b), "r"(1));
}

// After a wait: keep the compiler from reading an accumulator before it.
template <int N>
__device__ __forceinline__ void hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// This warpgroup's half of the logits: s (64 x T) = R Q^T over panels [p0,
// p0 + KP), R the resident tile at shared address r (64-row panels), Q the
// streamed tile at q (panels of T rows).
template <int HID, typename ET>
__device__ __forceinline__ void logits(float (&s)[Bwd<HID>::T / 2], uint32_t r, uint32_t q, int p0) {
  using G = Bwd<HID>;
  const uint64_t dr = vb_hopper::desc(r + p0 * PANEL), dq = vb_hopper::desc(q + p0 * G::T * 128);
#pragma unroll
  for (int p = 0; p < G::KP; ++p)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t a = dr + ((p * PANEL) >> 4) + 2 * kk, b = dq + ((p * G::T * 128) >> 4) + 2 * kk;
      wgmma_n32<ET>(s, a, b, p | kk);
    }
}

// K5 (DE false): grid (cdiv(N, 64), HID / COLS, S); block (x, y, z) keeps x
// rows [64 x, 64 x + 64), walks the vocabulary tiles [z vbs, z vbs + vbs) of
// T rows, and writes columns [y COLS, y COLS + COLS) of the fp32 partial
// part [S][N][HID]. K6 (DE true): grid (cdiv(V, 64), HID / COLS); block (x,
// y) keeps E rows [64 x, 64 x + 64), walks every x tile, and writes those
// rows of dE (its columns) and, for y = 0, of db.
template <int HID, bool DE, typename ET>
__global__ void __launch_bounds__(NTHREADS, 1)
xent_bwd_kernel(const ET* __restrict__ x, const ET* __restrict__ E, const float* __restrict__ bias,
                const int* __restrict__ labels, const float* __restrict__ lse, const float* __restrict__ gr, int N,
                int V, int vbs, float* __restrict__ part, ET* __restrict__ dE, float* __restrict__ db) {
  using G = Bwd<HID>;
  constexpr int T = G::T, TN = G::TN, NC = G::NC, XV = G::XV;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = vb_hopper::align_smem(smem_raw);
  unsigned char* Pt = sm + G::RES_BYTES + 2 * G::TILE_BYTES;  // the bf16 dlog tile
  float* xch = reinterpret_cast<float*>(Pt + P_BYTES);       // [2 to][XV][128]: partial logits for the other warpgroup
  float* cols = xch + 2 * XV * 128;                           // [2 buffers][NV][T]: the streamed rows' values
  float* red = cols + 2 * NV * T;                             // [2][RES]: K6's db over each warpgroup's columns
  const uint32_t sR = smem_addr(sm), sQ = sR + G::RES_BYTES, sP = smem_addr(Pt), sC = smem_addr(cols);

  const int r0 = blockIdx.x * RES;
  const int nres = DE ? V : N, nstr = DE ? N : V;
  const ET* res = DE ? E : x;
  const ET* str = DE ? x : E;
  const int ntiles = cdiv(nstr, T);
  const int t0 = DE ? 0 : blockIdx.z * vbs, t1 = DE ? ntiles : min(ntiles, t0 + vbs);

  const int tid = threadIdx.x & 127, wg = threadIdx.x >> 7, warp = tid >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int i0 = warp * 16 + g;                              // this thread's resident rows: i0, i0 + 8
  const int pc = (blockIdx.y * G::COLS + wg * G::CW) / 64;  // the panel of this warpgroup's first column

  // Tile t into buffer b: its rows, and its rows' values (K5: the bias of
  // each vocabulary row; K6: the lse, label and g of each x row; zero past
  // the end, where the row's dlog is 0 anyway).
  auto issue_tile = [&](int t, int b) {
    issue_rows<HID, T>(sQ + b * G::TILE_BYTES, str, t * T, nstr);
    if (threadIdx.x < (DE ? NV : 1) * T) {
      const int k = threadIdx.x / T, j = t * T + threadIdx.x % T, jj = j < nstr ? j : 0;
      const void* src = DE ? (k == 0 ? (const void*)(lse + jj) : k == 1 ? (const void*)(labels + jj)
                                                                         : (const void*)(gr + jj))
                           : (const void*)(bias + jj);
      cp_async4(sC + 4 * ((b * NV + k) * T + threadIdx.x % T), src, j < nstr);
    }
  };

  issue_rows<HID, RES>(sR, res, r0, nres);
  issue_tile(t0, 0);
  vb_hopper::cp_commit();

  // per resident row h: K5 the lse and label of x row r0 + i; K6 the bias of
  // vocabulary row r0 + i (rid: the row's vocabulary id, or its label)
  float rv[2];
  int rid[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + i0 + 8 * h;
    if (DE) {
      rv[h] = r < V ? bias[r] : 0.f;
      rid[h] = r;
    } else {
      rv[h] = r < N ? lse[r] : INFINITY;  // padded rows: p = 0
      rid[h] = r < N ? labels[r] : -1;
    }
  }
  float acc[NC][32];
#pragma unroll
  for (int j = 0; j < NC; ++j) vb_hopper::zero(acc[j]);
  float dsum[2] = {0.f, 0.f};  // K6: db of rows i0, i0 + 8 over this thread's columns

  for (int t = t0; t < t1; ++t) {
    const int b = (t - t0) & 1;
    const uint32_t sQb = sQ + b * G::TILE_BYTES;
    vb_hopper::cp_wait<0>();
    vb_hopper::fence_async();
    __syncthreads();  // tile t landed; both warpgroups are done with tile t - 1, the dlog tile and xch
#ifndef VB_XENT_NO_COPY
    if (t + 1 < t1) {
      issue_tile(t + 1, b ^ 1);
      vb_hopper::cp_commit();
    }
#endif

    // the logits over this warpgroup's half of the panels; it finishes the
    // columns [wg TN, wg TN + TN) (n-tiles wg TN / 8 ..) and hands the
    // other warpgroup its partial sums of the other half
    float s[T / 2], mine[XV];
    vb_hopper::wg_fence();
#ifndef VB_XENT_NO_LOGITS
    logits<HID, ET>(s, sR, sQb, wg * G::KP);
#else
#pragma unroll
    for (int i = 0; i < T / 2; ++i) s[i] = 0.f;
#endif
    vb_hopper::wg_commit();
    vb_hopper::wg_wait();
    hold(s);
#pragma unroll
    for (int k = 0; k < XV; ++k) {
      mine[k] = wg ? s[XV + k] : s[k];
      xch[((wg ^ 1) * XV + k) * 128 + tid] = wg ? s[k] : s[XV + k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < XV; ++k) mine[k] += xch[(wg * XV + k) * 128 + tid];

#ifndef VB_XENT_NO_DLOG
    const float* cv = cols + b * NV * T;  // [NV][T] of tile t
#pragma unroll
    for (int nt = 0; nt < TN / 8; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float d[2];
        const int c = wg * TN + nt * 8 + 2 * tq;  // tile column of e = 0
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float z = mine[4 * nt + 2 * h + e];
          const int j = t * T + c + e;
          if (DE) {  // row: vocabulary id rid; column: x row j
            const bool ok = rid[h] < V && j < N;
            const int lab = __float_as_int(cv[T + c + e]);
            d[e] = ok ? (expf(z + rv[h] - cv[c + e]) - (lab == rid[h] ? 1.f : 0.f)) * cv[2 * T + c + e] : 0.f;
            dsum[h] += d[e];
          } else {   // row: x row with label rid; column: vocabulary id j
            d[e] = j < V ? expf(z + cv[c + e] - rv[h]) - (rid[h] == j ? 1.f : 0.f) : 0.f;
          }
        }
        *reinterpret_cast<uint32_t*>(Pt + swz(i0 + 8 * h, c >> 3) + (c & 7) * 2) = vb::Elem<ET>::pack(d[0], d[1]);
      }
#endif
    vb_hopper::fence_async();
    __syncthreads();  // the whole dlog tile is written

    const uint64_t dp = vb_hopper::desc(sP), dq = vb_hopper::desc(sQb);
    vb_hopper::wg_fence();
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int kk = 0; kk < T / 16; ++kk)
#ifndef VB_XENT_NO_PRODUCT
        wgmma_n64_tb<ET>(acc[j], dp + 2 * kk, dq + (uint64_t)(((pc + j) * T * 128 + kk * 2048) >> 4));
#endif
    vb_hopper::wg_commit();
    vb_hopper::wg_wait();
#pragma unroll
    for (int j = 0; j < NC; ++j) hold(acc[j]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + i0 + 8 * h;
    if (r >= nres) continue;
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = (pc + j) * 64 + nt * 8 + 2 * tq;
        const float a = acc[j][4 * nt + 2 * h], b = acc[j][4 * nt + 2 * h + 1];
        if (DE)
          *reinterpret_cast<uint32_t*>(dE + (size_t)r * HID + col) = vb::Elem<ET>::pack(a, b);
        else
          *reinterpret_cast<float2*>(part + ((size_t)blockIdx.z * N + r) * HID + col) = make_float2(a, b);
      }
  }
  if (DE) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = dsum[h];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (tq == 0) red[wg * RES + i0 + 8 * h] = v;
    }
    __syncthreads();
    const int i = threadIdx.x;
    if (blockIdx.y == 0 && i < RES && r0 + i < V) db[r0 + i] = red[i] + red[RES + i];
  }
}

// dx[n, :] = ET(g[n] * sum_s part[s, n, :]), the splits summed in order.
template <int HID, typename ET>
__global__ void xent_dx_reduce_kernel(const float* __restrict__ part, const float* __restrict__ gr, int N,
                                      int S, ET* __restrict__ dx) {
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
    out.x = vb::Elem<ET>::pack(sum.x * gn, sum.y * gn);
    out.y = vb::Elem<ET>::pack(sum.z * gn, sum.w * gn);
    reinterpret_cast<uint2*>(dx)[q] = out;
  }
}

// ------------------------------------------------------------------ K4

constexpr float LOG2E_F = 1.4426950408889634f;

// K4's tiling at hidden width HID (see the header comment).
template <int HID>
struct Fwd {
#ifndef VB_XENT_FWD_SPLIT_K
  static constexpr bool SPLIT = HID > 768;           // the warpgroups split K over the same rows
#else
  static constexpr bool SPLIT = true;
#endif
  static constexpr int NP = HID / 64;                  // 128 B panels of an E row
  static constexpr int KP = SPLIT ? NP / 2 : NP;       // ... a warpgroup multiplies
  static constexpr int KS = 4 * KP;                    // its k-steps: A fragments of 4 registers each
  static constexpr int ROWS = SPLIT ? RES : 2 * RES;   // x rows a block
  static constexpr int T = 32;                         // vocabulary rows a tile: the logits' n
  static constexpr int NTC = SPLIT ? 2 : 4;            // n8 tiles of a tile's logits a warpgroup finishes
  static constexpr int XV = T / 4;                     // SPLIT: partial logits a thread hands the other warpgroup
  static constexpr int TILE_BYTES = T * HID * 2;       // one tile: NP panels of T rows
  static constexpr int STAGES = 196608 / TILE_BYTES < 4 ? 196608 / TILE_BYTES : 4;  // 4 up to 768, 3 at 1024
  static constexpr size_t SMEM = vb_hopper::ALIGN + STAGES * TILE_BYTES +
                                 (STAGES * T + (SPLIT ? 2 * XV * 128 + 2 * RES * 5 : 0)) * sizeof(float);
};
static_assert(Fwd<128>::SMEM <= 232448 && Fwd<256>::SMEM <= 232448 && Fwd<512>::SMEM <= 232448 &&
                  Fwd<768>::SMEM <= 232448 && Fwd<1024>::SMEM <= 232448,
              "a K4 block must fit the H100's 227 KB of shared memory");
static_assert(Fwd<128>::STAGES >= 2 && Fwd<768>::STAGES >= 2 && Fwd<1024>::STAGES >= 2,
              "the ring needs a tile to use and one in flight");
static_assert(Fwd<128>::STAGES * Fwd<128>::TILE_BYTES >= Fwd<128>::ROWS * 128 * 2 &&
                  Fwd<512>::STAGES * Fwd<512>::TILE_BYTES >= Fwd<512>::ROWS * 512 * 2,
              "the block's x rows arrive in the ring's space");
static_assert(Fwd<768>::T * 8 == NTHREADS, "a tile's panel is one 16-byte chunk a thread");

// d (64 x 32 fp32) += A B^T, A [64 x 16] bf16 in registers (the
// mma.m16n8k16 A fragment of each warp's 16 rows), B [32 x 16] K-major in
// shared memory.
#define VB_XENT_RS_N32(TY)                                                                                        \
  asm volatile(                                                                                                   \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, " \
      "%12, %13, %14, %15}, {%16, %17, %18, %19}, %20, 1, 1, 1, 0;\n"                                              \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),  \
        "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])                    \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b))
template <typename ET>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (std::is_same<ET, __half>::value)
    VB_XENT_RS_N32("f16");
  else
    VB_XENT_RS_N32("bf16");
}
#undef VB_XENT_RS_N32

// After a wait: the A fragments stay in their registers until the products
// that read them are done.
template <int KS>
__device__ __forceinline__ void keep(const uint32_t (&a)[KS][4]) {
#pragma unroll
  for (int k = 0; k < KS; ++k) asm volatile("" ::"r"(a[k][0]), "r"(a[k][1]), "r"(a[k][2]), "r"(a[k][3]) : "memory");
}

// This warpgroup's logits of a tile: s (64 x T) += X Q^T over its KP panels
// from p0 on, X the fragments a, Q the tile at shared address q.
template <int HID, typename ET>
__device__ __forceinline__ void fwd_logits(float (&s)[16], const uint32_t (&a)[Fwd<HID>::KS][4], uint32_t q,
                                           int p0) {
  using G = Fwd<HID>;
  const uint64_t dq = vb_hopper::desc(q + p0 * G::T * 128);
#pragma unroll
  for (int p = 0; p < G::KP; ++p)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_n32<ET>(s, a[4 * p + kk], dq + ((p * G::T * 128) >> 4) + 2 * kk);
}

// Tile t (rows [t T, t T + T) of E, zero past V) into NP swizzled panels of
// T rows at shared address dst, as issue_rows lays them out, and its bias
// (zero past V) to shared address bias_dst: thread x copies chunk x % 8 of
// row x / 8 in every panel, so its addresses differ from panel to panel by
// constants. cp.async; plain loads and stores with VB_XENT_FWD_SYNC_LOADS.
template <int HID, typename ET>
__device__ __forceinline__ void copy_tile(uint32_t dst, uint32_t bias_dst, const ET* __restrict__ E,
                                          const float* __restrict__ bias, int t, int V) {
  constexpr int T = Fwd<HID>::T;
  const int r = threadIdx.x >> 3, c = threadIdx.x & 7, row = t * T + r, j = t * T + threadIdx.x;
  const bool ok = row < V;
  const ET* src = E + (size_t)(ok ? row : 0) * HID + c * 8;
  dst += swz(r, c);
#ifndef VB_XENT_FWD_SYNC_LOADS
#pragma unroll
  for (int p = 0; p < HID / 64; ++p) vb_hopper::cp_async16(dst + p * T * 128, src + p * 64, ok);
  if (threadIdx.x < T) cp_async4(bias_dst + 4 * threadIdx.x, bias + (j < V ? j : 0), j < V);
#else
#pragma unroll
  for (int p = 0; p < HID / 64; ++p)
    *static_cast<uint4*>(__cvta_shared_to_generic(dst + p * T * 128)) =
        ok ? *reinterpret_cast<const uint4*>(src + p * 64) : make_uint4(0u, 0u, 0u, 0u);
  if (threadIdx.x < T) *static_cast<float*>(__cvta_shared_to_generic(bias_dst + 4 * threadIdx.x)) = j < V ? bias[j] : 0.f;
#endif
}

// One thread's online statistics of its two rows (h = 0, 1: rows g, g + 8 of
// its warp's 16). add() takes a tile's logits z (NTC n8 tiles: z[4 nt + 2 h
// + e] is row h, vocabulary id v0 + 8 nt + 2 tq + e).
template <int NTC>
struct RowStats {
  float m[2], l[2], ll[2], bv[2];  // max, sum of exp(z - max), label logit, best value
  int bi[2], lab[2];               // best index, label (-1: no row)

  __device__ __forceinline__ void add(const float (&z)[4 * NTC], int v0, int V, int tq) {
    const int c0 = v0 + 2 * tq;             // column of value i: c0 + 8 (i / 2) + i % 2, ascending with i
    const bool full = v0 + 8 * NTC <= V;    // every tile but the last
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float w[2 * NTC];
      float tm = -INFINITY;
#pragma unroll
      for (int i = 0; i < 2 * NTC; ++i) {
        w[i] = full || c0 + 8 * (i / 2) + i % 2 < V ? z[4 * (i / 2) + 2 * h + i % 2] : -INFINITY;
        tm = fmaxf(tm, w[i]);
      }
      if (tm == -INFINITY) continue;  // every column past V
      const int d = lab[h] - c0;  // the label among these columns: d = 8 (i / 2) + i % 2
      if (d >= 0 && d < 8 * NTC && (d & 6) == 0)
#pragma unroll
        for (int i = 0; i < 2 * NTC; ++i)
          if (d == 8 * (i / 2) + i % 2) ll[h] = w[i];
      if (tm > bv[h]) {  // a new best: the first of its equal values, as a strict > over ascending columns
        bv[h] = tm;
#pragma unroll
        for (int i = 2 * NTC - 1; i >= 0; --i)
          if (w[i] == tm) bi[h] = c0 + 8 * (i / 2) + i % 2;
      }
      const float mn = fmaxf(m[h], tm);
      float acc = l[h] * exp2f((m[h] - mn) * LOG2E_F);  // m = -inf only while l = 0
#pragma unroll
      for (int i = 0; i < 2 * NTC; ++i) acc += exp2f((w[i] - mn) * LOG2E_F);  // -inf: 0
      l[h] = acc;
      m[h] = mn;
    }
  }

  // add() on z itself, its columns past V set to -inf in place: no copy of
  // the tile's values beside them (the wide K4's registers hold two
  // accumulators besides z).
  __device__ __forceinline__ void add_in_place(float (&z)[4 * NTC], int v0, int V, int tq) {
    const int c0 = v0 + 2 * tq;  // column of value i: c0 + 8 (i / 2) + i % 2, ascending with i
    if (v0 + 8 * NTC > V)        // the last tile
#pragma unroll
      for (int i = 0; i < 2 * NTC; ++i)
        if (c0 + 8 * (i / 2) + i % 2 >= V) z[4 * (i / 2) + i % 2] = z[4 * (i / 2) + 2 + i % 2] = -INFINITY;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float tm = -INFINITY;
#pragma unroll
      for (int i = 0; i < 2 * NTC; ++i) tm = fmaxf(tm, z[4 * (i / 2) + 2 * h + i % 2]);
      if (tm == -INFINITY) continue;  // every column past V
      const int d = lab[h] - c0;      // the label among these columns: d = 8 (i / 2) + i % 2
      if (d >= 0 && d < 8 * NTC && (d & 6) == 0)
#pragma unroll
        for (int i = 0; i < 2 * NTC; ++i)
          if (d == 8 * (i / 2) + i % 2) ll[h] = z[4 * (i / 2) + 2 * h + i % 2];
      if (tm > bv[h]) {  // a new best: the first of its equal values, as a strict > over ascending columns
        bv[h] = tm;
#pragma unroll
        for (int i = 2 * NTC - 1; i >= 0; --i)
          if (z[4 * (i / 2) + 2 * h + i % 2] == tm) bi[h] = c0 + 8 * (i / 2) + i % 2;
      }
      const float mn = fmaxf(m[h], tm);
      float acc = l[h] * exp2f((m[h] - mn) * LOG2E_F);  // m = -inf only while l = 0
#pragma unroll
      for (int i = 0; i < 2 * NTC; ++i) acc += exp2f((z[4 * (i / 2) + 2 * h + i % 2] - mn) * LOG2E_F);  // -inf: 0
      l[h] = acc;
      m[h] = mn;
    }
  }

  // Merge the 4 threads of each row (lanes tq = 0..3).
  __device__ __forceinline__ void merge_quad() {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float m2 = __shfl_xor_sync(0xffffffffu, m[h], off), l2 = __shfl_xor_sync(0xffffffffu, l[h], off);
        const float ll2 = __shfl_xor_sync(0xffffffffu, ll[h], off), v2 = __shfl_xor_sync(0xffffffffu, bv[h], off);
        const int i2 = __shfl_xor_sync(0xffffffffu, bi[h], off);
        lse_merge(m[h], l[h], m2, l2);
        ll[h] += ll2;
        argmax_merge(bv[h], bi[h], v2, i2);
      }
  }
};

// Write a row's partials: pf [4][S][N] fp32 (max, sum of exp, label logit,
// best value), pi [S][N] int32 (best index); at = split * N + row.
__device__ __forceinline__ void store_partial(float* __restrict__ pf, int* __restrict__ pi, size_t plane, size_t at,
                                              float m, float l, float ll, float bv, int bi) {
  pf[at] = m;
  pf[plane + at] = l;
  pf[2 * plane + at] = ll;
  pf[3 * plane + at] = bv;
  pi[at] = bi;
}

// grid (cdiv(N, ROWS), S): row blocks x vocabulary splits of `vbs` tiles of
// T rows.
template <int HID, typename ET>
__global__ void __launch_bounds__(NTHREADS, 1)
xent_fwd_kernel(const ET* __restrict__ x, const ET* __restrict__ E, const float* __restrict__ bias,
                const int* __restrict__ labels, int N, int V, int vbs, float* __restrict__ pf,
                int* __restrict__ pi) {
  using G = Fwd<HID>;
  constexpr int T = G::T, ST = G::STAGES, XV = G::XV, NTC = G::NTC;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = vb_hopper::align_smem(smem_raw);
  float* cols = reinterpret_cast<float*>(sm + ST * G::TILE_BYTES);  // [ST][T]: each tile's bias
  float* xch = cols + ST * T;                                     // SPLIT: [2 to][XV][128] partial logits
  float* red = xch + 2 * XV * 128;                                // SPLIT: [2][RES][5] each warpgroup's statistics
  const uint32_t sQ = smem_addr(sm), sC = smem_addr(cols);

  const int tid = threadIdx.x & 127, wg = threadIdx.x >> 7, warp = tid >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int i0 = warp * 16 + g;                                            // this thread's rows of its 64: i0, i0 + 8
  const int r0 = blockIdx.x * G::ROWS + (G::SPLIT ? 0 : wg * RES) + i0;  // ... in x
  const int ntiles = cdiv(V, T);
  const int t0 = blockIdx.y * vbs, t1 = min(ntiles, t0 + vbs);

  // tile t and its bias into slot b
  auto issue = [&](int t, int b) { copy_tile<HID, ET>(sQ + b * G::TILE_BYTES, sC + 4 * b * T, E, bias, t, V); };

  // this warpgroup's x rows as A fragments: k-step k holds its columns 16 k
  // + 2 tq, + 1 (registers 0, 1: rows i0, i0 + 8) and + 8, + 9 (2, 3)
  uint32_t a[G::KS][4];
  RowStats<NTC> st;
  {
    // the block's x rows into the ring's space (NP swizzled panels of ROWS
    // rows, zero past N), then each warpgroup's fragments by ldmatrix: lane
    // l gives the address of row l % 16 of its warp's 16, chunk l / 16 of
    // the k-step
    issue_rows<HID, G::ROWS>(sQ, x, blockIdx.x * G::ROWS, N);
    vb_hopper::cp_commit();
    vb_hopper::cp_wait<0>();
    __syncthreads();
    const int row = (G::SPLIT ? 0 : wg * RES) + warp * 16 + (lane & 15), p0 = G::SPLIT ? wg * G::KP : 0;
#pragma unroll
    for (int k = 0; k < G::KS; ++k) {
      const uint32_t at = sQ + (p0 + k / 4) * (G::ROWS * 128) + swz(row, 2 * (k % 4) + (lane >> 4));
      asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(a[k][0]), "=r"(a[k][1]), "=r"(a[k][2]), "=r"(a[k][3])
                   : "r"(at));
    }
    __syncthreads();  // the ring's space is free again
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      const bool ok = r < N;
      st.m[h] = -INFINITY;
      st.l[h] = 0.f;
      st.ll[h] = 0.f;
      st.bv[h] = -INFINITY;
      st.bi[h] = INT_MAX;
      st.lab[h] = ok ? labels[r] : -1;
    }
  }

  // the logits of tile t (in slot b) into this thread's statistics: the
  // products start from the bias (at SPLIT, on this warpgroup's columns
  // only, so that the exchanged sums hold it once)
  auto tile = [&](int t, int b) {
    float s[16];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const float2 bb = G::SPLIT && (nt >> 1) != wg ? make_float2(0.f, 0.f)
                                                      : *reinterpret_cast<const float2*>(cols + b * T + 8 * nt + 2 * tq);
      s[4 * nt] = s[4 * nt + 2] = bb.x;
      s[4 * nt + 1] = s[4 * nt + 3] = bb.y;
    }
#ifndef VB_XENT_FWD_NO_LOGITS
    vb_hopper::wg_fence();
    fwd_logits<HID, ET>(s, a, sQ + b * G::TILE_BYTES, G::SPLIT ? wg * G::KP : 0);
    vb_hopper::wg_commit();
    vb_hopper::wg_wait();
    hold(s);
    keep(a);
#endif
    float z[4 * G::NTC];
    if constexpr (G::SPLIT) {  // finish the columns [wg T / 2, wg T / 2 + T / 2)
#pragma unroll
      for (int k = 0; k < XV; ++k) {
        z[k] = wg ? s[XV + k] : s[k];
        xch[((wg ^ 1) * XV + k) * 128 + tid] = wg ? s[k] : s[XV + k];
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < XV; ++k) z[k] += xch[(wg * XV + k) * 128 + tid];
    } else {
#pragma unroll
      for (int k = 0; k < 16; ++k) z[k] = s[k];
    }
#ifndef VB_XENT_FWD_NO_STATS
    st.add(z, t * T + (G::SPLIT ? wg * (T / 2) : 0), V, tq);
#else
#pragma unroll
    for (int k = 0; k < 4 * G::NTC; ++k) st.ll[0] += z[k];
#endif
  };

  for (int j = 0; j < ST - 1; ++j) {  // tiles t0 .. t0 + ST - 2, one commit group each
    if (t0 + j < t1) issue(t0 + j, j);
    vb_hopper::cp_commit();
  }
  for (int t = t0, b = 0; t < t1; ++t) {
    vb_hopper::cp_wait<ST - 2>();
    vb_hopper::fence_async();
    __syncthreads();  // tile t landed; every thread is done with tile t - 1 (its slot, xch)
    if (t + ST - 1 < t1) issue(t + ST - 1, b == 0 ? ST - 1 : b - 1);
    vb_hopper::cp_commit();
    tile(t, b);
    b = b + 1 == ST ? 0 : b + 1;
  }

  st.merge_quad();
  const size_t plane = (size_t)gridDim.y * N, at = (size_t)blockIdx.y * N;
  if constexpr (!G::SPLIT) {
    if (tq == 0)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (r0 + 8 * h < N)
          store_partial(pf, pi, plane, at + r0 + 8 * h, st.m[h], st.l[h], st.ll[h], st.bv[h], st.bi[h]);
  } else {  // the two warpgroups' columns of a row meet here
    if (tq == 0)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* o = red + ((size_t)wg * RES + i0 + 8 * h) * 5;
        o[0] = st.m[h];
        o[1] = st.l[h];
        o[2] = st.ll[h];
        o[3] = st.bv[h];
        reinterpret_cast<int*>(o)[4] = st.bi[h];
      }
    __syncthreads();
    const int i = threadIdx.x, r = blockIdx.x * RES + i;
    if (i < RES && r < N) {
      float m = -INFINITY, l = 0.f, ll = 0.f, bv = -INFINITY;
      int bi = INT_MAX;
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        const float* o = red + ((size_t)w * RES + i) * 5;
        lse_merge(m, l, o[0], o[1]);
        ll += o[2];
        argmax_merge(bv, bi, o[3], reinterpret_cast<const int*>(o)[4]);
      }
      store_partial(pf, pi, plane, at + r, m, l, ll, bv, bi);
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

// K4's shared memory allowed above 48 KB: set once a device, since the
// launch's host time counts beside its device time.
template <int HID, typename ET>
cudaError_t fwd_attributes() {
  return vb::once_a_device([] {
    return cudaFuncSetAttribute(xent_fwd_kernel<HID, ET>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)Fwd<HID>::SMEM);
  });
}

template <int HID, typename ET>
int launch_fwd(const void* x, const void* E, const void* bias, const void* labels, int N, int V, int S, int vbs,
               void* pf, void* pi, void* nll, void* lse, void* am, cudaStream_t st) {
  using G = Fwd<HID>;
  cudaError_t err = fwd_attributes<HID, ET>();
  if (err != cudaSuccess) return (int)err;
  xent_fwd_kernel<HID, ET><<<dim3(cdiv(N, G::ROWS), S), NTHREADS, G::SMEM, st>>>(
      static_cast<const ET*>(x), static_cast<const ET*>(E), static_cast<const float*>(bias),
      static_cast<const int*>(labels), N, V, vbs, static_cast<float*>(pf), static_cast<int*>(pi));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  xent_fwd_merge_kernel<<<cdiv(N, 128), 128, 0, st>>>(static_cast<const float*>(pf), static_cast<const int*>(pi),
                                                       N, S, static_cast<float*>(nll), static_cast<float*>(lse),
                                                       static_cast<int*>(am));
  return (int)cudaGetLastError();
}

template <int HID, typename ET>
int launch_dx(const void* x, const void* E, const void* bias, const void* labels, const void* lse, const void* g,
              int N, int V, int S, int vbs, void* part, void* dx, cudaStream_t st) {
  using G = Bwd<HID>;
  cudaError_t err = cudaFuncSetAttribute(xent_bwd_kernel<HID, false, ET>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::SMEM);
  if (err != cudaSuccess) return (int)err;
  xent_bwd_kernel<HID, false, ET><<<dim3(cdiv(N, RES), HID / G::COLS, S), NTHREADS, G::SMEM, st>>>(
      static_cast<const ET*>(x), static_cast<const ET*>(E), static_cast<const float*>(bias),
      static_cast<const int*>(labels), static_cast<const float*>(lse), nullptr, N, V, vbs,
      static_cast<float*>(part), nullptr, nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int quads = cdiv(N * (HID / 4), 256);
  xent_dx_reduce_kernel<HID, ET><<<quads < 4096 ? quads : 4096, 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<const float*>(g), N, S, static_cast<ET*>(dx));
  return (int)cudaGetLastError();
}

template <int HID, typename ET>
int launch_de(const void* x, const void* E, const void* bias, const void* labels, const void* lse, const void* g,
              int N, int V, void* dE, void* db, cudaStream_t st) {
  using G = Bwd<HID>;
  cudaError_t err = cudaFuncSetAttribute(xent_bwd_kernel<HID, true, ET>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)G::SMEM);
  if (err != cudaSuccess) return (int)err;
  xent_bwd_kernel<HID, true, ET><<<dim3(cdiv(V, RES), HID / G::COLS), NTHREADS, G::SMEM, st>>>(
      static_cast<const ET*>(x), static_cast<const ET*>(E), static_cast<const float*>(bias),
      static_cast<const int*>(labels), static_cast<const float*>(lse), static_cast<const float*>(g), N, V, 0,
      nullptr, static_cast<ET*>(dE), static_cast<float*>(db));
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ cluster helpers
//
// What the cluster forms (the 1024 form below and the wide form, the last
// section) share.

// The thread-block cluster of K5/K6 at 1024 and of the wide K5/K6: this
// block's rank and the cluster's blocks; a barrier of every thread of the
// cluster's blocks that releases each thread's earlier shared-memory writes
// and acquires the others'; the address of a shared-memory location of this
// block in the block of another rank; 8 bytes stored there, counted on that
// block's mbarrier bar (an address from cluster_addr).
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}
__device__ __forceinline__ int cluster_blocks() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return (int)r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_async2(uint32_t addr, float a, float b, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];\n" ::"r"(addr),
               "f"(a), "f"(b), "r"(bar)
               : "memory");
}
// An mbarrier of this block that completes a phase on one arrival and the
// bytes it expects; that arrival, expecting `bytes`; a wait until phase
// `parity` completes. A copy of `bytes` (a multiple of 16) of this block's
// shared memory into another block's (dst, and its mbarrier bar, from
// cluster_addr), which counts them on that mbarrier; this thread's copies
// committed as a group; a wait until they have read their sources.
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\nfence.mbarrier_init.release.cluster;\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void bulk_to_cluster(uint32_t dst, uint32_t src, int bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   dst),
               "r"(src), "r"(bytes), "r"(bar)
               : "memory");
}
// Box {c0, c1} (columns, rows) of the 2-D tensor of `map` into shared
// memory at dst, in the map's swizzle, counted on mbarrier bar.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void bulk_wait_read() { asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory"); }
__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }
// Wait until at most the newest wgmma group is pending.
__device__ __forceinline__ void wg_wait1() { asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory"); }
// An mbarrier of this block that completes a phase on `count` arrivals; an
// arrival on it.
__device__ __forceinline__ void mbar_init_count(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\nfence.mbarrier_init.release.cluster;\n" ::"r"(bar), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// The TMA map of a [rows, hid] matrix of ET: boxes of 64 columns (128 B,
// swizzled as swz lays them out) by box_rows rows, zeros past the last row.
template <typename ET>
cudaError_t wide_map(CUtensorMap* map, const void* ptr, int rows, int hid, int box_rows = 64) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    void* fn = nullptr;
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault,
                                                             &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess) return cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)hid, (cuuint64_t)rows}, strides[1] = {(cuuint64_t)hid * sizeof(ET)};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows}, steps[2] = {1, 1};
  const CUresult r = encode(map, std::is_same<ET, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                                                  : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                            2, const_cast<void*>(ptr), dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ------------------------------------------------------------ the 1024 form
//
// K5 and K6 at hidden width 1024 (bert-large's, and every width from 769
// up that the wrapper zero-pads onto it), bf16 and fp16: xent_h1024_bwd_kernel
// replaces the same TPU kernels as xent_bwd_kernel
// (visualbert_tpu/ops/mlm_xent.py::_dx_kernel :145, ::_de_kernel :170).
// Bound by its two N V 1024 products: at N = 3072, V = 30522, 384 GFLOP,
// 0.388 ms at 989 TFLOP/s, against 62.5 MB of E.
// - What it replaces. xent_bwd_kernel at 1024 kept a resident tile of 64 x
//   1024 (128 KB), which left room for streamed tiles of 16 rows only
//   (m64n16 logits, the narrowest wgmma), and its accumulator of 64 x 1024
//   fp32 did not fit a block's registers: a block owned 512 columns and a
//   second block formed every tile's logits again for the other 512 (three
//   N V H products, not two), each step's barriers, exchange and dlog math
//   with the tensor cores idle (3.09 ms, 2.1x cuBLAS's two products, on an
//   NVIDIA H100 80GB HBM3 at 700 W, PERF.md).
// - A cluster of two blocks (H_R) shares one resident row block (K5: 64 rows
//   of x, and K5's vocabulary split; K6: 64 rows of E). Block r keeps the
//   panels [8 r, 8 r + 8) of the resident rows (64 KB, by TMA, once) and
//   streams its 8 panels of every tile of 64 streamed rows through two
//   stages of 64 KB (TMA, one box a panel, counted on an mbarrier a stage):
//   each streamed byte is read once a (row block, column half), and one
//   copy feeds both products.
// - The logits by split K, formed once. Each warpgroup multiplies its 32
//   columns of the tile (m64n32) over the block's 8 panels, each panel's
//   four k-steps in a fresh accumulator added into the tile's partial sums
//   in panel order, two panels in flight. Each thread then stores its 16
//   partial sums into the other block's shared memory (four 16-byte
//   st.async, whose bytes that block's mbarrier counts), where the thread of
//   the same index, which holds the same places of the tile, adds them to
//   its own: both blocks form the same sums (a sum of two fp32 terms does
//   not depend on their order), then the bias, and so the whole 64 x 64
//   dlog tile, each by itself. No dlog row crosses the cluster, and the
//   exchange is one hop: the wide form's cluster sends partial sums to the
//   block that owns a row and the dlog rows back. The receive buffer is
//   one: a block stores a tile's partial sums only after the other has
//   signalled (a remote arrival on this block's `free` mbarrier, given under
//   its product) that it read the previous tile's, a whole tile earlier.
// - Products. The dlog tile (bf16 or fp16, K-major, swizzled) times the
//   block's panels of the streamed tile, each warpgroup into its four
//   m64n64 accumulators (the block's panels 2 j + wg, 128 registers),
//   waited for at the end of the tile. Left running under the next tile's
//   logits it made ptxas serialize every wgmma of K5 or K6 (C7515: the
//   kernel ran 1.4x slower, PERF.md). Every wgmma runs on every path, none
//   under a condition.
// - What overlaps. Tile t + 1's copy (64 KB, TMA) runs under the whole of
//   tile t: thread 0 issues it once tile t's second panel is in flight and
//   a block barrier has shown both warpgroups done with tile t - 1. Thread
//   0's signal to the other block runs under the product. The exchange, the
//   dlog math and the two barriers a tile run with the tensor cores idle:
//   a third stage, which would let them run under the next tile's logits,
//   does not fit beside the resident rows (PERF.md).
// - dlog math. Every load (the other block's sums, the columns' values) is
//   issued before the first store of the dlog tile (one pointer reaches
//   both, so the stores would order them), and every exp is computed and
//   then masked: under a condition each was a branch of its own.
// - Rows' values. Each tile's K5 bias or K6 (lse, label, g) of its 64
//   streamed rows by 4-byte cp.async into two slots, issued with the tile's
//   copy and waited for at the barrier of the next tile.
// - Numerics. Each panel's products in a fresh fp32 accumulator, summed in
//   panel order, then the two blocks' sums, then the bias; dlog rounded to
//   the element type before the product; K5's splits summed in split order
//   by xent_dx_reduce_kernel and scaled by g there; no atomics, so two calls
//   agree bit for bit. Rows past N and V are zeros from TMA and give dlog 0;
//   E is read in place.
// - Grid. K5: (cdiv(N, 64), 2, S) in clusters of (1, 2, 1), S vocabulary
//   splits chosen from the clusters that run at once (ops/mlm_xent.py,
//   wide_dx_plan over vb_xent_info(0, 4, 1024)); K6: (cdiv(V, 64), 2), each
//   cluster over every x tile. The wrapper raises where no cluster fits.
// Switches for tools/xent_steps.py --h1024, which the kernel library never
// defines (wrong results, timing only): VB_XENT_H1024_NO_COPY, no stage after
// a block's first is copied (every tile reads the first); _NO_LOGITS, no
// logits products (zeros); _NO_EXCHANGE, no partial sums cross the cluster
// (each block's own); _NO_PRODUCT, no second product.

constexpr int H_R = 2;                          // blocks a cluster
constexpr int H_CP = 8;                         // 64-column panels a block owns: 512 columns
constexpr int H_ROWS = 64;                      // resident rows a cluster: wgmma's m64
constexpr int H_TILE = 64;                      // streamed rows a tile: two warpgroups' m64n32 logits
constexpr int H_RES_BYTES = H_ROWS * H_CP * 128;     // 64 KB
constexpr int H_STAGE_BYTES = H_TILE * H_CP * 128;   // 64 KB
constexpr int H_X_BYTES = H_ROWS * H_TILE * 4;       // the other block's partial logits of a tile, fp32
constexpr int H_D_BYTES = H_ROWS * H_TILE * 2;       // the dlog tile
constexpr int H_V_BYTES = 2 * NV * H_TILE * 4;       // two slots of the streamed rows' values
constexpr size_t H_SMEM = vb_hopper::ALIGN + H_RES_BYTES + 2 * H_STAGE_BYTES + H_X_BYTES + H_D_BYTES + H_V_BYTES +
                          5 * sizeof(uint64_t);
static_assert(H_R * H_CP * 64 == 1024 && H_TILE % 16 == 0, "two blocks of 512 columns cover width 1024");
static_assert(H_SMEM <= 232448, "a 1024 block must fit the H100's 227 KB of shared memory");
static_assert(NV * H_TILE <= NTHREADS, "a thread copies one value of a tile's rows");

#ifndef VB_XENT_H1024_NO_COPY
constexpr bool H_COPY = true;
#else
constexpr bool H_COPY = false;
#endif
#ifndef VB_XENT_H1024_NO_LOGITS
constexpr bool H_LOGITS = true;
#else
constexpr bool H_LOGITS = false;
#endif
#ifndef VB_XENT_H1024_NO_EXCHANGE
constexpr bool H_EXCHANGE = true;
#else
constexpr bool H_EXCHANGE = false;
#endif
#ifndef VB_XENT_H1024_NO_PRODUCT
constexpr bool H_PRODUCT = true;
#else
constexpr bool H_PRODUCT = false;
#endif

// 16 bytes stored into another block of the cluster (an address from
// cluster_addr), counted on that block's mbarrier bar.
__device__ __forceinline__ void st_async4(uint32_t addr, float a, float b, float c, float d, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(
                   addr),
               "f"(a), "f"(b), "f"(c), "f"(d), "r"(bar)
               : "memory");
}
// An arrival on the mbarrier of another block of the cluster (an address
// from cluster_addr) that releases this block's earlier accesses at the
// cluster's scope; a wait on this block's mbarrier that acquires them.
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// K5 (DE false): grid (cdiv(N, H_ROWS), H_R, S), clusters of (1, H_R, 1);
// cluster (x, z) keeps x rows [64 x, 64 x + 64) and walks the vocabulary
// tiles [z vbs, z vbs + vbs); its block of rank r writes its 512 columns of
// the fp32 partial part [S][N][1024]. K6 (DE true): grid (cdiv(V, H_ROWS),
// H_R), the same clusters; cluster x keeps E rows [64 x, 64 x + 64) and
// walks every x tile; block r writes its columns of those rows of dE, and
// rank 0 their db.
template <bool DE, typename ET>
__global__ void __launch_bounds__(NTHREADS, 1)
xent_h1024_bwd_kernel(const __grid_constant__ CUtensorMap mres, const __grid_constant__ CUtensorMap mstr,
                      const float* __restrict__ bias, const int* __restrict__ labels, const float* __restrict__ lse,
                      const float* __restrict__ gr, int N, int V, int vbs, float* __restrict__ part,
                      ET* __restrict__ dE, float* __restrict__ db) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = vb_hopper::align_smem(smem_raw);
  const uint32_t sR = smem_addr(sm);                  // the resident rows: H_CP panels of 64 rows
  const uint32_t sQ = sR + H_RES_BYTES;               // two stages: H_CP panels of H_TILE streamed rows
  const uint32_t sX = sQ + 2 * H_STAGE_BYTES;         // [4][NTHREADS] float4: the other block's partial logits
  const uint32_t sD = sX + H_X_BYTES;                 // [64][64] the dlog tile, K-major, swizzled
  const uint32_t sC = sD + H_D_BYTES;                 // [2 slots][NV][H_TILE] the streamed rows' values
  // mbarriers: the resident panels landed; stage 0 / 1 landed (a phase every
  // other tile); the other block's partial logits of a tile arrived (a phase
  // a tile); the other block read this block's (a phase a tile)
  const uint32_t resFull = sC + H_V_BYTES, full0 = resFull + 8, xFull = full0 + 16, xFree = xFull + 8;
  const float* X = reinterpret_cast<const float*>(sm + (sX - sR));
  const float* cols = reinterpret_cast<const float*>(sm + (sC - sR));

  const int rank = cluster_rank(), p0 = rank * H_CP, other = rank ^ 1;
  const int r0 = blockIdx.x * H_ROWS;
  const int nres = DE ? V : N, nstr = DE ? N : V;
  const int ntiles = cdiv(nstr, H_TILE);
  const int t0 = DE ? 0 : blockIdx.z * vbs, t1 = DE ? ntiles : min(ntiles, t0 + vbs);
  const int tid = threadIdx.x & 127, wg = threadIdx.x >> 7, warp = tid >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int i0 = warp * 16 + g;  // this thread's resident rows: i0, i0 + 8

  if (threadIdx.x == 0) {
    mbar_init(resFull);
    mbar_init(full0);
    mbar_init(full0 + 8);
    mbar_init(xFull);
    mbar_expect(xFull, H_X_BYTES);
    mbar_init_count(xFree, 1);
  }
  cluster_sync();  // every block's mbarriers are ready before any block signals one

  // tile t into its stage (its 8 panels, one TMA box each, rows past the
  // matrix zero) by thread 0, and its rows' values into their slot by
  // cp.async (K5: the bias of each vocabulary row; K6: the lse, label and g
  // of each x row; zero past the end, where the row's dlog is 0 anyway)
  auto issue_tile = [&](int t) {
    const int b = (t - t0) & 1;
    if (threadIdx.x == 0) {
      const uint32_t dst = sQ + b * H_STAGE_BYTES, bar = full0 + 8 * b;
      mbar_expect(bar, H_STAGE_BYTES);
      for (int p = 0; p < H_CP; ++p) tma_load_2d(dst + p * (H_TILE * 128), &mstr, (p0 + p) * 64, t * H_TILE, bar);
    }
    if (threadIdx.x < (DE ? NV : 1) * H_TILE) {
      const int k = threadIdx.x / H_TILE, c = threadIdx.x % H_TILE, j = t * H_TILE + c, jj = j < nstr ? j : 0;
      const void* src = DE ? (k == 0 ? (const void*)(lse + jj) : k == 1 ? (const void*)(labels + jj)
                                                                         : (const void*)(gr + jj))
                           : (const void*)(bias + jj);
      cp_async4(sC + 4 * ((b * NV + k) * H_TILE + c), src, j < nstr);
    }
    vb_hopper::cp_commit();
  };

  if (threadIdx.x == 0) {
    mbar_expect(resFull, H_RES_BYTES);
    for (int p = 0; p < H_CP; ++p) tma_load_2d(sR + p * (H_ROWS * 128), &mres, (p0 + p) * 64, r0, resFull);
  }
  issue_tile(t0);

  // per resident row h of this thread: K5 the lse (inf past N: p = 0) and
  // label (-1) of x row r0 + i; K6 the bias of vocabulary row r0 + i and a
  // factor of 1, 0 past V
  float rv[2], rk[2], dsum[2] = {0.f, 0.f};
  int rid[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + i0 + 8 * h;
    rk[h] = r < V ? 1.f : 0.f;
    if (DE) {
      rv[h] = r < V ? bias[r] : 0.f;
      rid[h] = r;
    } else {
      rv[h] = r < N ? lse[r] : INFINITY;
      rid[h] = r < N ? labels[r] : -1;
    }
  }
  // this warpgroup's result columns: accumulator j holds the block's panel 2 j + wg
  float acc[4][32];
#pragma unroll
  for (int j = 0; j < 4; ++j) vb_hopper::zero(acc[j]);

  mbar_wait(resFull, 0);
  const uint64_t da = vb_hopper::desc(sR);
  for (int t = t0; t < t1; ++t) {
    const int b = H_COPY ? (t - t0) & 1 : 0;
    const uint32_t q = sQ + b * H_STAGE_BYTES;
    if (H_COPY || t == t0) mbar_wait(full0 + 8 * b, ((t - t0) >> 1) & 1);  // tile t

    // this warpgroup's partial logits of tile t into z: the 64 rows x its
    // columns [32 wg, 32 wg + 32), each panel's products in a fresh
    // accumulator (s0, s1 in turn) added into z in panel order
    float z[16], s0[16], s1[16];
    const uint64_t dq = vb_hopper::desc(q + wg * 32 * 128);
    auto panel = [&](float(&s)[16], int p) {
      vb_hopper::wg_fence();
      if constexpr (H_LOGITS) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_n32<ET>(s, da + ((p * (H_ROWS * 128)) >> 4) + 2 * kk, dq + ((p * (H_TILE * 128)) >> 4) + 2 * kk, kk);
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i) s[i] = 0.f;
      }
      vb_hopper::wg_commit();
    };
    // panel p + 2 is issued as soon as panel p is added in, so two are in
    // flight while one is added; tile t + 1's copy is issued under panels 1
    // and 2, once a barrier has shown both warpgroups done with tile t - 1's
    // stage and dlog tile (each waited for its product at the end of tile t
    // - 1) and tile t's values landed
    panel(s0, 0);
    panel(s1, 1);
#pragma unroll
    for (int p = 0; p < H_CP; p += 2) {
      wg_wait1();  // panel p
      hold(s0);
#pragma unroll
      for (int i = 0; i < 16; ++i) z[i] = p == 0 ? s0[i] : z[i] + s0[i];
      if (p + 2 < H_CP) panel(s0, p + 2);
      if (p == 0) {
        vb_hopper::cp_wait<0>();
        __syncthreads();
        if (H_COPY && t + 1 < t1) issue_tile(t + 1);
      }
      if (p + 2 < H_CP)
        wg_wait1();  // panel p + 1
      else
        vb_hopper::wg_wait();
      hold(s1);
#pragma unroll
      for (int i = 0; i < 16; ++i) z[i] += s1[i];
      if (p + 3 < H_CP) panel(s1, p + 3);
    }

    // the exchange: this thread's 16 partial sums into the other block's
    // receive buffer, where the thread of the same index there reads them
    // (the same places of the tile: [4][NTHREADS] float4, 16 bytes a store),
    // once it has read the previous tile's; then the other block's
    if constexpr (H_EXCHANGE) {
      if (t > t0) mbar_wait_cluster(xFree, (t - 1 - t0) & 1);
      const uint32_t bar = cluster_addr(xFull, other), dst = cluster_addr(sX + 16 * threadIdx.x, other);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        st_async4(dst + k * (16 * NTHREADS), z[4 * k], z[4 * k + 1], z[4 * k + 2], z[4 * k + 3], bar);
      mbar_wait(xFull, (t - t0) & 1);
    }

    // the logits of this thread's places: both blocks' sums, then the bias;
    // their dlog, rounded, into the dlog tile. Every load is issued before
    // the first store (one pointer reaches both: the stores would order
    // them). Column nt, e of this thread: c = 32 wg + 8 nt + 2 tq + e.
    if constexpr (H_EXCHANGE) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 o = reinterpret_cast<const float4*>(X)[k * NTHREADS + threadIdx.x];
        z[4 * k] += o.x;
        z[4 * k + 1] += o.y;
        z[4 * k + 2] += o.z;
        z[4 * k + 3] += o.w;
      }
    }
    const float* cv = cols + ((t - t0) & 1) * NV * H_TILE + wg * 32 + 2 * tq;  // [NV][H_TILE] of tile t
    float2 c0[4], c1[4], c2[4];  // K5: the bias; K6: the lse, the label (bits) and g of each column pair
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      c0[nt] = *reinterpret_cast<const float2*>(cv + 8 * nt);
      if (DE) {
        c1[nt] = *reinterpret_cast<const float2*>(cv + H_TILE + 8 * nt);
        c2[nt] = *reinterpret_cast<const float2*>(cv + 2 * H_TILE + 8 * nt);
      }
    }
    uint32_t packed[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float d[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float zz = z[4 * nt + 2 * h + e], cc0 = e ? c0[nt].y : c0[nt].x;
          const int j = t * H_TILE + wg * 32 + 8 * nt + 2 * tq + e;
          // the exp of every place, then the mask as a factor of 0 or 1 (p
          // is finite everywhere): under a condition the compiler sank each
          // exp into a branch of its own, run one by one
          if (DE) {  // row: vocabulary id rid; column: x row j (its lse and g 0 past N)
            const float p = expf(zz + rv[h] - cc0);
            const int lab = __float_as_int(e ? c1[nt].y : c1[nt].x);
            d[e] = (p - (lab == rid[h] ? 1.f : 0.f)) * ((e ? c2[nt].y : c2[nt].x) * rk[h]);
            dsum[h] += d[e];
          } else {   // row: x row with label rid (lse inf past N: p = 0); column: vocabulary id j
            const float p = expf(zz + cc0 - rv[h]);
            d[e] = (p - (rid[h] == j ? 1.f : 0.f)) * (j < V ? 1.f : 0.f);
          }
        }
        packed[nt][h] = vb::Elem<ET>::pack(d[0], d[1]);
      }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = i0 + 8 * h, c = wg * 32 + nt * 8 + 2 * tq;
        *reinterpret_cast<uint32_t*>(sm + (sD - sR) + swz(i, c >> 3) + (c & 7) * 2) = packed[nt][h];
      }
    vb_hopper::fence_async();
    __syncthreads();  // the dlog tile is whole; every thread has read the other block's partial sums

    // this warpgroup's result columns += dlog . its panels of tile t
    vb_hopper::wg_fence();
    if constexpr (H_PRODUCT) {
      const uint64_t dp = vb_hopper::desc(sD);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint64_t dk = vb_hopper::desc(q + (2 * j + wg) * (H_TILE * 128));
#pragma unroll
        for (int kk = 0; kk < H_TILE / 16; ++kk) wgmma_n64_tb<ET>(acc[j], dp + 2 * kk, dk + ((kk * 2048) >> 4));
      }
    }
    vb_hopper::wg_commit();
    // the other block may send the next tile's partial sums: this block
    // expects them first (thread 0, under the product)
    if (H_EXCHANGE && threadIdx.x == 0 && t + 1 < t1) {
      mbar_expect(xFull, H_X_BYTES);
      mbar_arrive_remote(cluster_addr(xFree, other));
    }
    // waited for here: left running under the next tile's logits, it made
    // ptxas serialize every wgmma of the kernel (C7515), K5's or K6's
    // depending on the rest of the loop
    vb_hopper::wg_wait();
#pragma unroll
    for (int j = 0; j < 4; ++j) hold(acc[j]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + i0 + 8 * h;
    if (r >= nres) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = (p0 + 2 * j + wg) * 64 + nt * 8 + 2 * tq;
        const float a = acc[j][4 * nt + 2 * h], c = acc[j][4 * nt + 2 * h + 1];
        if (DE)
          *reinterpret_cast<uint32_t*>(dE + (size_t)r * 1024 + col) = vb::Elem<ET>::pack(a, c);
        else
          *reinterpret_cast<float2*>(part + ((size_t)blockIdx.z * N + r) * 1024 + col) = make_float2(a, c);
      }
  }
  if (DE && rank == 0) {  // db: both blocks formed the same dlog; each thread's columns, then the warpgroups'
    float* red = reinterpret_cast<float*>(sm + (sX - sR));  // the receive buffer: nothing arrives any more
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = dsum[h];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (tq == 0) red[wg * H_ROWS + i0 + 8 * h] = v;
    }
    __syncthreads();
    const int i = threadIdx.x;
    if (i < H_ROWS && r0 + i < V) db[r0 + i] = red[i] + red[H_ROWS + i];
  }
  cluster_sync();  // no block leaves while the other may still signal it
}

// The 1024 form's cluster launch: `grid` in clusters of (1, H_R, 1), 256
// threads, H_SMEM bytes; attr is the storage of its one attribute.
cudaLaunchConfig_t h1024_config(dim3 grid, cudaStream_t st, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = H_SMEM;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1;
  attr->val.clusterDim.y = H_R;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool DE, typename ET>
cudaError_t h1024_attributes() {
  return vb::once_a_device([] {
    return cudaFuncSetAttribute(xent_h1024_bwd_kernel<DE, ET>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)H_SMEM);
  });
}

// The clusters of the 1024 form's K5 (DE false) or K6 that the card runs at
// once (0: none fits), or -1 on an error.
template <bool DE, typename ET>
int h1024_active_clusters() {
  if (h1024_attributes<DE, ET>() != cudaSuccess) return -1;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = h1024_config(dim3(1, H_R, 1), nullptr, &attr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, xent_h1024_bwd_kernel<DE, ET>, &cfg) != cudaSuccess) return -1;
  return n;
}

// K5 (DE false, z vocabulary splits) or K6 (DE true) at width 1024: the
// launch's own error where no cluster fits.
template <bool DE, typename ET>
int launch_h1024_bwd(int z, const void* x, const void* E, const void* bias, const void* labels, const void* lse,
                     const void* g, int N, int V, int vbs, void* part, void* dE, void* db, cudaStream_t st) {
  CUtensorMap mres, mstr;
  cudaError_t err = h1024_attributes<DE, ET>();
  if (err == cudaSuccess) err = wide_map<ET>(&mres, DE ? E : x, DE ? V : N, 1024);
  if (err == cudaSuccess) err = wide_map<ET>(&mstr, DE ? x : E, DE ? N : V, 1024);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = h1024_config(dim3(cdiv(DE ? V : N, H_ROWS), H_R, z), st, &attr);
  err = cudaLaunchKernelEx(&cfg, xent_h1024_bwd_kernel<DE, ET>, mres, mstr, static_cast<const float*>(bias),
                           static_cast<const int*>(labels), static_cast<const float*>(lse),
                           static_cast<const float*>(g), N, V, vbs, static_cast<float*>(part), static_cast<ET*>(dE),
                           static_cast<float*>(db));
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <typename ET>
int launch_h1024_dx(const void* x, const void* E, const void* bias, const void* labels, const void* lse,
                    const void* g, int N, int V, int S, int vbs, void* part, void* dx, cudaStream_t st) {
  const int err = launch_h1024_bwd<false, ET>(S, x, E, bias, labels, lse, nullptr, N, V, vbs, part, nullptr, nullptr,
                                              st);
  if (err != 0) return err;
  const int quads = cdiv(N * (1024 / 4), 256);
  xent_dx_reduce_kernel<1024, ET><<<quads < 4096 ? quads : 4096, 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<const float*>(g), N, S, static_cast<ET*>(dx));
  return (int)cudaGetLastError();
}

template <typename ET>
int launch_h1024_de(const void* x, const void* E, const void* bias, const void* labels, const void* lse,
                    const void* g, int N, int V, void* dE, void* db, cudaStream_t st) {
  return launch_h1024_bwd<true, ET>(1, x, E, bias, labels, lse, g, N, V, 0, nullptr, dE, db, st);
}

// The widths the kernels are instantiated for, in order.
constexpr int WIDTHS[] = {128, 256, 512, 768, 1024};

// Everything the entry points need of one (width, element type): the three
// kernels (K5, K6, K4), their shared memory and launches, the tiling.
struct Form {
  const void* kernel[3];
  size_t bytes[3];
  int geometry[6];
  int (*fwd)(const void*, const void*, const void*, const void*, int, int, int, int, void*, void*, void*, void*,
             void*, cudaStream_t);
  int (*dx)(const void*, const void*, const void*, const void*, const void*, const void*, int, int, int, int, void*,
            void*, cudaStream_t);
  int (*de)(const void*, const void*, const void*, const void*, const void*, const void*, int, int, void*, void*,
            cudaStream_t);
};

template <int HID, typename ET>
Form form_of() {
  return Form{{(const void*)xent_bwd_kernel<HID, false, ET>, (const void*)xent_bwd_kernel<HID, true, ET>,
               (const void*)xent_fwd_kernel<HID, ET>},
              {Bwd<HID>::SMEM, Bwd<HID>::SMEM, Fwd<HID>::SMEM},
              {HID, Fwd<HID>::ROWS, RES, Fwd<HID>::T, Bwd<HID>::T, Bwd<HID>::COLS},
              launch_fwd<HID, ET>,
              launch_dx<HID, ET>,
              launch_de<HID, ET>};
}

// Width 1024: K4's form, K5/K6 on the 1024 form's cluster kernel.
template <typename ET>
Form form_1024() {
  return Form{{(const void*)xent_h1024_bwd_kernel<false, ET>, (const void*)xent_h1024_bwd_kernel<true, ET>,
               (const void*)xent_fwd_kernel<1024, ET>},
              {H_SMEM, H_SMEM, Fwd<1024>::SMEM},
              {1024, Fwd<1024>::ROWS, H_ROWS, Fwd<1024>::T, H_TILE, H_CP * 64},
              launch_fwd<1024, ET>,
              launch_h1024_dx<ET>,
              launch_h1024_de<ET>};
}

// The form of width hid in bf16 (dtype 0) or fp16 (1), or nullptr.
const Form* form(int dtype, int hid) {
  static const Form forms[2][5] = {
      {form_of<128, bf16>(), form_of<256, bf16>(), form_of<512, bf16>(), form_of<768, bf16>(), form_1024<bf16>()},
      {form_of<128, __half>(), form_of<256, __half>(), form_of<512, __half>(), form_of<768, __half>(),
       form_1024<__half>()}};
  if (dtype != 0 && dtype != 1) return nullptr;
  for (int w = 0; w < 5; ++w)
    if (WIDTHS[w] == hid) return &forms[dtype][w];
  return nullptr;
}

int info(int dtype, int kernel, int what, int hid) {
  const Form* f = form(dtype, hid);
  if (f == nullptr || kernel < 0 || kernel > 2) return -1;
  const void* fn = f->kernel[kernel];
  const size_t bytes = f->bytes[kernel];
  if (what == 0 || what == 1) {
    cudaFuncAttributes attr;
    if (cudaFuncGetAttributes(&attr, fn) != cudaSuccess) return -1;
    return what == 0 ? attr.numRegs : (int)attr.localSizeBytes;
  }
  if (what == 2) return (int)bytes;
  if (what == 3) {
    int n = 0;
    if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes) != cudaSuccess) return -1;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, NTHREADS, bytes) != cudaSuccess) return -1;
    return n;
  }
  if (what == 4 && hid == 1024 && kernel < 2)
    return dtype == 0 ? (kernel == 0 ? h1024_active_clusters<false, bf16>() : h1024_active_clusters<true, bf16>())
                      : (kernel == 0 ? h1024_active_clusters<false, __half>() : h1024_active_clusters<true, __half>());
  return -1;
}

int fwd(int dtype, const void* x, const void* E, const void* bias, const void* labels, int N, int V, int hid, int S,
        int vbs, void* pf, void* pi, void* nll, void* lse, void* am, void* stream) {
  const Form* f = form(dtype, hid);
  if (f == nullptr) return (int)cudaErrorInvalidValue;
  return f->fwd(x, E, bias, labels, N, V, S, vbs, pf, pi, nll, lse, am, static_cast<cudaStream_t>(stream));
}

int dx(int dtype, const void* x, const void* E, const void* bias, const void* labels, const void* lse, const void* g,
       int N, int V, int hid, int S, int vbs, void* part, void* out, void* stream) {
  const Form* f = form(dtype, hid);
  if (f == nullptr) return (int)cudaErrorInvalidValue;
  return f->dx(x, E, bias, labels, lse, g, N, V, S, vbs, part, out, static_cast<cudaStream_t>(stream));
}

int de(int dtype, const void* x, const void* E, const void* bias, const void* labels, const void* lse, const void* g,
       int N, int V, int hid, void* dE, void* db, void* stream) {
  const Form* f = form(dtype, hid);
  if (f == nullptr) return (int)cudaErrorInvalidValue;
  return f->de(x, E, bias, labels, lse, g, N, V, dE, db, static_cast<cudaStream_t>(stream));
}

// ------------------------------------------------------------ the wide form
//
// K4-K6 in bf16 and fp16 at any width hid above 1024 that is a multiple of
// 64 (the wrapper zero-pads other widths to the next multiple of 64),
// templates on the element type; hid is a runtime argument. They replace
// the same TPU kernels as the forms above
// (visualbert_tpu/ops/mlm_xent.py::_fwd_kernel :52, ::_dx_kernel :145,
// ::_de_kernel :170).
// - K4 (xent_wide_fwd_kernel) is bound by its N V hid product (at N = 3072,
//   V = 30522, hid = 2048: 0.39 ms at 989 TFLOP/s). Its first design
//   streamed a 64-column panel of 128 x rows and of 64 vocabulary rows a
//   step through a cp.async ring that all 256 threads fed, and waited for
//   each panel's products before adding them: 24 KB from L2 for every 1
//   MFLOP, so L2's rate bound it, and the tensor cores idled through every
//   add and barrier (1.73 ms at 2048, 22 % of the bound, on an NVIDIA H100
//   80GB HBM3 at 700 W). Here:
//   * A tile is 128 x rows by WF_TILE = 128 vocabulary rows, each consumer
//     warpgroup an m64n128 over its 64 rows: a step (a 64-column panel of
//     both, 32 KB) feeds 2 MFLOP, a third fewer bytes from L2 a FLOP.
//   * A producer warp (its lane 0) issues the copies, TMA boxes of a panel
//     (rows past the matrix zero), into a ring of WF_STAGES stages, each
//     with a full mbarrier (the bytes that land) and an empty one (an
//     arrival of every consumer warp once its products of the stage ran):
//     it refills a stage as soon as both warpgroups have left it, and no
//     consumer ever waits on a release.
//   * Each step's products run in a fresh accumulator, waited for, then
//     added into the tile's logits in fp32 (see Accumulation); the two
//     consumer warpgroups interleave on the tensor cores, so one's products
//     run while the other adds, releases, or after a tile's last panel adds
//     the bias and takes RowStats (in place: add_in_place; the splits'
//     partials and xent_fwd_merge_kernel as K4's). A second accumulator a
//     warpgroup, to overlap its own adds, does not fit its registers beside
//     the tile's logits (255 and a spill, which serializes the wgmmas), nor
//     did sharing each E panel between two row blocks by TMA multicast run
//     faster (PERF.md).
// - K5 / K6 (xent_wide_bwd_kernel) are bound by their two N V hid products
//   (at N = 3072, V = 30522, hid = 2048: 0.78 ms at 989 TFLOP/s, against
//   125 MB of E). The first design, in which a block owned 512 columns,
//   formed every tile's logits again over the whole width for them (2.5 x
//   the products at 2048) and copied both operands' panels every tile, ran
//   at 3 % of that bound (23.73 / 20.72 ms on an NVIDIA H100 80GB HBM3 at
//   700 W). Here each tile's logits are formed once, by a thread-block
//   cluster:
//   * A cluster of R = cdiv(hid, WB_COLS) blocks shares one resident row
//     block (K5: WB_ROWS rows of x; K6: of E) and K5's vocabulary split;
//     block r owns the panels [r CP, r CP + CP) of the columns, CP =
//     cdiv(hid / 64, R) <= WB_CP (the last block may own fewer). It keeps
//     its panels of the resident rows in shared memory, copied once, and
//     streams only its panels of each tile of WB_TILE streamed rows through
//     two stages: one copy feeds both its products, and each streamed byte
//     is read once a (row block, column range). The copies are TMA's (one
//     a panel, by one thread, 128 B-swizzled as swz lays tiles out, rows
//     past the matrix zero), counted on an mbarrier a stage.
//   * The logits by split K. Each block multiplies its panels into fp32
//     partial logits of the tile, each panel's products in a fresh
//     accumulator added in panel order (see Accumulation), and stores each
//     row's partials into the shared memory of the block that sums that row
//     (distributed shared memory: st.async, whose bytes that block's
//     mbarrier counts). Block r sums its share of the tile's rows over the
//     R blocks' partials in rank order, forms their dlog (the exp, the
//     one-hot; K6 also the factor g and the db sums), writes it into its
//     own dlog tile and copies those rows into every other block's by bulk
//     copies, counted on that block's mbarrier; then each block multiplies
//     the whole dlog tile by its panels of the streamed tile. Every block
//     multiplies the same bits and nothing is added by atomics: two calls
//     agree bit for bit. No cluster barrier runs inside the loop: each
//     wait is on an mbarrier of the waiting block, and the order of the
//     exchange keeps every buffer's reuse safe (a block sends a tile's
//     partials only after the previous tile's dlog arrived, so every block
//     has summed the previous tile's; it sends its dlog rows only after every
//     block's partials arrived, each sent after that block's product).
//   * Shapes. A block keeps 64 resident rows, both warpgroups the same: each
//     forms half of a tile's logits columns (m64n32) and owns every other
//     panel of the block's for the result (four m64n64 accumulators, 128
//     registers). Every wgmma runs on every path, none under a condition,
//     and no accumulator is live across other code while its wgmma runs
//     (ptxas would serialize them): a block's panels past its own are
//     zeros in shared memory and add nothing.
//   * What bounds it (PERF.md: a build without the exchange, timed on an
//     NVIDIA H100 80GB HBM3 at 700 W): the exchange's chain of latencies
//     (partials out, sums, dlog rows out, each waited for before the
//     product) with the tensor cores idle; without it K5 runs in less than
//     half its time at 2048. The next tile's copy runs under the whole of
//     this one.
//   * Above 8 x 512 = 4096 columns the cluster is larger than the portable
//     8: the H100 takes 16 (WB_MAX_CLUSTER), so hid up to 8192; wider rows
//     run on the fp32 kernels. The wrapper raises where
//     cudaOccupancyMaxActiveClusters finds no room for a cluster
//     (vb_xent_wide_info's `what` 4); the launch itself returns its error.
//   K5 splits the vocabulary (ops/mlm_xent.py::wide_dx_plan, from the
//   clusters that run at once) and writes fp32 partials, which
//   xent_wide_dx_reduce_kernel sums in split order; K6 walks every x tile.
// - Accumulation. A wgmma chain over all of a wide row (128 k-steps at
//   2048) rounds differently from an fp32 sum: on the H100 the logits
//   drifted, lse by 2.3e-5 and db by 6.5e-6 of its largest value at 2048
//   in bf16, against 1.9e-6 and 7.1e-7 at 1024. So K4 starts a fresh
//   accumulator each panel (4 k-steps), which an fp32 add takes into the
//   logits' running total: 2.9e-6 and 1.0e-6 at 2048; K5's and K6's logits
//   likewise (each panel in a fresh accumulator, the panels and then the
//   cluster's blocks summed in fp32, in order).
//   fp16 runs on these kernels too. Its products carry 22 bits against
//   bf16's 16, and its db at 2560 was once read 3.9e-6 of its largest
//   value from the plain version's, beyond DBIAS_TOL (2e-6), which sent it
//   to the fp32 kernels. But the plain version's own fp32 sums of 2560 products
//   are 3.7e-6 from db with the products summed exactly (fp64,
//   tools/xent_steps.py::db_exact); the kernels' fp16 db is 3.7e-7 from it
//   at 2560 and 3.6e-7 at 2048, as near as bf16's (PERF.md): the
//   yardstick, not the products, was off. The same kernels serve both
//   dtypes (wgmma's .f16 or .bf16, the TMA maps' element type).
// Ragged N, V and the last column range are masked as above; E is read in
// place.

constexpr int WIDE_MIN = 1088;      // the narrowest wide width: 17 panels
constexpr int WF_ROWS = 128;        // wide K4: x rows a block, 64 a warpgroup
constexpr int WF_TILE = 128;        // wide K4: vocabulary rows a tile, each warpgroup's m64n128
constexpr int WF_STAGES = 6;        // wide K4: ring stages, each a 64-column panel of the x rows and the tile
constexpr int WF_THREADS = NTHREADS + 32;  // wide K4: two consumer warpgroups and a producer warp
constexpr int WF_X_BYTES = WF_ROWS * 128;             // a stage's panel of x
constexpr int WF_STAGE = WF_X_BYTES + WF_TILE * 128;  // ... and of the tile's E rows
constexpr size_t WF_SMEM = vb_hopper::ALIGN + WF_STAGES * WF_STAGE + 2 * WF_STAGES * sizeof(uint64_t);
constexpr int WB_ROWS = 64;                 // wide K5/K6: resident rows a block, both warpgroups' 64
constexpr int WB_COLS = 512;                // ... result columns a block owns at most: 256 a warpgroup
constexpr int WB_CP = WB_COLS / 64;         // ... in 64-column panels
constexpr int WB_TILE = 64;                 // ... streamed rows a tile
constexpr int WB_STAGES = 2;                // ... ring stages, each the block's panels of a streamed tile
constexpr int WB_MAX_CLUSTER = 16;          // ... blocks a cluster at most: the H100's non-portable limit
constexpr int WB_RES_BYTES = WB_ROWS * WB_COLS * 2;
constexpr int WB_STAGE_BYTES = WB_TILE * WB_COLS * 2;
// a tile's partial logits as the block of each rank receives them: [R][cdiv(WB_ROWS, R)][64] fp32
constexpr int WB_P_BYTES = (WB_ROWS + WB_MAX_CLUSTER) * WB_TILE * 4;
constexpr int WB_D_BYTES = WB_ROWS * WB_TILE * 2;  // a tile's dlog, K-major, swizzled
constexpr int WB_MIN_CLUSTER = (WIDE_MIN / 64 + WB_CP - 1) / WB_CP;  // ... blocks a cluster at least
// ... rows of a tile a thread sums and turns into dlog: a block takes
// WB_ROWS / R rows or one more, a warp (of 8) every eighth
constexpr int WB_MAXK = ((WB_ROWS + WB_MIN_CLUSTER - 1) / WB_MIN_CLUSTER + 7) / 8;
constexpr size_t WB_SMEM =
    vb_hopper::ALIGN + WB_RES_BYTES + WB_STAGES * WB_STAGE_BYTES + WB_P_BYTES + WB_D_BYTES + 5 * sizeof(uint64_t);
static_assert(WF_SMEM <= 232448 && WB_SMEM <= 232448, "a wide block must fit the H100's 227 KB of shared memory");

// The 64 accumulator registers of an m64n128 wgmma: their list in the
// instruction, and the operands s[0..63] that bind them in place.
#define VB_R64                                                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, " \
  "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "  \
  "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, "  \
  "%59, %60, %61, %62, %63}"
#define VB_S64                                                                                                \
      "+f"(s[0]), "+f"(s[1]), "+f"(s[2]), "+f"(s[3]), "+f"(s[4]), "+f"(s[5]), "+f"(s[6]), "+f"(s[7]),         \
      "+f"(s[8]), "+f"(s[9]), "+f"(s[10]), "+f"(s[11]), "+f"(s[12]), "+f"(s[13]), "+f"(s[14]), "+f"(s[15]),   \
      "+f"(s[16]), "+f"(s[17]), "+f"(s[18]), "+f"(s[19]), "+f"(s[20]), "+f"(s[21]), "+f"(s[22]), "+f"(s[23]), \
      "+f"(s[24]), "+f"(s[25]), "+f"(s[26]), "+f"(s[27]), "+f"(s[28]), "+f"(s[29]), "+f"(s[30]), "+f"(s[31]), \
      "+f"(s[32]), "+f"(s[33]), "+f"(s[34]), "+f"(s[35]), "+f"(s[36]), "+f"(s[37]), "+f"(s[38]), "+f"(s[39]), \
      "+f"(s[40]), "+f"(s[41]), "+f"(s[42]), "+f"(s[43]), "+f"(s[44]), "+f"(s[45]), "+f"(s[46]), "+f"(s[47]), \
      "+f"(s[48]), "+f"(s[49]), "+f"(s[50]), "+f"(s[51]), "+f"(s[52]), "+f"(s[53]), "+f"(s[54]), "+f"(s[55]), \
      "+f"(s[56]), "+f"(s[57]), "+f"(s[58]), "+f"(s[59]), "+f"(s[60]), "+f"(s[61]), "+f"(s[62]), "+f"(s[63])
// s (64 x 128 fp32) = A B^T over one 64-column panel, four k-steps, the
// first from zero: A [64 x 64] and B [128 x 64] K-major in shared memory at
// descriptors a and b. s is bound in place ("+f"), so the accumulator keeps
// its registers from one panel to the next and nothing copies it while its
// products run (ptxas would serialize the wgmmas).
#define VB_XENT_N128_PANEL(TY)                                                                            \
  asm volatile(                                                                                           \
      "{\n.reg .pred z, o;\n.reg .b64 a1, a2, a3, b1, b2, b3;\n"                                          \
      "setp.ne.b32 z, %66, 0;\nsetp.eq.b32 o, %66, 0;\n"                                                  \
      "add.s64 a1, %64, 2;\nadd.s64 a2, %64, 4;\nadd.s64 a3, %64, 6;\n"                                   \
      "add.s64 b1, %65, 2;\nadd.s64 b2, %65, 4;\nadd.s64 b3, %65, 6;\n"                                   \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " VB_R64 ", %64, %65, z, 1, 1, 0, 0;\n"  \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " VB_R64 ", a1, b1, o, 1, 1, 0, 0;\n"    \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " VB_R64 ", a2, b2, o, 1, 1, 0, 0;\n"    \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " VB_R64 ", a3, b3, o, 1, 1, 0, 0;\n}\n" \
      : VB_S64                                                                                            \
      : "l"(a), "l"(b), "r"(0))
template <typename ET>
__device__ __forceinline__ void wgmma_n128_panel(float (&s)[64], uint64_t a, uint64_t b) {
  if constexpr (std::is_same<ET, __half>::value)
    VB_XENT_N128_PANEL("f16");
  else
    VB_XENT_N128_PANEL("bf16");
}
#undef VB_XENT_N128_PANEL
#undef VB_S64
#undef VB_R64

// The wide K4: grid (row blocks of WF_ROWS, S vocabulary splits of `vbs`
// tiles of WF_TILE rows), WF_THREADS threads: warpgroups 0 and 1 consume,
// lane 0 of warp 8 produces; writes pf / pi as xent_fwd_kernel does. Step q
// of a block is panel q % NP of its split's tile q / NP, in stage q %
// WF_STAGES.
template <typename ET>
__global__ void __launch_bounds__(WF_THREADS, 1)
xent_wide_fwd_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap me,
                     const float* __restrict__ bias, const int* __restrict__ labels, int N, int V, int hid, int vbs,
                     float* __restrict__ pf, int* __restrict__ pi) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t sQ = smem_addr(vb_hopper::align_smem(smem_raw));  // stage b: x panel, then E panel
  const uint32_t full0 = sQ + WF_STAGES * WF_STAGE, empty0 = full0 + 8 * WF_STAGES;
  const int tid = threadIdx.x & 127, wg = threadIdx.x >> 7, warp = tid >> 5, lane = threadIdx.x & 31;
  const int rb = blockIdx.x * WF_ROWS;
  const int NP = hid / 64, ntiles = cdiv(V, WF_TILE);
  const int t0 = blockIdx.y * vbs, t1 = min(ntiles, t0 + vbs), nsteps = (t1 - t0) * NP;
  if (threadIdx.x == 0)
    for (int b = 0; b < WF_STAGES; ++b) {
      mbar_init(full0 + 8 * b);
      mbar_init_count(empty0 + 8 * b, NTHREADS / 32);  // every consumer warp, once its products of the stage ran
    }
  __syncthreads();  // the mbarriers are ready

  if (wg == 2) {  // the producer: step q into its stage (a TMA box of x, one of E) once every consumer left it
    if (lane == 0)
      for (int q = 0, b = 0, t = t0, p = 0; q < nsteps; ++q) {
        if (q >= WF_STAGES) mbar_wait(empty0 + 8 * b, (q / WF_STAGES - 1) & 1);
        const uint32_t dst = sQ + b * WF_STAGE, bar = full0 + 8 * b;
        mbar_expect(bar, WF_STAGE);
        tma_load_2d(dst, &mx, p * 64, rb, bar);
        tma_load_2d(dst + WF_X_BYTES, &me, p * 64, t * WF_TILE, bar);
        b = b + 1 == WF_STAGES ? 0 : b + 1;
        if (++p == NP) {
          p = 0;
          ++t;
        }
      }
    __syncwarp();
    return;
  }

  const int tq = lane & 3, r0 = rb + wg * RES + warp * 16 + (lane >> 2);  // this thread's rows: r0, r0 + 8
  RowStats<16> st;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    st.m[h] = -INFINITY;
    st.l[h] = 0.f;
    st.ll[h] = 0.f;
    st.bv[h] = -INFINITY;
    st.bi[h] = INT_MAX;
    st.lab[h] = r0 + 8 * h < N ? labels[r0 + 8 * h] : -1;
  }
  // each step: its products in a fresh accumulator s, once its stage has
  // landed; the stage released (an arrival of each warp); s added into the
  // tile's logits z, and after the tile's last panel its bias and then its
  // statistics. While one warpgroup adds, the other's products run.
  float s[64], z[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;
  for (int q = 0, b = 0, t = t0, p = 0; q < nsteps; ++q) {
    mbar_wait(full0 + 8 * b, (q / WF_STAGES) & 1);
    const uint32_t xs = sQ + b * WF_STAGE;
    vb_hopper::wg_fence();
    wgmma_n128_panel<ET>(s, vb_hopper::desc(xs + wg * RES * 128), vb_hopper::desc(xs + WF_X_BYTES));
    vb_hopper::wg_commit();
    vb_hopper::wg_wait();
    hold(s);
    if (lane == 0) mbar_arrive(empty0 + 8 * b);
    b = b + 1 == WF_STAGES ? 0 : b + 1;
    if (p == 0) {
#pragma unroll
      for (int i = 0; i < 64; ++i) z[i] = s[i];
    } else {
#pragma unroll
      for (int i = 0; i < 64; ++i) z[i] += s[i];
    }
    if (++p < NP) continue;
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      const int v = t * WF_TILE + 8 * nt + 2 * tq;
      const float b0 = v < V ? bias[v] : 0.f, b1 = v + 1 < V ? bias[v + 1] : 0.f;
      z[4 * nt] += b0;
      z[4 * nt + 2] += b0;
      z[4 * nt + 1] += b1;
      z[4 * nt + 3] += b1;
    }
    st.add_in_place(z, t * WF_TILE, V, tq);
    p = 0;
    ++t;
  }
  st.merge_quad();
  const size_t plane = (size_t)gridDim.y * N, at = (size_t)blockIdx.y * N;
  if (tq == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (r0 + 8 * h < N) store_partial(pf, pi, plane, at + r0 + 8 * h, st.m[h], st.l[h], st.ll[h], st.bv[h], st.bi[h]);
}

// K5 (DE false): grid (cdiv(N, WB_ROWS), R, S), clusters of (1, R, 1), R =
// cdiv(hid, WB_COLS); cluster (x, z) keeps x rows [WB_ROWS x, WB_ROWS x +
// WB_ROWS) and walks the vocabulary tiles [z vbs, z vbs + vbs); its block of
// rank r writes its panels of the fp32 partial part [S][N][hid]. K6 (DE
// true): grid (cdiv(V, WB_ROWS), R), the same clusters; cluster x keeps E
// rows [WB_ROWS x, WB_ROWS x + WB_ROWS) and walks every x tile; block r
// writes its panels of those rows of dE, and db of the rows it sums.
// Every wgmma runs on every path (a conditional one is serialized): a
// block's panels past its own (the last block of a cluster may own fewer
// than CP) are zeros in shared memory and add nothing.
template <bool DE, typename ET>
__global__ void __launch_bounds__(NTHREADS, 1)
xent_wide_bwd_kernel(const __grid_constant__ CUtensorMap mres, const __grid_constant__ CUtensorMap mstr,
                     const float* __restrict__ bias, const int* __restrict__ labels, const float* __restrict__ lse,
                     const float* __restrict__ gr, int N, int V, int hid, int vbs, float* __restrict__ part,
                     ET* __restrict__ dE, float* __restrict__ db) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = vb_hopper::align_smem(smem_raw);
  const uint32_t sR = smem_addr(sm);                    // the resident rows: WB_CP panels of WB_ROWS rows
  const uint32_t sQ = sR + WB_RES_BYTES;                // stages: WB_CP panels of WB_TILE streamed rows
  const uint32_t sP = sQ + WB_STAGES * WB_STAGE_BYTES;  // partial logits received [R][rhi - rlo][64], swizzled
  const uint32_t sD = sP + WB_P_BYTES;                  // the dlog tile [WB_ROWS][64], K-major, swizzled
  // mbarriers: a phase a tile, the dlog tile is whole; the resident panels
  // have landed; a phase every other tile, stage 0 / 1 has landed; a phase
  // a tile, every block's partials of this block's rows have arrived
  const uint32_t dFull = sD + WB_D_BYTES, resFull = dFull + 8, full0 = resFull + 8, pFull = full0 + 16;
  float* P = reinterpret_cast<float*>(sm + (sP - sR));

  const int R = cluster_blocks(), rank = cluster_rank();
  const int NP = hid / 64, CP = cdiv(NP, R), p0 = rank * CP;
  const int np = max(0, min(CP, NP - p0));              // this block's panels: p0 .. p0 + np
  const int r0 = blockIdx.x * WB_ROWS;
  const int nres = DE ? V : N, nstr = DE ? N : V;
  const int ntiles = cdiv(nstr, WB_TILE);
  const int t0 = DE ? 0 : blockIdx.z * vbs, t1 = DE ? ntiles : min(ntiles, t0 + vbs);
  const int tid = threadIdx.x & 127, wg = threadIdx.x >> 7, warp = tid >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  // the rows of a tile this block sums: [rlo, rhi), the R blocks' shares
  // of WB_ROWS as even as they go (at most per, at least 4); this
  // thread's: rlo + rl + 8 k, at columns jp, jp + 1
  const int per = cdiv(WB_ROWS, R), rlo = rank * WB_ROWS / R, rhi = (rank + 1) * WB_ROWS / R;
  const int rl = threadIdx.x >> 5, jp = 2 * lane;

  // the other blocks' dlog rows and every block's partials of this block's
  // rows of the first tile are expected
  const int d_bytes = (WB_ROWS - (rhi - rlo)) * 128, p_bytes = R * (rhi - rlo) * 64 * 4;
  if (threadIdx.x == 0) {
    mbar_init(dFull);
    mbar_expect(dFull, d_bytes);
    mbar_init(pFull);
    mbar_expect(pFull, p_bytes);
    mbar_init(resFull);
    mbar_init(full0);
    mbar_init(full0 + 8);
  }
  cluster_sync();  // every block's mbarriers are ready before any block signals one
  // the panels past this block's, zero in the resident rows and the stages
  for (int idx = threadIdx.x; idx < (WB_CP - np) * (WB_ROWS * 8); idx += NTHREADS) {
    const int p = np + idx / (WB_ROWS * 8), c = idx % (WB_ROWS * 8);
    *reinterpret_cast<uint4*>(sm + p * (WB_ROWS * 128) + 16 * c) = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int idx = threadIdx.x; idx < WB_STAGES * (WB_CP - np) * (WB_TILE * 8); idx += NTHREADS) {
    const int b = idx / ((WB_CP - np) * (WB_TILE * 8)), rest = idx % ((WB_CP - np) * (WB_TILE * 8));
    const int p = np + rest / (WB_TILE * 8), c = rest % (WB_TILE * 8);
    *reinterpret_cast<uint4*>(sm + WB_RES_BYTES + b * WB_STAGE_BYTES + p * (WB_TILE * 128) + 16 * c) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  // tile t into its stage: this block's panels, one TMA copy each (rows
  // past the matrix are zeros), by thread 0
  auto issue_stage = [&](int t) {
    const int b = (t - t0) % WB_STAGES;
    const uint32_t dst = sQ + b * WB_STAGE_BYTES, bar = full0 + 8 * b;
    mbar_expect(bar, np * (WB_TILE * 128));
    for (int p = 0; p < np; ++p) tma_load_2d(dst + p * (WB_TILE * 128), &mstr, (p0 + p) * 64, t * WB_TILE, bar);
  };

  // per row of this thread: K5 the lse (inf past N: p = 0) and label (-1)
  // of x row r0 + i; K6 the bias of vocabulary row r0 + i
  float rv[WB_MAXK], dsum[WB_MAXK];
  int rid[WB_MAXK];
#pragma unroll
  for (int k = 0; k < WB_MAXK; ++k) {
    const int r = r0 + rlo + rl + 8 * k;
    dsum[k] = 0.f;
    if (DE) {
      rv[k] = r < V ? bias[r] : 0.f;
      rid[k] = r;
    } else {
      rv[k] = r < N ? lse[r] : INFINITY;
      rid[k] = r < N ? labels[r] : -1;
    }
  }

  // this warpgroup's result columns: accumulator j holds panel 2 j + wg of
  // the block's
  float acc[4][32];
#pragma unroll
  for (int j = 0; j < 4; ++j) vb_hopper::zero(acc[j]);

  if (threadIdx.x == 0) {
    mbar_expect(resFull, np * (WB_ROWS * 128));
    for (int p = 0; p < np; ++p) tma_load_2d(sR + p * (WB_ROWS * 128), &mres, (p0 + p) * 64, r0, resFull);
    issue_stage(t0);
  }

  // this warpgroup's partial logits of the tile in `stage` into z: the 64
  // rows x columns [32 wg, 32 wg + 32), each panel's products in a fresh
  // accumulator (s0, s1 in turn) added into z in panel order
  float z[16], s0[16], s1[16];
  auto logits = [&](uint32_t stage) {
    const uint64_t da = vb_hopper::desc(sR), dq = vb_hopper::desc(stage + wg * 32 * 128);
    auto panel = [&](float(&s)[16], int p) {
      vb_hopper::wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_n32<ET>(s, da + ((p * (WB_ROWS * 128)) >> 4) + 2 * kk, dq + ((p * (WB_TILE * 128)) >> 4) + 2 * kk,
                      kk);
      vb_hopper::wg_commit();
    };
#pragma unroll
    for (int p = 0; p < WB_CP; p += 2) {
      panel(s0, p);
      if (p > 0) {  // panel p - 1
        wg_wait1();
        hold(s1);
#pragma unroll
        for (int i = 0; i < 16; ++i) z[i] += s1[i];
      }
      panel(s1, p + 1);
      wg_wait1();  // panel p
      hold(s0);
#pragma unroll
      for (int i = 0; i < 16; ++i) z[i] = p == 0 ? s0[i] : z[i] + s0[i];
    }
    vb_hopper::wg_wait();  // the last panel
    hold(s1);
#pragma unroll
    for (int i = 0; i < 16; ++i) z[i] += s1[i];
  };

  for (int t = t0; t < t1; ++t) {
    const uint32_t q = sQ + ((t - t0) % WB_STAGES) * WB_STAGE_BYTES;
    // the values of tile t's columns jp, jp + 1 (K5: bias; K6: lse, label,
    // g, zero past N), used once its logits are summed
    float c0[2], c2[2];
    int c1[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = t * WB_TILE + jp + e, jj = j < nstr ? j : 0;
      c0[e] = DE ? lse[jj] : bias[jj];
      c1[e] = DE ? labels[jj] : 0;
      c2[e] = DE && j < nstr ? gr[jj] : 0.f;
    }
    if (t == t0) {
      mbar_wait(resFull, 0);
      vb_hopper::fence_async();  // the zeros past this block's panels
      __syncthreads();
    }
    mbar_wait(full0 + 8 * ((t - t0) % WB_STAGES), ((t - t0) / WB_STAGES) & 1);  // tile t
    logits(q);
    __syncthreads();  // both warpgroups are done with tile t - 1's stage
    if (threadIdx.x == 0 && t + 1 < t1) issue_stage(t + 1);
    // tile t's partials of each row i to the block that sums it (the rank
    // whose [rlo, rhi) holds i), as its row (rank, i - that rlo), by stores
    // that count their bytes on that block's mbarrier. Every block has
    // summed tile t - 1's: its
    // dlog rows of tile t - 1 arrived here after that. A block sends its
    // dlog rows of tile t only once every block's partials of tile t have
    // arrived, each sent after that block's product of tile t - 1.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = warp * 16 + g + 8 * h, owner = ((i + 1) * R - 1) / WB_ROWS;
      const int slot = rank * per + i - owner * WB_ROWS / R;
      const uint32_t bar = cluster_addr(pFull, owner);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = wg * 32 + nt * 8 + 2 * tq;
        st_async2(cluster_addr(sP + 4 * (slot * 64 + (c ^ ((slot & 7) << 3))), owner), z[4 * nt + 2 * h],
                  z[4 * nt + 2 * h + 1], bar);
      }
    }
    mbar_wait(pFull, (t - t0) & 1);  // every block's partials of this block's rows of tile t have arrived
    if (threadIdx.x == 0) mbar_expect(pFull, p_bytes);

    // the logits of this block's rows: the R blocks' partials summed in
    // rank order; their dlog into every block's dlog tile
    float2 zr[WB_MAXK];
#pragma unroll
    for (int k = 0; k < WB_MAXK; ++k) {
      const int il = rl + 8 * k;
      zr[k] = make_float2(0.f, 0.f);
      if (rlo + il < rhi)
        for (int src = 0; src < R; ++src) {
          const int slot = src * per + il;
          const float2 v = *reinterpret_cast<const float2*>(P + slot * 64 + (jp ^ ((slot & 7) << 3)));
          zr[k].x += v.x;
          zr[k].y += v.y;
        }
    }
#pragma unroll
    for (int k = 0; k < WB_MAXK; ++k) {
      const int i = rlo + rl + 8 * k;  // the same in a warp
      if (i >= rhi) break;
      float d[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float zz = e ? zr[k].y : zr[k].x;
        const int j = t * WB_TILE + jp + e;
        if (DE) {  // row: vocabulary id rid; column: x row j
          const bool ok = rid[k] < V && j < N;
          d[e] = ok ? (expf(zz + rv[k] - c0[e]) - (c1[e] == rid[k] ? 1.f : 0.f)) * c2[e] : 0.f;
          dsum[k] += d[e];
        } else {   // row: x row with label rid; column: vocabulary id j
          d[e] = j < V ? expf(zz + c0[e] - rv[k]) - (rid[k] == j ? 1.f : 0.f) : 0.f;
        }
      }
      *reinterpret_cast<uint32_t*>(sm + (sD - sR) + swz(i, jp >> 3) + (jp & 7) * 2) = vb::Elem<ET>::pack(d[0], d[1]);
    }
    // this block's dlog rows into every other block's dlog tile, by copies
    // that count their bytes on that block's mbarrier; every block has
    // multiplied tile t - 1's dlog (before it sent this block partials)
    vb_hopper::fence_async();
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int qq = 0; qq < R; ++qq)
        if (qq != rank && rhi > rlo)
          bulk_to_cluster(cluster_addr(sD + rlo * 128, qq), sD + rlo * 128, (rhi - rlo) * 128,
                          cluster_addr(dFull, qq));
      bulk_commit();
    }
    mbar_wait(dFull, (t - t0) & 1);  // tile t's dlog is whole
    if (threadIdx.x == 0) {
      bulk_wait_read();  // this block's rows may be written again (the next tile's, once its partials arrived)
      mbar_expect(dFull, d_bytes);
    }

    // this warpgroup's result columns += dlog . its panels of tile t
    {
      const uint64_t dp = vb_hopper::desc(sD);
      vb_hopper::wg_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint64_t dk = vb_hopper::desc(q + (2 * j + wg) * (WB_TILE * 128));
#pragma unroll
        for (int kk = 0; kk < WB_TILE / 16; ++kk) wgmma_n64_tb<ET>(acc[j], dp + 2 * kk, dk + ((kk * 2048) >> 4));
      }
      vb_hopper::wg_commit();
      vb_hopper::wg_wait();
#pragma unroll
      for (int j = 0; j < 4; ++j) hold(acc[j]);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + warp * 16 + g + 8 * h;
    if (r >= nres) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int pj = 2 * j + wg;
      if (pj >= np) continue;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = (p0 + pj) * 64 + nt * 8 + 2 * tq;
        const float a = acc[j][4 * nt + 2 * h], c = acc[j][4 * nt + 2 * h + 1];
        if (DE)
          *reinterpret_cast<uint32_t*>(dE + (size_t)r * hid + col) = vb::Elem<ET>::pack(a, c);
        else
          *reinterpret_cast<float2*>(part + ((size_t)blockIdx.z * N + r) * hid + col) = make_float2(a, c);
      }
    }
  }
  if (threadIdx.x == 0) bulk_wait();
  cluster_sync();  // no block leaves while another may still copy into it
  if (DE) {  // db of the rows this block summed: each warp's rows, its lanes' columns summed
#pragma unroll
    for (int k = 0; k < WB_MAXK; ++k) {
      float v = dsum[k];
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      const int i = rlo + rl + 8 * k;
      if (lane == 0 && i < rhi && r0 + i < V) db[r0 + i] = v;
    }
  }
}

// dx[n, :] = ET(g[n] * sum_s part[s, n, :]), the splits summed in order, at a
// runtime (even) width.
template <typename ET>
__global__ void xent_wide_dx_reduce_kernel(const float* __restrict__ part, const float* __restrict__ gr, int N,
                                           int hid, int S, ET* __restrict__ dx) {
  const size_t total = (size_t)N * hid / 2;
  for (size_t q = (size_t)blockIdx.x * blockDim.x + threadIdx.x; q < total; q += (size_t)gridDim.x * blockDim.x) {
    float2 sum = make_float2(0.f, 0.f);
    for (int s = 0; s < S; ++s) {
      const float2 v = reinterpret_cast<const float2*>(part + (size_t)s * N * hid)[q];
      sum.x += v.x;
      sum.y += v.y;
    }
    const float gn = gr[q * 2 / hid];
    reinterpret_cast<uint32_t*>(dx)[q] = vb::Elem<ET>::pack(sum.x * gn, sum.y * gn);
  }
}

// K5 (kernel 0), K6 (1) or K4 (2) of the wide form in bf16 (dtype 0) or
// fp16 (1), or nullptr.
const void* wide_kernel_of(int dtype, int kernel) {
  static const void* const kernels[2][3] = {
      {(const void*)xent_wide_bwd_kernel<false, bf16>, (const void*)xent_wide_bwd_kernel<true, bf16>,
       (const void*)xent_wide_fwd_kernel<bf16>},
      {(const void*)xent_wide_bwd_kernel<false, __half>, (const void*)xent_wide_bwd_kernel<true, __half>,
       (const void*)xent_wide_fwd_kernel<__half>}};
  return dtype >= 0 && dtype < 2 && kernel >= 0 && kernel < 3 ? kernels[dtype][kernel] : nullptr;
}

// The wide K5/K6's cluster at width hid: one block a column range.
int wide_cluster(int hid) { return cdiv(hid / 64, WB_CP); }

bool wide_width(int hid) { return hid >= WIDE_MIN && hid % 64 == 0; }

cudaError_t set_smem(const void* fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// K5's (kernel 0) or K6's (1) launch attributes in `dtype`, its shared
// memory and clusters above the portable 8 blocks, set at its first use on
// a device.
cudaError_t wide_bwd_attributes(int dtype, int kernel) {
  static bool set[2][2][64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && set[dtype][kernel][dev])) return err;
  const void* fn = wide_kernel_of(dtype, kernel);
  err = set_smem(fn, WB_SMEM);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && dev < 64) set[dtype][kernel][dev] = true;
  return err;
}

// A launch of K5 or K6 on `grid` in clusters of (1, R, 1); attr is the
// storage of its one attribute.
cudaLaunchConfig_t wide_bwd_config(dim3 grid, int R, cudaStream_t st, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = WB_SMEM;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1;
  attr->val.clusterDim.y = R;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The clusters of K5 (kernel 0) or K6 (kernel 1) in `dtype` at width hid
// that the card runs at once (0: none fits), or -1 on an error.
int wide_active_clusters(int dtype, int kernel, int hid) {
  const void* fn = wide_kernel_of(dtype, kernel);
  const int R = wide_cluster(hid);
  if (fn == nullptr || kernel > 1 || R > WB_MAX_CLUSTER) return -1;
  if (wide_bwd_attributes(dtype, kernel) != cudaSuccess) return -1;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = wide_bwd_config(dim3(1, R, 1), R, nullptr, &attr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, fn, &cfg) != cudaSuccess) return -1;
  return n;
}

template <typename ET>
int wide_fwd(const void* x, const void* E, const void* bias, const void* labels, int N, int V, int hid, int S,
             int vbs, void* pf, void* pi, void* nll, void* lse, void* am, cudaStream_t st) {
  cudaError_t err = vb::once_a_device([] { return set_smem((const void*)xent_wide_fwd_kernel<ET>, WF_SMEM); });
  CUtensorMap mx, me;
  if (err == cudaSuccess) err = wide_map<ET>(&mx, x, N, hid, WF_ROWS);
  if (err == cudaSuccess) err = wide_map<ET>(&me, E, V, hid, WF_TILE);
  if (err != cudaSuccess) return (int)err;
  xent_wide_fwd_kernel<ET><<<dim3(cdiv(N, WF_ROWS), S), WF_THREADS, WF_SMEM, st>>>(
      mx, me, static_cast<const float*>(bias), static_cast<const int*>(labels), N, V, hid, vbs,
      static_cast<float*>(pf), static_cast<int*>(pi));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  xent_fwd_merge_kernel<<<cdiv(N, 128), 128, 0, st>>>(static_cast<const float*>(pf), static_cast<const int*>(pi),
                                                       N, S, static_cast<float*>(nll), static_cast<float*>(lse),
                                                       static_cast<int*>(am));
  return (int)cudaGetLastError();
}

// K5 (DE false, grid (cdiv(N, WB_ROWS), R, S)) or K6 (DE true, grid
// (cdiv(V, WB_ROWS), R)) in clusters of R: where no cluster fits, the
// launch's own error.
template <bool DE, typename ET>
int launch_wide_bwd(int z, const void* x, const void* E, const void* bias, const void* labels, const void* lse,
                    const void* g, int N, int V, int hid, int vbs, void* part, void* dE, void* db, cudaStream_t st) {
  const int R = wide_cluster(hid);
  CUtensorMap mres, mstr;
  cudaError_t err = wide_bwd_attributes(std::is_same<ET, __half>::value ? 1 : 0, DE ? 1 : 0);
  if (err == cudaSuccess) err = wide_map<ET>(&mres, DE ? E : x, DE ? V : N, hid);
  if (err == cudaSuccess) err = wide_map<ET>(&mstr, DE ? x : E, DE ? N : V, hid);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = wide_bwd_config(dim3(cdiv(DE ? V : N, WB_ROWS), R, z), R, st, &attr);
  err = cudaLaunchKernelEx(&cfg, xent_wide_bwd_kernel<DE, ET>, mres, mstr, static_cast<const float*>(bias),
                           static_cast<const int*>(labels), static_cast<const float*>(lse),
                           static_cast<const float*>(g), N, V, hid, vbs, static_cast<float*>(part),
                           static_cast<ET*>(dE), static_cast<float*>(db));
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <typename ET>
int wide_dx(const void* x, const void* E, const void* bias, const void* labels, const void* lse, const void* g,
            int N, int V, int hid, int S, int vbs, void* part, void* dx, cudaStream_t st) {
  const int err = launch_wide_bwd<false, ET>(S, x, E, bias, labels, lse, nullptr, N, V, hid, vbs, part, nullptr,
                                             nullptr, st);
  if (err != 0) return err;
  const int pairs = cdiv(N * (hid / 2), 256);
  xent_wide_dx_reduce_kernel<ET><<<pairs < 4096 ? pairs : 4096, 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<const float*>(g), N, hid, S, static_cast<ET*>(dx));
  return (int)cudaGetLastError();
}

template <typename ET>
int wide_de(const void* x, const void* E, const void* bias, const void* labels, const void* lse, const void* g,
            int N, int V, int hid, void* dE, void* db, cudaStream_t st) {
  return launch_wide_bwd<true, ET>(1, x, E, bias, labels, lse, g, N, V, hid, 0, nullptr, dE, db, st);
}

// The wide form's `what` of K5 (kernel 0), K6 (1) or K4 (2) in `dtype` at
// width hid, as vb_xent_wide_info documents it.
int wide_info(int dtype, int kernel, int what, int hid) {
  const void* fn = wide_kernel_of(dtype, kernel);
  if (fn == nullptr || !wide_width(hid) || (kernel < 2 && wide_cluster(hid) > WB_MAX_CLUSTER)) return -1;
  const size_t bytes = kernel == 2 ? WF_SMEM : WB_SMEM;
  if (what == 0 || what == 1) {
    cudaFuncAttributes attr;
    if (cudaFuncGetAttributes(&attr, fn) != cudaSuccess) return -1;
    return what == 0 ? attr.numRegs : (int)attr.localSizeBytes;
  }
  if (what == 2) return (int)bytes;
  if (what == 3) {
    int n = 0;
    if (set_smem(fn, bytes) != cudaSuccess) return -1;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, kernel == 2 ? WF_THREADS : NTHREADS, bytes) !=
        cudaSuccess)
      return -1;
    return n;
  }
  if (what == 4 && kernel < 2) return wide_active_clusters(dtype, kernel, hid);
  return -1;
}

// The wide entry points in ET (bf16 or fp16), their arguments checked.
template <typename ET>
int wide_fwd_entry(const void* x, const void* E, const void* bias, const void* labels, int N, int V, int hid, int S,
                   int vbs, void* pf, void* pi, void* nll, void* lse, void* am, void* stream) {
  if (!wide_width(hid) || S < 1 || vbs < 1) return (int)cudaErrorInvalidValue;
  return wide_fwd<ET>(x, E, bias, labels, N, V, hid, S, vbs, pf, pi, nll, lse, am, static_cast<cudaStream_t>(stream));
}

template <typename ET>
int wide_dx_entry(const void* x, const void* E, const void* bias, const void* labels, const void* lse, const void* g,
                  int N, int V, int hid, int S, int vbs, void* part, void* dx, void* stream) {
  if (!wide_width(hid) || wide_cluster(hid) > WB_MAX_CLUSTER || S < 1 || vbs < 1) return (int)cudaErrorInvalidValue;
  return wide_dx<ET>(x, E, bias, labels, lse, g, N, V, hid, S, vbs, part, dx, static_cast<cudaStream_t>(stream));
}

template <typename ET>
int wide_de_entry(const void* x, const void* E, const void* bias, const void* labels, const void* lse, const void* g,
                  int N, int V, int hid, void* dE, void* db, void* stream) {
  if (!wide_width(hid) || wide_cluster(hid) > WB_MAX_CLUSTER) return (int)cudaErrorInvalidValue;
  return wide_de<ET>(x, E, bias, labels, lse, g, N, V, hid, dE, db, static_cast<cudaStream_t>(stream));
}

}  // namespace

// The tiling the wrapper needs to check inputs and size the grids and the
// split partials, at hidden width hid (the same in bf16 and fp16): 0 hid
// itself if the kernels take it (else -1), 1 K4's x rows per block, 2
// K5/K6's resident rows per block (a cluster's at 1024), 3 K4's vocabulary
// rows per tile, 4 K5/K6's streamed rows per tile, 5 the result columns a
// K5/K6 block owns (at 1024 a cluster has 1024 / this blocks).
extern "C" int vb_xent_geometry(int which, int hid) {
  const Form* f = form(0, hid);
  return f != nullptr && which >= 0 && which < 6 ? f->geometry[which] : -1;
}

// K5 (kernel 0), K6 (kernel 1) or K4 (kernel 2) at width hid in bf16: `what`
// 0 its registers a thread, 1 its local (spill) bytes a thread, 2 its
// dynamic shared memory, 3 its resident blocks per SM, 4 (K5, K6 at 1024)
// the clusters the card runs at once (0: none fits). -1 on an error.
extern "C" int vb_xent_info(int kernel, int what, int hid) { return info(0, kernel, what, hid); }

// pf [4][S][N] fp32 and pi [S][N] int32 are scratch the caller allocates: S
// vocabulary splits of vbs tiles each.
extern "C" int vb_xent_fwd(const void* x, const void* E, const void* bias, const void* labels, int N, int V,
                           int hid, int S, int vbs, void* pf, void* pi, void* nll, void* lse, void* am, void* stream) {
  return fwd(0, x, E, bias, labels, N, V, hid, S, vbs, pf, pi, nll, lse, am, stream);
}

// part [S][N][hid] fp32 is scratch the caller allocates: S vocabulary splits
// of vbs streamed tiles each.
extern "C" int vb_xent_dx(const void* x, const void* E, const void* bias, const void* labels, const void* lse,
                          const void* g, int N, int V, int hid, int S, int vbs, void* part, void* dx, void* stream) {
  return ::dx(0, x, E, bias, labels, lse, g, N, V, hid, S, vbs, part, dx, stream);
}

extern "C" int vb_xent_de(const void* x, const void* E, const void* bias, const void* labels, const void* lse,
                          const void* g, int N, int V, int hid, void* dE, void* db, void* stream) {
  return de(0, x, E, bias, labels, lse, g, N, V, hid, dE, db, stream);
}

// The same entry points in fp16 (x, E, dx and dE fp16).
extern "C" int vb_xent_f16_info(int kernel, int what, int hid) { return info(1, kernel, what, hid); }

extern "C" int vb_xent_f16_fwd(const void* x, const void* E, const void* bias, const void* labels, int N, int V,
                               int hid, int S, int vbs, void* pf, void* pi, void* nll, void* lse, void* am,
                               void* stream) {
  return fwd(1, x, E, bias, labels, N, V, hid, S, vbs, pf, pi, nll, lse, am, stream);
}

extern "C" int vb_xent_f16_dx(const void* x, const void* E, const void* bias, const void* labels, const void* lse,
                              const void* g, int N, int V, int hid, int S, int vbs, void* part, void* dx,
                              void* stream) {
  return ::dx(1, x, E, bias, labels, lse, g, N, V, hid, S, vbs, part, dx, stream);
}

extern "C" int vb_xent_f16_de(const void* x, const void* E, const void* bias, const void* labels, const void* lse,
                              const void* g, int N, int V, int hid, void* dE, void* db, void* stream) {
  return de(1, x, E, bias, labels, lse, g, N, V, hid, dE, db, stream);
}

// The wide form's tiling, numbered as vb_xent_geometry's (the same in bf16
// and fp16): 0 the step of the widths it takes (it takes multiples of 64
// from 1088 on), 1 K4's x rows per block, 2 K5/K6's resident rows per
// block, 3 K4's vocabulary rows per tile, 4 K5/K6's streamed rows per tile,
// 5 the result columns a K5/K6 block owns at most (a cluster has cdiv(hid,
// this) blocks), 6 the blocks a K5/K6 cluster may have.
extern "C" int vb_xent_wide_geometry(int which) {
  const int g[7] = {64, WF_ROWS, WB_ROWS, WF_TILE, WB_TILE, WB_COLS, WB_MAX_CLUSTER};
  return which >= 0 && which < 7 ? g[which] : -1;
}

// K5 (kernel 0), K6 (kernel 1) or K4 (kernel 2) of the wide form (bf16) at
// width hid: `what` as vb_xent_info's, and 4 (K5, K6) the clusters the card
// runs at once (0: none fits). -1 on an error or a width the form does not
// take.
extern "C" int vb_xent_wide_info(int kernel, int what, int hid) { return wide_info(0, kernel, what, hid); }

// The wide form's entry points (bf16 x, E, dx, dE), with the scratch of
// vb_xent_fwd / vb_xent_dx.
extern "C" int vb_xent_wide_fwd(const void* x, const void* E, const void* bias, const void* labels, int N, int V,
                                int hid, int S, int vbs, void* pf, void* pi, void* nll, void* lse, void* am,
                                void* stream) {
  return wide_fwd_entry<bf16>(x, E, bias, labels, N, V, hid, S, vbs, pf, pi, nll, lse, am, stream);
}

extern "C" int vb_xent_wide_dx(const void* x, const void* E, const void* bias, const void* labels, const void* lse,
                               const void* g, int N, int V, int hid, int S, int vbs, void* part, void* dx,
                               void* stream) {
  return wide_dx_entry<bf16>(x, E, bias, labels, lse, g, N, V, hid, S, vbs, part, dx, stream);
}

extern "C" int vb_xent_wide_de(const void* x, const void* E, const void* bias, const void* labels, const void* lse,
                               const void* g, int N, int V, int hid, void* dE, void* db, void* stream) {
  return wide_de_entry<bf16>(x, E, bias, labels, lse, g, N, V, hid, dE, db, stream);
}

// The same entry points in fp16 (x, E, dx and dE fp16).
extern "C" int vb_xent_f16_wide_geometry(int which) { return vb_xent_wide_geometry(which); }

extern "C" int vb_xent_f16_wide_info(int kernel, int what, int hid) { return wide_info(1, kernel, what, hid); }

extern "C" int vb_xent_f16_wide_fwd(const void* x, const void* E, const void* bias, const void* labels, int N, int V,
                                    int hid, int S, int vbs, void* pf, void* pi, void* nll, void* lse, void* am,
                                    void* stream) {
  return wide_fwd_entry<__half>(x, E, bias, labels, N, V, hid, S, vbs, pf, pi, nll, lse, am, stream);
}

extern "C" int vb_xent_f16_wide_dx(const void* x, const void* E, const void* bias, const void* labels,
                                   const void* lse, const void* g, int N, int V, int hid, int S, int vbs, void* part,
                                   void* dx, void* stream) {
  return wide_dx_entry<__half>(x, E, bias, labels, lse, g, N, V, hid, S, vbs, part, dx, stream);
}

extern "C" int vb_xent_f16_wide_de(const void* x, const void* E, const void* bias, const void* labels,
                                   const void* lse, const void* g, int N, int V, int hid, void* dE, void* db,
                                   void* stream) {
  return wide_de_entry<__half>(x, E, bias, labels, lse, g, N, V, hid, dE, db, stream);
}
