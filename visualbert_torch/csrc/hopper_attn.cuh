// Hopper building blocks of the attention kernels designed for sm_90a
// (flash_attention_packed.cu: K1/K2; flash_attention.cu: K11/K12;
// flash_attention_sp.cu: K13/K14; flash_attention_exp.cu: K15/K16).
//
// A block is one warpgroup (4 warps, 128 threads). Every D = 64 bf16 row is
// one 128-byte swizzle row, and a tile is 64 such rows (wgmma's m64) in a
// 1024-aligned region in the 128 B swizzle: chunk c of row r lies at byte
// swz(r, c). Tiles arrive by cp.async (16 bytes a thread); products are
// wgmma m64n64k16 with fp32 accumulators in mma.sync's fragment layout
// (lane g = lane / 4 holds rows g and g + 8 of its warp's 16, columns
// 2 tq, 2 tq + 1 of every 8-column n-tile, tq = lane % 4).
//
// K1/K2 also take fp16 and a head dim of 128 (the templates at the end of
// this header): a row of DH elements is DH / 64 panels of 128 B, each panel
// of a tile the layout above, and wgmma's element type is the kernel's
// (.f16 in place of .bf16, the same shapes and swizzle: both are 2 bytes).
// Every bf16 and fp16 kernel of K1/K2 and K11-K14 also takes head dims 16
// and 32 on rows of their own size (the small-row tiles below, in the 32 B
// and 64 B swizzles). K2 at DH = 128 streams its tiles through a TMA ring
// into two warpgroups (the TMA rings at the end of this header).
//
// Two switches leave a design step out for tools/attn_steps.py's builds;
// the kernel library never defines either: VB_PACKED_SYNC_LOADS makes every
// copy a plain load and store, VB_PACKED_PHILOX_PER_ROW makes every lane
// compute the Philox calls of both its rows.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"
#include "philox.cuh"

namespace vb_hopper {

using vb::bf16;
using vb::pack_bf16;
using vb::round_bf16;

constexpr int D = 64;                      // head dim
constexpr int TILE = 64;                   // rows of a tile: wgmma's m64
constexpr int NT = 128;                    // one warpgroup
constexpr int ROW = D * 2;                 // bytes of a row: one 128 B swizzle row
constexpr int TILE_BYTES = TILE * ROW;     // 8 KB
constexpr int ALIGN = 1024;                // swizzle atom: 8 rows x 128 B
constexpr float LOG2E = 1.4426950408889634f;
constexpr float SCALE = 0.125f;            // 1 / sqrt(D)

__host__ __device__ __forceinline__ int round_up(int x, int m) { return (x + m - 1) / m * m; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned char* align_smem(unsigned char* p) {
  return p + ((ALIGN - (smem_addr(p) & (ALIGN - 1))) & (ALIGN - 1));
}

// Byte offset of 16-byte chunk c of row r in a 1024-aligned swizzled region.
__device__ __forceinline__ uint32_t swz(int r, int c) { return (uint32_t)(r * ROW + ((c ^ (r & 7)) << 4)); }

// ------------------------------------------------------------- cp.async

// Built with VB_PACKED_SYNC_LOADS (step 3 left out, for tools/attn_steps.py)
// a copy is a plain load and store: a thread's loads of one tile are in
// flight together, but each tile has landed when issue_tile returns, so no
// copy overlaps a product; commit and wait do nothing. cp_async16 copies 16
// bytes or zeros; cp_async_n copies the first n of 16 bytes (n even) and
// zeros the rest.
#ifdef VB_PACKED_SYNC_LOADS
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const uint4 v = valid ? *static_cast<const uint4*>(src) : make_uint4(0u, 0u, 0u, 0u);
  *static_cast<uint4*>(__cvta_shared_to_generic(dst)) = v;
}
__device__ __forceinline__ void cp_async_n(uint32_t dst, const void* src, int n) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (n == 16) {
    v = *static_cast<const uint4*>(src);
  } else {
    unsigned short* e = reinterpret_cast<unsigned short*>(&v);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (2 * k < n) e[k] = static_cast<const unsigned short*>(src)[k];
  }
  *static_cast<uint4*>(__cvta_shared_to_generic(dst)) = v;
}
__device__ __forceinline__ void cp_commit() {}
template <int N>
__device__ __forceinline__ void cp_wait() {}
#else
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_n(uint32_t dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
#endif
// Wait until at most n groups are pending (fewer is always safe).
__device__ __forceinline__ void cp_wait_dyn(int n) {
  switch (n) {
    case 0: cp_wait<0>(); break;
    case 1: cp_wait<1>(); break;
    case 2: cp_wait<2>(); break;
    case 3: cp_wait<3>(); break;
    case 4: cp_wait<4>(); break;
    case 5: cp_wait<5>(); break;
    case 6: cp_wait<6>(); break;
    default: cp_wait<7>(); break;
  }
}
// Generic-proxy writes (cp.async, the bias pass) before wgmma reads them.
__device__ __forceinline__ void fence_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// Issue the copy of rows [t0, t0 + TILE) of a D-wide row block (row t at
// src + t * ld) into the swizzled tile at shared address dst; rows past T
// are zero. Thread x always copies chunk x % 8 of its rows.
__device__ __forceinline__ void issue_tile(uint32_t dst, const bf16* __restrict__ src, int t0, int T, int ld) {
#pragma unroll
  for (int idx = threadIdx.x; idx < TILE * 8; idx += NT) {
    const int r = idx >> 3, c = idx & 7, t = t0 + r;
    cp_async16(dst + swz(r, c), src + (size_t)(t < T ? t : 0) * ld + c * 8, t < T);
  }
}

// ----------------------------------------------------------------- wgmma

// Shared-memory matrix descriptor of a 1024-aligned tile in the 128 B
// swizzle: 8-row groups 1024 B apart (both byte-offset fields; a 64-wide
// operand has one swizzle atom along its contiguous dimension). A k-step of
// 16 elements along a row adds 32 B, i.e. 2, to the descriptor.
__device__ __forceinline__ uint64_t desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_wait() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// After a wait: keep the compiler from reading an accumulator before it, or
// from reusing the registers of an A operand still in flight until it.
__device__ __forceinline__ void reg_fence(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void reg_fence(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[c][i])::"memory");
}

#define VB_D32                                                                                                  \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),   \
      "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),    \
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),   \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define VB_R32                                                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, " \
  "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64 x 64 fp32) = (acc ? d : 0) + A B^T, A [64 x 16] and B [64 x 16]
// both K-major in shared memory (rows of A, rows of B).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " VB_R32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : VB_D32
      : "l"(a), "l"(b), "r"(acc));
}

// d += A B, A [64 x 16] bf16 in registers (the mma.m16n8k16 A fragment of
// each warp's 16 rows), B [16 x 64] from shared memory rows (16 rows of 64
// contiguous elements: the transposed, MN-major operand).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " VB_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : VB_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// S (64 x 64) = A B^T over D = 64: A and B 64-row tiles at shared addresses.
__device__ __forceinline__ void product_ss(float (&d)[32], uint32_t a, uint32_t b) {
  const uint64_t da = desc(a), db = desc(b);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_ss(d, da + 2 * kk, db + 2 * kk, kk);
}

// Accumulator n-tiles (2c, 2c + 1) -> the A fragment of k-step c.
__device__ __forceinline__ void to_a(uint32_t (&a)[4][4], const float (&s)[32]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    a[c][0] = pack_bf16(s[8 * c + 0], s[8 * c + 1]);
    a[c][1] = pack_bf16(s[8 * c + 2], s[8 * c + 3]);
    a[c][2] = pack_bf16(s[8 * c + 4], s[8 * c + 5]);
    a[c][3] = pack_bf16(s[8 * c + 6], s[8 * c + 7]);
  }
}

// d += A B with A from registers (4 k-steps of 16) and B the 64 rows at
// shared address b (k-step c: rows 16c .. 16c + 15, two swizzle atoms).
__device__ __forceinline__ void product_rs(float (&d)[32], const uint32_t (&a)[4][4], uint32_t b) {
  const uint64_t db = desc(b);
#pragma unroll
  for (int c = 0; c < 4; ++c) wgmma_rs(d, a[c], db + c * (2048 >> 4));
}

__device__ __forceinline__ void zero(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
}

// ---------------------------------------------------------------- Philox

// The four keep bits of the Philox call of fragment row `row` and column
// pair (col, col + 1), bit ((i & 1) << 1 | (j & 1)) for query i, key j; 0
// where the whole 2 x 2 block lies past T (its values are unused).
template <bool KEY_MAJOR>
__device__ __forceinline__ uint32_t call_bits(uint32_t seed, uint32_t bh, int row, int col, bool col_ok, int T,
                                              uint32_t thr) {
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (col_ok && (row & ~1) < T) r = KEY_MAJOR ? vb::attn_philox(seed, bh, col, row) : vb::attn_philox(seed, bh, row, col);
  return (uint32_t)(r.x >= thr) | ((uint32_t)(r.y >= thr) << 1) | ((uint32_t)(r.z >= thr) << 2) |
         ((uint32_t)(r.w >= thr) << 3);
}

// The two bits (col, col + 1) of the fragment row of parity p in a call's k.
template <bool KEY_MAJOR>
__device__ __forceinline__ uint32_t row_bits(uint32_t k, int p) {
  return KEY_MAJOR ? (((k >> p) & 1u) | (((k >> (2 + p)) & 1u) << 1)) : ((k >> (2 * p)) & 3u);
}

// Keep bits of this lane's 2 x 2 fragment elements at column pair (col,
// col + 1) and rows row0 (= base + g) and row1 (= base + g + 8): bit
// 2 r + c keeps (row r, col + c). Lanes 4 apart hold rows i and i ^ 1 of one
// Philox call: each lane computes the call of its row of parity par =
// g & 1 (row0 for even g, row1 for odd g) and passes the partner's two bits
// by shuffle. KEY_MAJOR: fragment rows are keys, columns queries (the dK/dV
// pass). col_ok: col < T. Built with VB_PACKED_PHILOX_PER_ROW (step 2 left
// out, for tools/attn_steps.py), each lane computes both its rows' calls.
template <bool KEY_MAJOR>
__device__ __forceinline__ uint32_t keep_bits(uint32_t seed, uint32_t bh, int row0, int row1, int col, int par,
                                              uint32_t thr, bool col_ok, int T) {
#ifdef VB_PACKED_PHILOX_PER_ROW
  return row_bits<KEY_MAJOR>(call_bits<KEY_MAJOR>(seed, bh, row0, col, col_ok, T, thr), par) |
         (row_bits<KEY_MAJOR>(call_bits<KEY_MAJOR>(seed, bh, row1, col, col_ok, T, thr), par) << 2);
#else
  const uint32_t k = call_bits<KEY_MAJOR>(seed, bh, par ? row1 : row0, col, col_ok, T, thr);
  const uint32_t mine = row_bits<KEY_MAJOR>(k, par), got = __shfl_xor_sync(0xffffffffu, row_bits<KEY_MAJOR>(k, par ^ 1), 4);
  return par ? (got | (mine << 2)) : (mine | (got << 2));
#endif
}

// keep_bits of a 64-column step: the 4 bits of n-tile nt (columns c0 + 8 nt,
// + 1; c0 = the step's first column + 2 tq) at bits 4 nt .. 4 nt + 3.
// Computed before a wgmma.wait, the Philox work runs while the products do.
template <bool KEY_MAJOR>
__device__ __forceinline__ uint32_t step_keep_bits(uint32_t seed, uint32_t bh, int row0, int row1, int c0, int par,
                                                   uint32_t thr, int T) {
  uint32_t k = 0;
#pragma unroll 4
  for (int nt = 0; nt < 8; ++nt) {
    const int c = c0 + 8 * nt;
    k |= keep_bits<KEY_MAJOR>(seed, bh, row0, row1, c, par, thr, c < T, T) << (4 * nt);
  }
  return k;
}

// ------------------------------------------------------------- epilogues

// Add the bias chunk (this thread's chunk threadIdx.x % 8 of the head's
// bias) to the chunks this thread copied into a landed tile.
__device__ __forceinline__ void add_bias(unsigned char* tile, uint4 bias, int t0, int T) {
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&bias);
#pragma unroll
  for (int idx = threadIdx.x; idx < TILE * 8; idx += NT) {
    const int r = idx >> 3, c = idx & 7;
    if (t0 + r < T) {
      uint4* p = reinterpret_cast<uint4*>(tile + swz(r, c));
      uint4 v = *p;
      __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(&v);
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = __bfloat1622float2(x[e]), b = __bfloat1622float2(y[e]);
        w[e] = pack_bf16(a.x + b.x, a.y + b.y);
      }
      *p = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

__device__ __forceinline__ uint4 bias_chunk(const bf16* __restrict__ qb, int h, int j) {
  return *reinterpret_cast<const uint4*>(qb + (3 * h + j) * D + (threadIdx.x & 7) * 8);
}

// Add the column sums over this warp's valid rows of bf16(acc * scale) to
// red[warp * D + col]; the g == 0 lanes own the columns, in a fixed order.
__device__ __forceinline__ void colsum_add(const float (&acc)[32], float scale, bool ok0, bool ok1, float* red,
                                           int warp, int g, int tq) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = (ok0 ? round_bf16(acc[4 * nt + e] * scale) : 0.f) + (ok1 ? round_bf16(acc[4 * nt + 2 + e] * scale) : 0.f);
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (g == 0) red[warp * D + nt * 8 + 2 * tq + e] += v;
    }
  }
}

// Store a 64 x 64 accumulator times `scale` as bf16 (this thread's rows
// row0, row1 at dst + row * ld).
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, const float (&acc)[32], float scale, int row0,
                                           int row1, bool ok0, bool ok1, int ld, int tq) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int c = nt * 8 + 2 * tq;
    if (ok0)
      *reinterpret_cast<uint32_t*>(dst + (size_t)row0 * ld + c) = pack_bf16(acc[4 * nt] * scale, acc[4 * nt + 1] * scale);
    if (ok1)
      *reinterpret_cast<uint32_t*>(dst + (size_t)row1 * ld + c) =
          pack_bf16(acc[4 * nt + 2] * scale, acc[4 * nt + 3] * scale);
  }
}

__device__ __forceinline__ void load_key_bias(float* kb, const float* __restrict__ key_bias, int T, int Tp) {
  for (int j = threadIdx.x; j < Tp; j += NT) kb[j] = j < T ? key_bias[j] * LOG2E : -INFINITY;
}

// delta = rowsum(dO * O) in fp32 for every row of the pair (two threads a
// row, 32 columns each), into dl[Tp] and, for rows < T, delta_g.
__device__ __forceinline__ void pair_delta(const bf16* __restrict__ dout, const bf16* __restrict__ out, int ld,
                                           float* dl, float* __restrict__ delta_g, int T, int Tp) {
  for (int idx = threadIdx.x; idx < 2 * Tp; idx += NT) {
    const int i = idx >> 1, half = idx & 1;
    float acc = 0.f;
    if (i < T) {
      const uint4* pd = reinterpret_cast<const uint4*>(dout + (size_t)i * ld + half * 32);
      const uint4* po = reinterpret_cast<const uint4*>(out + (size_t)i * ld + half * 32);
      uint4 a[4], c[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        a[k] = pd[k];
        c[k] = po[k];
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a[k]);
        const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&c[k]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 u = __bfloat1622float2(x[e]), v = __bfloat1622float2(y[e]);
          acc += u.x * v.x;
          acc += u.y * v.y;
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      dl[i] = acc;
      if (i < T) delta_g[i] = acc;
    }
  }
}

// ------------------------------------ element types and head dims (K1/K2)
//
// Tile<DH>: a tile of 64 rows x DH elements is NP = DH / 64 panels of 64
// rows x 128 B (each the 8 KB layout above), panel p at + p * TILE_BYTES;
// chunk c of a row (c < DH / 8) lies in panel c / 8 at swz(r, c % 8). An
// accumulator over DH output columns is NP 64 x 64 accumulators. At DH =
// 16 and 32 (the small rows, the *_s helpers below) a tile is
// one panel of 32 or 64 B rows and an accumulator one 64 x DH tile of DH /
// 2 floats a thread; the *_t helpers call the *_s ones there.

template <int DH>
struct Tile {
  static_assert(DH == 16 || DH == 32 || DH == 64 || DH == 128, "K1/K2 take head dims of 16, 32, 64 and 128");
  static constexpr bool SMALL = DH < 64;             // small rows
  static constexpr int NP = SMALL ? 1 : DH / 64;     // panels of a row; accumulator tiles
  static constexpr int NA = SMALL ? DH / 2 : 32;     // accumulator floats a thread of each
  static constexpr int CH = DH / 8;                  // 16-byte chunks of a row
  static constexpr int ROWB = DH * 2;                // bytes of a row
  static constexpr int BYTES = TILE * ROWB;          // bytes of a 64-row tile
};

template <typename E>
__device__ __forceinline__ void wgmma_ss_e(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  if constexpr (std::is_same<E, __half>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " VB_R32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : VB_D32
        : "l"(a), "l"(b), "r"(acc));
  } else {
    wgmma_ss(d, a, b, acc);
  }
}

template <typename E>
__device__ __forceinline__ void wgmma_rs_e(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (std::is_same<E, __half>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " VB_R32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : VB_D32
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  } else {
    wgmma_rs(d, a, b);
  }
}

// ------------------------------------- small rows: head dims 16 and 32
//
// A head dim of 16 or 32 keeps its rows as they lie: 32 or 64 bytes, one
// row of wgmma's 32 B or 64 B swizzle, with no zero columns. Chunk c (16
// bytes) of row r of a tile lies at r * ROWB + ((c ^ (r >> SH) % CH) << 4):
// address bits 4.. XORed with bits 7.., as the hardware reads the 32 B
// (bit 4 with bit 7) and 64 B (bits 4-5 with bits 7-8) swizzles; the
// pattern repeats every 8 rows (256 or 512 bytes), so a tile needs only that
// alignment. The descriptor gives both byte offsets as 8 rows' bytes: the
// K-major operands (S = Q K^T, dP = dO V^T) step 32 bytes a k-step of 16
// along the row (DH / 16 k-steps); the MN-major ones (the rows of K, V, Q,
// dO as B of P V-type products, N = DH, one swizzle row wide) step 16 rows
// a k-step. Those products are m64n16k16 or m64n32k16 with DH / 2 fp32
// accumulators a thread, in the m64n64 layout's first DH / 8 n-tiles.

template <int DH>
struct Small {
  static_assert(DH == 16 || DH == 32, "the small-row tiles take head dims of 16 and 32");
  static constexpr int SH = DH == 16 ? 2 : 1;            // row bits above the row's 128-byte line
  static constexpr int GROUP = 8 * DH * 2;               // bytes of 8 rows: the descriptor's byte offsets
  static constexpr uint64_t LAYOUT = DH == 16 ? 3 : 2;   // the descriptor's 32 B or 64 B swizzle
};

template <int DH>
__device__ __forceinline__ uint32_t swz_s(int r, int c) {
  return (uint32_t)(r * Tile<DH>::ROWB + ((c ^ ((r >> Small<DH>::SH) & (Tile<DH>::CH - 1))) << 4));
}

template <int DH>
__device__ __forceinline__ uint64_t desc_s(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(Small<DH>::GROUP >> 4) << 16) |
         ((uint64_t)(Small<DH>::GROUP >> 4) << 32) | (Small<DH>::LAYOUT << 62);
}

#define VB_D8 "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
#define VB_D16                                                                                                \
  VB_D8, "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define VB_RS_N16(T)                                                                                    \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"                                              \
               "wgmma.mma_async.sync.aligned.m64n16k16.f32." T "." T                                     \
               " {%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"            \
               : VB_D8                                                                                   \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))
#define VB_RS_N32(T)                                                                                         \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                                                   \
               "wgmma.mma_async.sync.aligned.m64n32k16.f32." T "." T                                          \
               " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, "   \
               "%19}, %20, p, 1, 1, 1;\n}\n"                                                                  \
               : VB_D16                                                                                       \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))

// d (64 x DH fp32) += A B, A [64 x 16] in E from registers, B [16 x DH] the
// transposed (MN-major) operand: 16 rows of DH contiguous elements.
template <typename E, int DH>
__device__ __forceinline__ void wgmma_rs_s(float (&d)[DH / 2], const uint32_t (&a)[4], uint64_t b) {
  constexpr bool F16 = std::is_same<E, __half>::value;
  if constexpr (DH == 16) {
    if constexpr (F16)
      VB_RS_N16("f16");
    else
      VB_RS_N16("bf16");
  } else {
    if constexpr (F16)
      VB_RS_N32("f16");
    else
      VB_RS_N32("bf16");
  }
}
#undef VB_RS_N16
#undef VB_RS_N32

// S (64 x 64) = A B^T over DH: A and B 64-row small-row tiles.
template <typename E, int DH>
__device__ __forceinline__ void product_ss_s(float (&d)[32], uint32_t a, uint32_t b) {
  const uint64_t da = desc_s<DH>(a), db = desc_s<DH>(b);
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) wgmma_ss_e<E>(d, da + 2 * kk, db + 2 * kk, kk);
}

// d += A B: A from registers (4 k-steps of 16 rows of B), B the 64-row
// small-row tile at shared address b.
template <typename E, int DH>
__device__ __forceinline__ void product_rs_s(float (&d)[DH / 2], const uint32_t (&a)[4][4], uint32_t b) {
  const uint64_t db = desc_s<DH>(b);
#pragma unroll
  for (int c = 0; c < 4; ++c) wgmma_rs_s<E, DH>(d, a[c], db + c * ((16 * Tile<DH>::ROWB) >> 4));
}

template <typename E, int DH>
__device__ __forceinline__ void issue_tile_s(uint32_t dst, const E* __restrict__ src, int t0, int T, int ld) {
  constexpr int CH = Tile<DH>::CH;
#pragma unroll
  for (int idx = threadIdx.x; idx < TILE * CH; idx += NT) {
    const int r = idx / CH, c = idx % CH, t = t0 + r;
    cp_async16(dst + swz_s<DH>(r, c), src + (size_t)(t < T ? t : 0) * ld + c * 8, t < T);
  }
}

template <typename E, int DH>
__device__ __forceinline__ void add_bias_s(unsigned char* tile, uint4 bias, int t0, int T) {
  constexpr int CH = Tile<DH>::CH;
  const uint32_t* y = reinterpret_cast<const uint32_t*>(&bias);
#pragma unroll
  for (int idx = threadIdx.x; idx < TILE * CH; idx += NT) {
    const int r = idx / CH, c = idx % CH;
    if (t0 + r < T) {
      uint4* p = reinterpret_cast<uint4*>(tile + swz_s<DH>(r, c));
      uint4 v = *p;
      uint32_t* x = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = vb::Elem<E>::unpack(x[e]), b = vb::Elem<E>::unpack(y[e]);
        x[e] = vb::Elem<E>::pack(a.x + b.x, a.y + b.y);
      }
      *p = v;
    }
  }
}

template <typename E, int DH>
__device__ __forceinline__ void colsum_add_s(const float (&acc)[DH / 2], float scale, bool ok0, bool ok1, float* red,
                                             int warp, int g, int tq) {
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = (ok0 ? vb::Elem<E>::round(acc[4 * nt + e] * scale) : 0.f) +
                (ok1 ? vb::Elem<E>::round(acc[4 * nt + 2 + e] * scale) : 0.f);
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (g == 0) red[warp * DH + nt * 8 + 2 * tq + e] += v;
    }
  }
}

// The accumulator's rows row0 and row1 to dst in E, each times its own
// scale (sc[0], sc[1]).
template <typename E, int DH>
__device__ __forceinline__ void store_rows_s(E* __restrict__ dst, const float (&acc)[DH / 2], const float (&sc)[2],
                                             int row0, int row1, bool ok0, bool ok1, int ld, int tq) {
#pragma unroll
  for (int nt = 0; nt < DH / 8; ++nt) {
    const int c = nt * 8 + 2 * tq;
    if (ok0)
      *reinterpret_cast<uint32_t*>(dst + (size_t)row0 * ld + c) =
          vb::Elem<E>::pack(acc[4 * nt] * sc[0], acc[4 * nt + 1] * sc[0]);
    if (ok1)
      *reinterpret_cast<uint32_t*>(dst + (size_t)row1 * ld + c) =
          vb::Elem<E>::pack(acc[4 * nt + 2] * sc[1], acc[4 * nt + 3] * sc[1]);
  }
}

// The one-pass forwards' (K1, K11) online softmax on a small-row
// accumulator: every value times its row's alpha (element i of a thread's
// DH / 2 lies in its row (i >> 1) & 1: row0 or row1); their epilogue is
// store_rows_s with each row's own scale (inv / l of that row).
template <int DH>
__device__ __forceinline__ void rescale_s(float (&acc)[DH / 2], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
}

// S (64 x 64) = A B^T over DH: A and B 64-row tiles of DH at shared addresses.
template <typename E, int DH>
__device__ __forceinline__ void product_ss_t(float (&d)[32], uint32_t a, uint32_t b) {
  if constexpr (Tile<DH>::SMALL) {
    product_ss_s<E, DH>(d, a, b);
  } else {
#pragma unroll
    for (int p = 0; p < Tile<DH>::NP; ++p) {
      const uint64_t da = desc(a + p * TILE_BYTES), db = desc(b + p * TILE_BYTES);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss_e<E>(d, da + 2 * kk, db + 2 * kk, p | kk);
    }
  }
}

// d[p] += A B[:, panel p] for every output panel p: A from registers (4
// k-steps of 16 rows of B), B the 64-row tile of DH at shared address b.
template <typename E, int DH>
__device__ __forceinline__ void product_rs_t(float (&d)[Tile<DH>::NP][Tile<DH>::NA], const uint32_t (&a)[4][4],
                                             uint32_t b) {
  if constexpr (Tile<DH>::SMALL) {
    product_rs_s<E, DH>(d[0], a, b);
  } else {
#pragma unroll
    for (int p = 0; p < Tile<DH>::NP; ++p) {
      const uint64_t db = desc(b + p * TILE_BYTES);
#pragma unroll
      for (int c = 0; c < 4; ++c) wgmma_rs_e<E>(d[p], a[c], db + c * (2048 >> 4));
    }
  }
}

// Accumulator n-tiles (2c, 2c + 1) -> the A fragment of k-step c, in E.
template <typename E>
__device__ __forceinline__ void to_a_t(uint32_t (&a)[4][4], const float (&s)[32]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    a[c][0] = vb::Elem<E>::pack(s[8 * c + 0], s[8 * c + 1]);
    a[c][1] = vb::Elem<E>::pack(s[8 * c + 2], s[8 * c + 3]);
    a[c][2] = vb::Elem<E>::pack(s[8 * c + 4], s[8 * c + 5]);
    a[c][3] = vb::Elem<E>::pack(s[8 * c + 6], s[8 * c + 7]);
  }
}

template <int NP, int NA>
__device__ __forceinline__ void reg_fence_t(float (&d)[NP][NA]) {
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    if constexpr (NA == 32) {
      reg_fence(d[p]);
    } else {
#pragma unroll
      for (int i = 0; i < NA; ++i) asm volatile("" : "+f"(d[p][i])::"memory");
    }
  }
}

template <int NP, int NA>
__device__ __forceinline__ void zero_t(float (&d)[NP][NA]) {
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    if constexpr (NA == 32) {
      zero(d[p]);
    } else {
#pragma unroll
      for (int i = 0; i < NA; ++i) d[p][i] = 0.f;
    }
  }
}

// issue_tile for rows of DH elements: thread x copies chunk x % CH of its rows.
template <typename E, int DH>
__device__ __forceinline__ void issue_tile_t(uint32_t dst, const E* __restrict__ src, int t0, int T, int ld) {
  constexpr int CH = Tile<DH>::CH;
  if constexpr (Tile<DH>::SMALL) {
    issue_tile_s<E, DH>(dst, src, t0, T, ld);
  } else {
#pragma unroll
    for (int idx = threadIdx.x; idx < TILE * CH; idx += NT) {
      const int r = idx / CH, c = idx % CH, t = t0 + r;
      cp_async16(dst + (c >> 3) * TILE_BYTES + swz(r, c & 7), src + (size_t)(t < T ? t : 0) * ld + c * 8, t < T);
    }
  }
}

// add_bias for rows of DH elements in E (the chunks issue_tile_t gave this thread).
template <typename E, int DH>
__device__ __forceinline__ void add_bias_t(unsigned char* tile, uint4 bias, int t0, int T) {
  constexpr int CH = Tile<DH>::CH;
  if constexpr (Tile<DH>::SMALL) {
    add_bias_s<E, DH>(tile, bias, t0, T);
  } else {
    const uint32_t* y = reinterpret_cast<const uint32_t*>(&bias);
#pragma unroll
    for (int idx = threadIdx.x; idx < TILE * CH; idx += NT) {
      const int r = idx / CH, c = idx % CH;
      if (t0 + r < T) {
        uint4* p = reinterpret_cast<uint4*>(tile + (c >> 3) * TILE_BYTES + swz(r, c & 7));
        uint4 v = *p;
        uint32_t* x = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 a = vb::Elem<E>::unpack(x[e]), b = vb::Elem<E>::unpack(y[e]);
          x[e] = vb::Elem<E>::pack(a.x + b.x, a.y + b.y);
        }
        *p = v;
      }
    }
  }
}

template <typename E, int DH>
__device__ __forceinline__ uint4 bias_chunk_t(const E* __restrict__ qb, int h, int j) {
  return *reinterpret_cast<const uint4*>(qb + (3 * h + j) * DH + (threadIdx.x % Tile<DH>::CH) * 8);
}

// colsum_add over DH columns: red[warp * DH + col] += the column sums over
// this warp's valid rows of E(acc * scale); the g == 0 lanes own the columns.
template <typename E, int DH>
__device__ __forceinline__ void colsum_add_t(const float (&acc)[Tile<DH>::NP][Tile<DH>::NA], float scale, bool ok0,
                                             bool ok1, float* red, int warp, int g, int tq) {
  if constexpr (Tile<DH>::SMALL) {
    colsum_add_s<E, DH>(acc[0], scale, ok0, ok1, red, warp, g, tq);
  } else {
#pragma unroll
    for (int p = 0; p < Tile<DH>::NP; ++p)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = (ok0 ? vb::Elem<E>::round(acc[p][4 * nt + e] * scale) : 0.f) +
                    (ok1 ? vb::Elem<E>::round(acc[p][4 * nt + 2 + e] * scale) : 0.f);
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (g == 0) red[warp * DH + p * 64 + nt * 8 + 2 * tq + e] += v;
        }
      }
  }
}

// store_rows over DH columns, in E.
template <typename E, int DH>
__device__ __forceinline__ void store_rows_t(E* __restrict__ dst, const float (&acc)[Tile<DH>::NP][Tile<DH>::NA],
                                             float scale, int row0, int row1, bool ok0, bool ok1, int ld, int tq) {
  if constexpr (Tile<DH>::SMALL) {
    store_rows_s<E, DH>(dst, acc[0], {scale, scale}, row0, row1, ok0, ok1, ld, tq);
  } else {
#pragma unroll
    for (int p = 0; p < Tile<DH>::NP; ++p)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int c = p * 64 + nt * 8 + 2 * tq;
        if (ok0)
          *reinterpret_cast<uint32_t*>(dst + (size_t)row0 * ld + c) =
              vb::Elem<E>::pack(acc[p][4 * nt] * scale, acc[p][4 * nt + 1] * scale);
        if (ok1)
          *reinterpret_cast<uint32_t*>(dst + (size_t)row1 * ld + c) =
              vb::Elem<E>::pack(acc[p][4 * nt + 2] * scale, acc[p][4 * nt + 3] * scale);
      }
  }
}

// pair_delta over DH columns in E (two threads a row, DH / 2 columns each).
template <typename E, int DH>
__device__ __forceinline__ void pair_delta_t(const E* __restrict__ dout, const E* __restrict__ out, int ld, float* dl,
                                             float* __restrict__ delta_g, int T, int Tp) {
  constexpr int NQ = DH / 16;  // 16-byte chunks of a half row
  for (int idx = threadIdx.x; idx < 2 * Tp; idx += NT) {
    const int i = idx >> 1, half = idx & 1;
    float acc = 0.f;
    if (i < T) {
      const uint4* pd = reinterpret_cast<const uint4*>(dout + (size_t)i * ld + half * (DH / 2));
      const uint4* po = reinterpret_cast<const uint4*>(out + (size_t)i * ld + half * (DH / 2));
#pragma unroll
      for (int k = 0; k < NQ; ++k) {
        const uint4 a = pd[k], c = po[k];
        const uint32_t* x = reinterpret_cast<const uint32_t*>(&a);
        const uint32_t* y = reinterpret_cast<const uint32_t*>(&c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 u = vb::Elem<E>::unpack(x[e]), v = vb::Elem<E>::unpack(y[e]);
          acc += u.x * v.x;
          acc += u.y * v.y;
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      dl[i] = acc;
      if (i < T) delta_g[i] = acc;
    }
  }
}

// ------------------------------- the bf16, D = 64 form of K11-K14's bodies
//
// K11-K14's bodies are templates on <E, DH> (flash_attention.cu,
// flash_attention_sp.cu). At bf16 and DH = 64 they call the helpers their
// bodies called before the templates (issue_tile, product_ss, product_rs,
// to_a, pair_delta, store_rows), so that form compiles to the machine code
// it had; the *_t helpers (index arithmetic over DH / 8 chunks, loads
// interleaved with the sums) compile to other code. Every other form calls
// the *_t helpers, also at DH = 16 and 32, where the accumulators are
// [1][DH / 2] (Tile<DH>::NA) and the *_t helpers call the *_s ones. At DH >=
// 64 NA is 32: the types the helpers took before.

template <typename E, int DH>
constexpr bool kMainForm = std::is_same<E, bf16>::value && DH == 64;

template <typename E, int DH>
__device__ __forceinline__ void issue_tile_v(uint32_t dst, const E* __restrict__ src, int t0, int T, int ld) {
  if constexpr (kMainForm<E, DH>)
    issue_tile(dst, src, t0, T, ld);
  else
    issue_tile_t<E, DH>(dst, src, t0, T, ld);
}

template <typename E, int DH>
__device__ __forceinline__ void product_ss_v(float (&d)[32], uint32_t a, uint32_t b) {
  if constexpr (kMainForm<E, DH>)
    product_ss(d, a, b);
  else
    product_ss_t<E, DH>(d, a, b);
}

template <typename E, int DH>
__device__ __forceinline__ void product_rs_v(float (&d)[Tile<DH>::NP][Tile<DH>::NA], const uint32_t (&a)[4][4],
                                             uint32_t b) {
  if constexpr (kMainForm<E, DH>)
    product_rs(d[0], a, b);
  else
    product_rs_t<E, DH>(d, a, b);
}

template <typename E>
__device__ __forceinline__ void to_a_v(uint32_t (&a)[4][4], const float (&s)[32]) {
  if constexpr (std::is_same<E, bf16>::value)
    to_a(a, s);
  else
    to_a_t<E>(a, s);
}

template <typename E, int DH>
__device__ __forceinline__ void pair_delta_v(const E* __restrict__ dout, const E* __restrict__ out, int ld, float* dl,
                                             float* __restrict__ delta_g, int T, int Tp) {
  if constexpr (kMainForm<E, DH>)
    pair_delta(dout, out, ld, dl, delta_g, T, Tp);
  else
    pair_delta_t<E, DH>(dout, out, ld, dl, delta_g, T, Tp);
}

template <typename E, int DH>
__device__ __forceinline__ void store_rows_v(E* __restrict__ dst, const float (&acc)[Tile<DH>::NP][Tile<DH>::NA],
                                             float scale, int row0, int row1, bool ok0, bool ok1, int ld, int tq) {
  if constexpr (kMainForm<E, DH>)
    store_rows(dst, acc[0], scale, row0, row1, ok0, ok1, ld, tq);
  else
    store_rows_t<E, DH>(dst, acc, scale, row0, row1, ok0, ok1, ld, tq);
}

// ------------------------------------------ TMA rings on mbarriers
//
// Blocks that stream tiles (K2 at DH = 128, flash_attention_packed.cu step
// 7) keep a ring of stages, each with a full mbarrier: one arrival, which
// expects the stage's bytes, and the bytes of the TMA copies that land.
// The tensor maps are encoded on the host (cuTensorMapEncodeTiled through
// cudaGetDriverEntryPointByVersion), passed as __grid_constant__ kernel
// parameters and used here by address. A tile that TMA lays down in the 128
// B swizzle is Tile<DH>'s layout: a box of 64 rows x 64 elements is one 8 KB
// panel, chunk c of row r at swz(r, c).

// An mbarrier that completes a phase on `count` arrivals (and the bytes its
// arrivals expect); the fence that makes mbarrier.init visible to the async
// proxy; an arrival expecting `bytes`; a plain arrival; a wait until phase
// `parity` completes, which traps (the launch fails with an error) after
// 2^26 polls that found it open, seconds where a phase takes microseconds,
// so that a lost arrival ends the kernel instead of holding the card.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() { asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory"); }
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) asm volatile("trap;");
  }
}

// Box {c0, c1, c2} (elements of a row, rows, matrices) of the 3-D tensor
// of `map` into shared memory at dst, counted on mbarrier bar; elements past
// the tensor's extent land as zeros (and their bytes count).
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* map, int c0, int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];"
      "\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// add_bias_t at DH = 128 by `n` threads of index i (n a multiple of 16):
// thread i adds its chunk i % 16 of the head's bias (bias_chunk_by) to the
// rows it walks of a landed tile; rows past T stay as they are.
template <typename E>
__device__ __forceinline__ void add_bias_by(unsigned char* tile, uint4 bias, int t0, int T, int i, int n) {
  constexpr int CH = Tile<128>::CH;
  const uint32_t* y = reinterpret_cast<const uint32_t*>(&bias);
#pragma unroll 4
  for (int idx = i; idx < TILE * CH; idx += n) {
    const int r = idx / CH, c = idx % CH;
    if (t0 + r < T) {
      uint4* p = reinterpret_cast<uint4*>(tile + (c >> 3) * TILE_BYTES + swz(r, c & 7));
      uint4 v = *p;
      uint32_t* x = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = vb::Elem<E>::unpack(x[e]), b = vb::Elem<E>::unpack(y[e]);
        x[e] = vb::Elem<E>::pack(a.x + b.x, a.y + b.y);
      }
      *p = v;
    }
  }
}

template <typename E>
__device__ __forceinline__ uint4 bias_chunk_by(const E* __restrict__ qb, int h, int j, int i) {
  return *reinterpret_cast<const uint4*>(qb + (3 * h + j) * 128 + (i % Tile<128>::CH) * 8);
}

// ------------------------------------------------------------- launches

// The instantiation of K1/K2's, K11/K12's and K13/K14's bf16 and fp16
// kernels of element type `dtype` (0 bf16, 1 fp16) and head dim dh (64, 128;
// 16, 32 on small rows): 0 bf16/64, 1 bf16/128, 2 fp16/64, 3 fp16/128, 4
// bf16/16, 5 bf16/32, 6 fp16/16, 7 fp16/32; -1 for any other.
inline int attn_form(int dtype, int dh) {
  if (dtype != 0 && dtype != 1) return -1;
  switch (dh) {
    case 64: return 2 * dtype;
    case 128: return 2 * dtype + 1;
    case 16: return 4 + 2 * dtype;
    case 32: return 5 + 2 * dtype;
    default: return -1;
  }
}

// Of kernel fn (nullptr: -1) at `bytes` of dynamic shared memory and
// `threads` a block: `what` 0 its registers a thread, 1 its local (spill)
// bytes a thread, 2 `bytes`, 3 its resident blocks per SM. -1 on an
// error.
inline int kernel_info(const void* fn, size_t bytes, int what, int threads = NT) {
  if (fn == nullptr) return -1;
  if (what == 0 || what == 1) {
    cudaFuncAttributes attr;
    if (cudaFuncGetAttributes(&attr, fn) != cudaSuccess) return -1;
    return what == 0 ? attr.numRegs : (int)attr.localSizeBytes;
  }
  if (what == 2) return (int)bytes;
  if (what == 3) {
    int n = 0;
    if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes) != cudaSuccess) return -1;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, threads, bytes) != cudaSuccess) return -1;
    return n;
  }
  return -1;
}

}  // namespace vb_hopper
