// Warp-level bf16 tensor-core helpers shared by the port's kernels:
// mma.sync m16n8k16 (bf16 in, fp32 accumulate) and its fragment loads from
// row-major shared-memory tiles with a padded row stride LD (elements).
// g = lane / 4, tq = lane % 4 are the mma.sync thread-group coordinates.
// pack_f16 / round_f16 are pack_bf16 / round_bf16 for fp16, and Elem<E>
// names the pair of an element type (the Hopper kernels that take both).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace vb {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float round_f16(float x) { return __half2float(__float2half_rn(x)); }

__device__ __forceinline__ uint32_t pack_raw(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// The two 16-bit element types of the Hopper kernels: pack two floats
// (round to nearest even), round one, and unpack a packed pair.
template <typename E>
struct Elem;
template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) { return pack_bf16(lo, hi); }
  static __device__ __forceinline__ float round(float x) { return round_bf16(x); }
  static __device__ __forceinline__ float2 unpack(uint32_t w) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
  }
};
template <>
struct Elem<__half> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) { return pack_f16(lo, hi); }
  static __device__ __forceinline__ float round(float x) { return round_f16(x); }
  static __device__ __forceinline__ float2 unpack(uint32_t w) {
    return __half22float2(*reinterpret_cast<const __half2*>(&w));
  }
};

__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A (16x16) = X[r0 .. r0+15][k0 .. k0+15]
template <int LD>
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* X, int r0, int k0, int g, int tq) {
  a[0] = *reinterpret_cast<const uint32_t*>(X + (r0 + g) * LD + k0 + 2 * tq);
  a[1] = *reinterpret_cast<const uint32_t*>(X + (r0 + g + 8) * LD + k0 + 2 * tq);
  a[2] = *reinterpret_cast<const uint32_t*>(X + (r0 + g) * LD + k0 + 2 * tq + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(X + (r0 + g + 8) * LD + k0 + 2 * tq + 8);
}

// B (16x8) with B[k][n] = X[n0 + n][k0 + k]  (X's rows are B's columns)
template <int LD>
__device__ __forceinline__ void load_b_rows(uint32_t& b0, uint32_t& b1, const bf16* X, int n0, int k0,
                                            int g, int tq) {
  b0 = *reinterpret_cast<const uint32_t*>(X + (n0 + g) * LD + k0 + 2 * tq);
  b1 = *reinterpret_cast<const uint32_t*>(X + (n0 + g) * LD + k0 + 2 * tq + 8);
}

// B (16x8) with B[k][n] = X[k0 + k][n0 + n]  (X's rows are B's rows)
template <int LD>
__device__ __forceinline__ void load_b_cols(uint32_t& b0, uint32_t& b1, const bf16* X, int k0, int n0,
                                            int g, int tq) {
  const bf16* p = X + (k0 + 2 * tq) * LD + n0 + g;
  b0 = pack_raw(p[0], p[LD]);
  b1 = pack_raw(p[8 * LD], p[9 * LD]);
}

// Accumulator pair (n-tiles 2c, 2c+1 of a 16-row C) -> A fragment with k = those 16 columns.
__device__ __forceinline__ void c_to_a(uint32_t a[4], const float lo[4], const float hi[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

}  // namespace vb
