// Philox4x32-10 counter-based generator (Salmon et al., SC'11), shared by
// the dropout-mask kernel and the attention kernels so that every random
// bit in the port comes from one function of (key, counter).
//
// The plain PyTorch twin lives in visualbert_torch/ops/philox.py and is
// bit-exact: the kernels' masks can be compared with it element by element.
#pragma once

#include <stdint.h>

namespace vb {

__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint2 key) {
  constexpr uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  constexpr uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(M0, ctr.x), lo0 = M0 * ctr.x;
    const uint32_t hi1 = __umulhi(M1, ctr.z), lo1 = M1 * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ key.x, lo1, hi0 ^ ctr.w ^ key.y, lo0);
    key.x += W0;
    key.y += W1;
  }
  return ctr;
}

__device__ __forceinline__ uint32_t philox_word(const uint4& r, int w) {
  return w == 0 ? r.x : (w == 1 ? r.y : (w == 2 ? r.z : r.w));
}

// Attention dropout: the keep bit of probability (b, h, i, j) is word
// ((i & 1) << 1 | (j & 1)) of philox(ctr = (j >> 1, i >> 1, 0, 0),
// key = (seed, b * H + h)). One call covers a 2x2 block of (query, key), so
// the forward (which holds two keys of a query row per fragment) and the
// key-major backward (two queries of a key row) each use two bits per call.
__device__ __forceinline__ uint4 attn_philox(uint32_t seed, uint32_t bh, int i, int j) {
  return philox4x32_10(make_uint4((uint32_t)(j >> 1), (uint32_t)(i >> 1), 0u, 0u),
                       make_uint2(seed, bh));
}

}  // namespace vb
