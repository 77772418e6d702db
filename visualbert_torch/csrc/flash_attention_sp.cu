// K13/K14: packed-QKV attention that saves its probabilities. Replace
// visualbert_tpu/ops/flash_attention.py::_packed_fwd_sp_kernel and
// ::_packed_bwd_sp_kernel (flash_attention_packed(..., save_probs=True), the
// encoder's flash_save_probs).
//
// Layout: qkv [B, T, H*3*D] bf16 packed head-major WITH the projection bias
// already added (the JAX wrapper adds it eagerly before this pair, so
// autograd of that add gives the bias gradient and K14 writes none);
// key_bias [B, T] fp32; out, dout [B, T, H*D] bf16; probs [B, H, T, T] bf16,
// the normalised pre-dropout probabilities p = softmax(q.k * scale +
// key_bias), always bf16 (as the JAX kernel stores them at every compute
// dtype), and K14 reads those rounded values back.
//
// K13, the forward. K1's online softmax only knows p once the last key tile
// is seen, but every p(i, j) must be written normalised, so the kernel makes
// two passes over the keys of its 64 query rows: the first takes the row
// statistic stat = max t + log2 sum exp2(t - max) of t = (q.k) * scale *
// log2(e) + key_bias * log2(e) (QK^T only); the second recomputes t, writes
// p = exp2(t - stat) as bf16 for every i, j < T, drops it with the Philox
// bits of attn_philox (seed, b*H + h), as K1 does, scales by 1 / (1 - rate)
// and accumulates (p_d as bf16) . V. Columns j >= T of the ragged last tile
// are -inf before the exponent and are not written. One block of 4 warps per
// (64 query rows, head, batch), the head's K and V in shared memory.
//
// K14, the backward, from the saved probabilities: dV = P_d^T dO, dP = dO
// V^T with the same mask, delta = rowsum(dO * O), dS = p (dP - delta), dQ =
// dS K * scale, dK = dS^T Q * scale. As K2, a query-tile pass (dQ, delta)
// and a key-tile pass (dK, dV) with accumulators in registers and no
// atomics; neither recomputes QK^T or the exponent: p comes from probs
// (the key-tile pass reads it transposed, 8 consecutive keys of a row per
// group of lanes).
//
// Bound on the H100: at B=128, T=228, H=12 the probabilities are 160 MB,
// written once by K13 and read twice by K14 (once per pass); K13 does 1.5x
// K1's products (QK^T twice), K14 5 of K2's 7 (no QK^T). mma.sync
// m16n8k16 with fragments from padded shared memory, as K1/K2: simple and
// right first; the probabilities are stored and loaded 4 bytes a thread
// straight from the fragments.
#include "attn_common.cuh"

namespace {

using namespace vb_attn;
using vb::c_to_a;
using vb::load_a;
using vb::load_b_cols;
using vb::load_b_rows;
using vb::mma16816;

// p(row, j) and p(row, j + 1) of a [T, T] bf16 matrix (j even): one 4-byte
// access when T is even (rows then start 4-byte aligned), else two 2-byte
// ones; zero outside [0, T).
__device__ __forceinline__ void load_p2(const bf16* __restrict__ pb, int row, int j, int T, float& p0, float& p1) {
  p0 = p1 = 0.f;
  if (row >= T || j >= T) return;
  const bf16* src = pb + (size_t)row * T + j;
  if ((T & 1) == 0) {
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(src);
    p0 = __low2float(v);
    p1 = __high2float(v);
  } else {
    p0 = __bfloat162float(src[0]);
    if (j + 1 < T) p1 = __bfloat162float(src[1]);
  }
}

__device__ __forceinline__ void store_p2(bf16* __restrict__ pb, int row, int j, int T, float p0, float p1) {
  if (row >= T || j >= T) return;
  bf16* dst = pb + (size_t)row * T + j;
  if ((T & 1) == 0) {
    *reinterpret_cast<uint32_t*>(dst) = pack_bf16(p0, p1);
  } else {
    dst[0] = __float2bfloat16(p0);
    if (j + 1 < T) dst[1] = __float2bfloat16(p1);
  }
}

// S = Q K^T for this warp's 16 query rows and key tile k0.
__device__ __forceinline__ void scores(float s[8][4], const uint32_t qa[4][4], const bf16* Ks, int k0, int g, int tq) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t b0, b1;
      load_b_rows<LDS>(b0, b1, Ks, k0 + nt * 8, kk * 16, g, tq);
      mma16816(s[nt], qa[kk], b0, b1);
    }
  }
}

// ---------------------------------------------------------------- K13

__global__ void __launch_bounds__(NTHREADS)
attn_sp_fwd_kernel(const bf16* __restrict__ qkv, const float* __restrict__ key_bias, bf16* __restrict__ out,
                   bf16* __restrict__ probs, int T, int H, uint32_t seed, uint32_t threshold, float inv,
                   int dropout) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Tp = round_up(T, TILE);
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [TILE][LDS]
  bf16* Ks = Qs + TILE * LDS;                // [Tp][LDS]
  bf16* Vs = Ks + Tp * LDS;                  // [Tp][LDS]
  float* bias2 = reinterpret_cast<float*>(Vs + Tp * LDS);  // [Tp]

  using L = PackedLayout;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int ld = L::ld_in(H);
  load_tile(Qs, qkv + L::in_off(b, h, 0, T, H), nullptr, qt * TILE, TILE, T, ld);
  load_tile(Ks, qkv + L::in_off(b, h, 1, T, H), nullptr, 0, Tp, T, ld);
  load_tile(Vs, qkv + L::in_off(b, h, 2, T, H), nullptr, 0, Tp, T, ld);
  for (int j = threadIdx.x; j < Tp; j += NTHREADS)
    bias2[j] = j < T ? key_bias[(size_t)b * T + j] * LOG2E : -INFINITY;
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int r0 = warp * 16;
  const int row[2] = {qt * TILE + r0 + g, qt * TILE + r0 + g + 8};
  const uint32_t bh = (uint32_t)(b * H + h);
  const float c1 = SCALE * LOG2E;

  uint32_t qa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) load_a<LDS>(qa[kk], Qs, r0, kk * 16, g, tq);

  // pass 1: the row statistic (running max, rescaled sum; the max is
  // shared by the row's 4 lanes, the sum is per lane until the end)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < Tp; k0 += TILE) {
    float s[8][4];
    scores(s, qa, Ks, k0, g, tq);
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = s[nt][e] * c1 + bias2[k0 + nt * 8 + 2 * tq + (e & 1)];
        mt[e >> 1] = fmaxf(mt[e >> 1], s[nt][e]);
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
      for (int e = 0; e < 4; ++e) l[e >> 1] += exp2f(s[nt][e] - m[e >> 1]);
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
  bf16* pb = probs + ((size_t)b * H + h) * (size_t)T * T;
  float o[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  for (int k0 = 0; k0 < Tp; k0 += TILE) {
    float s[8][4];
    scores(s, qa, Ks, k0, g, tq);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int j = k0 + nt * 8 + 2 * tq;  // even: (j, j+1) share one Philox call and one store
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float p0 = exp2f(s[nt][2 * r] * c1 + bias2[j] - stat[r]);
        const float p1 = exp2f(s[nt][2 * r + 1] * c1 + bias2[j + 1] - stat[r]);
        store_p2(pb, row[r], j, T, p0, p1);
        float d0 = p0 * inv, d1 = p1 * inv;
        if (dropout) {
          const uint4 rnd = vb::attn_philox(seed, bh, row[r], j);
          const int w = (row[r] & 1) << 1;
          if (vb::philox_word(rnd, w) < threshold) d0 = 0.f;
          if (vb::philox_word(rnd, w + 1) < threshold) d1 = 0.f;
        }
        s[nt][2 * r] = d0;
        s[nt][2 * r + 1] = d1;
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint32_t pa[4];
      c_to_a(pa, s[2 * c], s[2 * c + 1]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t b0, b1;
        load_b_cols<LDS>(b0, b1, Vs, k0 + c * 16, nt * 8, g, tq);
        mma16816(o[nt], pa, b0, b1);
      }
    }
  }
  store_rows(out + L::out_off(b, h, T, H), o, 1.f, row[0], row[1], row[0] < T, row[1] < T, L::ld_out(H), tq);
}

// ------------------------------------------------------- K14: dQ pass

__global__ void __launch_bounds__(NTHREADS)
attn_sp_bwd_dq_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ probs, const bf16* __restrict__ dout,
                      const bf16* __restrict__ out, bf16* __restrict__ dqkv, float* __restrict__ delta_g, int T,
                      int H, uint32_t seed, uint32_t threshold, float inv, int dropout) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Tp = round_up(T, TILE);
  bf16* dOs = reinterpret_cast<bf16*>(smem);  // [TILE][LDS]
  bf16* Ks = dOs + TILE * LDS;                // [Tp][LDS]
  bf16* Vs = Ks + Tp * LDS;                   // [Tp][LDS]
  float* dl_s = reinterpret_cast<float*>(Vs + Tp * LDS);  // [TILE]

  using L = PackedLayout;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int ld = L::ld_in(H), ldo = L::ld_out(H);
  const size_t oo = L::out_off(b, h, T, H);
  load_tile(dOs, dout + oo, nullptr, qt * TILE, TILE, T, ldo);
  load_tile(Ks, qkv + L::in_off(b, h, 1, T, H), nullptr, 0, Tp, T, ld);
  load_tile(Vs, qkv + L::in_off(b, h, 2, T, H), nullptr, 0, Tp, T, ld);
  row_delta(dout + oo, out + oo, ldo, dl_s, delta_g + ((size_t)b * H + h) * T, qt, T);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int r0 = warp * 16;
  const int row[2] = {qt * TILE + r0 + g, qt * TILE + r0 + g + 8};
  const float dlrow[2] = {dl_s[r0 + g], dl_s[r0 + g + 8]};
  const uint32_t bh = (uint32_t)(b * H + h);
  const bf16* pb = probs + ((size_t)b * H + h) * (size_t)T * T;

  uint32_t da[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) load_a<LDS>(da[kk], dOs, r0, kk * 16, g, tq);
  float dq[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) dq[nt][0] = dq[nt][1] = dq[nt][2] = dq[nt][3] = 0.f;

  for (int k0 = 0; k0 < Tp; k0 += TILE) {
    float dp[8][4];
    scores(dp, da, Vs, k0, g, tq);  // dP = dO V^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int j = k0 + nt * 8 + 2 * tq;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float p[2];
        load_p2(pb, row[r], j, T, p[0], p[1]);
        uint4 rnd;
        if (dropout) rnd = vb::attn_philox(seed, bh, row[r], j);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float d = dp[nt][2 * r + c];
          if (dropout) d = vb::philox_word(rnd, ((row[r] & 1) << 1) | c) >= threshold ? d * inv : 0.f;
          dp[nt][2 * r + c] = p[c] * (d - dlrow[r]);  // dS (the scale goes on dQ)
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint32_t sa[4];
      c_to_a(sa, dp[2 * c], dp[2 * c + 1]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t b0, b1;
        load_b_cols<LDS>(b0, b1, Ks, k0 + c * 16, nt * 8, g, tq);
        mma16816(dq[nt], sa, b0, b1);
      }
    }
  }
  store_rows(dqkv + L::in_off(b, h, 0, T, H), dq, SCALE, row[0], row[1], row[0] < T, row[1] < T, ld, tq);
}

// --------------------------------------------------- K14: dK, dV pass

__global__ void __launch_bounds__(NTHREADS)
attn_sp_bwd_dkv_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ probs,
                       const bf16* __restrict__ dout, const float* __restrict__ delta_g, bf16* __restrict__ dqkv,
                       int T, int H, uint32_t seed, uint32_t threshold, float inv, int dropout) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Tp = round_up(T, TILE);
  bf16* Vs = reinterpret_cast<bf16*>(smem);  // [TILE][LDS] this block's keys' values
  bf16* Qs = Vs + TILE * LDS;                // [Tp][LDS] all queries
  bf16* dOs = Qs + Tp * LDS;                 // [Tp][LDS]
  float* dl_s = reinterpret_cast<float*>(dOs + Tp * LDS);  // [Tp]

  using L = PackedLayout;
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int ld = L::ld_in(H);
  const size_t sb = ((size_t)b * H + h) * T;
  load_tile(Vs, qkv + L::in_off(b, h, 2, T, H), nullptr, kt * TILE, TILE, T, ld);
  load_tile(Qs, qkv + L::in_off(b, h, 0, T, H), nullptr, 0, Tp, T, ld);
  load_tile(dOs, dout + L::out_off(b, h, T, H), nullptr, 0, Tp, T, L::ld_out(H));
  for (int i = threadIdx.x; i < Tp; i += NTHREADS) dl_s[i] = i < T ? delta_g[sb + i] : 0.f;
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int r0 = warp * 16;
  const int key[2] = {kt * TILE + r0 + g, kt * TILE + r0 + g + 8};
  const uint32_t bh = (uint32_t)(b * H + h);
  const bf16* pb = probs + sb * T;

  uint32_t va[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) load_a<LDS>(va[kk], Vs, r0, kk * 16, g, tq);
  float dk[8][4], dv[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    dk[nt][0] = dk[nt][1] = dk[nt][2] = dk[nt][3] = 0.f;
    dv[nt][0] = dv[nt][1] = dv[nt][2] = dv[nt][3] = 0.f;
  }

  for (int q0 = 0; q0 < Tp; q0 += QC) {
    // dP^T = V dO^T for this warp's 16 keys x QC queries
    float st[QC / 8][4], dpt[QC / 8][4];
#pragma unroll
    for (int nt = 0; nt < QC / 8; ++nt) {
      dpt[nt][0] = dpt[nt][1] = dpt[nt][2] = dpt[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t b0, b1;
        load_b_rows<LDS>(b0, b1, dOs, q0 + nt * 8, kk * 16, g, tq);
        mma16816(dpt[nt], va[kk], b0, b1);
      }
    }
    // element (key[r], query i): st -> P_d (dropped, scaled), dpt -> dS
#pragma unroll
    for (int nt = 0; nt < QC / 8; ++nt) {
      const int i0 = q0 + nt * 8 + 2 * tq;  // even: (i0, i0+1) share one Philox call
      uint4 rnd[2];
      if (dropout) {
        rnd[0] = vb::attn_philox(seed, bh, i0, key[0]);
        rnd[1] = vb::attn_philox(seed, bh, i0, key[1]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, i = i0 + (e & 1);
        const float p = (i < T && key[r] < T) ? __bfloat162float(pb[(size_t)i * T + key[r]]) : 0.f;
        float pd = p * inv, d = dpt[nt][e];
        if (dropout) {
          const bool keep = vb::philox_word(rnd[r], ((e & 1) << 1) | (key[r] & 1)) >= threshold;
          pd = keep ? pd : 0.f;
          d = keep ? d * inv : 0.f;
        }
        st[nt][e] = pd;
        dpt[nt][e] = p * (d - dl_s[i]);
      }
    }
#pragma unroll
    for (int c = 0; c < QC / 16; ++c) {
      uint32_t pa[4], sa[4];
      c_to_a(pa, st[2 * c], st[2 * c + 1]);
      c_to_a(sa, dpt[2 * c], dpt[2 * c + 1]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t b0, b1;
        load_b_cols<LDS>(b0, b1, dOs, q0 + c * 16, nt * 8, g, tq);
        mma16816(dv[nt], pa, b0, b1);
        load_b_cols<LDS>(b0, b1, Qs, q0 + c * 16, nt * 8, g, tq);
        mma16816(dk[nt], sa, b0, b1);
      }
    }
  }

  const bool ok0 = key[0] < T, ok1 = key[1] < T;
  store_rows(dqkv + L::in_off(b, h, 1, T, H), dk, SCALE, key[0], key[1], ok0, ok1, ld, tq);
  store_rows(dqkv + L::in_off(b, h, 2, T, H), dv, 1.f, key[0], key[1], ok0, ok1, ld, tq);
}

size_t sp_fwd_smem(int T) {
  const int Tp = round_up(T, TILE);
  return (size_t)(TILE + 2 * Tp) * LDS * sizeof(bf16) + Tp * sizeof(float);
}
size_t sp_dq_smem(int T) {
  const int Tp = round_up(T, TILE);
  return (size_t)(TILE + 2 * Tp) * LDS * sizeof(bf16) + TILE * sizeof(float);
}
size_t sp_dkv_smem(int T) {
  const int Tp = round_up(T, TILE);
  return (size_t)(TILE + 2 * Tp) * LDS * sizeof(bf16) + Tp * sizeof(float);
}

}  // namespace

extern "C" size_t vb_attn_sp_smem_bytes(int T) {
  size_t a = sp_fwd_smem(T), b = sp_dq_smem(T), c = sp_dkv_smem(T);
  size_t m = a > b ? a : b;
  return m > c ? m : c;
}

extern "C" int vb_attn_sp_fwd(const void* qkv, const void* key_bias, void* out, void* probs, int B, int T, int H,
                              unsigned int seed, unsigned int threshold, float inv, int dropout, void* stream) {
  const size_t smem = sp_fwd_smem(T);
  cudaError_t err = cudaFuncSetAttribute(attn_sp_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + TILE - 1) / TILE, H, B);
  attn_sp_fwd_kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(key_bias), static_cast<bf16*>(out),
      static_cast<bf16*>(probs), T, H, seed, threshold, inv, dropout);
  return (int)cudaGetLastError();
}

extern "C" int vb_attn_sp_bwd(const void* qkv, const void* probs, const void* dout, const void* out, void* dqkv,
                              void* delta, int B, int T, int H, unsigned int seed, unsigned int threshold, float inv,
                              int dropout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((T + TILE - 1) / TILE, H, B);
  const size_t smem_dq = sp_dq_smem(T), smem_dkv = sp_dkv_smem(T);
  cudaError_t err = cudaFuncSetAttribute(attn_sp_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_dq);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attn_sp_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dkv);
  if (err != cudaSuccess) return (int)err;
  attn_sp_bwd_dq_kernel<<<grid, NTHREADS, smem_dq, s>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(probs), static_cast<const bf16*>(dout),
      static_cast<const bf16*>(out), static_cast<bf16*>(dqkv), static_cast<float*>(delta), T, H, seed, threshold,
      inv, dropout);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_sp_bwd_dkv_kernel<<<grid, NTHREADS, smem_dkv, s>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(probs), static_cast<const bf16*>(dout),
      static_cast<const float*>(delta), static_cast<bf16*>(dqkv), T, H, seed, threshold, inv, dropout);
  return (int)cudaGetLastError();
}
