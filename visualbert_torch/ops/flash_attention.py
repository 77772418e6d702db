"""Packed-QKV fused attention (counterpart of
``visualbert_tpu/ops/flash_attention.py::flash_attention_packed``).

The layout and semantics are the JAX package's: ``qkv`` [B, T, H*3*D] packed
head-major ``[h0(q,k,v) | h1(q,k,v) | ...]`` without the projection bias,
which is DEFERRED into the kernel as ``qkv_bias`` [H*3*D] (the backward emits
its gradient directly); an additive key mask (0 valid, -10000 pad) of shape
[B, T] or [B, 1, 1, T]; a seed for attention-probability dropout. The output
is [B, T, H*D]. Scores and softmax are fp32 in the base-2 form
``t = q.k * scale * log2(e) + bias * log2(e)``; the forward also emits the
per-row statistic ``stats = max t + log2 sum exp2(t - max)`` [B, H, T], from
which the backward rebuilds ``p = exp2(t - stats)``. Probabilities are cast to
the compute dtype before PV; backward products take compute-dtype operands
and accumulate in fp32.

Kernels (``csrc/flash_attention.cu``):

* K1, :func:`packed_attention_fwd`, replaces ``_packed_fwd_kernel``;
* K2, :func:`packed_attention_bwd`, replaces ``_packed_bwd_kernel``.

Both are bound by math and, with dropout on, by Philox's integer work; see
the source for the design. On CPU tensors the wrappers compute the plain
versions :func:`packed_attention_fwd_reference` and
:func:`packed_attention_bwd_reference` (which follow the kernels' math step
by step); on CUDA tensors they launch the kernels or raise.

The dropout keep bit of probability (b, h, i, j) is a pure function of
(seed, b, h, i, j) — see ``csrc/philox.cuh::attn_philox`` and its twin
:func:`attention_keep_reference` — so forward and backward draw the same
mask, and kernel and plain version draw it bit for bit.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from visualbert_torch.ops import _build
from visualbert_torch.ops.philox import MASK32, keep_threshold, philox4x32_10

LOG2E = 1.4426950408889634
KERNEL_HEAD_DIM = 64
TILE = 64
MAX_SMEM_BYTES = 232448  # opt-in shared memory per block on sm_90


def attention_keep_reference(seed: int, B: int, H: int, T: int, rate: float, device="cpu") -> torch.Tensor:
    """[B, H, T, T] bool keep mask, bit-exact with the kernels: the bit of
    (b, h, i, j) is word ``(i & 1) << 1 | (j & 1)`` of
    ``philox(ctr=(j >> 1, i >> 1, 0, 0), key=(seed, b*H + h))``."""
    n = (T + 1) // 2
    jj = torch.arange(n, dtype=torch.int64, device=device).view(1, 1, 1, n)
    ii = torch.arange(n, dtype=torch.int64, device=device).view(1, 1, n, 1)
    bh = torch.arange(B * H, dtype=torch.int64, device=device).view(B, H, 1, 1)
    words = philox4x32_10(jj, ii, 0, 0, int(seed) & MASK32, bh, device=device)
    w = [x.expand(B, H, n, n) for x in words]
    # [B, H, i>>1, j>>1, (i&1), (j&1)] -> [B, H, i, j]
    blk = torch.stack(w, dim=-1).view(B, H, n, n, 2, 2).permute(0, 1, 2, 4, 3, 5)
    bits = blk.reshape(B, H, 2 * n, 2 * n)[:, :, :T, :T]
    return bits >= keep_threshold(rate)


def _split_heads(x: torch.Tensor, n_heads: int):
    """[B, T, H*3*D] -> q, k, v each [B, H, T, D]."""
    B, T, F = x.shape
    d = F // (3 * n_heads)
    x = x.view(B, T, n_heads, 3, d).permute(3, 0, 2, 1, 4)
    return x[0], x[1], x[2]


def packed_attention_fwd_reference(qkv, qb, key_bias, n_heads: int, rate: float, seed: int):
    """Plain version of K1: (out [B, T, H*D], stats [B, H, T] fp32)."""
    B, T, F = qkv.shape
    d = F // (3 * n_heads)
    scale = 1.0 / math.sqrt(d)
    x = qkv + qb  # deferred projection bias, in the compute dtype
    q, k, v = _split_heads(x, n_heads)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    t = s * (scale * LOG2E) + (key_bias.float() * LOG2E)[:, None, None, :]
    m2 = t.amax(dim=-1, keepdim=True)
    e = torch.exp2(t - m2)
    ssum = e.sum(dim=-1, keepdim=True)
    p = e * (1.0 / ssum)
    stats = (m2 + torch.log2(ssum))[..., 0]
    if rate > 0.0:
        keep = attention_keep_reference(seed, B, n_heads, T, rate, qkv.device)
        p = torch.where(keep, p * (1.0 / (1.0 - rate)), torch.zeros((), device=p.device))
    o = torch.matmul(p.to(x.dtype).float(), v.float()).to(x.dtype)  # [B, H, T, D]
    return o.permute(0, 2, 1, 3).reshape(B, T, n_heads * d), stats


def packed_attention_bwd_reference(qkv, qb, key_bias, dout, out, stats, n_heads: int, rate: float, seed: int):
    """Plain version of K2, following its math: P rebuilt from the stats,
    delta = rowsum(dO * O), dQ and dK scaled at the end. Returns
    (dqkv [B, T, H*3*D], dqb [H*3*D] in qb's dtype)."""
    B, T, F = qkv.shape
    d = F // (3 * n_heads)
    scale = 1.0 / math.sqrt(d)
    dt = qkv.dtype
    x = qkv + qb
    q, k, v = _split_heads(x, n_heads)
    do = dout.view(B, T, n_heads, d).permute(0, 2, 1, 3)
    o = out.view(B, T, n_heads, d).permute(0, 2, 1, 3)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    t = s * (scale * LOG2E) + (key_bias.float() * LOG2E)[:, None, None, :]
    p = torch.exp2(t - stats[..., None])
    zero = torch.zeros((), device=p.device)
    if rate > 0.0:
        keep = attention_keep_reference(seed, B, n_heads, T, rate, qkv.device)
        p_d = torch.where(keep, p * (1.0 / (1.0 - rate)), zero).to(dt)
    else:
        p_d = p.to(dt)
    dv = torch.matmul(p_d.float().transpose(-1, -2), do.float()).to(dt)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    if rate > 0.0:
        dp = torch.where(keep, dp * (1.0 / (1.0 - rate)), zero)
    delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta)).to(dt).float()
    dq = (torch.matmul(ds, k.float()) * scale).to(dt)
    dk = (torch.matmul(ds.transpose(-1, -2), q.float()) * scale).to(dt)
    dqkv = torch.stack([dq, dk, dv], dim=0).permute(1, 3, 2, 0, 4).reshape(B, T, F)
    dqb = dqkv.float().sum(dim=(0, 1)).to(qb.dtype)
    return dqkv, dqb


def _check_cuda_inputs(what, qkv, qb, key_bias, n_heads, *others):
    if qkv.dtype != torch.bfloat16:
        raise ValueError(f"{what}: the kernel takes bf16 qkv, got {qkv.dtype}")
    B, T, F = qkv.shape
    if F % (3 * n_heads) or F // (3 * n_heads) != KERNEL_HEAD_DIM:
        raise ValueError(f"{what}: the kernel takes head dim {KERNEL_HEAD_DIM}, got F={F}, H={n_heads}")
    if qb.shape != (F,) or qb.dtype != qkv.dtype:
        raise ValueError(f"{what}: qkv_bias must be [{F}] {qkv.dtype}, got {tuple(qb.shape)} {qb.dtype}")
    if key_bias.shape != (B, T) or key_bias.dtype != torch.float32:
        raise ValueError(f"{what}: key bias must be [{B}, {T}] float32")
    for t in (qkv, qb, key_bias) + others:
        if t.device != qkv.device:
            raise ValueError(f"{what}: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: tensors must be 16-byte aligned")
    lib = _build.library()
    if lib.vb_attn_smem_bytes(T) > MAX_SMEM_BYTES:
        raise ValueError(f"{what}: T={T} needs more shared memory than a block has")
    return lib


def _seed_args(rate: float, seed: int):
    return int(seed) & MASK32, keep_threshold(rate), (1.0 / (1.0 - rate) if rate > 0.0 else 1.0), int(rate > 0.0)


def packed_attention_fwd(qkv, qb, key_bias, n_heads: int, rate: float, seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 wrapper: (out [B, T, H*D], stats [B, H, T] fp32)."""
    if qkv.device.type == "cpu":
        return packed_attention_fwd_reference(qkv, qb, key_bias, n_heads, rate, seed)
    if qkv.device.type != "cuda":
        raise ValueError(f"packed attention: unsupported device {qkv.device}")
    lib = _check_cuda_inputs("packed attention forward (K1)", qkv, qb, key_bias, n_heads)
    B, T, F = qkv.shape
    out = torch.empty((B, T, F // 3), dtype=qkv.dtype, device=qkv.device)
    stats = torch.empty((B, n_heads, T), dtype=torch.float32, device=qkv.device)
    code = lib.vb_attn_fwd(
        qkv.data_ptr(), qb.data_ptr(), key_bias.data_ptr(), out.data_ptr(), stats.data_ptr(),
        B, T, n_heads, *_seed_args(rate, seed), _build.stream_ptr(qkv.device),
    )
    lib.check(code, "packed attention forward (K1)")
    packed_attention_fwd.launches += 1
    return out, stats


packed_attention_fwd.launches = 0


def packed_attention_bwd(qkv, qb, key_bias, dout, out, stats, n_heads: int, rate: float, seed: int):
    """K2 wrapper: (dqkv [B, T, H*3*D], dqb [H*3*D] in qb's dtype). The
    kernel writes fp32 per-(batch, 64-row tile) partials of the bias
    gradient; their sum here is the only reduction outside it."""
    if qkv.device.type == "cpu":
        return packed_attention_bwd_reference(qkv, qb, key_bias, dout, out, stats, n_heads, rate, seed)
    if qkv.device.type != "cuda":
        raise ValueError(f"packed attention: unsupported device {qkv.device}")
    what = "packed attention backward (K2)"
    lib = _check_cuda_inputs(what, qkv, qb, key_bias, n_heads, dout, out, stats)
    B, T, F = qkv.shape
    if dout.shape != (B, T, F // 3) or dout.dtype != qkv.dtype or out.shape != dout.shape or out.dtype != qkv.dtype:
        raise ValueError(f"{what}: dout and out must be [{B}, {T}, {F // 3}] {qkv.dtype}")
    if stats.shape != (B, n_heads, T) or stats.dtype != torch.float32:
        raise ValueError(f"{what}: stats must be [{B}, {n_heads}, {T}] float32")
    n_tiles = (T + TILE - 1) // TILE
    dqkv = torch.empty_like(qkv)
    db_part = torch.empty((B, n_tiles, F), dtype=torch.float32, device=qkv.device)
    delta = torch.empty((B, n_heads, T), dtype=torch.float32, device=qkv.device)
    code = lib.vb_attn_bwd(
        qkv.data_ptr(), qb.data_ptr(), key_bias.data_ptr(), dout.data_ptr(), out.data_ptr(),
        stats.data_ptr(), dqkv.data_ptr(), db_part.data_ptr(), delta.data_ptr(),
        B, T, n_heads, *_seed_args(rate, seed), _build.stream_ptr(qkv.device),
    )
    lib.check(code, what)
    packed_attention_bwd.launches += 1
    return dqkv, db_part.sum(dim=(0, 1)).to(qb.dtype)


packed_attention_bwd.launches = 0


class _PackedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, qb, key_bias, n_heads, rate, seed, plain):
        fwd = packed_attention_fwd_reference if plain else packed_attention_fwd
        out, stats = fwd(qkv, qb, key_bias, n_heads, rate, seed)
        ctx.save_for_backward(qkv, qb, key_bias, out, stats)
        ctx.args = (n_heads, rate, seed, plain)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, qb, key_bias, out, stats = ctx.saved_tensors
        n_heads, rate, seed, plain = ctx.args
        bwd = packed_attention_bwd_reference if plain else packed_attention_bwd
        dqkv, dqb = bwd(qkv, qb, key_bias, dout.contiguous(), out, stats, n_heads, rate, seed)
        return dqkv, dqb, None, None, None, None, None


def _prepare(qkv, bias, seed, qkv_bias):
    B, T, F = qkv.shape
    key_bias = bias[:, 0, 0, :] if bias.dim() == 4 else bias
    key_bias = key_bias.to(torch.float32).contiguous()
    qb = qkv_bias if qkv_bias is not None else torch.zeros(F, dtype=qkv.dtype, device=qkv.device)
    return qkv.contiguous(), qb.contiguous(), key_bias, int(seed or 0)


def flash_attention_packed(qkv: torch.Tensor, n_heads: int, bias: torch.Tensor, dropout_rate: float = 0.0,
                           seed: Optional[int] = None, qkv_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused attention over a packed QKV projection (K1 forward, K2 backward).

    qkv: [B, T, H*3*D] head-major, bias-free when ``qkv_bias`` is given.
    bias: [B, 1, 1, T] or [B, T] additive key mask (0 valid, -10000 pad).
    seed: int, required when ``dropout_rate > 0``. Returns [B, T, H*D]."""
    if dropout_rate > 0.0 and seed is None:
        raise ValueError("flash_attention_packed: dropout needs a seed")
    qkv, qb, key_bias, seed = _prepare(qkv, bias, seed, qkv_bias)
    return _PackedAttention.apply(qkv, qb, key_bias, n_heads, float(dropout_rate), seed, False)


def flash_attention_packed_reference(qkv: torch.Tensor, n_heads: int, bias: torch.Tensor, dropout_rate: float = 0.0,
                                     seed: Optional[int] = None, qkv_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`flash_attention_packed` through the plain versions on any device."""
    if dropout_rate > 0.0 and seed is None:
        raise ValueError("flash_attention_packed_reference: dropout needs a seed")
    qkv, qb, key_bias, seed = _prepare(qkv, bias, seed, qkv_bias)
    return _PackedAttention.apply(qkv, qb, key_bias, n_heads, float(dropout_rate), seed, True)
