"""Fused attention (counterpart of ``visualbert_tpu/ops/flash_attention.py``):
the packed-QKV op ``flash_attention_packed`` (with and without saved
probabilities) and the heads-major op ``flash_attention_heads_major`` (the
JAX ``flash_attention(..., heads_major=True)`` on q, k, v stacked into one
tensor, as the encoder builds it).

Layouts and semantics are the JAX package's. Packed: ``qkv`` [B, T, H*3*D]
packed head-major ``[h0(q,k,v) | h1(q,k,v) | ...]`` without the projection
bias, which is DEFERRED into the kernel as ``qkv_bias`` [H*3*D] (the
backward emits its gradient directly); output [B, T, H*D]. Heads-major:
``qkv`` [B, 3, H, T, D] with the bias added; output [B, H, T, D]. Both take
an additive key mask (0 valid, -10000 pad) of shape [B, T] or [B, 1, 1, T]
and a seed for attention-probability dropout. Scores and softmax are fp32
in the base-2 form ``t = q.k * scale * log2(e) + bias * log2(e)``; the
forward also emits the per-row statistic ``stats = max t + log2 sum exp2(t
- max)`` [B, H, T], from which the backward rebuilds ``p = exp2(t -
stats)``. Probabilities are cast to the compute dtype before PV; backward
products take compute-dtype operands and accumulate in fp32.

With ``save_probs`` the packed op adds the bias eagerly (autograd gives its
gradient, as in JAX), its forward also writes the normalised pre-dropout
probabilities [B, H, T, T], always bf16, and its backward reads them back
instead of recomputing QK^T and the softmax.

Kernels (``csrc/flash_attention_packed.cu``, ``csrc/flash_attention.cu``,
``csrc/flash_attention_sp.cu``, all on ``csrc/hopper_attn.cuh``, and
``csrc/flash_attention_f32.cu``):

* K1, :func:`packed_attention_fwd`, replaces ``_packed_fwd_kernel``;
* K2, :func:`packed_attention_bwd`, replaces ``_packed_bwd_kernel``;
* K11, :func:`heads_major_attention_fwd`, replaces ``_fwd_kernel``;
* K12, :func:`heads_major_attention_bwd`, replaces ``_bwd_kernel``;
* K13, :func:`packed_attention_sp_fwd`, replaces ``_packed_fwd_sp_kernel``;
* K14, :func:`packed_attention_sp_bwd`, replaces ``_packed_bwd_sp_kernel``.

All are bound by math and, with dropout on, by Philox's integer work (K13
and K14 also move the probabilities); see the sources for the designs. Each
block owns one batch row x hg heads, hg from :func:`head_group` over the
kernel's occupancy (:func:`packed_head_groups`, :func:`hm_head_groups`,
:func:`sp_head_groups`). On CPU tensors the wrappers compute their plain
versions (the ``*_reference`` functions, which follow the kernels' math
step by step); on CUDA tensors they launch the kernels or raise.

K1 and K2 take every dtype and head dim the JAX kernels take up to D = 128
(the JAX wrapper asserts only ``F % 3H == 0``): bf16 and fp16 on the Hopper
kernels, instantiated at D = 16, 32, 64 and 128 (HEAD_DIMS; at 16 and 32
on rows of their own size, read in place; so are K11-K14), a head dim
below an instantiation zero-padded to it (:func:`kernel_head_dim`,
:func:`pad_heads`, :func:`unpad_heads`; exact, and the softmax scale stays
1/sqrt(D) of the unpadded D), and fp32 on the SIMT
kernels of ``flash_attention_f32.cu`` at any D <= 128 (all register-tiled,
64-row tiles of a (batch row, head): K1/K11's forward in one pass over the
keys, K13's in two, the backward of K2, K12 and K14; the bias gradient's
partials one row a (batch row, tile): :func:`f32_bias_tiles`,
:func:`sum_bias_partials`). K2 at D = STREAMED_HEAD_DIM (128) runs its two
passes a block a (128 rows, head, batch row), the other operand streamed
through a TMA ring into two consumer warpgroups: no head groups, no T
limit (K1's forward bounds the packed path there), and its bias partials
one row a (batch row, 128-row block) (:func:`packed_bias_rows`). K11-K14
take the same dtypes and head dims: bf16 and fp16 on their Hopper kernels
at the same instantiations (the heads-major ``[B, 3, H, T, D]``
zero-padded to ``[..., Dp]`` by :func:`pad_heads_major`, the packed layout
by :func:`pad_heads`, Dp = :func:`kernel_head_dim` (D)), and fp32 on the SIMT kernels of
``flash_attention_f32.cu`` (K11/K12 on the heads-major strides, K13/K14 on
save-probs kernels of their own); K13's probabilities are bf16 in every
form. bf16 at D = 64, the main path's form, keeps its entry points
(``vb_attn_hm_fwd``, ``vb_attn_sp_fwd``...), which tools launch on another
tree's build; the other bf16 and fp16 forms go through ``vb_attn_hm_x_*``
and ``vb_attn_sp_x_*`` with the dtype, head dim and scale. Each wrapper
counts its launches in ``launches`` and, by form (:func:`attention_form`:
"bf16 D32", "fp16 D64", "fp32"...), in ``forms``. A training step runs a
pair's forward and backward, so each forward's wrapper and K11-K14's
backwards check T against the largest of their pair's three kernels'
shared memory (K2 against its own passes', which at 128 take any T): at D
<= 32 the backwards' passes bound every path (T up to 2880 / 1472 packed,
2880 / 1536 heads-major, 3072 / 1536 save-probs at 16 / 32), at 64 the
forwards (704), at 128 K1 (384) and K11/K12 (256).

The dropout keep bit of probability (b, h, i, j) is a pure function of
(seed, b, h, i, j) — see ``csrc/philox.cuh::attn_philox`` and its twin
:func:`attention_keep_reference` — so forward and backward draw the same
mask, and kernel and plain version draw it bit for bit.

Under a (data, model) mesh (``parallel/mesh.py``) each rank calls the ops
on its own shard: its rows of the batch and its whole heads (``H / m``,
a contiguous block of the head-major packing). The ``mesh`` argument offsets
the dropout seed by the data and model index (``Mesh.shard_seed``; JAX
``:740``/``:761`` offset theirs inside ``shard_map``), so every rank draws
its own probabilities' mask.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from visualbert_torch.ops import _build
from visualbert_torch.ops.philox import MASK32, keep_threshold, philox4x32_10

LOG2E = 1.4426950408889634
KERNEL_HEAD_DIM = 64  # the bf16 main forms' head dim (K15/K16 take only it)
HEAD_DIMS = (16, 32, 64, 128)  # the bf16 and fp16 instantiations of K1/K2 and K11-K14: 16 and 32 on small rows
MAX_HEAD_DIM = 128  # K1/K2 and K11-K14 in every dtype
STREAMED_HEAD_DIM = 128  # K2's passes there take a block a (128 rows, head, batch row) and no T limit
PACKED_DTYPES = (torch.bfloat16, torch.float16, torch.float32)  # K1/K2 and K11-K14
_DTYPE_CODE = {torch.bfloat16: 0, torch.float16: 1}  # csrc/flash_attention_packed.cu's dtype argument
MAX_SMEM_BYTES = 232448  # opt-in shared memory per block on sm_90


def kernel_head_dim(d: int) -> int:
    """The head dim at which the bf16 and fp16 kernels of K1/K2 and K11-K14
    run heads of dim d (<= MAX_HEAD_DIM): the smallest of HEAD_DIMS that
    holds it, so that heads of 16, 32, 64 and 128 run unpadded."""
    return next(dp for dp in HEAD_DIMS if d <= dp)


def pad_heads(x: torch.Tensor, n_heads: int, parts: int, dp: int) -> torch.Tensor:
    """[..., H*parts*D] packed head-major -> [..., H*parts*dp], each head's
    ``parts`` blocks of D columns (q, k, v: 3; an output: 1) zero-padded to
    dp columns (``x`` itself when D = dp)."""
    d = x.shape[-1] // (n_heads * parts)
    if d == dp:
        return x
    lead = x.shape[:-1]
    return torch.nn.functional.pad(x.reshape(*lead, n_heads, parts, d), (0, dp - d)).reshape(*lead, -1)


def unpad_heads(x: torch.Tensor, n_heads: int, parts: int, d: int) -> torch.Tensor:
    """The inverse of :func:`pad_heads`: [..., H*parts*dp] -> [..., H*parts*d]."""
    dp = x.shape[-1] // (n_heads * parts)
    if d == dp:
        return x
    lead = x.shape[:-1]
    return x.reshape(*lead, n_heads, parts, dp)[..., :d].reshape(*lead, n_heads * parts * d)


def pad_heads_major(x: torch.Tensor, dp: int) -> torch.Tensor:
    """Heads-major [..., D] (qkv [B, 3, H, T, D], out [B, H, T, D]) with
    each row zero-padded to dp columns (``x`` itself when D = dp)."""
    d = x.shape[-1]
    return x if d == dp else torch.nn.functional.pad(x, (0, dp - d))


def unpad_heads_major(x: torch.Tensor, d: int) -> torch.Tensor:
    """The inverse of :func:`pad_heads_major`, contiguous."""
    return x if x.shape[-1] == d else x[..., :d].contiguous()


def attention_form(dtype, d: int) -> str:
    """The kernel form every attention kernel (K1/K2, K11-K14) runs heads of
    dim d in ``dtype`` on: "fp32" (the SIMT kernels) or "<dtype>
    D<kernel_head_dim(d)>"."""
    if dtype == torch.float32:
        return "fp32"
    return f"{'bf16' if dtype == torch.bfloat16 else 'fp16'} D{kernel_head_dim(d)}"


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


def _pack_heads(dq, dk, dv):
    """dq, dk, dv [B, H, T, D] -> [B, T, H*3*D] packed head-major."""
    B, H, T, d = dq.shape
    return torch.stack([dq, dk, dv], dim=0).permute(1, 3, 2, 0, 4).reshape(B, T, 3 * H * d)


def _merge_heads(o):
    """[B, H, T, D] -> [B, T, H*D]."""
    B, H, T, d = o.shape
    return o.permute(0, 2, 1, 3).reshape(B, T, H * d)


def _heads(x, n_heads):
    """[B, T, H*D] -> [B, H, T, D]."""
    B, T, F = x.shape
    return x.view(B, T, n_heads, F // n_heads).permute(0, 2, 1, 3)


def _keep(seed, q, rate):
    B, H, T, _ = q.shape
    return attention_keep_reference(seed, B, H, T, rate, q.device)


def _scores2(q, k, key_bias, prescale: bool = False, scale: Optional[float] = None):
    """t = q.k * scale * log2(e) + key_bias * log2(e), fp32 [B, H, T, T];
    scale 1/sqrt(D) unless given (heads zero-padded past their D keep their
    own). With ``prescale`` (K15's variant) q is first rounded to q's dtype
    as q * scale * log2(e) and the product is not scaled again."""
    c1 = (1.0 / math.sqrt(q.shape[-1]) if scale is None else scale) * LOG2E
    kb = (key_bias.float() * LOG2E)[:, None, None, :]
    if prescale:
        return torch.matmul((q.float() * c1).to(q.dtype).float(), k.float().transpose(-1, -2)) + kb
    return torch.matmul(q.float(), k.float().transpose(-1, -2)) * c1 + kb


def _attention_fwd(q, k, v, key_bias, rate: float, seed: int, prescale: bool = False, nomax: bool = False,
                   scale: Optional[float] = None):
    """K1's and K11's math on biased q, k, v [B, H, T, D]: (o [B, H, T, D]
    in q's dtype, stats [B, H, T] fp32). ``prescale`` and ``nomax`` are
    K15's variants: q rounded after scaling, and no row max (stats = log2
    sum exp2(t)); ``scale`` as :func:`_scores2`'s."""
    t = _scores2(q, k, key_bias, prescale, scale)
    m2 = torch.zeros_like(t[..., :1]) if nomax else t.amax(dim=-1, keepdim=True)
    e = torch.exp2(t - m2)
    ssum = e.sum(dim=-1, keepdim=True)
    p = e * (1.0 / ssum)
    stats = (m2 + torch.log2(ssum))[..., 0]
    if rate > 0.0:
        p = torch.where(_keep(seed, q, rate), p * (1.0 / (1.0 - rate)), torch.zeros((), device=p.device))
    return torch.matmul(p.to(q.dtype).float(), v.float()).to(q.dtype), stats


def _attention_bwd_from_p(q, k, v, do, o, p, rate: float, seed: int, fdrop: bool = False,
                          scale: Optional[float] = None):
    """The backward of every attention kernel given the pre-dropout
    probabilities p (fp32 [B, H, T, T]): delta = rowsum(dO * O), dQ and dK
    scaled at the end (by 1/sqrt(D) unless ``scale`` is given). Returns dq,
    dk, dv [B, H, T, D] in q's dtype. ``fdrop`` (K15's variant) takes ds =
    p_d * dP - p * delta with the dropped probabilities p_d rounded to q's
    dtype, at rate > 0."""
    dt = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    zero = torch.zeros((), device=p.device)
    if rate > 0.0:
        keep = _keep(seed, q, rate)
        p_d = torch.where(keep, p * (1.0 / (1.0 - rate)), zero).to(dt)
    else:
        p_d = p.to(dt)
    dv = torch.matmul(p_d.float().transpose(-1, -2), do.float()).to(dt)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
    if rate > 0.0 and fdrop:
        ds = p_d.float() * dp - p * delta
    else:
        if rate > 0.0:
            dp = torch.where(keep, dp * (1.0 / (1.0 - rate)), zero)
        ds = p * (dp - delta)
    ds = ds.to(dt).float()
    dq = (torch.matmul(ds, k.float()) * scale).to(dt)
    dk = (torch.matmul(ds.transpose(-1, -2), q.float()) * scale).to(dt)
    return dq, dk, dv


def _attention_bwd(q, k, v, key_bias, do, o, stats, rate: float, seed: int, prescale: bool = False,
                   fdrop: bool = False, scale: Optional[float] = None):
    """K2's and K12's math: P rebuilt from the stats (K15's variants and
    ``scale`` as in :func:`_scores2` and :func:`_attention_bwd_from_p`)."""
    p = torch.exp2(_scores2(q, k, key_bias, prescale, scale) - stats[..., None])
    return _attention_bwd_from_p(q, k, v, do, o, p, rate, seed, fdrop, scale)


def packed_attention_fwd_reference(qkv, qb, key_bias, n_heads: int, rate: float, seed: int,
                                   scale: Optional[float] = None):
    """Plain version of K1: (out [B, T, H*D], stats [B, H, T] fp32); the
    softmax scale 1/sqrt(D) unless ``scale`` is given (the padded heads'
    kernel call keeps the unpadded D's)."""
    q, k, v = _split_heads(qkv + qb, n_heads)  # deferred projection bias, in the compute dtype
    o, stats = _attention_fwd(q, k, v, key_bias, rate, seed, scale=scale)
    return _merge_heads(o), stats


def packed_attention_bwd_reference(qkv, qb, key_bias, dout, out, stats, n_heads: int, rate: float, seed: int,
                                   scale: Optional[float] = None):
    """Plain version of K2. Returns (dqkv [B, T, H*3*D], dqb [H*3*D] in
    qb's dtype); ``scale`` as the forward's."""
    q, k, v = _split_heads(qkv + qb, n_heads)
    dqkv = _pack_heads(*_attention_bwd(q, k, v, key_bias, _heads(dout, n_heads), _heads(out, n_heads), stats,
                                       rate, seed, scale=scale))
    return dqkv, dqkv.float().sum(dim=(0, 1)).to(qb.dtype)


def heads_major_attention_fwd_reference(qkv, key_bias, rate: float, seed: int, scale: Optional[float] = None):
    """Plain version of K11: qkv [B, 3, H, T, D] -> (out [B, H, T, D],
    stats [B, H, T] fp32); ``scale`` as K1's."""
    return _attention_fwd(*qkv.unbind(1), key_bias, rate, seed, scale=scale)


def heads_major_attention_bwd_reference(qkv, key_bias, dout, out, stats, rate: float, seed: int,
                                        scale: Optional[float] = None):
    """Plain version of K12: dqkv [B, 3, H, T, D]."""
    return torch.stack(_attention_bwd(*qkv.unbind(1), key_bias, dout, out, stats, rate, seed, scale=scale), dim=1)


def packed_attention_sp_fwd_reference(qkv, key_bias, n_heads: int, rate: float, seed: int,
                                      scale: Optional[float] = None):
    """Plain version of K13 on the biased packed qkv: (out [B, T, H*D],
    probs [B, H, T, T] bf16, the normalised pre-dropout p); ``scale`` as
    K1's."""
    q, k, v = _split_heads(qkv, n_heads)
    t = _scores2(q, k, key_bias, scale=scale)
    m2 = t.amax(dim=-1, keepdim=True)
    p = torch.exp2(t - (m2 + torch.log2(torch.exp2(t - m2).sum(dim=-1, keepdim=True))))
    probs = p.to(torch.bfloat16)
    if rate > 0.0:
        p = torch.where(_keep(seed, q, rate), p * (1.0 / (1.0 - rate)), torch.zeros((), device=p.device))
    o = torch.matmul(p.to(qkv.dtype).float(), v.float()).to(qkv.dtype)
    return _merge_heads(o), probs


def packed_attention_sp_bwd_reference(qkv, probs, dout, out, n_heads: int, rate: float, seed: int,
                                      scale: Optional[float] = None):
    """Plain version of K14: dqkv [B, T, H*3*D] from the saved bf16 probs."""
    q, k, v = _split_heads(qkv, n_heads)
    return _pack_heads(*_attention_bwd_from_p(q, k, v, _heads(dout, n_heads), _heads(out, n_heads),
                                              probs.float(), rate, seed, scale=scale))


# --------------------------------------------------------------- wrappers


def _on_cuda(what, x) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises on any other."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    return True


def _check(what, smem_fn, T, key_bias, B, *tensors):
    """Device, contiguity, alignment, key bias (unless None) and shared
    memory (``smem_fn(lib, T)``: the kernels' bytes at T; None for kernels
    whose shared memory does not grow with T); returns the library."""
    if key_bias is not None:
        if key_bias.shape != (B, T) or key_bias.dtype != torch.float32:
            raise ValueError(f"{what}: key bias must be [{B}, {T}] float32")
        tensors = tensors + (key_bias,)
    for t in tensors:
        if t.device != tensors[0].device:
            raise ValueError(f"{what}: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: tensors must be 16-byte aligned")
    lib = _build.library()
    if smem_fn is not None and smem_fn(lib, T) > MAX_SMEM_BYTES:
        longest = max(t for t in range(1, T) if smem_fn(lib, t) <= MAX_SMEM_BYTES)
        raise ValueError(f"{what}: T={T} needs more shared memory than a block has; the kernel takes T up to "
                         f"{longest}")
    return lib


def _check_packed(what, qkv, key_bias, n_heads, *others, smem_fn, qb=None):
    """The checks of the bf16, head dim 64 packed kernels (K15/K16), their
    shared memory from the entry point ``smem_fn`` of T."""
    if qkv.dtype != torch.bfloat16:
        raise ValueError(f"{what}: the kernel takes bf16 qkv, got {qkv.dtype}")
    B, T, F = qkv.shape
    if F % (3 * n_heads) or F // (3 * n_heads) != KERNEL_HEAD_DIM:
        raise ValueError(f"{what}: the kernel takes head dim {KERNEL_HEAD_DIM}, got F={F}, H={n_heads}")
    for t in others:
        if t.dtype != qkv.dtype or t.shape != (B, T, F // 3):
            raise ValueError(f"{what}: dout and out must be [{B}, {T}, {F // 3}] {qkv.dtype}")
    if qb is not None:
        if qb.shape != (F,) or qb.dtype != qkv.dtype:
            raise ValueError(f"{what}: qkv_bias must be [{F}] {qkv.dtype}, got {tuple(qb.shape)} {qb.dtype}")
        others = others + (qb,)
    return _check(what, lambda lib, t: getattr(lib, smem_fn)(t), T, key_bias, B, qkv, *others)


def _check_packed_any(what, qkv, key_bias, n_heads, *others, qb, kernels=None):
    """K1/K2's checks in every form: a dtype of PACKED_DTYPES, head dim up
    to MAX_HEAD_DIM, shapes, and (bf16, fp16) the shared memory of T at the
    instantiated head dim :func:`kernel_head_dim` (D): the largest of the
    three kernels' (K1: a step runs all three), or of ``kernels``
    (PACKED_KERNELS' indices; K2: its two passes, which at
    STREAMED_HEAD_DIM take any T)."""
    if qkv.dtype not in PACKED_DTYPES:
        raise ValueError(f"{what}: the kernels take bf16, fp16 or fp32 qkv, got {qkv.dtype}")
    B, T, F = qkv.shape
    if F % (3 * n_heads) or F // (3 * n_heads) > MAX_HEAD_DIM:
        raise ValueError(f"{what}: the kernels take head dims up to {MAX_HEAD_DIM}, got F={F}, H={n_heads}")
    d = F // (3 * n_heads)
    for t in others:
        if t.dtype != qkv.dtype or t.shape != (B, T, F // 3):
            raise ValueError(f"{what}: dout and out must be [{B}, {T}, {F // 3}] {qkv.dtype}")
    if qb.shape != (F,) or qb.dtype != qkv.dtype:
        raise ValueError(f"{what}: qkv_bias must be [{F}] {qkv.dtype}, got {tuple(qb.shape)} {qb.dtype}")
    dp = kernel_head_dim(d)
    if qkv.dtype == torch.float32:
        smem = None
    elif kernels is None:
        smem = lambda lib, t: lib.vb_attn_packed_x_smem_bytes(dp, t)  # noqa: E731
    else:
        code = _DTYPE_CODE[qkv.dtype]
        smem = lambda lib, t: max(lib.vb_attn_packed_x_info(code, dp, k, 2, t) for k in kernels)  # noqa: E731
    return _check(what, smem, T, key_bias, B, qkv, *others, qb)


def _main_form(dtype, d: int) -> bool:
    """Whether K11-K14 run heads of dim d in ``dtype`` on their bf16, D = 64
    entry points (the main path's form, the scale a constant)."""
    return dtype == torch.bfloat16 and d == KERNEL_HEAD_DIM


def _variant_smem(dtype, d: int, main: str, x: str):
    """The shared-memory function of T (None for fp32) of K11-K14's form of
    ``dtype`` and head dim d, the largest of the pair's three kernels': the
    entry point ``main`` at bf16 D = 64, else ``x`` at the instantiated head
    dim :func:`kernel_head_dim` (d)."""
    if dtype == torch.float32:
        return None
    if _main_form(dtype, d):
        return lambda lib, t: getattr(lib, main)(t)
    dp = kernel_head_dim(d)
    return lambda lib, t: getattr(lib, x)(dp, t)


def _check_variant_dtype(what, qkv, d: int):
    if qkv.dtype not in PACKED_DTYPES:
        raise ValueError(f"{what}: the kernels take bf16, fp16 or fp32 qkv, got {qkv.dtype}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"{what}: the kernels take head dims up to {MAX_HEAD_DIM}, got {d}")


def _check_sp(what, qkv, key_bias, n_heads, *others):
    """K13/K14's checks in every form: dtype, head dim, shapes, and (bf16,
    fp16) the shared memory of T at :func:`kernel_head_dim` (D): the largest
    of the three kernels' bytes there bounds the save-probs path."""
    B, T, F = qkv.shape
    if F % (3 * n_heads):
        raise ValueError(f"{what}: F={F} does not split into 3 x {n_heads} heads")
    d = F // (3 * n_heads)
    _check_variant_dtype(what, qkv, d)
    for t in others:
        if t.dtype != qkv.dtype or t.shape != (B, T, F // 3):
            raise ValueError(f"{what}: dout and out must be [{B}, {T}, {F // 3}] {qkv.dtype}")
    smem = _variant_smem(qkv.dtype, d, "vb_attn_sp_smem_bytes", "vb_attn_sp_x_smem_bytes")
    return _check(what, smem, T, key_bias, B, qkv, *others)


def _check_stats(what, stats, B, H, T):
    if stats.shape != (B, H, T) or stats.dtype != torch.float32:
        raise ValueError(f"{what}: stats must be [{B}, {H}, {T}] float32")


def _seed_args(rate: float, seed: int):
    return int(seed) & MASK32, keep_threshold(rate), (1.0 / (1.0 - rate) if rate > 0.0 else 1.0), int(rate > 0.0)


def head_group(B: int, H: int, n_sm: int, per_sm: int) -> int:
    """Heads a block of K1/K2, K11/K12 or K13/K14 walks (one batch row x hg
    heads a block): the divisor hg of H that minimises the wave estimate
    ceil(blocks / slots) x hg, blocks = B * H / hg and slots = n_sm * per_sm
    (the time of a wave is about that of hg pairs); ties go to the fewer
    blocks."""
    slots = n_sm * per_sm
    divisors = [hg for hg in range(1, H + 1) if H % hg == 0]
    return min(divisors, key=lambda hg: (-(-(B * H // hg) // slots) * hg, -hg))


# kernel index of vb_attn_packed_info, vb_attn_hm_info and vb_attn_sp_info:
# the forward, the dQ pass, the dK/dV pass
PACKED_KERNELS = ("forward", "dQ pass", "dK/dV pass")
_head_groups = {}


def _kernel_head_groups(lib, info: str, label: str, B: int, H: int, T: int, device, form=(),
                        kernels=(0, 1, 2)) -> Tuple[int, int, int]:
    """hg of a forward kernel and of its backward's two passes at this shape
    on ``device``, from each kernel's resident blocks per SM (the CUDA
    occupancy query ``info``, after the ``form`` arguments it takes, at its
    shared memory for T); None for a kernel not in ``kernels`` (K2's
    streamed passes, which take no head groups); computed once a (kernel
    pair, form, B, H, T, device)."""
    key = (info, form, B, H, T, device.index)
    if key not in _head_groups:
        n_sm = torch.cuda.get_device_properties(device).multi_processor_count
        out = []
        for k, kernel in enumerate(PACKED_KERNELS):
            if k not in kernels:
                out.append(None)
                continue
            per_sm = getattr(lib, info)(*form, k, 3, T)
            if per_sm < 1:
                raise RuntimeError(f"{label} {kernel}: no block fits an SM at T={T}")
            out.append(head_group(B, H, n_sm, per_sm))
        _head_groups[key] = tuple(out)
    return _head_groups[key]


def packed_head_groups(lib, B: int, H: int, T: int, device) -> Tuple[int, int, int]:
    """hg of K1's kernel and of K2's two passes (``vb_attn_packed_info``)."""
    return _kernel_head_groups(lib, "vb_attn_packed_info", "K1/K2", B, H, T, device)


def packed_x_head_groups(lib, dtype, dp: int, B: int, H: int, T: int, device) -> Tuple[int, int, int]:
    """hg of K1's kernel and of K2's two passes in bf16 or fp16 at the
    instantiated head dim dp (``vb_attn_packed_x_info``); at
    STREAMED_HEAD_DIM, whose passes take a block a (128 rows, head, batch
    row), K2's are None."""
    kernels = (0,) if dp == STREAMED_HEAD_DIM else (0, 1, 2)
    return _kernel_head_groups(lib, "vb_attn_packed_x_info", "K1/K2", B, H, T, device, (_DTYPE_CODE[dtype], dp),
                               kernels)


def hm_head_groups(lib, B: int, H: int, T: int, device) -> Tuple[int, int, int]:
    """hg of K11's kernel and of K12's two passes (``vb_attn_hm_info``)."""
    return _kernel_head_groups(lib, "vb_attn_hm_info", "K11/K12", B, H, T, device)


def sp_head_groups(lib, B: int, H: int, T: int, device) -> Tuple[int, int, int]:
    """hg of K13's kernel and of K14's two passes (``vb_attn_sp_info``)."""
    return _kernel_head_groups(lib, "vb_attn_sp_info", "K13/K14", B, H, T, device)


def hm_x_head_groups(lib, dtype, dp: int, B: int, H: int, T: int, device) -> Tuple[int, int, int]:
    """hg of K11's kernel and of K12's two passes in another bf16 or fp16
    form at the instantiated head dim dp (``vb_attn_hm_x_info``)."""
    return _kernel_head_groups(lib, "vb_attn_hm_x_info", "K11/K12", B, H, T, device, (_DTYPE_CODE[dtype], dp))


def sp_x_head_groups(lib, dtype, dp: int, B: int, H: int, T: int, device) -> Tuple[int, int, int]:
    """hg of K13's kernel and of K14's two passes in another bf16 or fp16
    form at the instantiated head dim dp (``vb_attn_sp_x_info``)."""
    return _kernel_head_groups(lib, "vb_attn_sp_x_info", "K13/K14", B, H, T, device, (_DTYPE_CODE[dtype], dp))


def launch_packed_fwd(lib, qkv, qb, key_bias, n_heads: int, rate: float, seed: int, hg: int):
    """K1's kernel in bf16 at D = 64 from ``lib`` (the kernel library, or
    another build of its source: the tools that time an earlier tree launch
    this entry point, whose signature every tree shares) on checked inputs,
    hg heads a block: (CUDA code, out, stats). The wrapper launches every
    bf16 and fp16 form through :func:`launch_packed_x_fwd`."""
    B, T, F = qkv.shape
    out = torch.empty((B, T, F // 3), dtype=qkv.dtype, device=qkv.device)
    stats = torch.empty((B, n_heads, T), dtype=torch.float32, device=qkv.device)
    code = lib.vb_attn_packed_fwd(
        qkv.data_ptr(), qb.data_ptr(), key_bias.data_ptr(), out.data_ptr(), stats.data_ptr(),
        B, T, n_heads, hg, *_seed_args(rate, seed), _build.stream_ptr(qkv.device),
    )
    return code, out, stats


def launch_packed_bwd(lib, qkv, qb, key_bias, dout, out, stats, n_heads: int, rate: float, seed: int, hg_dq: int,
                      hg_dkv: int):
    """K2's two kernels in bf16 at D = 64 from ``lib`` on checked inputs, as
    :func:`launch_packed_fwd`: (CUDA code, dqkv, dqb). The kernels write
    fp32 per-batch-row partials of the bias gradient; their sum here is the
    only reduction outside them."""
    B, T, F = qkv.shape
    dqkv = torch.empty_like(qkv)
    db_part = torch.empty((B, F), dtype=torch.float32, device=qkv.device)
    delta = torch.empty((B, n_heads, T), dtype=torch.float32, device=qkv.device)
    code = lib.vb_attn_packed_bwd(
        qkv.data_ptr(), qb.data_ptr(), key_bias.data_ptr(), dout.data_ptr(), out.data_ptr(),
        stats.data_ptr(), dqkv.data_ptr(), db_part.data_ptr(), delta.data_ptr(),
        B, T, n_heads, hg_dq, hg_dkv, *_seed_args(rate, seed), _build.stream_ptr(qkv.device),
    )
    return code, dqkv, db_part.sum(dim=0).to(qb.dtype)


def launch_packed_x_fwd(lib, qkv, qb, key_bias, n_heads: int, rate: float, seed: int, hg: int, scale: float):
    """K1's kernel in bf16 or fp16 at the instantiated head dim of qkv (the
    heads already padded to it), softmax scale ``scale``: (CUDA code, out,
    stats)."""
    B, T, F = qkv.shape
    out = torch.empty((B, T, F // 3), dtype=qkv.dtype, device=qkv.device)
    stats = torch.empty((B, n_heads, T), dtype=torch.float32, device=qkv.device)
    code = lib.vb_attn_packed_x_fwd(
        qkv.data_ptr(), qb.data_ptr(), key_bias.data_ptr(), out.data_ptr(), stats.data_ptr(),
        B, T, n_heads, hg, *_seed_args(rate, seed), _DTYPE_CODE[qkv.dtype], F // (3 * n_heads), float(scale),
        _build.stream_ptr(qkv.device),
    )
    return code, out, stats


def packed_bias_rows(lib, dp: int, T: int) -> int:
    """Rows of bias-gradient partials a batch row of K2's bf16 and fp16
    passes at head dim dp write: one a 128-row block of either pass at
    STREAMED_HEAD_DIM (``vb_attn_packed_x_bias_rows``), else one, from
    blocks that walk a whole batch row."""
    return lib.vb_attn_packed_x_bias_rows(dp, T) if dp == STREAMED_HEAD_DIM else 1


def launch_packed_x_bwd(lib, qkv, qb, key_bias, dout, out, stats, n_heads: int, rate: float, seed: int, hg_dq: int,
                        hg_dkv: int, scale: float):
    """K2's two kernels in bf16 or fp16 at the instantiated head dim, as
    :func:`launch_packed_x_fwd`: (CUDA code, dqkv, dqb); the bias gradient
    is the sum of the [B, packed_bias_rows, F] partials the kernels write
    (:func:`sum_bias_partials`). hg_dq and hg_dkv are not used at
    STREAMED_HEAD_DIM."""
    B, T, F = qkv.shape
    dqkv = torch.empty_like(qkv)
    db_part = torch.empty((B, packed_bias_rows(lib, F // (3 * n_heads), T), F), dtype=torch.float32,
                          device=qkv.device)
    delta = torch.empty((B, n_heads, T), dtype=torch.float32, device=qkv.device)
    code = lib.vb_attn_packed_x_bwd(
        qkv.data_ptr(), qb.data_ptr(), key_bias.data_ptr(), dout.data_ptr(), out.data_ptr(),
        stats.data_ptr(), dqkv.data_ptr(), db_part.data_ptr(), delta.data_ptr(),
        B, T, n_heads, hg_dq, hg_dkv, *_seed_args(rate, seed), _DTYPE_CODE[qkv.dtype], F // (3 * n_heads),
        float(scale), _build.stream_ptr(qkv.device),
    )
    return code, dqkv, sum_bias_partials(db_part).to(qb.dtype)


def launch_small_products(lib, a, b, q):
    """The two products the kernels run at head dims 16 and 32, alone, on the small-
    row tiles (``vb_attn_packed_x_probe``, one block): a [64, 64], b and q
    [64, D] (D 16 or 32) in bf16 or fp16 on the card -> (CUDA code, a @ b,
    q @ b^T) in fp32; b is the transposed operand of the first."""
    d = b.shape[1]
    d1 = torch.empty((64, d), dtype=torch.float32, device=a.device)
    d2 = torch.empty((64, 64), dtype=torch.float32, device=a.device)
    code = lib.vb_attn_packed_x_probe(a.data_ptr(), b.data_ptr(), q.data_ptr(), d1.data_ptr(), d2.data_ptr(),
                                      _DTYPE_CODE[a.dtype], d, _build.stream_ptr(a.device))
    return code, d1, d2


def launch_f32_fwd(lib, qkv, qb, key_bias, n_heads: int, rate: float, seed: int):
    """K1's fp32 kernel (``csrc/flash_attention_f32.cu``) on checked inputs,
    any head dim up to MAX_HEAD_DIM: (CUDA code, out, stats)."""
    B, T, F = qkv.shape
    d = F // (3 * n_heads)
    out = torch.empty((B, T, F // 3), dtype=qkv.dtype, device=qkv.device)
    stats = torch.empty((B, n_heads, T), dtype=torch.float32, device=qkv.device)
    code = lib.vb_attn_f32_fwd(qkv.data_ptr(), qb.data_ptr(), key_bias.data_ptr(), out.data_ptr(), stats.data_ptr(),
                               B, T, n_heads, d, *_seed_args(rate, seed), 1.0 / math.sqrt(d),
                               _build.stream_ptr(qkv.device))
    return code, out, stats


def f32_bias_tiles(lib, T: int) -> int:
    """Rows of bias-gradient partials a batch row of ``lib``'s fp32
    backward writes: one a tile of T of ``vb_attn_f32_geometry(0)`` rows,
    each from one block of either pass."""
    return -(-T // lib.vb_attn_f32_geometry(0))


def sum_bias_partials(db_part: torch.Tensor) -> torch.Tensor:
    """The QKV-bias gradient [F] from a backward's partials [B, rows, F]
    (the fp32 backward's tiles, :func:`f32_bias_tiles`; K2's in bf16 and
    fp16, :func:`packed_bias_rows`): one reduction over the B x rows rows,
    in the same order on every call (no atomics: two calls agree bit for
    bit)."""
    return db_part.reshape(-1, db_part.shape[-1]).sum(dim=0)


def launch_f32_bwd(lib, qkv, qb, key_bias, dout, out, stats, n_heads: int, rate: float, seed: int):
    """K2's two fp32 kernels on checked inputs: (CUDA code, dqkv, dqb)."""
    B, T, F = qkv.shape
    d = F // (3 * n_heads)
    dqkv = torch.empty_like(qkv)
    db_part = torch.empty((B, f32_bias_tiles(lib, T), F), dtype=torch.float32, device=qkv.device)
    delta = torch.empty((B, n_heads, T), dtype=torch.float32, device=qkv.device)
    code = lib.vb_attn_f32_bwd(qkv.data_ptr(), qb.data_ptr(), key_bias.data_ptr(), dout.data_ptr(), out.data_ptr(),
                               stats.data_ptr(), dqkv.data_ptr(), db_part.data_ptr(), delta.data_ptr(),
                               B, T, n_heads, d, *_seed_args(rate, seed), 1.0 / math.sqrt(d),
                               _build.stream_ptr(qkv.device))
    return code, dqkv, sum_bias_partials(db_part)


def _counted(fn, form: str) -> None:
    fn.launches += 1
    fn.forms[form] = fn.forms.get(form, 0) + 1


def packed_attention_fwd(qkv, qb, key_bias, n_heads: int, rate: float, seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 wrapper: (out [B, T, H*D], stats [B, H, T] fp32), in the forms of
    :func:`attention_form`: bf16 and fp16 heads of 16, 32, 64 and 128 read
    in place, the others zero-padded to the next of HEAD_DIMS here and the
    output cut back; fp32 runs the SIMT kernel."""
    what = "packed attention forward (K1)"
    if not _on_cuda(what, qkv):
        return packed_attention_fwd_reference(qkv, qb, key_bias, n_heads, rate, seed)
    lib = _check_packed_any(what, qkv, key_bias, n_heads, qb=qb)
    B, T, F = qkv.shape
    d = F // (3 * n_heads)
    form = attention_form(qkv.dtype, d)
    if qkv.dtype == torch.float32:
        code, out, stats = launch_f32_fwd(lib, qkv, qb, key_bias, n_heads, rate, seed)
    else:
        dp = kernel_head_dim(d)
        hg = packed_x_head_groups(lib, qkv.dtype, dp, B, n_heads, T, qkv.device)[0]
        code, out, stats = launch_packed_x_fwd(lib, pad_heads(qkv, n_heads, 3, dp), pad_heads(qb, n_heads, 3, dp),
                                               key_bias, n_heads, rate, seed, hg, 1.0 / math.sqrt(d))
        out = unpad_heads(out, n_heads, 1, d)
    lib.check(code, what)
    _counted(packed_attention_fwd, form)
    return out, stats


packed_attention_fwd.launches = 0
packed_attention_fwd.forms = {}


def packed_attention_bwd(qkv, qb, key_bias, dout, out, stats, n_heads: int, rate: float, seed: int):
    """K2 wrapper: (dqkv [B, T, H*3*D], dqb [H*3*D] in qb's dtype), in K1's
    forms (heads padded to the next of HEAD_DIMS here and the gradients cut
    back); fp32 on the SIMT kernels."""
    what = "packed attention backward (K2)"
    if not _on_cuda(what, qkv):
        return packed_attention_bwd_reference(qkv, qb, key_bias, dout, out, stats, n_heads, rate, seed)
    lib = _check_packed_any(what, qkv, key_bias, n_heads, dout, out, qb=qb, kernels=(1, 2))
    B, T, F = qkv.shape
    _check_stats(what, stats, B, n_heads, T)
    d = F // (3 * n_heads)
    form = attention_form(qkv.dtype, d)
    if qkv.dtype == torch.float32:
        code, dqkv, dqb = launch_f32_bwd(lib, qkv, qb, key_bias, dout, out, stats, n_heads, rate, seed)
    else:
        dp = kernel_head_dim(d)
        hg_dq = hg_dkv = 1  # the streamed passes' grid has no head groups
        if dp != STREAMED_HEAD_DIM:
            _, hg_dq, hg_dkv = packed_x_head_groups(lib, qkv.dtype, dp, B, n_heads, T, qkv.device)
        code, dqkv, dqb = launch_packed_x_bwd(
            lib, pad_heads(qkv, n_heads, 3, dp), pad_heads(qb, n_heads, 3, dp), key_bias,
            pad_heads(dout, n_heads, 1, dp), pad_heads(out, n_heads, 1, dp), stats, n_heads, rate, seed, hg_dq,
            hg_dkv, 1.0 / math.sqrt(d))
        dqkv, dqb = unpad_heads(dqkv, n_heads, 3, d), unpad_heads(dqb, n_heads, 3, d)
    lib.check(code, what)
    _counted(packed_attention_bwd, form)
    return dqkv, dqb


packed_attention_bwd.launches = 0
packed_attention_bwd.forms = {}


def _check_heads_major(what, qkv, key_bias, *others):
    """K11/K12's checks in every form: dtype, head dim, shapes, and (bf16,
    fp16) the shared memory of T at :func:`kernel_head_dim` (D), the largest
    of the three kernels'."""
    if qkv.dim() != 5 or qkv.shape[1] != 3:
        raise ValueError(f"{what}: qkv must be [B, 3, H, T, D], got {tuple(qkv.shape)}")
    B, _, H, T, d = qkv.shape
    _check_variant_dtype(what, qkv, d)
    for t in others:
        if t.dtype != qkv.dtype or t.shape != (B, H, T, d):
            raise ValueError(f"{what}: dout and out must be [{B}, {H}, {T}, {d}] {qkv.dtype}")
    smem = _variant_smem(qkv.dtype, d, "vb_attn_hm_smem_bytes", "vb_attn_hm_x_smem_bytes")
    return _check(what, smem, T, key_bias, B, qkv, *others)


def launch_hm_fwd(lib, qkv, key_bias, rate: float, seed: int, hg: int):
    """K11's kernel in bf16 at D = 64 from ``lib`` (the kernel library, or
    another build of its source) on checked inputs, hg heads a block: (CUDA
    code, out, stats)."""
    B, _, H, T, d = qkv.shape
    out = torch.empty((B, H, T, d), dtype=qkv.dtype, device=qkv.device)
    stats = torch.empty((B, H, T), dtype=torch.float32, device=qkv.device)
    code = lib.vb_attn_hm_fwd(qkv.data_ptr(), key_bias.data_ptr(), out.data_ptr(), stats.data_ptr(),
                              B, T, H, hg, *_seed_args(rate, seed), _build.stream_ptr(qkv.device))
    return code, out, stats


def launch_hm_bwd(lib, qkv, key_bias, dout, out, stats, rate: float, seed: int, hg_dq: int, hg_dkv: int):
    """K12's two kernels in bf16 at D = 64 from ``lib`` on checked inputs:
    (CUDA code, dqkv)."""
    B, _, H, T, _ = qkv.shape
    dqkv = torch.empty_like(qkv)
    delta = torch.empty((B, H, T), dtype=torch.float32, device=qkv.device)
    code = lib.vb_attn_hm_bwd(qkv.data_ptr(), key_bias.data_ptr(), dout.data_ptr(), out.data_ptr(),
                              stats.data_ptr(), dqkv.data_ptr(), delta.data_ptr(),
                              B, T, H, hg_dq, hg_dkv, *_seed_args(rate, seed), _build.stream_ptr(qkv.device))
    return code, dqkv


def launch_hm_x_fwd(lib, qkv, key_bias, rate: float, seed: int, hg: int, scale: float):
    """K11's kernel in bf16 or fp16 at the instantiated head dim of qkv (the
    heads already padded to it), softmax scale ``scale``: (CUDA code, out,
    stats)."""
    B, _, H, T, dp = qkv.shape
    out = torch.empty((B, H, T, dp), dtype=qkv.dtype, device=qkv.device)
    stats = torch.empty((B, H, T), dtype=torch.float32, device=qkv.device)
    code = lib.vb_attn_hm_x_fwd(qkv.data_ptr(), key_bias.data_ptr(), out.data_ptr(), stats.data_ptr(), B, T, H, hg,
                                *_seed_args(rate, seed), _DTYPE_CODE[qkv.dtype], dp, float(scale),
                                _build.stream_ptr(qkv.device))
    return code, out, stats


def launch_hm_x_bwd(lib, qkv, key_bias, dout, out, stats, rate: float, seed: int, hg_dq: int, hg_dkv: int,
                    scale: float):
    """K12's two kernels in bf16 or fp16 at the instantiated head dim, as
    :func:`launch_hm_x_fwd`: (CUDA code, dqkv)."""
    B, _, H, T, dp = qkv.shape
    dqkv = torch.empty_like(qkv)
    delta = torch.empty((B, H, T), dtype=torch.float32, device=qkv.device)
    code = lib.vb_attn_hm_x_bwd(qkv.data_ptr(), key_bias.data_ptr(), dout.data_ptr(), out.data_ptr(),
                                stats.data_ptr(), dqkv.data_ptr(), delta.data_ptr(), B, T, H, hg_dq, hg_dkv,
                                *_seed_args(rate, seed), _DTYPE_CODE[qkv.dtype], dp, float(scale),
                                _build.stream_ptr(qkv.device))
    return code, dqkv


def launch_f32_hm_fwd(lib, qkv, key_bias, rate: float, seed: int):
    """K11's fp32 kernel (``csrc/flash_attention_f32.cu`` on the heads-major
    strides) on checked inputs, any head dim up to MAX_HEAD_DIM: (CUDA
    code, out, stats)."""
    B, _, H, T, d = qkv.shape
    out = torch.empty((B, H, T, d), dtype=qkv.dtype, device=qkv.device)
    stats = torch.empty((B, H, T), dtype=torch.float32, device=qkv.device)
    code = lib.vb_attn_f32_hm_fwd(qkv.data_ptr(), key_bias.data_ptr(), out.data_ptr(), stats.data_ptr(), B, T, H, d,
                                  *_seed_args(rate, seed), 1.0 / math.sqrt(d), _build.stream_ptr(qkv.device))
    return code, out, stats


def launch_f32_hm_bwd(lib, qkv, key_bias, dout, out, stats, rate: float, seed: int):
    """K12's two fp32 kernels on checked inputs: (CUDA code, dqkv)."""
    B, _, H, T, d = qkv.shape
    dqkv = torch.empty_like(qkv)
    delta = torch.empty((B, H, T), dtype=torch.float32, device=qkv.device)
    code = lib.vb_attn_f32_hm_bwd(qkv.data_ptr(), key_bias.data_ptr(), dout.data_ptr(), out.data_ptr(),
                                  stats.data_ptr(), dqkv.data_ptr(), delta.data_ptr(), B, T, H, d,
                                  *_seed_args(rate, seed), 1.0 / math.sqrt(d), _build.stream_ptr(qkv.device))
    return code, dqkv


def heads_major_attention_fwd(qkv, key_bias, rate: float, seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K11 wrapper: qkv [B, 3, H, T, D] (bias added) -> (out [B, H, T, D],
    stats [B, H, T] fp32). fp32 and bf16 and fp16 heads of 16, 32, 64 and
    128 read q, k and v in place from ``qkv``; the other bf16 and fp16 head
    dims are zero-padded to the next of HEAD_DIMS here and the output cut
    back."""
    what = "heads-major attention forward (K11)"
    if not _on_cuda(what, qkv):
        return heads_major_attention_fwd_reference(qkv, key_bias, rate, seed)
    lib = _check_heads_major(what, qkv, key_bias)
    B, _, H, T, d = qkv.shape
    if qkv.dtype == torch.float32:
        code, out, stats = launch_f32_hm_fwd(lib, qkv, key_bias, rate, seed)
    elif _main_form(qkv.dtype, d):
        hg = hm_head_groups(lib, B, H, T, qkv.device)[0]
        code, out, stats = launch_hm_fwd(lib, qkv, key_bias, rate, seed, hg)
    else:
        dp = kernel_head_dim(d)
        hg = hm_x_head_groups(lib, qkv.dtype, dp, B, H, T, qkv.device)[0]
        code, out, stats = launch_hm_x_fwd(lib, pad_heads_major(qkv, dp), key_bias, rate, seed, hg,
                                           1.0 / math.sqrt(d))
        out = unpad_heads_major(out, d)
    lib.check(code, what)
    _counted(heads_major_attention_fwd, attention_form(qkv.dtype, d))
    return out, stats


heads_major_attention_fwd.launches = 0
heads_major_attention_fwd.forms = {}


def heads_major_attention_bwd(qkv, key_bias, dout, out, stats, rate: float, seed: int) -> torch.Tensor:
    """K12 wrapper: dqkv [B, 3, H, T, D], written as one tensor, in K11's
    forms (heads padded as there and the gradient cut back); fp32 on the
    SIMT kernels."""
    what = "heads-major attention backward (K12)"
    if not _on_cuda(what, qkv):
        return heads_major_attention_bwd_reference(qkv, key_bias, dout, out, stats, rate, seed)
    lib = _check_heads_major(what, qkv, key_bias, dout, out)
    B, _, H, T, d = qkv.shape
    _check_stats(what, stats, B, H, T)
    if qkv.dtype == torch.float32:
        code, dqkv = launch_f32_hm_bwd(lib, qkv, key_bias, dout, out, stats, rate, seed)
    elif _main_form(qkv.dtype, d):
        _, hg_dq, hg_dkv = hm_head_groups(lib, B, H, T, qkv.device)
        code, dqkv = launch_hm_bwd(lib, qkv, key_bias, dout, out, stats, rate, seed, hg_dq, hg_dkv)
    else:
        dp = kernel_head_dim(d)
        _, hg_dq, hg_dkv = hm_x_head_groups(lib, qkv.dtype, dp, B, H, T, qkv.device)
        code, dqkv = launch_hm_x_bwd(lib, pad_heads_major(qkv, dp), key_bias, pad_heads_major(dout, dp),
                                     pad_heads_major(out, dp), stats, rate, seed, hg_dq, hg_dkv, 1.0 / math.sqrt(d))
        dqkv = unpad_heads_major(dqkv, d)
    lib.check(code, what)
    _counted(heads_major_attention_bwd, attention_form(qkv.dtype, d))
    return dqkv


heads_major_attention_bwd.launches = 0
heads_major_attention_bwd.forms = {}


PROBS_ROW_ALIGN = 8  # elements: 16 bytes, K14's copy of a probability chunk


def probs_row_stride(T: int) -> int:
    """Row stride (elements) of the probabilities K13 writes: T rounded up
    to a multiple of 8, so that every row starts 16-byte aligned."""
    return -(-T // PROBS_ROW_ALIGN) * PROBS_ROW_ALIGN


def probs_layout(probs, B: int, H: int, T: int) -> Optional[int]:
    """The row stride with which K14 reads ``probs`` [B, H, T, T] bf16 in
    place: rows a multiple of 8 elements apart in one [B, H, T, ldp] block,
    16-byte aligned (K13's own layout, or a contiguous tensor at T % 8 ==
    0). None for a contiguous tensor whose rows are not: the wrapper copies
    it into K13's layout. Raises on anything else."""
    if probs.shape != (B, H, T, T) or probs.dtype != torch.bfloat16:
        raise ValueError(f"probs must be [{B}, {H}, {T}, {T}] bfloat16, got {tuple(probs.shape)} {probs.dtype}")
    ldp = probs.stride(2)
    if (probs.stride() == (H * T * ldp, T * ldp, ldp, 1) and ldp >= T and ldp % PROBS_ROW_ALIGN == 0
            and probs.data_ptr() % 16 == 0):
        return ldp
    if probs.is_contiguous():
        return None
    raise ValueError(f"probs: rows must lie in one [B, H, T, ldp] block with ldp a multiple of "
                     f"{PROBS_ROW_ALIGN}, or be contiguous; got strides {probs.stride()}")


def padded_probs(probs) -> torch.Tensor:
    """A copy of [B, H, T, T] ``probs`` in K13's layout (row stride
    :func:`probs_row_stride`), as its [B, H, T, T] view."""
    B, H, T, _ = probs.shape
    buf = torch.empty((B, H, T, probs_row_stride(T)), dtype=probs.dtype, device=probs.device)
    buf[..., :T].copy_(probs)
    return buf[..., :T]


def packed_attention_sp_fwd(qkv, key_bias, n_heads: int, rate: float, seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K13 wrapper on the biased packed qkv: (out [B, T, H*D], probs
    [B, H, T, T] bf16 in every form). On the card probs is the [B, H, T, T]
    view of a [B, H, T, probs_row_stride(T)] buffer; K14 reads it in place.
    In the forms of :func:`attention_form`: bf16 and fp16 heads of 16, 32,
    64 and 128 read in place, the others zero-padded to the next of
    HEAD_DIMS here and the output cut back; fp32 runs the SIMT kernel."""
    what = "save-probs attention forward (K13)"
    if not _on_cuda(what, qkv):
        return packed_attention_sp_fwd_reference(qkv, key_bias, n_heads, rate, seed)
    lib = _check_sp(what, qkv, key_bias, n_heads)
    B, T, F = qkv.shape
    d = F // (3 * n_heads)
    if qkv.dtype == torch.float32:
        code, out, probs = launch_f32_sp_fwd(lib, qkv, key_bias, n_heads, rate, seed)
    elif _main_form(qkv.dtype, d):
        hg = sp_head_groups(lib, B, n_heads, T, qkv.device)[0]
        code, out, probs = launch_sp_fwd(lib, qkv, key_bias, n_heads, rate, seed, hg)
    else:
        dp = kernel_head_dim(d)
        hg = sp_x_head_groups(lib, qkv.dtype, dp, B, n_heads, T, qkv.device)[0]
        code, out, probs = launch_sp_x_fwd(lib, pad_heads(qkv, n_heads, 3, dp), key_bias, n_heads, rate, seed, hg,
                                           1.0 / math.sqrt(d))
        out = unpad_heads(out, n_heads, 1, d)
    lib.check(code, what)
    _counted(packed_attention_sp_fwd, attention_form(qkv.dtype, d))
    return out, probs


packed_attention_sp_fwd.launches = 0
packed_attention_sp_fwd.forms = {}


def _probs_buffer(qkv, n_heads: int):
    """K13's [B, H, T, probs_row_stride(T)] bf16 buffer for qkv [B, T, F]."""
    B, T, _ = qkv.shape
    return torch.empty((B, n_heads, T, probs_row_stride(T)), dtype=torch.bfloat16, device=qkv.device)


def launch_sp_fwd(lib, qkv, key_bias, n_heads: int, rate: float, seed: int, hg: int):
    """K13's kernel in bf16 at D = 64 from ``lib`` (the kernel library, or
    another build of its source) on checked inputs, hg heads a block: (CUDA
    code, out, probs), probs the [B, H, T, T] view of a [B, H, T,
    probs_row_stride(T)] buffer."""
    B, T, F = qkv.shape
    out = torch.empty((B, T, F // 3), dtype=qkv.dtype, device=qkv.device)
    probs = _probs_buffer(qkv, n_heads)
    code = lib.vb_attn_sp_fwd(qkv.data_ptr(), key_bias.data_ptr(), out.data_ptr(), probs.data_ptr(),
                              B, T, n_heads, hg, probs.shape[-1], *_seed_args(rate, seed),
                              _build.stream_ptr(qkv.device))
    return code, out, probs[..., :T]


def launch_sp_x_fwd(lib, qkv, key_bias, n_heads: int, rate: float, seed: int, hg: int, scale: float):
    """K13's kernel in bf16 or fp16 at the instantiated head dim of qkv (the
    heads already padded to it), softmax scale ``scale``: as
    :func:`launch_sp_fwd`."""
    B, T, F = qkv.shape
    out = torch.empty((B, T, F // 3), dtype=qkv.dtype, device=qkv.device)
    probs = _probs_buffer(qkv, n_heads)
    code = lib.vb_attn_sp_x_fwd(qkv.data_ptr(), key_bias.data_ptr(), out.data_ptr(), probs.data_ptr(),
                                B, T, n_heads, hg, probs.shape[-1], *_seed_args(rate, seed), _DTYPE_CODE[qkv.dtype],
                                F // (3 * n_heads), float(scale), _build.stream_ptr(qkv.device))
    return code, out, probs[..., :T]


def launch_f32_sp_fwd(lib, qkv, key_bias, n_heads: int, rate: float, seed: int):
    """K13's fp32 kernel (``csrc/flash_attention_f32.cu``) on checked inputs,
    any head dim up to MAX_HEAD_DIM: as :func:`launch_sp_fwd`."""
    B, T, F = qkv.shape
    d = F // (3 * n_heads)
    out = torch.empty((B, T, F // 3), dtype=qkv.dtype, device=qkv.device)
    probs = _probs_buffer(qkv, n_heads)
    code = lib.vb_attn_f32_sp_fwd(qkv.data_ptr(), key_bias.data_ptr(), out.data_ptr(), probs.data_ptr(),
                                  B, T, n_heads, d, probs.shape[-1], *_seed_args(rate, seed), 1.0 / math.sqrt(d),
                                  _build.stream_ptr(qkv.device))
    return code, out, probs[..., :T]


def launch_sp_bwd(lib, qkv, probs, ldp: int, dout, out, n_heads: int, rate: float, seed: int, hg_dq: int,
                  hg_dkv: int, passes: int = 3, dqkv=None, delta=None):
    """K14's kernels in bf16 at D = 64 from ``lib`` on checked inputs,
    ``probs`` read with row stride ``ldp``: ``passes`` 1 the dQ pass, 2 the
    dK/dV pass (on the ``delta`` of an earlier dQ pass), 3 both, into
    ``dqkv`` and ``delta`` when given. Returns (CUDA code, dqkv, delta)."""
    B, T, _ = qkv.shape
    dqkv = torch.empty_like(qkv) if dqkv is None else dqkv
    delta = torch.empty((B, n_heads, T), dtype=torch.float32, device=qkv.device) if delta is None else delta
    code = lib.vb_attn_sp_bwd(qkv.data_ptr(), probs.data_ptr(), dout.data_ptr(), out.data_ptr(), dqkv.data_ptr(),
                              delta.data_ptr(), B, T, n_heads, hg_dq, hg_dkv, ldp, passes, *_seed_args(rate, seed),
                              _build.stream_ptr(qkv.device))
    return code, dqkv, delta


def launch_sp_x_bwd(lib, qkv, probs, ldp: int, dout, out, n_heads: int, rate: float, seed: int, hg_dq: int,
                    hg_dkv: int, scale: float):
    """K14's kernels in bf16 or fp16 at the instantiated head dim (qkv, dout
    and out padded to it), both passes: (CUDA code, dqkv)."""
    B, T, F = qkv.shape
    dqkv = torch.empty_like(qkv)
    delta = torch.empty((B, n_heads, T), dtype=torch.float32, device=qkv.device)
    code = lib.vb_attn_sp_x_bwd(qkv.data_ptr(), probs.data_ptr(), dout.data_ptr(), out.data_ptr(), dqkv.data_ptr(),
                                delta.data_ptr(), B, T, n_heads, hg_dq, hg_dkv, ldp, 3, *_seed_args(rate, seed),
                                _DTYPE_CODE[qkv.dtype], F // (3 * n_heads), float(scale),
                                _build.stream_ptr(qkv.device))
    return code, dqkv


def launch_f32_sp_bwd(lib, qkv, probs, ldp: int, dout, out, n_heads: int, rate: float, seed: int):
    """K14's two fp32 kernels on checked inputs: (CUDA code, dqkv)."""
    B, T, F = qkv.shape
    d = F // (3 * n_heads)
    dqkv = torch.empty_like(qkv)
    delta = torch.empty((B, n_heads, T), dtype=torch.float32, device=qkv.device)
    code = lib.vb_attn_f32_sp_bwd(qkv.data_ptr(), probs.data_ptr(), dout.data_ptr(), out.data_ptr(),
                                  dqkv.data_ptr(), delta.data_ptr(), B, T, n_heads, d, ldp, *_seed_args(rate, seed),
                                  1.0 / math.sqrt(d), _build.stream_ptr(qkv.device))
    return code, dqkv


def packed_attention_sp_bwd(qkv, probs, dout, out, n_heads: int, rate: float, seed: int) -> torch.Tensor:
    """K14 wrapper: dqkv [B, T, H*3*D] from the saved probabilities, read in
    place in K13's layout (a contiguous tensor at T % 8 != 0 is first copied
    into it), in K13's forms (heads padded as there and the gradient cut
    back); fp32 on the SIMT kernels."""
    what = "save-probs attention backward (K14)"
    if not _on_cuda(what, qkv):
        return packed_attention_sp_bwd_reference(qkv, probs, dout, out, n_heads, rate, seed)
    B, T, F = qkv.shape
    # the key bias only enters through the saved probabilities
    lib = _check_sp(what, qkv, None, n_heads, dout, out)
    if probs.device != qkv.device:
        raise ValueError(f"{what}: tensors on different devices")
    ldp = probs_layout(probs, B, n_heads, T)
    if ldp is None:
        probs = padded_probs(probs)
        ldp = probs.stride(2)
    d = F // (3 * n_heads)
    if qkv.dtype == torch.float32:
        code, dqkv = launch_f32_sp_bwd(lib, qkv, probs, ldp, dout, out, n_heads, rate, seed)
    elif _main_form(qkv.dtype, d):
        _, hg_dq, hg_dkv = sp_head_groups(lib, B, n_heads, T, qkv.device)
        code, dqkv, _ = launch_sp_bwd(lib, qkv, probs, ldp, dout, out, n_heads, rate, seed, hg_dq, hg_dkv)
    else:
        dp = kernel_head_dim(d)
        _, hg_dq, hg_dkv = sp_x_head_groups(lib, qkv.dtype, dp, B, n_heads, T, qkv.device)
        code, dqkv = launch_sp_x_bwd(lib, pad_heads(qkv, n_heads, 3, dp), probs, ldp, pad_heads(dout, n_heads, 1, dp),
                                     pad_heads(out, n_heads, 1, dp), n_heads, rate, seed, hg_dq, hg_dkv,
                                     1.0 / math.sqrt(d))
        dqkv = unpad_heads(dqkv, n_heads, 3, d)
    lib.check(code, what)
    _counted(packed_attention_sp_bwd, attention_form(qkv.dtype, d))
    return dqkv


packed_attention_sp_bwd.launches = 0
packed_attention_sp_bwd.forms = {}


# ------------------------------------------------------ autograd and ops


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


class _PackedAttentionSP(torch.autograd.Function):
    """K13 forward, K14 backward; no key-bias gradient."""

    @staticmethod
    def forward(ctx, qkv, key_bias, n_heads, rate, seed):
        out, probs = packed_attention_sp_fwd(qkv, key_bias, n_heads, rate, seed)
        ctx.save_for_backward(qkv, probs, out)
        ctx.args = (n_heads, rate, seed)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, probs, out = ctx.saved_tensors
        return packed_attention_sp_bwd(qkv, probs, dout.contiguous(), out, *ctx.args), None, None, None, None


class _HeadsMajorAttention(torch.autograd.Function):
    """K11 forward, K12 backward, on one [B, 3, H, T, D] tensor."""

    @staticmethod
    def forward(ctx, qkv, key_bias, rate, seed):
        out, stats = heads_major_attention_fwd(qkv, key_bias, rate, seed)
        ctx.save_for_backward(qkv, key_bias, out, stats)
        ctx.args = (rate, seed)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, key_bias, out, stats = ctx.saved_tensors
        return heads_major_attention_bwd(qkv, key_bias, dout.contiguous(), out, stats, *ctx.args), None, None, None


def _key_bias(bias):
    key_bias = bias[:, 0, 0, :] if bias.dim() == 4 else bias
    return key_bias.to(torch.float32).contiguous()


def _seed(what, rate, seed, mesh=None) -> int:
    if rate > 0.0 and seed is None:
        raise ValueError(f"{what}: dropout needs a seed")
    seed = int(seed or 0)
    return mesh.shard_seed(seed) if mesh is not None and rate > 0.0 else seed


def _prepare(qkv, bias, qkv_bias):
    qb = qkv_bias if qkv_bias is not None else torch.zeros(qkv.shape[-1], dtype=qkv.dtype, device=qkv.device)
    return qkv.contiguous(), qb.contiguous(), _key_bias(bias)


def flash_attention_packed(qkv: torch.Tensor, n_heads: int, bias: torch.Tensor, dropout_rate: float = 0.0,
                           seed: Optional[int] = None, qkv_bias: Optional[torch.Tensor] = None,
                           save_probs: bool = False, mesh=None) -> torch.Tensor:
    """Fused attention over a packed QKV projection: K1 forward and K2
    backward, or with ``save_probs`` K13 and K14.

    qkv: [B, T, H*3*D] head-major, bias-free when ``qkv_bias`` is given.
    bias: [B, 1, 1, T] or [B, T] additive key mask (0 valid, -10000 pad).
    seed: int, required when ``dropout_rate > 0``. With ``save_probs`` the
    bias is added here, before the kernels, as the JAX op does, so autograd
    produces its gradient. ``mesh``: this rank's (data, model) mesh; the
    tensors are its shard. Returns [B, T, H*D]."""
    seed = _seed("flash_attention_packed", dropout_rate, seed, mesh)
    if save_probs:
        if qkv_bias is not None:
            qkv = qkv + qkv_bias
        return _PackedAttentionSP.apply(qkv.contiguous(), _key_bias(bias), n_heads, float(dropout_rate), seed)
    qkv, qb, key_bias = _prepare(qkv, bias, qkv_bias)
    return _PackedAttention.apply(qkv, qb, key_bias, n_heads, float(dropout_rate), seed, False)


def flash_attention_packed_reference(qkv: torch.Tensor, n_heads: int, bias: torch.Tensor, dropout_rate: float = 0.0,
                                     seed: Optional[int] = None, qkv_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`flash_attention_packed` through the plain versions on any device."""
    seed = _seed("flash_attention_packed_reference", dropout_rate, seed)
    qkv, qb, key_bias = _prepare(qkv, bias, qkv_bias)
    return _PackedAttention.apply(qkv, qb, key_bias, n_heads, float(dropout_rate), seed, True)


def flash_attention_heads_major(qkv: torch.Tensor, bias: torch.Tensor, dropout_rate: float = 0.0,
                                seed: Optional[int] = None, mesh=None) -> torch.Tensor:
    """Fused attention on one heads-major [B, 3, H, T, D] tensor of biased
    q, k, v (K11 forward, K12 backward; its gradient is one tensor of the
    same layout); ``mesh`` as :func:`flash_attention_packed`'s. Returns
    [B, H, T, D]."""
    seed = _seed("flash_attention_heads_major", dropout_rate, seed, mesh)
    return _HeadsMajorAttention.apply(qkv.contiguous(), _key_bias(bias), float(dropout_rate), seed)
