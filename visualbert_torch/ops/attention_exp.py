"""The attention experiment variants of the packed attention (counterparts
of ``scripts/attn_exp.py::make_variant`` and ``scripts/attn_hgrid.py::
make_hgrid``): K1/K2's function on packed qkv [B, T, H*3*D] with the
deferred QKV bias ``qb`` [H*3*D], the key bias [B, T] and a dropout seed,
with other numerics or another schedule.

* :data:`VARIANTS` are ``attn_exp.py``'s 13 names and keyword sets. The
  numerics keywords change the function: ``prescale`` rounds q to
  bf16(q * scale * log2(e)) before QK^T (the scores only; dK takes the
  unscaled q), ``nomax`` drops the forward's row max, ``fdrop`` takes the
  backward's ds = p_d * dP - p * delta with the dropped probabilities p_d
  rounded to the compute dtype (at dropout > 0 only). The schedule keywords
  (``bb``, ``group``, ``nostack``; ``hg`` for K16) say how much work one
  block of the kernel does, and leave the function and the plain versions
  as they are.
* K15, :func:`attn_exp_fwd` / :func:`attn_exp_bwd`, replace ``make_variant``'s
  ``fwd_kernel`` / ``bwd_kernel``: a block takes ``bb`` batch rows x all H
  heads in the forward, ``bb`` rows x ``group`` heads in the backward (one
  head with ``nostack``).
* K16, :func:`attn_hgrid_fwd` / :func:`attn_hgrid_bwd`, replace
  ``make_hgrid``'s: one batch row x ``hg`` heads a block in both passes;
  their statistic is [B, H/hg, hg, T], the same memory as K1's [B, H, T].

:func:`schedules` gives each kernel's (batch rows, heads) a block, its grid
(``ceil(B / rows)``, ``ceil(H / heads)``) and the rows of its bias-gradient
partials. All four are ``csrc/flash_attention_exp.cu``: K1/K2's Hopper
design (one warpgroup a block, ``cp.async`` into swizzled tiles, ``wgmma``
for every product, Philox once per 2x2 block) in kernels of their own,
which walk their block's (batch row, head) pairs. With the numerics flags
off they give K1/K2's out, stats and dqkv bit for bit at any schedule.
``prescale``'s backward keeps a second, scaled copy of the queries in
shared memory, so it takes T up to :data:`PRESCALE_MAX_T` and raises above.
They draw K1's dropout bits, a pure function of (seed, b, h, i, j),
whatever the grouping. The backward wrappers return the bias gradient
summed, as :func:`~visualbert_torch.ops.flash_attention.packed_attention_bwd`
does. On CPU tensors the wrappers compute the plain versions (the
``*_reference`` functions: K1/K2's plain math with the variant's
roundings); on CUDA tensors they launch the kernels or raise. Nothing on
the train step calls this module: ``python -m
visualbert_torch.tools.attn_exp`` and ``... attn_hgrid`` drive it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from visualbert_torch.ops import _build
from visualbert_torch.ops import flash_attention as fa

VARIANTS = {
    "base": None,  # make_variant's defaults (the production kernel's schedule in the TPU script)
    "prescale": dict(prescale=True),
    "g6": dict(group=6),
    "g3": dict(group=3),
    "nostack": dict(nostack=True),
    "prescale_nostack": dict(prescale=True, nostack=True),
    "bb2": dict(bb=2),
    "bb4": dict(bb=4),
    "bb8": dict(bb=8),
    "bb2_g6": dict(bb=2, group=6),
    "fdrop": dict(fdrop=True),
    "nomax": dict(nomax=True),
    "fdrop_prescale": dict(fdrop=True, prescale=True),
}


def _variant(what, B, H, prescale=False, group=12, nostack=False, bb=1, fdrop=False, nomax=False):
    """A K15 variant's {"forward": (batch rows, heads), "backward": (batch
    rows, heads)} a block, and its numerics flags."""
    if bb < 1 or B % bb:
        raise ValueError(f"{what}: bb={bb} must divide the batch of {B}")
    if group < 1:
        raise ValueError(f"{what}: group must be at least 1, got {group}")
    return ({"forward": (bb, H), "backward": (bb, 1 if nostack else min(group, H))},
            dict(prescale=prescale, nomax=nomax, fdrop=fdrop))


def _check_hg(what, H, hg):
    if hg < 1 or H % hg:
        raise ValueError(f"{what}: hg={hg} must divide the {H} heads")


def attn_exp_fwd_reference(qkv, qb, key_bias, n_heads: int, rate: float, seed: int, **variant):
    """Plain version of K15's forward: (out [B, T, H*D], stats [B, H, T] fp32)."""
    _, flags = _variant("attention experiment forward", qkv.shape[0], n_heads, **variant)
    q, k, v = fa._split_heads(qkv + qb, n_heads)
    o, stats = fa._attention_fwd(q, k, v, key_bias, rate, seed, prescale=flags["prescale"], nomax=flags["nomax"])
    return fa._merge_heads(o), stats


def attn_exp_bwd_reference(qkv, qb, key_bias, dout, out, stats, n_heads: int, rate: float, seed: int, **variant):
    """Plain version of K15's backward: (dqkv [B, T, H*3*D], dqb [H*3*D] in
    qb's dtype)."""
    _, flags = _variant("attention experiment backward", qkv.shape[0], n_heads, **variant)
    q, k, v = fa._split_heads(qkv + qb, n_heads)
    dqkv = fa._pack_heads(*fa._attention_bwd(q, k, v, key_bias, fa._heads(dout, n_heads), fa._heads(out, n_heads),
                                             stats, rate, seed, prescale=flags["prescale"], fdrop=flags["fdrop"]))
    return dqkv, dqkv.float().sum(dim=(0, 1)).to(qb.dtype)


def attn_hgrid_fwd_reference(qkv, qb, key_bias, n_heads: int, rate: float, seed: int, hg: int):
    """Plain version of K16's forward (K1's): (out [B, T, H*D], stats
    [B, H/hg, hg, T] fp32)."""
    _check_hg("2-D grid attention forward", n_heads, hg)
    out, stats = fa.packed_attention_fwd_reference(qkv, qb, key_bias, n_heads, rate, seed)
    B, _, T = stats.shape
    return out, stats.view(B, n_heads // hg, hg, T)


def attn_hgrid_bwd_reference(qkv, qb, key_bias, dout, out, stats, n_heads: int, rate: float, seed: int, hg: int):
    """Plain version of K16's backward (K2's): (dqkv, dqb)."""
    _check_hg("2-D grid attention backward", n_heads, hg)
    B, T, _ = qkv.shape
    return fa.packed_attention_bwd_reference(qkv, qb, key_bias, dout, out, stats.reshape(B, n_heads, T), n_heads,
                                             rate, seed)


# --------------------------------------------------------------- wrappers

PRESCALE_MAX_T = 448  # the largest T whose prescale dK/dV pass fits a block's shared memory


def grid(B: int, H: int, rows: int, heads: int) -> Tuple[int, int]:
    """The kernels' grid for ``rows`` batch rows x ``heads`` heads a block
    (``csrc/flash_attention_exp.cu::grid_of``); block (x, y) writes row x
    of the bias-gradient partials."""
    return -(-B // rows), -(-H // heads)


def schedules(B: int, H: int, **variant):
    """{"forward": (rows, heads), "backward": (rows, heads)} of a K15
    variant (keywords of :data:`VARIANTS`) or of K16 (``hg``)."""
    if "hg" in variant:
        _check_hg("2-D grid attention", H, variant["hg"])
        return {"forward": (1, variant["hg"]), "backward": (1, variant["hg"])}
    return _variant("attention experiment", B, H, **variant)[0]


def launch_exp_fwd(lib, qkv, qb, key_bias, n_heads, rate, seed, rows, heads, prescale=False, nomax=False):
    """K15/K16's forward from ``lib`` on checked inputs, ``rows`` x
    ``heads`` pairs a block: (CUDA code, out, stats [B, H, T])."""
    B, T, F = qkv.shape
    out = torch.empty((B, T, F // 3), dtype=qkv.dtype, device=qkv.device)
    stats = torch.empty((B, n_heads, T), dtype=torch.float32, device=qkv.device)
    code = lib.vb_attn_exp_fwd(
        qkv.data_ptr(), qb.data_ptr(), key_bias.data_ptr(), out.data_ptr(), stats.data_ptr(),
        B, T, n_heads, rows, heads, int(prescale), int(nomax), *fa._seed_args(rate, seed),
        _build.stream_ptr(qkv.device),
    )
    return code, out, stats


def launch_exp_bwd(lib, qkv, qb, key_bias, dout, out, stats, n_heads, rate, seed, rows, heads, prescale=False,
                   fdrop=False):
    """K15/K16's two backward passes from ``lib`` on checked inputs (stats
    [B, H, T]): (CUDA code, dqkv, db_part [ceil(B / rows), H*3*D] fp32, the
    per-block partials of the bias gradient)."""
    B, T, F = qkv.shape
    dqkv = torch.empty_like(qkv)
    db_part = torch.empty((grid(B, n_heads, rows, heads)[0], F), dtype=torch.float32, device=qkv.device)
    delta = torch.empty((B, n_heads, T), dtype=torch.float32, device=qkv.device)
    code = lib.vb_attn_exp_bwd(
        qkv.data_ptr(), qb.data_ptr(), key_bias.data_ptr(), dout.data_ptr(), out.data_ptr(), stats.data_ptr(),
        dqkv.data_ptr(), db_part.data_ptr(), delta.data_ptr(), B, T, n_heads, rows, heads, int(prescale),
        int(fdrop), *fa._seed_args(rate, seed), _build.stream_ptr(qkv.device),
    )
    return code, dqkv, db_part


def _forward(what, qkv, qb, key_bias, n_heads, rate, seed, rows, heads, prescale=False, nomax=False):
    lib = fa._check_packed(what, qkv, key_bias, n_heads, qb=qb, smem_fn="vb_attn_exp_smem_bytes")
    code, out, stats = launch_exp_fwd(lib, qkv, qb, key_bias, n_heads, rate, seed, rows, heads, prescale, nomax)
    lib.check(code, what)
    return out, stats


def _backward(what, qkv, qb, key_bias, dout, out, stats, n_heads, rate, seed, rows, heads, prescale=False,
              fdrop=False):
    """(dqkv, dqb): the kernels' per-block partials of the bias gradient
    summed here, the only reduction outside them."""
    lib = fa._check_packed(what, qkv, key_bias, n_heads, dout, out, qb=qb, smem_fn="vb_attn_exp_smem_bytes")
    B, T, _ = qkv.shape
    fa._check_stats(what, stats, B, n_heads, T)
    if not stats.is_contiguous() or stats.device != qkv.device:
        raise ValueError(f"{what}: stats must be contiguous, on qkv's device")
    if prescale and T > PRESCALE_MAX_T:
        raise ValueError(f"{what}: prescale's backward keeps a second, scaled copy of the queries in shared "
                         f"memory and takes T up to {PRESCALE_MAX_T}, got T={T}")
    code, dqkv, db_part = launch_exp_bwd(lib, qkv, qb, key_bias, dout, out, stats, n_heads, rate, seed, rows,
                                         heads, prescale, fdrop)
    lib.check(code, what)
    return dqkv, db_part.sum(dim=0).to(qb.dtype)


def attn_exp_fwd(qkv, qb, key_bias, n_heads: int, rate: float, seed: int, **variant) -> Tuple[torch.Tensor, torch.Tensor]:
    """K15 forward wrapper: (out [B, T, H*D], stats [B, H, T] fp32); each
    block takes ``bb`` batch rows x all heads."""
    what = "attention experiment forward (K15)"
    sched, flags = _variant(what, qkv.shape[0], n_heads, **variant)
    if not fa._on_cuda(what, qkv):
        return attn_exp_fwd_reference(qkv, qb, key_bias, n_heads, rate, seed, **variant)
    out, stats = _forward(what, qkv, qb, key_bias, n_heads, rate, seed, *sched["forward"], flags["prescale"],
                          flags["nomax"])
    attn_exp_fwd.launches += 1
    return out, stats


attn_exp_fwd.launches = 0


def attn_exp_bwd(qkv, qb, key_bias, dout, out, stats, n_heads: int, rate: float, seed: int, **variant):
    """K15 backward wrapper: (dqkv [B, T, H*3*D], dqb [H*3*D] in qb's
    dtype); each block takes ``bb`` batch rows x ``group`` heads (one with
    ``nostack``)."""
    what = "attention experiment backward (K15)"
    sched, flags = _variant(what, qkv.shape[0], n_heads, **variant)
    if not fa._on_cuda(what, qkv):
        return attn_exp_bwd_reference(qkv, qb, key_bias, dout, out, stats, n_heads, rate, seed, **variant)
    grads = _backward(what, qkv, qb, key_bias, dout, out, stats, n_heads, rate, seed, *sched["backward"],
                      flags["prescale"], flags["fdrop"])
    attn_exp_bwd.launches += 1
    return grads


attn_exp_bwd.launches = 0


def attn_hgrid_fwd(qkv, qb, key_bias, n_heads: int, rate: float, seed: int, hg: int):
    """K16 forward wrapper: (out [B, T, H*D], stats [B, H/hg, hg, T] fp32);
    each block takes one batch row x ``hg`` heads."""
    what = "2-D grid attention forward (K16)"
    _check_hg(what, n_heads, hg)
    if not fa._on_cuda(what, qkv):
        return attn_hgrid_fwd_reference(qkv, qb, key_bias, n_heads, rate, seed, hg)
    out, stats = _forward(what, qkv, qb, key_bias, n_heads, rate, seed, 1, hg)
    attn_hgrid_fwd.launches += 1
    B, _, T = stats.shape
    return out, stats.view(B, n_heads // hg, hg, T)


attn_hgrid_fwd.launches = 0


def attn_hgrid_bwd(qkv, qb, key_bias, dout, out, stats, n_heads: int, rate: float, seed: int, hg: int):
    """K16 backward wrapper: (dqkv, dqb) from stats [B, H/hg, hg, T]; each
    block takes one batch row x ``hg`` heads."""
    what = "2-D grid attention backward (K16)"
    _check_hg(what, n_heads, hg)
    if not fa._on_cuda(what, qkv):
        return attn_hgrid_bwd_reference(qkv, qb, key_bias, dout, out, stats, n_heads, rate, seed, hg)
    B, T, _ = qkv.shape
    if stats.shape != (B, n_heads // hg, hg, T):
        raise ValueError(f"{what}: stats must be [{B}, {n_heads // hg}, {hg}, {T}]")
    grads = _backward(what, qkv, qb, key_bias, dout, out, stats.reshape(B, n_heads, T), n_heads, rate, seed, 1, hg)
    attn_hgrid_bwd.launches += 1
    return grads


attn_hgrid_bwd.launches = 0
