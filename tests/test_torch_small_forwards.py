"""The one-pass forwards K1 and K11 at head dims 16 and 32 (bf16, fp16) on
the small-row tiles, on the CPU against the plain versions and the JAX
package.

On the card ``csrc/flash_attention_packed.cu::packed_fwd_kernel`` (K1) and
``csrc/flash_attention.cu::hm_fwd_kernel`` (K11) run heads of 16 and 32 in
place (26, TinyBERT-4's, zero-padded to 32) with O held as D / 2 fp32
accumulators a thread: D / 8 n-tiles of 8 columns in the m64nDk16
fragment layout. ``one_pass_fwd`` below is a torch model of that order:
64-key tiles, the row max merged tile by tile, l and O's D / 8 n-tiles
rescaled by exp2(m_old - m_new) (element i of a thread's accumulator in its
row (i >> 1) & 1, ``hopper_attn.cuh::rescale_s``), P rounded to the
element type before P V, and each row stored with its own inv / l
(``store_rows_s``); for K1 the deferred QKV bias added in the element type
to q, k and v. It is held against the plain versions at D = 16, 26 and 32,
T = 228 (four key tiles, the last ragged) with ragged key masks, at dropout
0 and 0.1, and against the JAX ops (their Pallas kernels in interpret mode)
at dropout 0.

Tolerances. fp16 as ``tests/test_torch_kernel_dtypes.py`` states it: rtol
4e-3 with atol 4e-3 of the largest entry (one fp16 ulp where two sides
round an intermediate at another place). bf16: the model rounds the
unnormalised p to bf16 where the plain version and the JAX kernel round the
normalised one, so each p may be one bf16 ulp (2^-8 relative) apart, and
the output rounds once more: rtol 1.6e-2 with atol 1.6e-2 of the largest
entry (two bf16 ulps each way; the card's bar for these forms is 2e-2 of
the largest entry). The fp32 row statistics atol 1e-4 (the kernel-dtype
tests' bar for statistics of half-precision products). The kernels
themselves are tested on the card (tests/test_torch_kernels_cuda.py)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualbert_tpu.ops import flash_attention as jfa
from visualbert_torch.ops import flash_attention as fa

TILE = 64  # the kernels' query and key tiles (wgmma's m64)
TOLS = {"float16": (4e-3, 4e-3), "bfloat16": (1.6e-2, 1.6e-2)}  # (rtol, atol of the largest entry)
STATS_ATOL = 1e-4
DIMS = [(16, 16), (26, 32), (32, 32)]  # (D, the kernel's head dim)


def assert_close(got, want, dtype, err_msg=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    rtol, atol = TOLS[dtype]
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * np.abs(want).max(), err_msg=err_msg)


def fragment_index(dp):
    """(row, col), each [4, 32, dp / 2]: the place in a 64 x dp tile of
    element i of lane l of warp w's accumulator (m64nDk16's layout: lane l
    = 4 g + tq holds rows 16 w + g and 16 w + g + 8, columns 2 tq and
    2 tq + 1 of each 8-column n-tile; element i in n-tile i >> 2, row
    (i >> 1) & 1 of the two, column i & 1 of the pair)."""
    w = torch.arange(4).view(4, 1, 1)
    lane = torch.arange(32).view(1, 32, 1)
    i = torch.arange(dp // 2).view(1, 1, dp // 2)
    g, tq = lane // 4, lane % 4
    return (16 * w + g + 8 * ((i >> 1) & 1)).expand(4, 32, dp // 2), (8 * (i >> 2) + 2 * tq + (i & 1)).expand(
        4, 32, dp // 2)


def thread_rows(x):
    """[..., 64] per row of a tile -> [..., 4, 32, 2]: each lane's row0
    (16 w + g) and row1 (16 w + g + 8) values."""
    w = torch.arange(4).view(4, 1)
    g = (torch.arange(32) // 4).view(1, 32)
    return torch.stack([x[..., 16 * w + g], x[..., 16 * w + g + 8]], dim=-1)


def store_rows_s(acc, sc, dp):
    """The epilogue: acc [..., 4, 32, dp / 2] fp32 fragments, sc [..., 4,
    32, 2] each lane's two rows' inv / l -> the [..., 64, dp] tile the
    kernel stores (element 4 nt + e of a lane at row (e >> 1), column 8 nt
    + 2 tq + (e & 1))."""
    out = torch.zeros(acc.shape[:-3] + (TILE, dp))
    tq = torch.arange(32) % 4
    rows = thread_rows(torch.arange(TILE))  # [4, 32, 2]
    for nt in range(dp // 8):
        for e in range(4):
            r, c = rows[..., e >> 1], 8 * nt + 2 * tq + (e & 1)  # [4, 32], [32]
            out[..., r, c.expand(4, 32)] = acc[..., 4 * nt + e] * sc[..., e >> 1]
    return out


def one_pass_fwd(q, k, v, key_bias, rate, seed, scale):
    """A torch model of K1's and K11's forward at a small head dim: biased
    q, k, v [B, H, T, dp] in the element type E (bf16 or fp16), the [B, T]
    fp32 key bias, the softmax scale of the unpadded D -> (out [B, H, T, dp]
    in E, stats [B, H, T] fp32). For each 64-row query tile and each 64-key
    tile: t = (q.k) fp32 * scale * log2(e) + key_bias * log2(e), the tile's
    row max merged into m, alpha = exp2(m_old - m_new), l = l alpha + sum p
    with p = exp2(t - m_new), O's fragments times their row's alpha, the
    kept p rounded to E, O += P_d V in fp32; at the end each row's
    fragments times inv / l, rounded to E, and stats = m + log2 l."""
    dt = q.dtype
    B, H, T, dp = q.shape
    Tp = -(-T // TILE) * TILE
    c1 = scale * fa.LOG2E
    kb = torch.full((B, Tp), -math.inf)
    kb[:, :T] = key_bias.float() * fa.LOG2E  # keys past T: -inf, p = 0
    keep = fa.attention_keep_reference(seed, B, H, T, rate) if rate > 0.0 else torch.ones((B, H, T, T), dtype=bool)
    keep = torch.nn.functional.pad(keep, (0, Tp - T, 0, Tp - T))
    inv = 1.0 / (1.0 - rate) if rate > 0.0 else 1.0
    qf, kf, vf = (torch.nn.functional.pad(x.float(), (0, 0, 0, Tp - T)) for x in (q, k, v))
    row, col = fragment_index(dp)
    out = torch.zeros((B, H, Tp, dp))
    stats = torch.zeros((B, H, Tp))
    for q0 in range(0, Tp, TILE):
        m = torch.full((B, H, TILE), -math.inf)
        l = torch.zeros((B, H, TILE))
        o = torch.zeros((B, H, 4, 32, dp // 2))  # each thread's D / 2 accumulators
        for k0 in range(0, Tp, TILE):
            t = qf[:, :, q0:q0 + TILE] @ kf[:, :, k0:k0 + TILE].transpose(-1, -2) * c1 + kb[:, None, None,
                                                                                          k0:k0 + TILE]
            mn = torch.maximum(m, t.amax(dim=-1))
            alpha = torch.exp2(m - mn)
            m = mn
            l = l * alpha
            a = thread_rows(alpha)  # [B, H, 4, 32, 2]
            o = o * a[..., (torch.arange(dp // 2) >> 1) & 1]  # rescale_s: element i in row (i >> 1) & 1
            p = torch.exp2(t - mn[..., None])
            l = l + p.sum(dim=-1)
            p = torch.where(keep[:, :, q0:q0 + TILE, k0:k0 + TILE], p, 0.0).to(dt).float()
            o = o + (p @ vf[:, :, k0:k0 + TILE])[..., row, col]
        out[:, :, q0:q0 + TILE] = store_rows_s(o, thread_rows(inv / l), dp)
        stats[:, :, q0:q0 + TILE] = m + torch.log2(l)
    return out[:, :, :T].to(dt), stats[:, :, :T]


def inputs(seed, B, T, H, D):
    """qkv, qb, the [B, 1, 1, T] key bias (row 0's last third of keys
    masked, row 1's last key and its whole second 64-key tile) and dout,
    from RandomState(seed)."""
    rng = np.random.RandomState(seed)
    F = 3 * H * D
    qkv = rng.randn(B, T, F).astype(np.float32)
    qb = (rng.randn(F) * 0.1).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    mask[0, T - T // 3:] = 0
    mask[1, -1:] = 0
    mask[1, 64:128] = 0
    return qkv, qb, ((1.0 - mask) * -10000.0)[:, None, None, :].astype(np.float32)


def model_fwd(variant, x, qb, kb, H, D, dp, rate, seed):
    """The model on the wrapper's inputs of ``variant`` (packed: qkv [B, T,
    H*3*D] and its deferred bias, added in E; heads_major: the biased [B, 3,
    H, T, D]), the heads zero-padded to dp as the wrapper pads them: out in
    the wrapper's layout, cut back to D, and stats."""
    if variant == "packed":
        q, k, v = fa._split_heads(fa.pad_heads(x + qb, H, 3, dp), H)
    else:
        q, k, v = fa.pad_heads_major(x, dp).unbind(1)
    out, stats = one_pass_fwd(q, k, v, kb, rate, seed, 1.0 / math.sqrt(D))
    if variant == "packed":
        return fa.unpad_heads(fa._merge_heads(out), H, 1, D), stats
    return fa.unpad_heads_major(out, D), stats


def variant_inputs(variant, dtype, D, B=2, T=228, H=2, seed=0):
    """(x, qb or None, kb [B, T], the [B, 1, 1, T] bias, the numpy qkv and
    qb) of ``variant`` in ``dtype`` from inputs()."""
    qkv, qb, bias = inputs(seed + D, B, T, H, D)
    td = getattr(torch, dtype)
    kb = torch.tensor(bias[:, 0, 0, :])
    x, b = torch.tensor(qkv).to(td), torch.tensor(qb).to(td)
    if variant == "heads_major":
        x = (x + b).view(B, T, H, 3, D).permute(0, 3, 2, 1, 4).contiguous()
        b = None
    return x, b, kb, bias, qkv, qb


@pytest.mark.parametrize("dp", [16, 32])
def test_the_fragment_layout_covers_each_tile_element_once(dp):
    """Each (row, col) of a 64 x dp tile is one thread's element once, and
    the epilogue puts each element back where the layout took it from."""
    row, col = fragment_index(dp)
    flat = (row * dp + col).flatten()
    assert torch.equal(torch.sort(flat).values, torch.arange(TILE * dp))
    tile = torch.randn(TILE, dp)
    assert torch.equal(store_rows_s(tile[row, col], torch.ones(4, 32, 2), dp), tile)
    sc = torch.rand(TILE) + 0.5
    assert torch.equal(store_rows_s(tile[row, col], thread_rows(sc), dp), tile * sc[:, None])


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("D,dp", DIMS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("variant", ["packed", "heads_major"])
def test_small_forward_order_matches_plain(variant, dtype, D, dp, rate):
    """The model of the small forms' one pass at T = 228 against the plain
    version (the wrapper on CPU tensors, which counts the form the card
    runs: "<dtype> D<dp>"), dropout 0 and 0.1 (the same keep bits)."""
    x, b, kb, _, _, _ = variant_inputs(variant, dtype, D)
    H = 2
    out, stats = model_fwd(variant, x, b, kb, H, D, dp, rate, 3)
    if variant == "packed":
        out_r, stats_r = fa.packed_attention_fwd(x, b, kb, H, rate, 3)
    else:
        out_r, stats_r = fa.heads_major_attention_fwd(x, kb, rate, 3)
    assert fa.attention_form(x.dtype, D) == f"{'bf16' if dtype == 'bfloat16' else 'fp16'} D{dp}"
    assert out.dtype == x.dtype and out.shape == out_r.shape
    assert_close(out.float().numpy(), out_r.float().numpy(), dtype, "out against the plain version")
    np.testing.assert_allclose(stats.numpy(), stats_r.numpy(), atol=STATS_ATOL, rtol=0, err_msg="stats")


@pytest.mark.parametrize("D,dp", DIMS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("variant", ["packed", "heads_major"])
def test_small_forward_order_matches_jax(variant, dtype, D, dp):
    """The model against the JAX op (its Pallas kernel in interpret mode) at
    dropout 0: flash_attention_packed with the deferred bias, or the
    heads-major flash_attention on the biased q, k, v."""
    x, b, kb, bias, qkv, qb = variant_inputs(variant, dtype, D)
    H = 2
    out, _ = model_fwd(variant, x, b, kb, H, D, dp, 0.0, 0)
    jd = jnp.dtype(dtype)
    if variant == "packed":
        out_j = jfa.flash_attention_packed(jnp.asarray(qkv, jd), H, jnp.asarray(bias), qkv_bias=jnp.asarray(qb, jd))
    else:
        q, k, v = (jnp.asarray(t.float().numpy(), jd) for t in x.unbind(1))
        out_j = jfa.flash_attention(q, k, v, jnp.asarray(bias), heads_major=True)
    assert_close(out.float().numpy(), np.asarray(out_j, np.float32), dtype, "out against JAX")
