"""Head dims below 64 and K1/K11's fp32 forward order, on the CPU against
the JAX package.

K1/K2 run bf16 and fp16 heads of 16 and 32 on kernels of those head dims
(``kernel_head_dim``; 26, TinyBERT-4's, padded to 32), and K1/K11's fp32
forward walks the key tiles once with an online max and sum. On CPU tensors
the wrappers run their plain versions, which are held here against the JAX
op (its Pallas kernel in interpret mode) at head dims 26 and 32 in fp32 and
fp16, and a torch model of the fp32 forward's one-pass order (64-key tiles,
the row max merged tile by tile, the running sums and O rescaled by
exp2(m_old - m_new), each row's sum kept as 16 shares merged by the
kernel's butterfly at the end, the dropped p into P V) is held against the
plain version and the JAX op at T = 228 with ragged keys. Tolerances: fp32
atol 2e-5 / rtol 1e-4 (the ROADMAP's bar: the same fp32 terms summed in
another order); fp16 as ``test_torch_kernel_dtypes.py`` states (one fp16
ulp where the two frameworks round an intermediate at another place)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualbert_tpu.ops.flash_attention import flash_attention_packed as jax_flash_packed
from visualbert_torch.ops import flash_attention as fa

ATOL, RTOL = 2e-5, 1e-4
F16_RTOL, F16_ATOL_OF_MAX = 4e-3, 4e-3
KEY_TILE = 64  # the fp32 forward's key tile (csrc/flash_attention_f32.cu's BR)


def assert_close(got, want, dtype, err_msg=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL, err_msg=err_msg)
    else:
        np.testing.assert_allclose(got, want, rtol=F16_RTOL, atol=F16_ATOL_OF_MAX * np.abs(want).max(),
                                   err_msg=err_msg)


def inputs(seed, B, T, H, D):
    """qkv, qb, the [B, 1, 1, T] key bias (row 0's last third of keys
    masked, row 1's last key; from T = 192 on, row 1's whole second 64-key
    tile too) and dout, from RandomState(seed)."""
    rng = np.random.RandomState(seed)
    F = 3 * H * D
    qkv = rng.randn(B, T, F).astype(np.float32)
    qb = (rng.randn(F) * 0.1).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    mask[0, T - T // 3:] = 0
    mask[1, -1:] = 0
    if T >= 192:
        mask[1, 64:128] = 0
    bias = ((1.0 - mask) * -10000.0)[:, None, None, :].astype(np.float32)
    dout = rng.randn(B, T, H * D).astype(np.float32)
    return qkv, qb, bias, dout


@pytest.mark.parametrize("D", [26, 32])
@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_small_heads_match_jax(dtype, D):
    """out, dqkv and the qkv-bias gradient of flash_attention_packed (the
    plain K1/K2) against the JAX op at a small head dim, dropout off; the
    pair's form there is the unpadded "D32" (fp16) or fp32."""
    B, T, H = 2, 37, 3
    qkv, qb, bias, dout = inputs(D, B, T, H, D)
    jd = jnp.dtype(dtype)

    def jax_loss(x, b):
        out = jax_flash_packed(x, H, jnp.asarray(bias), qkv_bias=b)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(dout)), out

    (_, out_j), (dx_j, db_j) = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(qkv, jd), jnp.asarray(qb, jd))
    td = getattr(torch, dtype)
    x = torch.tensor(qkv).to(td).requires_grad_(True)
    b = torch.tensor(qb).to(td).requires_grad_(True)
    out_t = fa.flash_attention_packed(x, H, torch.tensor(bias), qkv_bias=b)
    out_t.backward(torch.tensor(dout).to(td))
    assert fa.attention_form(td, D) == ("fp32" if dtype == "float32" else "fp16 D32")
    assert_close(out_t.detach().float().numpy(), out_j, dtype, "out")
    assert_close(x.grad.float().numpy(), dx_j, dtype, "dqkv")
    assert_close(b.grad.float().numpy(), db_j, dtype, "dqkv_bias")


def row_butterfly(shares):
    """The kernel's merge of a row's 16 shares [..., 16] (thread tx of the
    row holds share tx): sums with share tx ^ 1, ^ 2, ^ 4, ^ 8 in turn (the
    shuffles of lane bits 0, 1, 3, 4); every share ends with the same sum."""
    idx = torch.arange(16)
    for bit in (1, 2, 4, 8):
        shares = shares + shares[..., idx ^ bit]
    return shares[..., 0]


def one_pass_fwd(qkv, qb, key_bias, n_heads, rate, seed):
    """A torch model of K1's fp32 forward (csrc/flash_attention_f32.cu::
    attn_f32_tiled_fwd_kernel) on fp32 inputs: (out [B, T, H*D], stats [B,
    H, T]). q biased, k and v not. Per 64-key tile: t = (q.k + q.bk) c1 + kb
    log2(e) (-inf past T), the row max over the tile merged with the running one,
    alpha = exp2(m_old - m_new), p = exp2(t - m_new), the thread shares of
    the row sum (thread tx holds keys 2 tx + {0, 1, 32, 33} of every tile) l
    = l alpha + their p and likewise lk of the kept p, O = O alpha + p_d V
    with p_d the kept p; at the end l and lk the butterflies of their
    shares, out = (O + lk bv) inv / l and stats = m + log2 l (k's and v's
    bias folded into constants of the row)."""
    q, _, _ = fa._split_heads(qkv + qb, n_heads)
    _, k, v = fa._split_heads(qkv, n_heads)
    _, bk, bv = fa._split_heads(qb.view(1, 1, -1), n_heads)  # [1, H, 1, D]
    B, H, T, D = q.shape
    c1 = fa.LOG2E / math.sqrt(D)
    kb = key_bias * fa.LOG2E
    keep = fa.attention_keep_reference(seed, B, H, T, rate) if rate > 0.0 else None
    inv = 1.0 / (1.0 - rate) if rate > 0.0 else 1.0
    m = torch.full((B, H, T), -math.inf)
    shares, kept = torch.zeros((B, H, T, 16)), torch.zeros((B, H, T, 16))
    o = torch.zeros((B, H, T, D))
    tx_of = torch.tensor([((c % 32) // 2) for c in range(KEY_TILE)])  # the thread of each key column
    qk = (q * bk).sum(-1, keepdim=True)
    for c0 in range(0, T, KEY_TILE):
        n = min(KEY_TILE, T - c0)
        t = torch.full((B, H, T, KEY_TILE), -math.inf)
        t[..., :n] = (q @ k[:, :, c0:c0 + n].transpose(-1, -2) + qk) * c1 + kb[:, None, None, c0:c0 + n]
        mn = torch.maximum(m, t.amax(dim=-1))
        alpha = torch.exp2(m - mn)
        m = mn
        p = torch.exp2(t - mn[..., None])
        shares = shares * alpha[..., None] + torch.zeros((B, H, T, 16)).index_add_(-1, tx_of, p)
        if keep is not None:
            p = torch.where(torch.nn.functional.pad(keep[..., c0:c0 + n], (0, KEY_TILE - n)), p, 0.0)
        kept = kept * alpha[..., None] + torch.zeros((B, H, T, 16)).index_add_(-1, tx_of, p)
        o = o * alpha[..., None] + p[..., :n] @ v[:, :, c0:c0 + n]
    l, lk = row_butterfly(shares), row_butterfly(kept)
    out = (o + lk[..., None] * bv) * (inv / l)[..., None]
    return fa._merge_heads(out), m + torch.log2(l)


@pytest.mark.parametrize("D", [16, 26, 64])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_one_pass_fp32_forward_order_matches_plain_and_jax(D, rate):
    """The model of the one-pass fp32 forward at T = 228 (four key tiles,
    the last ragged; a wholly masked tile in batch row 1) against the plain
    version (dropout 0 and 0.1: the same keep bits) and, at dropout 0, the
    JAX op, within the fp32 bar."""
    B, T, H = 2, 228, 2
    qkv, qb, bias, _ = inputs(7 + D, B, T, H, D)
    x, b, kb = torch.tensor(qkv), torch.tensor(qb), torch.tensor(bias[:, 0, 0, :])
    out, stats = one_pass_fwd(x, b, kb, H, rate, 3)
    out_r, stats_r = fa.packed_attention_fwd_reference(x, b, kb, H, rate, 3)
    assert_close(out.numpy(), out_r.numpy(), "float32", "out against the plain version")
    np.testing.assert_allclose(stats.numpy(), stats_r.numpy(), atol=ATOL, rtol=RTOL, err_msg="stats")
    if rate == 0.0:
        out_j = jax_flash_packed(jnp.asarray(qkv), H, jnp.asarray(bias), qkv_bias=jnp.asarray(qb))
        assert_close(out.numpy(), out_j, "float32", "out against JAX")
