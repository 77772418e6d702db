"""The dtypes, head dims and widths K11-K14 (the heads-major and save-probs
attention) and K7-K10 (the residual LayerNorm) take beyond bf16 at head dim
64 and widths that are a multiple of 8 up to 1024, on the CPU against the
JAX package.

On CPU tensors the wrappers run their plain versions, the math of every
kernel form. Each is held against the JAX function on the same numpy
inputs, its Pallas kernel in interpret mode, dropout off:

* the heads-major attention (``flash_attention_heads_major``) forward and
  backward against ``flash_attention(..., heads_major=True)`` and
  ``jax.vjp``, in fp32 at head dims 8, 16, 32 and 128 and in fp16 at 64,
  26, 32 and 16 (the head dims at which the backwards K12 and K14 and the
  save-probs forward K13 run on small rows: 26 padded to 32, 16 and 32 in
  place);
* the save-probs attention (``flash_attention_packed(...,
  save_probs=True)``) at the same dtypes and head dims: out against the JAX
  op, each saved bf16 probability within one bf16 ulp of the JAX kernel's,
  and the plain K14 against the JAX backward ``_flash_packed_sp_bwd`` fed
  the JAX probabilities (so both sides read the same bf16 values);
* ``fused_add_layer_norm`` and ``fused_dropout_add_layer_norm`` (rate 0),
  forward and dx, dres, dscale, dbias, at widths 1, 7, 64, 100, 1030, 2048
  and 4096 in fp32 and bf16.

Tolerances as ``tests/test_torch_kernel_dtypes.py`` states them: fp32 atol
2e-5 / rtol 1e-4; fp16 rtol 4e-3 with atol 4e-3 of the largest entry (the
two frameworks round an intermediate at another place); the LayerNorm's
bf16 outputs within one bf16 ulp at |v| < 4 (atol 1/64) and its fp32
gradients at ``tests/test_torch_layer_norm.py``'s 2e-4 / 1e-3. The
zero-padding the bf16 and fp16 kernels take (``pad_heads_major``,
``pad_heads``, D = 8, 16, 32, 96 to 64 or 128; 8 to 16 and 26 to 32) is
held to the unpadded plain version at dropout 0 and 0.1, K11-K14 count
their forms by ``attention_form``, ``pack_bits`` / ``unpack_bits`` round
trip at widths no multiple of 8, and ``tiny()`` with ``packed_qkv: false``
or ``flash_save_probs: true`` and the other kernel flags on matches the JAX
model on the same exported weights. The kernels themselves are tested on
the card (tests/test_torch_kernels_cuda.py)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualbert_tpu.config import VisualBertConfig as JaxConfig
from visualbert_tpu.models.visualbert import VisualBertForTask as JaxTask
from visualbert_tpu.ops import flash_attention as jfa
from visualbert_tpu.ops.layer_norm import fused_add_layer_norm as jax_fused
from visualbert_tpu.ops.layer_norm import fused_dropout_add_layer_norm as jax_dfused
from visualbert_tpu.tools.export_torch import export_state_dict
from visualbert_tpu.train.trainer import unbox
from visualbert_torch.config import VisualBertConfig
from visualbert_torch.models.visualbert import VisualBertForTask
from visualbert_torch.ops import flash_attention as fa
from visualbert_torch.ops import layer_norm as ln
from visualbert_torch.tools.weights import load_state

ATOL, RTOL = 2e-5, 1e-4
F16_RTOL, F16_ATOL_OF_MAX = 4e-3, 4e-3
LN_GRAD_ATOL, LN_GRAD_RTOL = 2e-4, 1e-3
BF16_ATOL = 1.0 / 64
SP_GRAD_TOL = 1e-2  # tests/test_torch_attention_variants.py's: bf16 probabilities on both sides
FORMS = [("float32", 8), ("float32", 16), ("float32", 32), ("float32", 128), ("float16", 64), ("float16", 26),
         ("float16", 32), ("float16", 16)]


def assert_close(got, want, dtype, err_msg=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL, err_msg=err_msg)
    else:
        np.testing.assert_allclose(got, want, rtol=F16_RTOL, atol=F16_ATOL_OF_MAX * np.abs(want).max(),
                                   err_msg=err_msg)


def key_bias(B, T):
    mask = np.ones((B, T), np.float32)
    mask[0, -6:] = 0
    mask[-1, -1:] = 0
    return ((1.0 - mask) * -10000.0)[:, None, None, :].astype(np.float32)


def within_a_bf16_ulp(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    _, e = np.frexp(np.maximum(np.abs(want), 2.0 ** -126))  # |want| in [2^(e-1), 2^e)
    return bool((np.abs(got - want) <= np.maximum(np.ldexp(1.0, e - 8), 2.0 ** -126)).all())


@pytest.mark.parametrize("dtype,D", FORMS)
def test_heads_major_attention_matches_jax_at_every_dtype_and_head_dim(dtype, D):
    """out and the q, k, v gradients of flash_attention_heads_major (the
    plain K11/K12 of that form) against the JAX heads-major op."""
    B, T, H = 2, 21, 2
    rng = np.random.RandomState(D)
    q, k, v, dout = (rng.randn(B, H, T, D).astype(np.float32) for _ in range(4))
    bias = key_bias(B, T)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)

    def jax_out(q, k, v):
        return jfa.flash_attention(q, k, v, jnp.asarray(bias), heads_major=True)

    out_j, vjp = jax.vjp(jax_out, *(jnp.asarray(x, jd) for x in (q, k, v)))
    grads_j = vjp(jnp.asarray(dout, jd))
    qkv = torch.tensor(np.stack([q, k, v], axis=1)).to(td).requires_grad_(True)
    out_t = fa.flash_attention_heads_major(qkv, torch.tensor(bias))
    out_t.backward(torch.tensor(dout).to(td))
    assert out_t.dtype == td and qkv.grad.dtype == td and out_t.shape == (B, H, T, D)
    assert_close(out_t.detach().float().numpy(), out_j, dtype, "out")
    for i, name in enumerate(("dq", "dk", "dv")):
        assert_close(qkv.grad[:, i].float().numpy(), grads_j[i], dtype, name)


@pytest.mark.parametrize("dtype,D", FORMS)
def test_save_probs_attention_matches_jax_at_every_dtype_and_head_dim(dtype, D):
    """K13's plain version against the JAX save-probs forward: out, and its
    bf16 probabilities within one bf16 ulp of the JAX kernel's (bf16 in
    every dtype); K14's plain version against the JAX backward on the JAX
    probabilities and output; the op end to end, its bias gradient too."""
    B, T, H = 2, 21, 2
    F = 3 * H * D
    rng = np.random.RandomState(D + 1)
    qkv = rng.randn(B, T, F).astype(np.float32)
    qb = (rng.randn(F) * 0.1).astype(np.float32)
    dout = rng.randn(B, T, H * D).astype(np.float32)
    bias = key_bias(B, T)
    kb = bias[:, 0, 0, :]
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    x = np.asarray(jnp.asarray(qkv + qb, jd).astype(jnp.float32))  # the biased qkv, rounded once
    seed = jnp.zeros((1,), jnp.int32)
    out_j, probs_j = jfa._flash_packed_sp_fwd_impl(jnp.asarray(x, jd), jnp.asarray(kb), 0.0, H, D, seed)
    out_t, probs_t = fa.packed_attention_sp_fwd(torch.tensor(x).to(td), torch.tensor(kb), H, 0.0, 0)
    assert out_t.dtype == td and probs_t.dtype == torch.bfloat16 and probs_t.shape == (B, H, T, T)
    assert_close(out_t.float().numpy(), out_j, dtype, "out")
    assert within_a_bf16_ulp(probs_t.float().numpy(), probs_j)

    dqkv_j, _, _ = jfa._flash_packed_sp_bwd(0.0, H, D, (jnp.asarray(x, jd), probs_j, seed, out_j),
                                            jnp.asarray(dout, jd))
    probs = torch.tensor(np.asarray(probs_j, np.float32)).to(torch.bfloat16)
    dqkv_t = fa.packed_attention_sp_bwd(torch.tensor(x).to(td), probs, torch.tensor(dout).to(td),
                                        torch.tensor(np.asarray(out_j, np.float32)).to(td), H, 0.0, 0)
    assert dqkv_t.dtype == td
    assert_close(dqkv_t.float().numpy(), dqkv_j, dtype, "dqkv")

    def jax_loss(x, b):
        out = jfa.flash_attention_packed(x, H, jnp.asarray(bias), save_probs=True, qkv_bias=b)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(dout))

    dx_j, db_j = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(qkv, jd), jnp.asarray(qb, jd))
    xt = torch.tensor(qkv).to(td).requires_grad_(True)
    bt = torch.tensor(qb).to(td).requires_grad_(True)
    fa.flash_attention_packed(xt, H, torch.tensor(bias), qkv_bias=bt, save_probs=True).backward(
        torch.tensor(dout).to(td))
    for got, want in ((xt.grad, dx_j), (bt.grad, db_j)):
        got, want = got.float().numpy(), np.asarray(want, np.float32)
        assert np.abs(got - want).max() <= SP_GRAD_TOL * np.abs(want).max()


@pytest.mark.parametrize("D,dp", [(8, 64), (16, 64), (32, 64), (96, 128), (8, 16), (26, 32)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_padded_heads_major_heads_give_the_unpadded_attention(D, dp, rate):
    """K11/K12's plain versions on [B, 3, H, T, D] zero-padded to the
    kernel's head dim (pad_heads_major), at the unpadded D's softmax scale,
    cut back, equal the plain versions on the unpadded heads (the keep bits
    are a function of (b, h, i, j), not of D); the padded columns come out
    zero. The longer rows' sums may round differently: atol 1e-6."""
    B, T, H = 2, 21, 3
    rng = np.random.RandomState(D)
    qkv = torch.tensor(rng.randn(B, 3, H, T, D).astype(np.float32))
    dout = torch.tensor(rng.randn(B, H, T, D).astype(np.float32))
    kb = torch.tensor(key_bias(B, T)[:, 0, 0, :])
    out, stats = fa.heads_major_attention_fwd_reference(qkv, kb, rate, 11)
    dqkv = fa.heads_major_attention_bwd_reference(qkv, kb, dout, out, stats, rate, 11)
    scale = 1.0 / math.sqrt(D)
    qkv_p = fa.pad_heads_major(qkv, dp)
    assert qkv_p.shape == (B, 3, H, T, dp) and torch.equal(fa.unpad_heads_major(qkv_p, D), qkv)
    out_p, stats_p = fa.heads_major_attention_fwd_reference(qkv_p, kb, rate, 11, scale=scale)
    dqkv_p = fa.heads_major_attention_bwd_reference(qkv_p, kb, fa.pad_heads_major(dout, dp),
                                                    fa.pad_heads_major(out, dp), stats, rate, 11, scale=scale)
    assert torch.count_nonzero(out_p[..., D:]) == 0 and torch.count_nonzero(dqkv_p[..., D:]) == 0
    for got, want in ((fa.unpad_heads_major(out_p, D), out), (stats_p, stats), (fa.unpad_heads_major(dqkv_p, D), dqkv)):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("D,dp", [(8, 64), (16, 64), (32, 64), (96, 128), (8, 16), (26, 32)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_padded_save_probs_heads_give_the_unpadded_attention(D, dp, rate):
    """K13/K14's plain versions on the packed qkv zero-padded per head
    (pad_heads), at the unpadded D's scale, cut back, equal the plain
    versions on the unpadded heads: out, the probabilities (which do not
    depend on D) and dqkv."""
    B, T, H = 2, 21, 3
    rng = np.random.RandomState(D + 5)
    qkv = torch.tensor(rng.randn(B, T, 3 * H * D).astype(np.float32))
    dout = torch.tensor(rng.randn(B, T, H * D).astype(np.float32))
    kb = torch.tensor(key_bias(B, T)[:, 0, 0, :])
    out, probs = fa.packed_attention_sp_fwd_reference(qkv, kb, H, rate, 11)
    dqkv = fa.packed_attention_sp_bwd_reference(qkv, probs, dout, out, H, rate, 11)
    scale = 1.0 / math.sqrt(D)
    qkv_p = fa.pad_heads(qkv, H, 3, dp)
    out_p, probs_p = fa.packed_attention_sp_fwd_reference(qkv_p, kb, H, rate, 11, scale=scale)
    dqkv_p = fa.packed_attention_sp_bwd_reference(qkv_p, probs, fa.pad_heads(dout, H, 1, dp),
                                                  fa.pad_heads(out, H, 1, dp), H, rate, 11, scale=scale)
    assert within_a_bf16_ulp(probs_p.float().numpy(), probs.float().numpy())
    assert torch.count_nonzero(dqkv_p.view(B, T, H, 3, dp)[..., D:]) == 0
    for got, want in ((fa.unpad_heads(out_p, H, 1, D), out), (fa.unpad_heads(dqkv_p, H, 3, D), dqkv)):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype,D,form", [("bfloat16", 64, "bf16 D64"), ("float16", 16, "fp16 D16"),
                                          ("bfloat16", 96, "bf16 D128"), ("float32", 7, "fp32")])
def test_each_variant_form_is_named_and_padded_to_its_kernel(dtype, D, form):
    assert fa.attention_form(getattr(torch, dtype), D) == form
    x = torch.zeros((1, 3, 2, 5, D))
    assert fa.pad_heads_major(x, fa.kernel_head_dim(D)).shape[-1] == fa.kernel_head_dim(D)
    assert fa.pad_heads_major(x, D) is x and fa.unpad_heads_major(x, D) is x


@pytest.mark.parametrize("dtype,name", [("bfloat16", "bf16"), ("float16", "fp16")])
@pytest.mark.parametrize("D,dp", [(8, 16), (16, 16), (26, 32), (32, 32)])
def test_the_variant_backwards_have_their_own_forms_below_64(dtype, name, D, dp):
    """Below 64 K11-K14, forwards and backwards, run on their small-row
    forms (heads of 16 and 32 in place, 8 and 26 padded to 16 and 32), all
    counted by attention_form; fp32 is one form for all."""
    td = getattr(torch, dtype)
    assert fa.kernel_head_dim(D) == dp and fa.attention_form(td, D) == f"{name} D{dp}"
    assert fa.attention_form(torch.float32, D) == "fp32"
    x = torch.zeros((1, 3, 2, 5, D))
    assert fa.pad_heads_major(x, dp).shape == (1, 3, 2, 5, dp)
    assert fa.pad_heads(torch.zeros((1, 5, 3 * 2 * D)), 2, 3, dp).shape == (1, 5, 3 * 2 * dp)


@pytest.mark.parametrize("D", [8, 16, 17, 26, 32, 33, 48, 64, 96, 128])
@pytest.mark.parametrize("dtype,name", [("bfloat16", "bf16"), ("float16", "fp16")])
def test_the_save_probs_forward_has_its_own_forms(dtype, name, D):
    """K13 runs bf16 and fp16 heads of 16 and 32 in place and pads a head
    dim to the next of 16, 32, 64, 128 (kernel_head_dim, the head dim its
    wrapper pads to), as K1, K2, K11, K12 and K14 do: one form name for
    all (attention_form)."""
    td = getattr(torch, dtype)
    dp = 16 if D <= 16 else 32 if D <= 32 else 64 if D <= 64 else 128
    assert fa.kernel_head_dim(D) == dp and fa.attention_form(td, D) == f"{name} D{dp}"
    qkv = torch.arange(2 * 5 * 3 * 2 * D, dtype=torch.float32).reshape(2, 5, 3 * 2 * D).to(td)
    padded = fa.pad_heads(qkv, 2, 3, dp)
    assert padded.shape == (2, 5, 3 * 2 * dp) and torch.equal(fa.unpad_heads(padded, 2, 3, D), qkv)


# ---- K7-K10 ----

LN_DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
LN_WIDTHS = [1, 7, 64, 100, 1030, 2048, 4096]


def ln_inputs(rng, N, H, dtype):
    jdt, tdt = LN_DTYPES[dtype]
    arrs = [np.asarray(jnp.asarray(rng.randn(N, H), jdt).astype(jnp.float32)) for _ in range(3)]
    scale = (rng.rand(H) + 0.5).astype(np.float32)
    bias = (rng.randn(H) * 0.1).astype(np.float32)
    return ([jnp.asarray(a, jdt) for a in arrs] + [jnp.asarray(scale), jnp.asarray(bias)],
            [torch.tensor(a).to(tdt) for a in arrs] + [torch.tensor(scale), torch.tensor(bias)])


def ln_close(got, want, dtype, grad=False):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if dtype == "bfloat16":
        np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=0)
    elif grad:
        np.testing.assert_allclose(got, want, atol=LN_GRAD_ATOL, rtol=LN_GRAD_RTOL)
    else:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dropout", [False, True], ids=["add", "dropout_add"])
@pytest.mark.parametrize("dtype", list(LN_DTYPES))
@pytest.mark.parametrize("H", LN_WIDTHS)
def test_layer_norm_matches_jax_at_every_width(H, dtype, dropout):
    """fused_add_layer_norm (K7/K8's plain versions) or
    fused_dropout_add_layer_norm at rate 0 (K9/K10's) against the JAX op:
    y, and dx, dres, dscale, dbias by ``jax.vjp``."""
    N = 6
    (jx, jr, jdy, js, jb), (tx, tr, tdy, ts, tb) = ln_inputs(np.random.RandomState(H), N, H, dtype)
    if dropout:
        seed = jnp.asarray([3], jnp.int32)
        y_j, vjp = jax.vjp(lambda x, r, s, b: jax_dfused(x, r, s, b, seed, 0.0), jx, jr, js, jb)
        fn = lambda x, r, s, b: ln.fused_dropout_add_layer_norm(x, r, s, b, 3, 0.0)  # noqa: E731
    else:
        y_j, vjp = jax.vjp(lambda x, r, s, b: jax_fused(x, r, s, b), jx, jr, js, jb)
        fn = ln.fused_add_layer_norm
    grads_j = vjp(jdy)
    leaves = [t.clone().requires_grad_(True) for t in (tx, tr, ts, tb)]
    y_t = fn(*leaves)
    y_t.backward(tdy)
    assert y_t.shape == (N, H) and y_t.dtype == tx.dtype
    ln_close(y_t, y_j, dtype)
    for name, leaf, g_j in zip(("dx", "dres", "dscale", "dbias"), leaves, grads_j):
        ln_close(leaf.grad, g_j, dtype if name in ("dx", "dres") else "float32", grad=True)


@pytest.mark.parametrize("H", [1, 7, 9, 100, 1030, 4095])
def test_keep_bits_round_trip_at_widths_no_multiple_of_8(H):
    """pack_bits pads each row to whole bytes ([N, ceil(H / 8)], the tail
    bits 0, row r's bit of element e at byte e // 8, bit e % 8);
    unpack_bits with the width gives the mask back."""
    N = 5
    keep = torch.tensor(np.random.RandomState(H).rand(N, H) < 0.7)
    bits = ln.pack_bits(keep)
    assert bits.shape == (N, ln.bits_width(H)) == (N, -(-H // 8)) and bits.dtype == torch.uint8
    assert torch.equal(ln.unpack_bits(bits, H), keep)
    assert not bool(ln.unpack_bits(bits)[:, H:].any())
    r, e = 3, H - 1
    assert bool((bits[r, e // 8] >> (e % 8)) & 1) == bool(keep[r, e])


@pytest.mark.parametrize("H", [7, 100, 1030])
def test_plain_k10_on_odd_width_bits_drops_the_k9_positions(H):
    """At a width no multiple of 8, K10's plain version reads K9's padded
    bits of the same mask: dx is zero exactly where the mask drops."""
    rng = np.random.RandomState(H)
    x, res, dy = (torch.tensor(rng.randn(9, H).astype(np.float32)) for _ in range(3))
    scale, bias = torch.ones(H), torch.zeros(H)
    y, mu, rstd, bits = ln.dropout_add_layer_norm_fwd_reference(x, res, scale, bias, 0.25, 17)
    keep = ln.keep_mask((9, H), 0.25, 17, x.device)
    assert torch.equal(bits, ln.pack_bits(keep))
    dx, dres, _, _ = ln.dropout_add_layer_norm_bwd_reference(x, res, scale, mu, rstd, dy, bits, 0.25)
    assert torch.equal(dx == 0, ~keep | (dres == 0))


@pytest.mark.parametrize("flags", [dict(packed_qkv=False), dict(flash_save_probs=True)],
                         ids=["packed_qkv_false", "flash_save_probs"])
def test_tiny_pretraining_with_each_variant_and_every_kernel_flag_matches_jax(flags):
    """VisualBertForTask("pretraining") at tiny() (fp32, head dim 16, width
    64) with use_flash_attention and the variant flag, fused_mlm_xent,
    use_fused_layer_norm and fast_dropout, dropout off, on the JAX model's
    exported weights: the losses and mlm_accuracy against the JAX model
    with the same flags; every parameter gradient against the JAX model
    without fused_mlm_xent (the fused JAX op cannot be differentiated,
    ROADMAP C1), at 2e-5 / 1e-4 with the heads-major kernels and within 1e-2
    of its largest JAX value with the saved bf16 probabilities."""
    flags = dict(flags, use_flash_attention=True, fused_mlm_xent=True, use_fused_layer_norm=True, fast_dropout=True,
                 visual_embedding_dim=16)
    jcfg, tcfg = JaxConfig.tiny(**flags), VisualBertConfig.tiny(**flags)
    rng = np.random.RandomState(1)
    B, TT, TV, P = 3, 12, 7, 3
    lm = np.full((B, TT), -1, np.int32)
    pos = np.zeros((B, P), np.int32)
    for i in range(B):
        p = np.sort(rng.choice(np.arange(1, TT), size=P, replace=False))
        pos[i] = p
        lm[i, p[:2]] = rng.randint(0, jcfg.vocab_size, size=2)
    input_mask = np.ones((B, TT), np.int32)
    input_mask[0, -3:] = 0
    batch = {
        "input_ids": rng.randint(0, jcfg.vocab_size, (B, TT)).astype(np.int32),
        "token_type_ids": rng.randint(0, 2, (B, TT)).astype(np.int32),
        "input_mask": input_mask,
        "visual_embeddings": rng.randn(B, TV, 16).astype(np.float32),
        "image_mask": np.ones((B, TV), np.int32),
        "visual_embeddings_type": np.ones((B, TV), np.int32),
        "masked_lm_labels": lm,
        "mlm_positions": pos,
        "is_random_next": rng.randint(0, 2, (B,)).astype(np.int32),
    }
    jbatch = jax.tree.map(jnp.asarray, batch)
    jm = JaxTask(jcfg, head_type="pretraining")
    params = unbox(jax.jit(jm.init)(jax.random.PRNGKey(9), jbatch)["params"])
    out_j = jax.jit(lambda p: jm.apply({"params": p}, jbatch, deterministic=True))(params)
    unfused = JaxTask(jcfg.replace(fused_mlm_xent=False), head_type="pretraining")
    grads_j = jax.jit(jax.grad(lambda p: unfused.apply({"params": p}, jbatch, deterministic=True)["loss"]))(params)

    model = load_state(VisualBertForTask(tcfg, "pretraining"), export_state_dict(params, jcfg)).eval()
    out_t = model({k: torch.tensor(v).long() if v.dtype.kind == "i" else torch.tensor(v) for k, v in batch.items()})
    out_t["loss"].backward()
    for k in ("loss", "masked_lm_loss", "next_sentence_loss", "mlm_accuracy"):
        np.testing.assert_allclose(float(out_t[k].detach()), float(out_j[k]), atol=ATOL, rtol=RTOL, err_msg=k)
    want = export_state_dict(grads_j, jcfg)
    for name, p in model.named_parameters():
        if flags.get("flash_save_probs"):
            assert np.abs(p.grad.numpy() - want[name]).max() <= SP_GRAD_TOL * np.abs(want[name]).max(), name
        else:
            np.testing.assert_allclose(p.grad.numpy(), want[name], atol=ATOL, rtol=RTOL, err_msg=name)
