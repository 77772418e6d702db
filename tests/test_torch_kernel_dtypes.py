"""The dtypes and widths K1/K2 and K4-K6 take beyond bf16 at head dim 64
and widths 768 / 1024, on the CPU against the JAX package.

On CPU tensors the wrappers run their plain versions, the math of every
kernel form (bf16 and fp16 at a padded head dim or width, fp32). Each is
held against the JAX function on the same numpy inputs, its Pallas kernel
in interpret mode: packed attention at head dims 8, 16, 32 and 128 in fp32
and 64, 96 and 128 (K2's streamed form) in fp16, the fused cross-entropy at widths 32, 64, 256, 384 and,
past 1024 (the wide form in fp16), 1088 and 2048 in fp32 and fp16
(forward against ``mlm_xent``, backward against the JAX backward kernels
with the JAX forward's lse, as ``test_torch_xent.py`` does: the JAX op's
custom VJP cannot be differentiated, ROADMAP C1). Tolerances:
fp32 atol 2e-5 / rtol 1e-4 (the ROADMAP's bar; the two sum the same fp32
products in another order). fp16: outputs and gradients in fp16 may round
one fp16 ulp (2^-10 relative) apart where the two frameworks round an
intermediate (the biased q, k, v, p, dS, dlog) at another place, so rtol
4e-3 with atol 4e-3 of the largest entry; fp32 statistics of fp16 products
(nll, lse, stats) atol 1e-4. The zero-padding the bf16 and fp16 kernels
take (``pad_heads``, ``pad_width``; to head dims of 16 and 32 too) is
held to the unpadded plain version: the padded columns add exact zeros. Last, one ``VisualBertForTask`` at the
JAX package's ``tiny()`` geometry with all four kernel flags against the JAX
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
from visualbert_tpu.ops import mlm_xent as jax_xent
from visualbert_tpu.ops.flash_attention import flash_attention_packed as jax_flash_packed
from visualbert_tpu.tools.export_torch import export_state_dict
from visualbert_tpu.train.trainer import unbox
from visualbert_torch.config import VisualBertConfig
from visualbert_torch.models.visualbert import VisualBertForTask
from visualbert_torch.ops import flash_attention as fa
from visualbert_torch.ops import mlm_xent as xe
from visualbert_torch.tools.weights import load_state

ATOL, RTOL = 2e-5, 1e-4
F16_RTOL, F16_ATOL_OF_MAX, F16_STAT_ATOL = 4e-3, 4e-3, 1e-4


def assert_close(got, want, dtype, err_msg=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL, err_msg=err_msg)
    else:
        np.testing.assert_allclose(got, want, rtol=F16_RTOL, atol=F16_ATOL_OF_MAX * np.abs(want).max(),
                                   err_msg=err_msg)


def attention_inputs(seed, B=2, T=21, H=2, D=16):
    rng = np.random.RandomState(seed)
    F = 3 * H * D
    qkv = rng.randn(B, T, F).astype(np.float32)
    qb = (rng.randn(F) * 0.1).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    mask[0, -6:] = 0
    mask[1, -1:] = 0
    bias = ((1.0 - mask) * -10000.0)[:, None, None, :].astype(np.float32)
    dout = rng.randn(B, T, H * D).astype(np.float32)
    return qkv, qb, bias, dout


@pytest.mark.parametrize("dtype,D", [("float32", 8), ("float32", 16), ("float32", 32), ("float32", 128),
                                     ("float16", 64), ("float16", 96), ("float16", 128)])
def test_packed_attention_matches_jax_at_every_dtype_and_head_dim(dtype, D):
    """out, dqkv and the qkv-bias gradient of flash_attention_packed (the
    plain K1/K2 of that form) against the JAX op, dropout off."""
    H = 2
    qkv, qb, bias, dout = attention_inputs(D, H=H, D=D)
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
    assert out_t.dtype == td and x.grad.dtype == td and b.grad.dtype == td
    assert_close(out_t.detach().float().numpy(), out_j, dtype, "out")
    assert_close(x.grad.float().numpy(), dx_j, dtype, "dqkv")
    assert_close(b.grad.float().numpy(), db_j, dtype, "dqkv_bias")


@pytest.mark.parametrize("D,dp", [(8, 64), (16, 64), (32, 64), (96, 128), (8, 16), (26, 32)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_padded_heads_give_the_unpadded_attention(D, dp, rate):
    """K1/K2's plain versions on heads zero-padded to the kernel's head dim
    (pad_heads), at the unpadded D's softmax scale, cut back (unpad_heads),
    equal the plain versions on the unpadded heads: out and stats forward,
    dqkv and dqb backward, with and without dropout (the keep bits are a
    function of (b, h, i, j), not of D). The padded columns add exact zeros
    to each product; the products' sums may be taken in another order over
    the longer rows, so the comparison allows fp32 rounding (atol 1e-6)."""
    H = 3
    qkv, qb, bias, dout = (torch.tensor(a) for a in attention_inputs(D + 1, H=H, D=D))
    kb = bias[:, 0, 0, :]
    out, stats = fa.packed_attention_fwd_reference(qkv, qb, kb, H, rate, 11)
    dqkv, dqb = fa.packed_attention_bwd_reference(qkv, qb, kb, dout, out, stats, H, rate, 11)
    scale = 1.0 / math.sqrt(D)
    qkv_p, qb_p = fa.pad_heads(qkv, H, 3, dp), fa.pad_heads(qb, H, 3, dp)
    assert qkv_p.shape[-1] == 3 * H * dp and torch.equal(fa.unpad_heads(qkv_p, H, 3, D), qkv)
    out_p, stats_p = fa.packed_attention_fwd_reference(qkv_p, qb_p, kb, H, rate, 11, scale=scale)
    dqkv_p, dqb_p = fa.packed_attention_bwd_reference(qkv_p, qb_p, kb, fa.pad_heads(dout, H, 1, dp),
                                                      fa.pad_heads(out, H, 1, dp), stats, H, rate, 11, scale=scale)
    assert not fa.unpad_heads(out_p, H, 1, dp)[..., :0].numel()
    assert torch.count_nonzero(out_p.view(*out_p.shape[:2], H, dp)[..., D:]) == 0
    assert torch.count_nonzero(dqkv_p.view(*dqkv_p.shape[:2], H, 3, dp)[..., D:]) == 0
    for got, want in ((fa.unpad_heads(out_p, H, 1, D), out), (stats_p, stats), (fa.unpad_heads(dqkv_p, H, 3, D), dqkv),
                      (fa.unpad_heads(dqb_p, H, 3, D), dqb)):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype,D,form", [("bfloat16", 64, "bf16 D64"), ("bfloat16", 16, "bf16 D16"),
                                          ("float16", 96, "fp16 D128"), ("float16", 128, "fp16 D128"),
                                          ("float32", 8, "fp32"), ("float32", 128, "fp32")])
def test_each_dtype_and_head_dim_has_its_kernel_form(dtype, D, form):
    assert fa.attention_form(getattr(torch, dtype), D) == form
    assert fa.kernel_head_dim(D) == (16 if D <= 16 else 32 if D <= 32 else 64 if D <= 64 else 128)


@pytest.mark.parametrize("D", [1, 8, 16, 17, 26, 32, 33, 48, 64, 96, 128])
@pytest.mark.parametrize("dtype,name", [("bfloat16", "bf16"), ("float16", "fp16")])
def test_the_backward_has_its_own_forms_below_64(dtype, name, D):
    """K1 and K2 (and K11-K14) run bf16 and fp16 heads of 16 and 32 unpadded
    and pad a head dim to the next of 16, 32, 64, 128: one form, named by
    attention_form, for the forward and the backward."""
    dp = 16 if D <= 16 else 32 if D <= 32 else 64 if D <= 64 else 128
    assert fa.HEAD_DIMS == (16, 32, 64, 128)
    assert fa.kernel_head_dim(D) == dp
    assert fa.attention_form(getattr(torch, dtype), D) == f"{name} D{dp}"
    assert fa.attention_form(torch.float32, D) == "fp32"


def xent_inputs(seed, N, H, V):
    rng = np.random.RandomState(seed)
    x = rng.randn(N, H).astype(np.float32)
    emb = (rng.randn(V, H) * 0.1).astype(np.float32)
    bias = (rng.randn(V) * 0.1).astype(np.float32)
    labels = rng.randint(0, V, N).astype(np.int32)
    labels[rng.rand(N) < 0.15] = -1
    labels[0] = -1
    g = np.where(labels >= 0, rng.uniform(0.5, 1.5, N), 0.0).astype(np.float32)
    return x, emb, bias, labels, g


@pytest.mark.parametrize("dtype", ["float32", "float16"])
@pytest.mark.parametrize("H", [32, 64, 256, 384, 1088, 2048])
def test_mlm_xent_matches_jax_at_every_dtype_and_width(dtype, H):
    """nll and argmax of mlm_xent against the JAX op; dx, d embedding and d
    bias of the plain K5/K6 against the JAX backward kernels on the JAX
    forward's lse."""
    N, V = 48, 640  # the JAX kernels take unpadded multiples of their blocks here
    x, emb, bias, labels, g = xent_inputs(H, N, H, V)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    xj, ej = jnp.asarray(x, jd), jnp.asarray(emb, jd)
    nll_j, am_j = jax.jit(jax_xent.mlm_xent)(xj, ej, jnp.asarray(bias), jnp.asarray(labels))
    xt, et, bt = torch.tensor(x).to(td), torch.tensor(emb).to(td), torch.tensor(bias)
    nll, am = xe.mlm_xent(xt, et, bt, torch.tensor(labels).long())
    rows = labels >= 0
    np.testing.assert_allclose(nll.numpy()[rows], np.asarray(nll_j)[rows],
                               atol=ATOL if dtype == "float32" else F16_STAT_ATOL, rtol=RTOL)
    np.testing.assert_array_equal(am.numpy(), np.asarray(am_j))

    lab = jnp.asarray(np.maximum(labels, 0).reshape(N, 1))
    _, lse_j, _ = jax_xent._fwd_impl(xj, ej, jnp.asarray(bias).reshape(1, V), lab, nb=16, vbk=128)
    dx_j, de_j, db_j = jax_xent._bwd_impl(xj, ej, jnp.asarray(bias).reshape(1, V), lab, lse_j,
                                          jnp.asarray(g).reshape(N, 1), nb=16, vbk_dx=128, vbk_de=128)
    lt, lse, gt = torch.tensor(np.maximum(labels, 0)), torch.tensor(np.asarray(lse_j)[:, 0]), torch.tensor(g)
    _, lse_t, _ = xe.mlm_xent_fwd_reference(xt, et, bt, lt)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j)[:, 0],
                               atol=ATOL if dtype == "float32" else F16_STAT_ATOL, rtol=RTOL)
    dx = xe.mlm_xent_dx(xt, et, bt, lt, lse, gt)
    de, db = xe.mlm_xent_de(xt, et, bt, lt, lse, gt)
    assert dx.dtype == td and de.dtype == td and db.dtype == torch.float32
    assert_close(dx.float().numpy(), dx_j, dtype, "dx")
    assert_close(de.float().numpy(), np.asarray(de_j.astype(jd)), dtype, "d embedding")
    np.testing.assert_allclose(db.numpy(), np.asarray(db_j)[0], atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("H", [32, 200, 384, 1000, 1100, 2000])
def test_padded_widths_give_the_unpadded_cross_entropy(H):
    """K4-K6's plain versions on x and E zero-padded to the kernel's width
    (pad_width: the next instantiation up to 1024, above it the next
    multiple of 64, the wide form's), dx and dE cut back, equal the plain
    versions at H: the argmax exactly; nll, lse, dx, dE and db as far as
    fp32 rounding of the longer sums goes (the logits recomputed from
    them), atol 1e-5."""
    w = xe.kernel_width(H)
    if H > xe.KERNEL_WIDTHS[-1]:
        assert xe.is_wide(H) and w % xe.WIDE_STEP == 0 and w - xe.WIDE_STEP < H < w
    else:
        assert w in xe.KERNEL_WIDTHS and w >= H and (w == 128 or xe.KERNEL_WIDTHS[xe.KERNEL_WIDTHS.index(w) - 1] < H)
    N, V = 24, 300
    x, emb, bias, labels, g = (torch.tensor(a) for a in xent_inputs(H, N, H, V))
    lab = labels.clamp_min(0)
    xp, ep = xe.pad_width(x, w), xe.pad_width(emb, w)
    assert xp.shape == (N, w) and torch.equal(xp[:, :H], x) and torch.count_nonzero(xp[:, H:]) == 0
    nll, lse, am = xe.mlm_xent_fwd_reference(x, emb, bias, lab)
    nll_p, lse_p, am_p = xe.mlm_xent_fwd_reference(xp, ep, bias, lab)
    torch.testing.assert_close(nll_p, nll, rtol=0, atol=1e-5)
    torch.testing.assert_close(lse_p, lse, rtol=0, atol=1e-5)
    assert torch.equal(am_p, am)
    dx_p = xe.mlm_xent_dx_reference(xp, ep, bias, lab, lse, g)
    de_p, db_p = xe.mlm_xent_de_reference(xp, ep, bias, lab, lse, g)
    de, db = xe.mlm_xent_de_reference(x, emb, bias, lab, lse, g)
    assert torch.count_nonzero(dx_p[:, H:]) == 0 and torch.count_nonzero(de_p[:, H:]) == 0
    torch.testing.assert_close(dx_p[:, :H], xe.mlm_xent_dx_reference(x, emb, bias, lab, lse, g), rtol=0, atol=1e-5)
    torch.testing.assert_close(de_p[:, :H], de, rtol=0, atol=1e-5)
    torch.testing.assert_close(db_p, db, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype,H,form", [("bfloat16", 768, "bf16 H768"), ("bfloat16", 64, "bf16 H128"),
                                          ("float16", 384, "fp16 H512"), ("float16", 1024, "fp16 H1024"),
                                          ("float32", 200, "fp32"), ("bfloat16", 2048, "bf16 wide H2048"),
                                          ("float16", 1100, "fp16 wide H1152"), ("bfloat16", 1025, "bf16 wide H1088"),
                                          ("float32", 2560, "fp32"), ("float16", 2048, "fp16 wide H2048"),
                                          ("float16", 8192, "fp16 wide H8192"), ("float16", 8193, "fp16 on fp32"),
                                          ("bfloat16", 8256, "bf16 on fp32")])
def test_each_dtype_and_width_has_its_kernel_form(dtype, H, form):
    assert xe.xent_form(getattr(torch, dtype), H) == form


def test_the_port_has_the_jax_packages_large_and_tiny():
    """VisualBertConfig.large() and tiny() have the JAX package's fields."""
    for name in ("large", "tiny", "base"):
        j, t = getattr(JaxConfig, name)(), getattr(VisualBertConfig, name)()
        for field in ("vocab_size", "hidden_size", "num_hidden_layers", "num_attention_heads", "intermediate_size",
                      "max_position_embeddings", "hidden_dropout_prob", "attention_probs_dropout_prob"):
            assert getattr(t, field) == getattr(j, field), (name, field)
        assert str(t.dtype).split(".")[-1] == str(jnp.dtype(j.dtype)), name
    large = VisualBertConfig.large()
    assert (large.hidden_size, large.num_hidden_layers, large.num_attention_heads, large.intermediate_size) == (
        1024, 24, 16, 4096)


def test_tiny_pretraining_with_every_kernel_flag_matches_jax():
    """VisualBertForTask("pretraining") at tiny() (fp32, head dim 16, width
    64) with use_flash_attention, fused_mlm_xent, use_fused_layer_norm and
    fast_dropout, dropout off, on the JAX model's exported weights: loss,
    masked_lm_loss, next_sentence_loss and mlm_accuracy against the JAX
    model with the same flags (jitted, its Pallas kernels in interpret
    mode), every parameter gradient against the JAX model without
    fused_mlm_xent (the fused JAX op cannot be differentiated, ROADMAP C1)."""
    flags = dict(use_flash_attention=True, fused_mlm_xent=True, use_fused_layer_norm=True, fast_dropout=True,
                 visual_embedding_dim=16)
    jcfg, tcfg = JaxConfig.tiny(**flags), VisualBertConfig.tiny(**flags)
    rng = np.random.RandomState(0)
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
    params = unbox(jax.jit(jm.init)(jax.random.PRNGKey(7), jbatch)["params"])
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
        np.testing.assert_allclose(p.grad.numpy(), want[name], atol=ATOL, rtol=RTOL, err_msg=name)
