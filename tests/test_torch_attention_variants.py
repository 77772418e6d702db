"""The heads-major (K11/K12) and save-probs (K13/K14) attention of the port
on the CPU against the JAX package.

The port's plain versions (what its wrappers compute on CPU tensors) are
held against ``visualbert_tpu.ops.flash_attention.flash_attention`` (both
layouts, the port's ``flash_attention_heads_major`` on q, k, v stacked) and
``flash_attention_packed(..., save_probs=True)``,
whose Pallas kernels run in interpret mode here, on the same numpy inputs,
fp32, dropout off, ragged T and padded keys:

* K11 out at atol 2e-5 / rtol 1e-4 (the bar the JAX encoder meets against
  HF), K12's gradients at the JAX attention tests' 3e-4 / 1e-3;
* K13 out at 2e-5 / 1e-4, its saved probabilities within one bf16 ulp of
  the largest; K14's dqkv and the qkv-bias gradient within 1e-2 of the
  largest JAX value, since both sides' backward reads bf16 probabilities
  and a value near a rounding boundary may round the other way.

With dropout on the two packages draw different bits, so the port's masks
are checked by themselves: the same seed gives the same mask, forward and
backward regenerate it (the gradient equals autograd through an explicit
softmax with the twin's mask), and the keep rate lies within 3 sigma. At
the model level, ``VisualBertForTask("pretraining")`` with ``packed_qkv:
false`` and with ``flash_save_probs: true`` matches the JAX model with the
same flags on exported weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualbert_tpu.config import VisualBertConfig as JaxConfig
from visualbert_tpu.models.visualbert import VisualBertForTask as JaxTask
from visualbert_tpu.ops import flash_attention as jfa
from visualbert_tpu.tools.export_torch import export_state_dict
from visualbert_tpu.train.trainer import unbox
from visualbert_torch.config import VisualBertConfig
from visualbert_torch.models.visualbert import VisualBertForTask
from visualbert_torch.ops import flash_attention as fa
from visualbert_torch.tools.weights import load_state
from test_torch_model import SMALL, make_batch, to_torch

ATOL, RTOL = 2e-5, 1e-4
GRAD_ATOL, GRAD_RTOL = 3e-4, 1e-3
SP_GRAD_TOL = 1e-2  # share of the largest JAX value, bf16 probabilities on both sides


def key_bias(B, T):
    mask = np.ones((B, T), np.float32)
    mask[0, -6:] = 0
    mask[-1, -1:] = 0
    return ((1.0 - mask) * -10000.0)[:, None, None, :].astype(np.float32)


def close_to_max(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("heads_major", [True, False])
@pytest.mark.parametrize("T", [21, 16])
def test_heads_major_attention_matches_jax(rng, T, heads_major):
    B, H, D = 2, 4, 16
    shape = (B, H, T, D) if heads_major else (B, T, H, D)
    q, k, v, dout = (rng.randn(*shape).astype(np.float32) for _ in range(4))
    bias = key_bias(B, T)

    def jax_loss(q, k, v):
        out = jfa.flash_attention(q, k, v, jnp.asarray(bias), heads_major=heads_major)
        return jnp.sum(out * jnp.asarray(dout)), out

    (_, out_j), grads_j = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    # the port's op takes q, k, v stacked heads-major into one [B, 3, H, T, D] tensor
    to_hm = (lambda x: x) if heads_major else (lambda x: x.transpose(1, 2))
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out_t = to_hm(fa.flash_attention_heads_major(torch.stack([to_hm(x) for x in leaves], dim=1),
                                                 torch.tensor(bias)))
    out_t.backward(torch.tensor(dout))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), atol=ATOL, rtol=RTOL)
    for got, want in zip(leaves, grads_j):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), atol=GRAD_ATOL, rtol=GRAD_RTOL)


@pytest.mark.parametrize("T", [21, 16])
def test_save_probs_attention_matches_jax(rng, T):
    B, H, D = 2, 4, 16
    F = 3 * H * D
    qkv = rng.randn(B, T, F).astype(np.float32)
    qb = (rng.randn(F) * 0.1).astype(np.float32)
    dout = rng.randn(B, T, H * D).astype(np.float32)
    bias = key_bias(B, T)

    def jax_loss(x, b):
        out = jfa.flash_attention_packed(x, H, jnp.asarray(bias), save_probs=True, qkv_bias=b)
        return jnp.sum(out * jnp.asarray(dout)), out

    (_, out_j), (dx_j, db_j) = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(qkv), jnp.asarray(qb))
    x = torch.tensor(qkv, requires_grad=True)
    b = torch.tensor(qb, requires_grad=True)
    out_t = fa.flash_attention_packed(x, H, torch.tensor(bias), qkv_bias=b, save_probs=True)
    out_t.backward(torch.tensor(dout))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), atol=ATOL, rtol=RTOL)
    close_to_max(x.grad.numpy(), dx_j, SP_GRAD_TOL)
    close_to_max(b.grad.numpy(), db_j, SP_GRAD_TOL)


def test_saved_probs_match_jax(rng):
    """K13's plain version writes the JAX kernel's bf16 probabilities: each
    within one bf16 ulp of its JAX value (fp32 softmaxes computed in another
    order may round to neighbouring bf16 values), rows summing to 1."""
    B, T, H, D = 2, 21, 4, 16
    qkv = rng.randn(B, T, 3 * H * D).astype(np.float32)
    bias = key_bias(B, T)
    _, probs_j = jfa._flash_packed_sp_fwd_impl(jnp.asarray(qkv), jnp.asarray(bias[:, 0, 0, :]), 0.0, H, D,
                                               jnp.zeros((1,), jnp.int32))
    _, probs = fa.packed_attention_sp_fwd(torch.tensor(qkv), torch.tensor(bias[:, 0, 0, :]), H, 0.0, 0)
    assert probs.dtype == torch.bfloat16 and probs.shape == (B, H, T, T)
    got, want = probs.float().numpy(), np.asarray(probs_j, np.float32)
    _, e = np.frexp(np.maximum(np.abs(want), 2.0 ** -126))  # |want| in [2^(e-1), 2^e)
    assert (np.abs(got - want) <= np.maximum(np.ldexp(1.0, e - 8), 2.0 ** -126)).all()
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=T * 2.0 ** -8)


def explicit_attention(q, k, v, bias, keep, rate):
    """softmax(q k^T / sqrt(D) + bias) with the twin's mask, then PV."""
    s = torch.matmul(q, k.transpose(-1, -2)) / np.sqrt(q.shape[-1]) + bias
    return torch.matmul(torch.softmax(s, dim=-1) * keep / (1 - rate), v)


def test_heads_major_dropout_forward_backward_share_the_mask(rng):
    B, H, T, D, rate, seed = 2, 4, 21, 16, 0.2, 77
    qkv = rng.randn(B, 3, H, T, D).astype(np.float32)
    dout = torch.tensor(rng.randn(B, H, T, D).astype(np.float32))
    bias = torch.tensor(key_bias(B, T))
    keep = fa.attention_keep_reference(seed, B, H, T, rate)
    runs = []
    for fn in (lambda x: explicit_attention(*x.unbind(1), bias, keep, rate),
               lambda x: fa.flash_attention_heads_major(x, bias, rate, seed)):
        x = torch.tensor(qkv, requires_grad=True)
        out = fn(x)
        out.backward(dout)
        runs.append((out.detach(), x.grad))
    for a, b in zip(*runs):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=RTOL)


def test_save_probs_dropout_forward_backward_share_the_mask(rng):
    """The forward equals the explicit softmax with the twin's mask; the
    backward (which reads bf16 probabilities) its gradient within 1e-2 of
    the largest value: a mask drawn anew would be off by O(1)."""
    B, H, T, D, rate, seed = 2, 4, 21, 16, 0.2, 5
    qkv = rng.randn(B, T, 3 * H * D).astype(np.float32)
    dout = torch.tensor(rng.randn(B, T, H * D).astype(np.float32))
    bias = torch.tensor(key_bias(B, T))
    keep = fa.attention_keep_reference(seed, B, H, T, rate)
    runs = []
    for fn in (lambda x: fa._merge_heads(explicit_attention(*fa._split_heads(x, H), bias, keep, rate)),
               lambda x: fa.flash_attention_packed(x, H, bias, rate, seed, save_probs=True)):
        x = torch.tensor(qkv, requires_grad=True)
        out = fn(x)
        out.backward(dout)
        runs.append((out.detach(), x.grad))
    (out_e, dx_e), (out_k, dx_k) = runs
    torch.testing.assert_close(out_k, out_e, atol=ATOL, rtol=RTOL)
    close_to_max(dx_k.numpy(), dx_e.numpy(), SP_GRAD_TOL)


@pytest.mark.parametrize("variant", ["heads_major", "save_probs"])
def test_variant_masks_repeat_from_the_seed(rng, variant):
    B, H, T, D, rate = 3, 4, 33, 16, 0.1
    if variant == "heads_major":
        x = torch.tensor(rng.randn(B, 3, H, T, D).astype(np.float32))
        run = lambda seed: fa.heads_major_attention_fwd(x, torch.zeros(B, T), rate, seed)[0]
    else:
        x = torch.tensor(rng.randn(B, T, 3 * H * D).astype(np.float32))
        run = lambda seed: fa.packed_attention_sp_fwd(x, torch.zeros(B, T), H, rate, seed)[0]
    assert torch.equal(run(9), run(9))
    assert not torch.equal(run(9), run(10))
    keep = fa.attention_keep_reference(9, B, H, T, rate)
    n = keep.numel()
    assert abs(keep.float().mean().item() - (1 - rate)) <= 3 * np.sqrt(rate * (1 - rate) / n)


@pytest.mark.parametrize("flags", [dict(packed_qkv=False), dict(flash_save_probs=True)],
                         ids=["packed_qkv_false", "flash_save_probs"])
def test_pretraining_variants_match_jax(rng, flags):
    """Loss and outputs at 2e-5 / 1e-4; every parameter gradient at the same
    bar with the heads-major kernels, and within 1e-2 of its largest JAX
    value with the saved bf16 probabilities."""
    jcfg = JaxConfig(**SMALL, dtype=jnp.float32, use_flash_attention=True, **flags)
    tcfg = VisualBertConfig(**SMALL, dtype=torch.float32, use_flash_attention=True, **flags)
    batch = dict(make_batch(rng, alignment=True), example_weight=np.array([1.0, 1.0, 0.0], np.float32))
    jm = JaxTask(jcfg, head_type="pretraining")
    params = unbox(jm.init(jax.random.PRNGKey(6), batch)["params"])
    jbatch = jax.tree.map(jnp.asarray, batch)

    def loss_fn(p):
        out = jm.apply({"params": p}, jbatch, deterministic=True)
        return out["loss"], out

    (_, out_j), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(params)
    model = load_state(VisualBertForTask(tcfg, "pretraining"), export_state_dict(params, jcfg))
    out_t = model(to_torch(batch))
    out_t["loss"].backward()
    for k in ("loss", "masked_lm_loss", "next_sentence_loss", "mlm_accuracy"):
        np.testing.assert_allclose(float(out_t[k].detach()), float(out_j[k]), atol=ATOL, rtol=RTOL, err_msg=k)
    np.testing.assert_allclose(out_t["logits"].detach().numpy(), out_j["logits"], atol=ATOL, rtol=RTOL)
    want = export_state_dict(grads_j, jcfg)
    for name, p in model.named_parameters():
        if flags.get("flash_save_probs"):
            close_to_max(p.grad.numpy(), want[name], SP_GRAD_TOL)
        else:
            np.testing.assert_allclose(p.grad.numpy(), want[name], atol=ATOL, rtol=RTOL, err_msg=name)


def test_weight_bridge_is_layout_free():
    """The JAX tree stores qkv/kernel [E, 3, H, D] whatever the attention
    layout: the packed and heads-major models have the same parameters, so
    the weight bridge serves both unchanged."""
    batch = make_batch(np.random.RandomState(1))
    trees = [unbox(JaxTask(JaxConfig(**SMALL, dtype=jnp.float32, use_flash_attention=True, packed_qkv=packed),
                           head_type="pretraining").init(jax.random.PRNGKey(0), batch)["params"])
             for packed in (True, False)]
    a, b = (export_state_dict(t, JaxConfig(**SMALL)) for t in trees)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    model = VisualBertForTask(VisualBertConfig(**SMALL, use_flash_attention=True, packed_qkv=False), "pretraining")
    load_state(model, b)  # strict
