"""visualbert_torch models on the CPU against the JAX package.

JAX params are exported with ``visualbert_tpu.tools.export_torch.export_state_dict``
and loaded into the port with ``strict=True``; both sides then run the same
numpy batch in fp32 with dropout off (atol 2e-5 / rtol 1e-4, the bar the JAX
encoder meets against HF). The JAX attention kernel runs in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualbert_tpu.config import VisualBertConfig as JaxConfig
from visualbert_tpu.models.encoder import VisualBertModel as JaxModel
from visualbert_tpu.models.visualbert import VisualBertForTask as JaxTask
from visualbert_tpu.tools.export_torch import export_state_dict
from visualbert_tpu.train.trainer import unbox
from visualbert_torch.config import VisualBertConfig
from visualbert_torch.models.encoder import VisualBertModel
from visualbert_torch.models.visualbert import VisualBertForTask
from visualbert_torch.tools.weights import load_state

ATOL, RTOL = 2e-5, 1e-4
SMALL = dict(vocab_size=97, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
             intermediate_size=128, max_position_embeddings=64, visual_embedding_dim=24,
             hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
B, TT, TV, A, P = 3, 12, 9, 3, 4  # T = 21


def configs(**kw):
    return JaxConfig(**SMALL, dtype=jnp.float32, **kw), VisualBertConfig(**SMALL, dtype=torch.float32, **kw)


def make_batch(rng, alignment=False):
    input_mask = np.ones((B, TT), np.int32)
    input_mask[0, -3:] = 0
    image_mask = np.ones((B, TV), np.int32)
    image_mask[1, -4:] = 0
    lm = np.full((B, TT), -1, np.int32)
    pos = np.zeros((B, P), np.int32)
    for i in range(B):
        p = np.sort(rng.choice(np.arange(1, TT), size=P, replace=False))
        pos[i] = p
        lm[i, p[:3]] = rng.randint(0, SMALL["vocab_size"], size=3)  # one slot stays -1
    batch = {
        "input_ids": rng.randint(0, SMALL["vocab_size"], (B, TT)).astype(np.int32),
        "token_type_ids": rng.randint(0, 2, (B, TT)).astype(np.int32),
        "input_mask": input_mask,
        "visual_embeddings": rng.randn(B, TV, SMALL["visual_embedding_dim"]).astype(np.float32),
        "image_mask": image_mask,
        "visual_embeddings_type": np.ones((B, TV), np.int32),
        "masked_lm_labels": lm,
        "mlm_positions": pos,
        "is_random_next": rng.randint(0, 2, (B,)).astype(np.int32),
    }
    if alignment:
        ita = rng.randint(-1, TT, (B, TV, A)).astype(np.int32)
        ita[0, 0] = -1  # a region aligned to nothing
        batch["image_text_alignment"] = ita
    return batch


def to_torch(batch):
    return {k: torch.tensor(v).long() if v.dtype.kind == "i" else torch.tensor(v) for k, v in batch.items()}


def assert_close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL, rtol=RTOL)


def test_weight_bridge_loads_strict(rng):
    jcfg, tcfg = configs(bypass_transformer=False)
    batch = make_batch(rng)
    params = unbox(JaxTask(jcfg, head_type="pretraining").init(jax.random.PRNGKey(0), batch)["params"])
    sd = export_state_dict(params, jcfg)
    model = VisualBertForTask(tcfg, "pretraining")
    load_state(model, sd)  # strict: every key matches, every parameter covered
    assert model.cls.predictions.decoder.weight is model.bert.embeddings.word_embeddings.weight
    got = model.state_dict()
    assert set(got) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(got[k].numpy(), v)
    with pytest.raises(RuntimeError):
        load_state(model, {k: v for k, v in sd.items() if "pooler" not in k})


@pytest.mark.parametrize("flash", [True, False])
@pytest.mark.parametrize("alignment", [True, False])
def test_visualbert_model_matches_jax(rng, flash, alignment):
    jcfg, tcfg = configs(use_flash_attention=flash)
    batch = make_batch(rng, alignment)
    mask = np.concatenate([batch["input_mask"], batch["image_mask"]], axis=1)
    ita = batch.get("image_text_alignment")
    args = (batch["input_ids"], batch["token_type_ids"], mask, batch["visual_embeddings"],
            batch["visual_embeddings_type"], ita)
    jm = JaxModel(jcfg)
    params = unbox(jm.init(jax.random.PRNGKey(1), *args)["params"])
    seq_j, pooled_j, _ = jm.apply({"params": params}, *args)
    model = load_state(VisualBertModel(tcfg), export_state_dict({"bert": params}, jcfg, prefix=""))
    t = {k: v for k, v in to_torch(batch).items()}
    with torch.no_grad():
        seq_t, pooled_t, _ = model(t["input_ids"], t["token_type_ids"], torch.tensor(mask), t["visual_embeddings"],
                                t["visual_embeddings_type"], t.get("image_text_alignment"))
    assert_close(seq_t.numpy(), seq_j)
    assert_close(pooled_t.numpy(), pooled_j)


def test_bypass_transformer_matches_jax(rng):
    jcfg, tcfg = configs(use_flash_attention=True, bypass_transformer=True)
    batch = make_batch(rng)
    mask = np.concatenate([batch["input_mask"], batch["image_mask"]], axis=1)
    args = (batch["input_ids"], batch["token_type_ids"], mask, batch["visual_embeddings"], None, None)
    jm = JaxModel(jcfg)
    params = unbox(jm.init(jax.random.PRNGKey(2), *args)["params"])
    seq_j, pooled_j, _ = jm.apply({"params": params}, *args)
    sd = export_state_dict({"bert": params}, jcfg, prefix="")
    # the extra joint layer has the layout of an encoder layer
    extra = export_state_dict({"embeddings": params["embeddings"], "pooler": params["pooler"],
                               "encoder": {"layer_0": params["additional_layer"]}},
                              jcfg.replace(num_hidden_layers=1), prefix="x.")
    sd.update({k.replace("x.encoder.layer.0.", "additional_layer."): v
               for k, v in extra.items() if k.startswith("x.encoder.layer.0.")})
    model = load_state(VisualBertModel(tcfg), sd)
    t = to_torch(batch)
    with torch.no_grad():
        seq_t, pooled_t, _ = model(t["input_ids"], t["token_type_ids"], torch.tensor(mask), t["visual_embeddings"])
    assert_close(seq_t.numpy(), seq_j)
    assert_close(pooled_t.numpy(), pooled_j)


@pytest.mark.parametrize("flash", [True, False])
def test_pretraining_loss_and_grads_match_jax(rng, flash):
    jcfg, tcfg = configs(use_flash_attention=flash)
    batch = make_batch(rng, alignment=True)
    batch["example_weight"] = np.array([1.0, 1.0, 0.0], np.float32)  # a tail-pad duplicate
    jm = JaxTask(jcfg, head_type="pretraining")
    params = unbox(jm.init(jax.random.PRNGKey(3), batch)["params"])
    jbatch = jax.tree.map(jnp.asarray, batch)

    def loss_fn(p):
        out = jm.apply({"params": p}, jbatch, deterministic=True)
        return out["loss"], out

    (_, out_j), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(params)
    model = load_state(VisualBertForTask(tcfg, "pretraining"), export_state_dict(params, jcfg))
    out_t = model(to_torch(batch))
    out_t["loss"].backward()
    for k in ("loss", "masked_lm_loss", "next_sentence_loss", "mlm_accuracy"):
        assert_close(float(out_t[k].detach()), float(out_j[k]))
    assert_close(out_t["logits"].detach().numpy(), out_j["logits"])
    want = export_state_dict(grads_j, jcfg)
    names = dict(model.named_parameters())
    assert set(names) <= set(want)
    for name, p in names.items():
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), want[name], atol=ATOL, rtol=RTOL, err_msg=name)


def test_fused_xent_pretraining_matches_jax(rng):
    """fused_mlm_xent on (the main path's MLM head): loss, masked_lm_loss and
    mlm_accuracy against the JAX model with the flag on (jitted, its Pallas
    xent in interpret mode), and every parameter gradient against the JAX
    model with the flag off, the same fp32 math (the fused JAX op cannot be
    differentiated, ROADMAP.md C1). Neither side returns logits."""
    jcfg, tcfg = configs(use_flash_attention=True, fused_mlm_xent=True)
    batch = make_batch(rng, alignment=True)
    batch["example_weight"] = np.array([1.0, 0.0, 1.0], np.float32)
    jbatch = jax.tree.map(jnp.asarray, batch)
    jm = JaxTask(jcfg, head_type="pretraining")
    params = unbox(jax.jit(jm.init)(jax.random.PRNGKey(5), jbatch)["params"])
    out_j = jax.jit(lambda p: jm.apply({"params": p}, jbatch, deterministic=True))(params)
    unfused = JaxTask(jcfg.replace(fused_mlm_xent=False), head_type="pretraining")
    grads_j = jax.jit(jax.grad(lambda p: unfused.apply({"params": p}, jbatch, deterministic=True)["loss"]))(params)

    model = load_state(VisualBertForTask(tcfg, "pretraining"), export_state_dict(params, jcfg))
    out_t = model(to_torch(batch))
    out_t["loss"].backward()
    assert "logits" not in out_t and "logits" not in out_j
    for k in ("loss", "masked_lm_loss", "next_sentence_loss", "mlm_accuracy"):
        assert_close(float(out_t[k].detach()), float(out_j[k]))
    want = export_state_dict(grads_j, jcfg)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name], atol=ATOL, rtol=RTOL, err_msg=name)


def test_fused_layer_norm_pretraining_matches_jax(rng):
    """use_fused_layer_norm on, dropout off (the K7/K8 branch of every
    sublayer epilogue): loss, outputs and every parameter gradient against
    the JAX model with the flag on, its Pallas LayerNorm in interpret mode."""
    jcfg, tcfg = configs(use_flash_attention=True, use_fused_layer_norm=True)
    batch = make_batch(rng, alignment=True)
    batch["example_weight"] = np.array([1.0, 1.0, 0.0], np.float32)
    jm = JaxTask(jcfg, head_type="pretraining")
    params = unbox(jm.init(jax.random.PRNGKey(4), batch)["params"])
    jbatch = jax.tree.map(jnp.asarray, batch)

    def loss_fn(p):
        out = jm.apply({"params": p}, jbatch, deterministic=True)
        return out["loss"], out

    (_, out_j), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(params)
    model = load_state(VisualBertForTask(tcfg, "pretraining"), export_state_dict(params, jcfg))
    out_t = model(to_torch(batch))
    out_t["loss"].backward()
    for k in ("loss", "masked_lm_loss", "next_sentence_loss", "mlm_accuracy"):
        assert_close(float(out_t[k].detach()), float(out_j[k]))
    assert_close(out_t["logits"].detach().numpy(), out_j["logits"])
    assert_close(out_t["seq_relationship_score"].detach().numpy(), out_j["seq_relationship_score"])
    want = export_state_dict(grads_j, jcfg)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name], atol=ATOL, rtol=RTOL, err_msg=name)
