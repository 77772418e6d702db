"""The unsupervised stack's models in the port (``UnsupervisedVisualBert``,
``UnsupervisedVQAModel``), their weight bridge ``unsupervised_state`` and
their weight-decay decision, against the JAX package on the CPU.

Weights cross over from a JAX init through ``unsupervised_state``. In fp32
with dropout 0, the forward outputs, every loss and every parameter
gradient agree at atol 2e-5 / rtol 1e-4 on V&L, text-only and image-only
batches, with the symbolic tag head and with ``use_bert_input_for_tags``,
with the QA head, through the einsum attention and through the attention
kernels' plain versions. The fused cross-entropy's forward is held against
JAX's fused op (its Pallas kernels in interpret mode); its gradients against
JAX unfused, since JAX cannot differentiate its fused op (ROADMAP.md C1).
The decay decision of every parameter equals JAX's on the Flax path
(ROADMAP.md C9)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualbert_tpu.config import VisualBertConfig as JaxConfig
from visualbert_tpu.models import unsupervised as jax_unsup
from visualbert_tpu.tools.import_torch import convert_lxrt_state_dict
from visualbert_tpu.train.optimizer import default_decay_mask
from visualbert_tpu.train.trainer import unbox
from visualbert_torch.config import OptimizerConfig, VisualBertConfig
from visualbert_torch.models import unsupervised as unsup
from visualbert_torch.tools.weights import load_state, unsupervised_state
from visualbert_torch.train.optimizer import BertAdam, decays

ATOL, RTOL = 2e-5, 1e-4
V, F, N_OBJ, N_ATTR, N_SYM, N_ANS = 45, 16, 20, 8, 31, 8
TINY = dict(vocab_size=V, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def configs(kernels=False, fused=False, **kw):
    """(JAX, port) UnsupervisedConfig at the tiny width, fp32."""
    flags = dict(use_flash_attention=kernels, fast_dropout=kernels, fused_mlm_xent=fused)
    sizes = dict(visual_feat_dim=F, obj_id_num=N_OBJ, attr_id_num=N_ATTR, symbolic_vocab_size=N_SYM,
                 num_answers=N_ANS, **kw)
    return (jax_unsup.UnsupervisedConfig(bert=JaxConfig.tiny(**TINY, **flags), **sizes),
            unsup.UnsupervisedConfig(bert=VisualBertConfig.tiny(**TINY, **flags), **sizes))


def make_batch(streams="vl", bert_tags=False, seed=0, B=3, T=7, N=4):
    """A batch of the given streams ("vl", "text" or "image") with padded
    text, a padded region, -1 labels and a row without an answer."""
    rng = np.random.default_rng(seed)
    batch = {}
    if streams in ("vl", "text"):
        mask = np.ones((B, T), np.int32)
        mask[1, 5:] = 0
        lm = np.where(rng.random((B, T)) < 0.3, rng.integers(0, V, (B, T)), -1).astype(np.int32)
        lm[0, 2] = 7
        batch.update(input_ids=rng.integers(0, V, (B, T)).astype(np.int32), input_mask=mask,
                     token_type_ids=(np.arange(T) >= 4).astype(np.int32)[None].repeat(B, 0),
                     masked_lm_labels=lm, matched_label=rng.integers(0, 2, B).astype(np.int32),
                     ans=np.array([1, -1, 3], np.int32)[:B])
    if streams in ("vl", "image"):
        fm = (rng.random((B, N)) < 0.5).astype(np.float32)
        fm[0, 0] = 1.0
        n_tag = V if bert_tags else N_SYM
        vmask = np.ones((B, N), np.int32)
        vmask[2, -1] = 0
        batch.update(
            visual_feats=rng.normal(size=(B, N, F)).astype(np.float32), boxes=rng.random((B, N, 4)).astype(np.float32),
            visual_feats_mask=vmask,
            obj_labels=np.where(fm > 0, rng.integers(0, N_OBJ, (B, N)), -1).astype(np.int32), obj_conf=fm,
            attr_labels=np.where(fm > 0, rng.integers(0, N_ATTR, (B, N)), -1).astype(np.int32), attr_conf=fm * 0.5,
            feat_target=rng.normal(size=(B, N, F)).astype(np.float32), feat_mask=fm,
            visual_tags=rng.integers(0, n_tag, (B, N)).astype(np.int32),
            visual_tags_box=rng.random((B, N, 4)).astype(np.float32), visual_tags_mask=vmask,
            visual_tags_objective=np.where(rng.random((B, N)) < 0.5, rng.integers(0, n_tag, (B, N)),
                                           -1).astype(np.int32))
    return batch


def to_torch(batch):
    return {k: torch.as_tensor(v).long() if v.dtype.kind == "i" else torch.as_tensor(v) for k, v in batch.items()}


def jax_params(model, bert_tags=False, seed=0):
    """A JAX init from a V&L batch: the whole tree, as the registry's."""
    batch = jax.tree.map(jnp.asarray, make_batch("vl", bert_tags))
    if isinstance(model, jax_unsup.UnsupervisedVQAModel):
        batch = vqa_batch()
    return unbox(model.init(jax.random.PRNGKey(seed), jax.tree.map(jnp.asarray, batch))["params"])


def jax_run(model, params, batch, grads=True):
    jbatch = jax.tree.map(jnp.asarray, batch)

    def loss_fn(p):
        out = model.apply({"params": p}, jbatch, deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)})
        return out["loss"], out

    if not grads:
        return jax.jit(loss_fn)(params)[1], None
    (_, out), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return out, g


def port_run(model, batch, backward=True):
    out = model(to_torch(batch), torch.Generator().manual_seed(0))
    if backward:
        out["loss"].backward()
    return out


def assert_outputs(out_t, out_j, absent=()):
    assert set(out_t) == set(out_j), (sorted(out_t), sorted(out_j))
    for k in out_j:
        np.testing.assert_allclose(np.asarray(out_t[k].detach()), np.asarray(out_j[k]), atol=ATOL, rtol=RTOL,
                                   err_msg=k)
    for k in absent:
        assert k not in out_t, k


def assert_grads(model, grads_j):
    want = unsupervised_state(grads_j)
    names = dict(model.named_parameters())
    for name, p in names.items():
        got = p.grad.numpy() if p.grad is not None else np.zeros_like(want[name])
        np.testing.assert_allclose(got, want[name], atol=ATOL, rtol=RTOL, err_msg=name)
    return names


CASES = [("vl", False, {}), ("text", False, {}), ("image", False, {}), ("vl", True, {}), ("text", True, {}),
         ("image", True, {}), ("vl", False, dict(task_qa=True)), ("vl", False, dict(joint_layer_norm=True,
                                                                                      divide_by_2=False))]
IDS = ["vl", "text", "image", "vl_bert_tags", "text_bert_tags", "image_bert_tags", "vl_qa", "vl_joint_ln"]


@pytest.mark.parametrize("streams,bert_tags,kw", CASES, ids=IDS)
def test_forward_losses_and_gradients_match_jax(streams, bert_tags, kw):
    jcfg, tcfg = configs(use_bert_input_for_tags=bert_tags, **kw)
    jm = jax_unsup.UnsupervisedVisualBert(jcfg)
    params = jax_params(jm, bert_tags)
    batch = make_batch(streams, bert_tags)
    out_j, grads_j = jax_run(jm, params, batch)
    model = load_state(unsup.UnsupervisedVisualBert(tcfg), unsupervised_state(params))
    out_t = port_run(model, batch)
    assert_outputs(out_t, out_j)
    want = {"vl": {"masked_lm_loss", "matched_loss", "obj_loss", "masked_tag_loss"},
            "text": {"masked_lm_loss", "matched_loss", "mlm_logits"}, "image": {"obj_loss", "feat_loss"}}[streams]
    assert want <= set(out_t)
    if streams == "image":
        assert "masked_lm_loss" not in out_t and "matched_logits" not in out_t
    if kw.get("task_qa"):
        assert {"qa_loss", "qa_accuracy", "answer_logits"} <= set(out_t)
    names = assert_grads(model, grads_j)
    word_grad = names["bert.embeddings.word_embeddings.weight"].grad
    assert (word_grad is None) == (streams == "image" and not bert_tags)


def test_attention_kernels_plain_versions_match_jax():
    """use_flash_attention and fast_dropout on both sides (JAX's Pallas
    kernels in interpret mode, the port's plain K1/K2 and dropout sites),
    T = 7 + 4 + 4 ragged, train mode at rate 0."""
    jcfg, tcfg = configs(kernels=True)
    jm = jax_unsup.UnsupervisedVisualBert(jcfg)
    params = jax_params(jm)
    batch = make_batch("vl")
    out_j, grads_j = jax_run(jm, params, batch)
    model = load_state(unsup.UnsupervisedVisualBert(tcfg), unsupervised_state(params))
    assert_outputs(port_run(model, batch), out_j)
    assert_grads(model, grads_j)


@pytest.mark.parametrize("streams", ["vl", "text"])
def test_fused_xent_forward_matches_jax_fused(streams):
    """The fused cross-entropy over all B*T text rows (-1 labels included):
    the port's plain K4 against JAX's fused op in interpret mode, every
    output but the logits neither side makes."""
    jcfg, tcfg = configs(fused=True)
    jm = jax_unsup.UnsupervisedVisualBert(jcfg)
    params = jax_params(jm)
    batch = make_batch(streams)
    out_j, _ = jax_run(jm, params, batch, grads=False)
    model = load_state(unsup.UnsupervisedVisualBert(tcfg), unsupervised_state(params))
    with torch.no_grad():
        out_t = model(to_torch(batch))
    assert_outputs(out_t, out_j, absent=("mlm_logits",))


@pytest.mark.parametrize("streams", ["vl", "text"])
def test_fused_xent_gradients_match_jax_unfused(streams):
    """The port's training path (plain K4-K6, their gradients) against the
    JAX model with fused_mlm_xent off (C1)."""
    jcfg, _ = configs(fused=False)
    _, tcfg = configs(fused=True)
    jm = jax_unsup.UnsupervisedVisualBert(jcfg)
    params = jax_params(jm)
    batch = make_batch(streams)
    out_j, grads_j = jax_run(jm, params, batch)
    model = load_state(unsup.UnsupervisedVisualBert(tcfg), unsupervised_state(params))
    out_t = port_run(model, batch)
    assert "mlm_logits" not in out_t
    out_j = {k: v for k, v in out_j.items() if k != "mlm_logits"}
    assert_outputs(out_t, out_j)
    assert_grads(model, grads_j)


def vqa_batch(seed=1, B=4, T=6, N=5):
    rng = np.random.default_rng(seed)
    target = np.zeros((B, N_ANS), np.float32)
    target[np.arange(B), rng.integers(0, N_ANS, B)] = 1.0
    target[1, 2] = 0.3
    mask = np.ones((B, T), np.int32)
    mask[0, 4:] = 0
    return {
        "input_ids": rng.integers(0, V, (B, T)).astype(np.int32), "token_type_ids": np.zeros((B, T), np.int32),
        "input_mask": mask, "visual_feats": rng.normal(size=(B, N, F)).astype(np.float32),
        "boxes": rng.random((B, N, 4)).astype(np.float32), "visual_feats_mask": np.ones((B, N), np.int32),
        "visual_tags": rng.integers(0, N_SYM, (B, N)).astype(np.int32),
        "visual_tags_box": rng.random((B, N, 4)).astype(np.float32), "visual_tags_mask": np.ones((B, N), np.int32),
        "target": target, "example_weight": np.array([1.0, 1.0, 0.0, 1.0], np.float32),
    }


@pytest.mark.parametrize("weighted", [True, False])
def test_vqa_model_forward_and_gradients_match_jax(weighted):
    jcfg, tcfg = configs()
    jm = jax_unsup.UnsupervisedVQAModel(jcfg)
    params = jax_params(jm)
    batch = vqa_batch()
    if not weighted:
        del batch["example_weight"]
    out_j, grads_j = jax_run(jm, params, batch)
    model = load_state(unsup.UnsupervisedVQAModel(tcfg), unsupervised_state(params))
    out_t = port_run(model, batch)
    assert set(out_t) == {"logits", "loss", "accuracy"}
    assert_outputs(out_t, out_j)
    names = assert_grads(model, grads_j)
    # the trunk's heads are in the tree and take no part
    assert names["cls.seq_relationship.weight"].grad is None and "answer_head.logit_fc.3.weight" in names
    assert not hasattr(model, "obj_predict_head") and not hasattr(model, "symbolic_head")


@pytest.mark.parametrize("scan_layers", [True, False], ids=["stacked", "per_layer"])
def test_unsupervised_state_inverts_convert_lxrt_state_dict(scan_layers):
    """JAX's importer of the reference's LXRT checkpoints takes the port's
    state dict back to the Flax tree it came from, leaf for leaf, for both
    models and both encoder layouts."""
    for model_cls, extra in ((jax_unsup.UnsupervisedVisualBert, dict(task_qa=True)),
                             (jax_unsup.UnsupervisedVQAModel, {})):
        jcfg, _ = configs(**extra)
        jcfg = jcfg.replace(bert=jcfg.bert.replace(scan_layers=scan_layers))
        params = jax_params(model_cls(jcfg))
        state = unsupervised_state(params)
        tree = convert_lxrt_state_dict(state, jcfg)
        if model_cls is jax_unsup.UnsupervisedVQAModel:
            tree = {"answer_head": tree.pop("answer_head"), "trunk": tree}
        flat_want = jax.tree_util.tree_flatten_with_path(params)[0]
        flat_got = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
        assert len(flat_got) == len(flat_want)
        for path, leaf in flat_want:
            np.testing.assert_array_equal(flat_got[path], np.asarray(leaf), err_msg=str(path))


@pytest.mark.parametrize("model_name,kw", [("UnsupervisedVisualBert", dict(task_qa=True)),
                                           ("UnsupervisedVisualBert", dict(use_bert_input_for_tags=True)),
                                           ("UnsupervisedVQAModel", {})], ids=["pretrain_qa", "bert_tags", "vqa"])
@pytest.mark.parametrize("no_decay", [(), ("bias", "layer_norm", "LayerNorm")], ids=["mask_only", "config_default"])
def test_decay_decision_equals_jax_on_every_parameter(model_name, kw, no_decay):
    """C9: BertAdam's decay decision on each port parameter equals JAX's on
    its Flax leaf (``default_decay_mask``, then the config's ``no_decay``
    substrings as ``from_config`` applies them); the torch names alone
    would get ``answer_head``'s LayerNorm scale wrong, and with no
    ``no_decay`` the MLM and tag output biases too."""
    jcfg, tcfg = configs(**kw)
    params = jax_params(getattr(jax_unsup, model_name)(jcfg), kw.get("use_bert_input_for_tags", False))
    extra = tuple(s.lower() for s in no_decay)
    flat = {"/".join(str(k.key) for k in path): m and not any(s in "/".join(str(k.key) for k in path).lower()
                                                               for s in extra)
            for path, m in jax.tree_util.tree_flatten_with_path(default_decay_mask(params))[0]}
    model = getattr(unsup, model_name)(tcfg)
    opt = BertAdam(model.named_parameters(), OptimizerConfig(no_decay=no_decay), decay=model.decays)
    seen = set()
    for name in opt.params:
        path = unsup.flax_path(name)
        if model_name == "UnsupervisedVQAModel" and not path.startswith("answer_head/"):
            path = "trunk/" + path
        assert path in flat, (name, path)
        assert opt.decay[name] == flat[path], (name, path)
        seen.add(path)
    assert seen == set(flat)
    # where the port's names alone decide otherwise
    differs = {n for n in opt.params if decays(n, no_decay) != opt.decay[n]}
    want = {"answer_head.logit_fc.2.weight"} if hasattr(model, "answer_head") else set()
    if not no_decay:
        want.add("cls.predictions.bias")
        if hasattr(model, "symbolic_head"):
            want.add("symbolic_head.predictions.bias")
    assert differs == want


def test_trainer_hands_the_model_decision_to_bert_adam():
    from visualbert_torch.config import TrainConfig
    from visualbert_torch.train.trainer import Trainer

    _, tcfg = configs(task_qa=True)
    trainer = Trainer(unsup.UnsupervisedVisualBert(tcfg), OptimizerConfig(no_decay=()), TrainConfig(seed=0),
                      device="cpu").init_state()
    d = trainer.optimizer.decay
    assert d["cls.predictions.bias"] and d["symbolic_head.predictions.bias"]
    assert not d["answer_head.logit_fc.2.weight"] and not d["bert.embeddings.LayerNorm.weight"]
    assert d["bert.encoder.layer.0.attention.self.query.weight"] and not d["answer_head.logit_fc.0.bias"]


def test_init_weights_seeded_and_tied():
    _, tcfg = configs(task_qa=True)
    a = unsup.UnsupervisedVisualBert(tcfg).init_weights(torch.Generator().manual_seed(3))
    b = unsup.UnsupervisedVisualBert(tcfg).init_weights(torch.Generator().manual_seed(3))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    assert a.cls.predictions.decoder.weight is a.bert.embeddings.word_embeddings.weight
    assert a.symbolic_head.predictions.decoder.weight is a.bert.embeddings.symbolic_embedding.weight
    assert torch.equal(a.answer_head.logit_fc[2].weight, torch.ones(2 * tcfg.bert.hidden_size))
    assert not a.cls.predictions.bias.any() and not a.answer_head.logit_fc[3].bias.any()
    std = float(a.bert.embeddings.symbolic_embedding.weight.detach().std())
    assert 0.01 < std < 0.03


def test_attention_probabilities_on_request():
    _, tcfg = configs()
    model = unsup.UnsupervisedVisualBert(tcfg).init_weights(torch.Generator().manual_seed(0))
    batch = to_torch(make_batch("vl"))
    with torch.no_grad():
        out = model(batch, output_attention_probs=True)
    L, H = tcfg.bert.num_hidden_layers, tcfg.bert.num_attention_heads
    assert out["attention_weights"].shape == (L, 3, H, 15, 15)
    torch.testing.assert_close(out["attention_weights"].sum(-1), torch.ones(L, 3, H, 15))
