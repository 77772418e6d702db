"""VQA answer-as-MLM in the port (``VQADataset(advanced=True)``, the
``vqa_advanced`` head, tasks/registry.py's ``run_vqa_advanced`` with its
``out_select`` argmax and prediction dump) against the JAX package, on the
CPU.

Batches are byte-identical to the JAX dataset's. Weights cross over through
``export_state_dict`` (the head is the pretraining ``cls`` with the tied
decoder). In training the port runs the fused cross-entropy's plain K4-K6
and the JAX model the unfused decoder (its fused op cannot be
differentiated, ROADMAP.md C1): loss, MLM loss and accuracy and every
parameter gradient agree in fp32 at atol 2e-5 / rtol 1e-4 with dropout 0.
In evaluation both decode logits. A few epochs through both registries
follow each other within 2e-4. The prediction file equals the JAX file on a
split the eval batch divides; on one it does not divide, the JAX file also
holds the tail-pad rows (ROADMAP.md C6) and the port's is its first entries.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualbert_tpu.config import VisualBertConfig as JaxConfig
from visualbert_tpu.data.datasets import vqa as jax_vqa
from visualbert_tpu.data.features import ChunkFeatures as JaxChunkFeatures
from visualbert_tpu.data.pipeline import Batcher as JaxBatcher
from visualbert_tpu.data.tokenization import BertTokenizer as JaxTokenizer
from visualbert_tpu.models.visualbert import VisualBertForTask as JaxTask
from visualbert_tpu.tasks import registry as jax_registry
from visualbert_tpu.tools.export_torch import export_state_dict
from visualbert_tpu.train.trainer import unbox
from visualbert_tpu.utils.config_io import parse_task_config as jax_parse_task_config
from visualbert_torch.config import VisualBertConfig
from visualbert_torch.data.datasets import vqa
from visualbert_torch.data.features import ChunkFeatures
from visualbert_torch.data.pipeline import Batcher
from visualbert_torch.data.tokenization import BertTokenizer
from visualbert_torch.models.visualbert import VisualBertForTask
from visualbert_torch.tasks import registry
from visualbert_torch.tools.weights import load_state
from visualbert_torch.train.trainer import Trainer
from visualbert_torch.utils.config_io import parse_task_config
from test_torch_vqa import SMALL, WORDS, assert_same_batches, run_cli, to_torch, tokenizers

ATOL, RTOL = 2e-5, 1e-4
TINY = dict(SMALL, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def handmade_datasets():
    """A vocabulary with ## continuations; a question cut to make room for
    the answer, an answer of more wordpieces than max_answer_tokens, one
    with a word outside the vocabulary, one from ``answers`` alone and a
    question with no answer at all."""
    words = WORDS + ["##s", "##x"]
    vocab = {w: i for i, w in enumerate(words)}
    rng = np.random.RandomState(1)
    chunk = {str(i): {"features": rng.randn(3 + i, 16).astype(np.float32)} for i in range(6)}
    ann = [
        {"question_tokens": [f"w{k}" for k in range(20)], "image_id": "0", "answer_str": "w1s w2", "question_id": 7},
        {"question_tokens": ["w3", "w4"], "image_id": "1", "answer_str": "w5 w6s w7x w8", "question_id": 8},
        {"question_tokens": ["w9"], "image_id": "2", "answer_str": "zebra w10", "question_id": 9},
        {"question_tokens": ["w11", "w12", "w13"], "image_id": "3", "answers": ["w14s", "w15"]},
        {"question_tokens": ["w16"], "image_id": "4", "question_id": 11},
        {"question_tokens": ["w17", "w18"], "image_id": "5", "answer_str": "w19", "question_id": 12},
    ]
    kw = dict(max_seq_length=12, max_regions=5, advanced=True)
    return (vqa.VQADataset(ann, ChunkFeatures(chunk), BertTokenizer(vocab), None, **kw),
            jax_vqa.VQADataset(ann, JaxChunkFeatures(chunk), JaxTokenizer(vocab), None, **kw))


def synthetic_datasets():
    t_ours, t_theirs = tokenizers()
    ann, feats, _ = vqa.make_synthetic(40, t_ours, n_answers=8, feat_dim=16)
    ann_j, feats_j, _ = jax_vqa.make_synthetic(40, t_theirs, n_answers=8, feat_dim=16)
    assert ann == ann_j
    kw = dict(max_seq_length=16, max_regions=10, advanced=True)
    return vqa.VQADataset(ann, feats, t_ours, None, **kw), jax_vqa.VQADataset(ann_j, feats_j, t_theirs, None, **kw)


@pytest.mark.parametrize("make", [synthetic_datasets, handmade_datasets], ids=["synthetic", "handmade"])
def test_vqa_advanced_batches_are_byte_identical_to_jax(make):
    ours, theirs = make()
    sample = ours[(0, None)]
    assert {"masked_lm_labels", "mlm_positions"} <= set(sample) and "label" not in sample
    tail = dict(shuffle=False, drop_last=False, pad_final=True)
    batchers = [Batcher(ours, 4, seed=3, num_workers=2), JaxBatcher(theirs, 4, seed=3, num_workers=2),
                Batcher(ours, 4, **tail), JaxBatcher(theirs, 4, **tail)]
    try:
        for epoch in (0, 1):
            assert_same_batches(batchers[0].epoch(epoch), batchers[1].epoch(epoch))
        assert_same_batches(batchers[2].epoch(0), batchers[3].epoch(0))
    finally:
        for b in batchers:
            b.close()


def test_handmade_examples_hold_the_answer_in_mask_slots():
    ours, _ = handmade_datasets()
    vocab = ours.tokenizer.vocab
    cut = ours[(0, None)]  # a 20-word question, a 3-piece answer: 12 = 2 + 6 + ? + 3
    ids = cut["input_ids"]
    assert list(ids[7:12]) == [vocab["?"], vocab["[MASK]"], vocab["[MASK]"], vocab["[MASK]"], vocab["[SEP]"]]
    assert list(cut["mlm_positions"]) == [8, 9, 10, 0]
    assert list(cut["masked_lm_labels"][8:11]) == [vocab["w1"], vocab["##s"], vocab["w2"]]
    assert (cut["masked_lm_labels"][cut["mlm_positions"][3]] == -1)  # the pad slot points at [CLS]
    long = ours[(1, None)]  # 5 answer pieces, 4 kept
    assert (long["mlm_positions"] > 0).all() and (long["masked_lm_labels"] != -1).sum() == 4
    assert vocab["[UNK]"] in ours[(2, None)]["masked_lm_labels"]  # "zebra"
    assert (ours[(4, None)]["masked_lm_labels"] == -1).all()  # no answer, no slot


def head_batch(rng):
    B, TT, TV, P = 3, 10, 6, 4
    input_mask = np.zeros((B, TT), np.int32)
    lm = np.full((B, TT), -1, np.int32)
    pos = np.zeros((B, P), np.int32)
    for i, (n, n_ans) in enumerate(((10, 3), (7, 1), (6, 2))):
        input_mask[i, :n] = 1
        slots = np.arange(n - 1 - n_ans, n - 1)  # the answer's [MASK]s before [SEP]
        lm[i, slots] = rng.randint(6, len(WORDS), n_ans)
        pos[i, :n_ans] = slots
    image_mask = np.ones((B, TV), np.int32)
    image_mask[2, -2:] = 0
    return {
        "input_ids": rng.randint(0, len(WORDS), (B, TT)).astype(np.int32),
        "token_type_ids": np.zeros((B, TT), np.int32),
        "input_mask": input_mask,
        "visual_embeddings": rng.randn(B, TV, SMALL["visual_embedding_dim"]).astype(np.float32),
        "image_mask": image_mask,
        "masked_lm_labels": lm,
        "mlm_positions": pos,
        "example_weight": np.array([1.0, 0.0, 1.0], np.float32),  # a tail-pad duplicate
    }


def jax_params(jcfg, batch, seed):
    return unbox(JaxTask(jcfg, head_type="vqa_advanced").init(jax.random.PRNGKey(seed), batch)["params"])


@pytest.mark.parametrize("kernels", [False, True], ids=["einsum", "flash_fused_ln"])
def test_vqa_advanced_training_matches_jax(rng, kernels):
    """Train mode (a dropout generator given, rates 0): the port's fused
    cross-entropy (plain K4-K6 here) against the JAX unfused decoder."""
    kw = dict(use_flash_attention=kernels, use_fused_layer_norm=kernels)
    jcfg = JaxConfig(**TINY, dtype=jnp.float32, fused_mlm_xent=False, **kw)
    tcfg = VisualBertConfig(**TINY, dtype=torch.float32, fused_mlm_xent=True, **kw)
    batch = head_batch(rng)
    params = jax_params(jcfg, batch, 2)
    jm = JaxTask(jcfg, head_type="vqa_advanced")
    jbatch = jax.tree.map(jnp.asarray, batch)

    def loss_fn(p):
        out = jm.apply({"params": p}, jbatch, deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)})
        return out["loss"], out

    (_, out_j), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(params)
    model = load_state(VisualBertForTask(tcfg, "vqa_advanced"), export_state_dict(params, jcfg))
    assert model.cls.predictions.decoder.weight is model.bert.embeddings.word_embeddings.weight
    out_t = model(to_torch(batch), torch.Generator().manual_seed(0))
    out_t["loss"].backward()
    assert "logits" not in out_t and "next_sentence_loss" not in out_t and "next_sentence_loss" not in out_j
    for k in ("loss", "masked_lm_loss", "mlm_accuracy"):
        np.testing.assert_allclose(float(out_t[k].detach()), float(out_j[k]), atol=ATOL, rtol=RTOL, err_msg=k)
    want = export_state_dict(grads_j, jcfg)
    names = dict(model.named_parameters())
    assert set(names) <= set(want)
    for name, p in names.items():
        # the pooler and the alignment classifier take no part: no gradient here, zeros in JAX
        assert p.grad is not None or name.startswith(("bert.pooler.", "cls.seq_relationship.")), name
        got = p.grad.numpy() if p.grad is not None else np.zeros_like(want[name])
        np.testing.assert_allclose(got, want[name], atol=ATOL, rtol=RTOL, err_msg=name)


def test_vqa_advanced_evaluation_matches_jax(rng):
    """Eval mode: both sides decode the gathered slots' [B, P, V] logits,
    the fused flag on (JAX's fused op runs only in training)."""
    jcfg = JaxConfig(**TINY, dtype=jnp.float32, fused_mlm_xent=True, use_flash_attention=True)
    tcfg = VisualBertConfig(**TINY, dtype=torch.float32, fused_mlm_xent=True, use_flash_attention=True)
    batch = head_batch(rng)
    params = jax_params(jcfg, batch, 3)
    out_j = JaxTask(jcfg, head_type="vqa_advanced").apply({"params": params}, jax.tree.map(jnp.asarray, batch))
    model = load_state(VisualBertForTask(tcfg, "vqa_advanced"), export_state_dict(params, jcfg))
    with torch.no_grad():
        out_t = model(to_torch(batch))
    assert out_t["logits"].shape == (3, 4, len(WORDS))
    np.testing.assert_allclose(out_t["logits"].numpy(), out_j["logits"], atol=ATOL, rtol=RTOL)
    for k in ("loss", "masked_lm_loss", "mlm_accuracy"):
        np.testing.assert_allclose(float(out_t[k]), float(out_j[k]), atol=ATOL, rtol=RTOL, err_msg=k)


def raw_config(n=40, fused=True, epochs=2):
    return {
        "task": "vqa_advanced", "data": {"synthetic": n, "max_seq_length": 12, "max_regions": 6},
        "model": dict(TINY, dtype="float32", fused_mlm_xent=fused),
        "optimizer": {"learning_rate": 1e-3, "schedule": "none"},
        "train": {"train_batch_size": 8, "eval_batch_size": 8, "num_train_epochs": epochs, "num_workers": 0},
    }


def jax_task_parts(monkeypatch, raw, folder):
    """What the JAX ``run_vqa_advanced`` hands its ``_run_fit``: trainer,
    datasets, dump hook and out_select, with the state it would start from."""
    parts = {}

    def capture(cfg, trainer, train_ds, eval_ds, **kw):
        parts.update(kw, cfg=cfg, trainer=trainer, train_ds=train_ds, eval_ds=eval_ds)
        return None, None

    with monkeypatch.context() as m:
        m.setattr(jax_registry, "_run_fit", capture)
        jax_registry.run(dataclasses.replace(jax_parse_task_config(raw), folder=str(folder)))
    example = next(iter(JaxBatcher(parts["train_ds"], 8, seed=parts["cfg"].train.seed).epoch(0)))
    parts["state"] = parts["trainer"].init_state(jax.random.PRNGKey(parts["cfg"].train.seed), example)
    return parts


class ExportedStart(Trainer):
    """A Trainer whose ``init_state`` keeps the weights loaded into its
    model, so that the registry's ``_run_fit`` starts from them."""

    def init_state(self, init_weights: bool = True):
        return super().init_state(init_weights=False)


def port_trainer_from(params, jcfg, cfg, head_type="vqa_advanced", state=None):
    sd = export_state_dict(params, jcfg)
    sd.update(state or {})
    model = load_state(VisualBertForTask(cfg.model, head_type), sd)
    return ExportedStart(model, cfg.optimizer, cfg.train, device="cpu").init_state()


def test_registry_trajectory_follows_jax(tmp_path, monkeypatch):
    """Two epochs of 32 training and 8 eval questions through both
    registries from the JAX run's starting weights: every epoch's train and
    val metrics within 2e-4; the best metric is val_mlm_accuracy."""
    jraw, raw = raw_config(fused=False), raw_config(fused=True)
    parts = jax_task_parts(monkeypatch, jraw, tmp_path / "probe")
    start = jax.device_get(parts["state"].params)
    jcfg = parts["cfg"].model
    _, want = jax_registry.run(dataclasses.replace(jax_parse_task_config(jraw), folder=str(tmp_path / "jax")))

    cfg = dataclasses.replace(parse_task_config(raw), folder=str(tmp_path / "torch"))
    monkeypatch.setattr(registry, "_trainer", lambda c, model, device: port_trainer_from(start, jcfg, c))
    trainer, got = registry.run(cfg, "cpu")
    assert trainer.step == 8 and got.epochs_run == want.epochs_run == 2
    keys = ("train_loss", "train_masked_lm_loss", "train_mlm_accuracy", "val_loss", "val_masked_lm_loss",
            "val_mlm_accuracy")
    np.testing.assert_allclose([[h[k] for k in keys] for h in got.history],
                               [[h[k] for k in keys] for h in want.history], rtol=2e-4, atol=2e-4)
    assert got.best_metric == max(h["val_mlm_accuracy"] for h in got.history)
    assert got.best_epoch == want.best_epoch


@pytest.mark.parametrize("n,divides", [(40, True), (50, False)], ids=["divides", "tail"])
def test_prediction_dump_matches_jax(tmp_path, monkeypatch, n, divides):
    """The same weights through both registries' ``evaluate`` with their own
    out_select and dump hook: 8 eval questions (one batch) give equal files;
    10 (8 + 2 real and 6 repeated) give the JAX file 16 entries and the
    port's its first 10."""
    parts = jax_task_parts(monkeypatch, raw_config(n=n), tmp_path / "probe")
    params = jax.device_get(parts["state"].params)
    (tmp_path / "jax").mkdir()
    jax_eval_b = JaxBatcher(parts["eval_ds"], 8, shuffle=False, drop_last=False, pad_final=True)
    want = jax_registry.evaluate(parts["trainer"], parts["state"], jax_eval_b, parts["dump_hook"],
                                 str(tmp_path / "jax"), out_select=parts["out_select"])

    cfg = parse_task_config(raw_config(n=n))
    captured = {}
    monkeypatch.setattr(registry, "_run_fit", lambda c, trainer, tr, ev, **kw: captured.update(kw, eval_ds=ev))
    registry.run(dataclasses.replace(cfg, folder=str(tmp_path / "probe_torch")), "cpu")
    assert captured["val_metric"] == "mlm_accuracy"
    trainer = port_trainer_from(params, parts["cfg"].model, cfg)
    (tmp_path / "torch").mkdir()
    eval_b = Batcher(captured["eval_ds"], 8, shuffle=False, drop_last=False, pad_final=True)
    got = registry.evaluate(trainer, eval_b, captured["dump_hook"], str(tmp_path / "torch"),
                            captured["out_select"])
    for k in ("loss", "masked_lm_loss", "mlm_accuracy"):
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=RTOL, err_msg=k)
    ours = json.loads((tmp_path / "torch" / "vqa_advanced_predictions.json").read_text())
    theirs = json.loads((tmp_path / "jax" / "vqa_advanced_predictions.json").read_text())
    n_eval = n - int(n * 0.8)
    assert [p["question_id"] for p in ours] == list(range(n - n_eval, n))
    assert all(p["answer"] for p in ours)
    if divides:
        assert ours == theirs
    else:
        assert len(theirs) == 16 and ours == theirs[:n_eval]
        assert [p["question_id"] for p in theirs[n_eval:]] == [n - 2, n - 1] * 3  # the last batch's rows again


def test_out_select_takes_the_argmax_on_the_device():
    logits = torch.randn(2, 3, 7)
    out = registry.vqa_advanced_select({"logits": logits, "loss": torch.tensor(1.0)})
    assert set(out) == {"pred_ids", "loss"}
    assert torch.equal(out["pred_ids"], logits.argmax(-1))


def test_cli_trains_vqa_advanced_and_eval_only_reproduces_it(tmp_path, capsys):
    """A tiny model, fused cross-entropy (plain K4-K6), 32 training and 8
    eval questions, two epochs: the run writes its checkpoint and
    vqa_advanced_predictions.json; ``--eval_only --restore`` gives the last
    epoch's val_ metrics within 1e-6 and the same file."""
    config = tmp_path / "vqa_advanced.json"
    config.write_text(json.dumps(raw_config()))
    trainer, result = run_cli(config, tmp_path / "run")
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    last = result.history[-1]
    assert summary["task"] == "vqa_advanced" and summary["epochs_run"] == 2 and trainer.step == 8
    assert summary["best_metric"] == max(h["val_mlm_accuracy"] for h in result.history)
    assert np.isfinite(last["train_loss"]) and "train_next_sentence_loss" not in last
    preds = json.loads((tmp_path / "run" / "vqa_advanced_predictions.json").read_text())
    assert [p["question_id"] for p in preds] == list(range(32, 40))

    _, again = run_cli(config, tmp_path / "eval", "--eval_only", "--restore", str(tmp_path / "run" / "ckpt"))
    assert again.epochs_run == 0 and again.best_metric == pytest.approx(last["val_mlm_accuracy"], abs=1e-6)
    for k in ("loss", "masked_lm_loss", "mlm_accuracy"):
        assert again.history[0][k] == pytest.approx(last["val_" + k], abs=1e-6)
    assert json.loads((tmp_path / "eval" / "vqa_advanced_predictions.json").read_text()) == preds
