"""Flickr30k entity grounding in the port (data/datasets/flickr.py, the
``flickr`` head with ``FlickrAttention``, the ``flickr_attention`` weight
bridge and tasks/registry.py's ``run_flickr`` with its R@1/5/10 dump)
against the JAX package, on the CPU.

Batches are byte-identical to the JAX dataset's, an entity whose boxes all
lie beyond ``max_regions`` included. A Flax ``flickr`` model (params
``bert`` and ``flickr_attention``, no ``cls``) loads into the port with
``strict=True`` through ``export_state_dict`` and
``tools/weights.py::flickr_attention_state``; the head's scores, loss,
accuracy, upper bound, entity count and every parameter gradient agree in
fp32 at atol 2e-5 / rtol 1e-4 with a zero-weight row in the batch. A few
epochs through both registries follow each other within 2e-4. The recall
dump equals the JAX one on a split the eval batch divides; on one it does
not divide, the JAX hook also counts the tail-pad rows (ROADMAP.md C6) and
the port's equals it without them.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualbert_tpu.config import VisualBertConfig as JaxConfig
from visualbert_tpu.data.datasets import flickr as jax_flickr
from visualbert_tpu.data.features import ChunkFeatures as JaxChunkFeatures
from visualbert_tpu.data.pipeline import Batcher as JaxBatcher
from visualbert_tpu.data.tokenization import BertTokenizer as JaxTokenizer
from visualbert_tpu.models.visualbert import VisualBertForTask as JaxTask
from visualbert_tpu.tasks import registry as jax_registry
from visualbert_tpu.tools.export_torch import export_state_dict
from visualbert_tpu.train.trainer import unbox
from visualbert_tpu.utils.config_io import parse_task_config as jax_parse_task_config
from visualbert_torch.config import VisualBertConfig
from visualbert_torch.data.datasets import flickr
from visualbert_torch.data.features import ChunkFeatures
from visualbert_torch.data.pipeline import Batcher
from visualbert_torch.data.tokenization import BertTokenizer
from visualbert_torch.models.heads import FlickrAttention
from visualbert_torch.models.visualbert import VisualBertForTask
from visualbert_torch.tasks import registry
from visualbert_torch.tools.weights import flickr_attention_state, load_state
from visualbert_torch.utils.config_io import load_task_config, parse_task_config
from test_torch_vqa import SMALL, WORDS, assert_same_batches, run_cli, to_torch, tokenizers
from test_torch_vqa_advanced import TINY, port_trainer_from

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL, RTOL = 2e-5, 1e-4


def synthetic_datasets():
    """The synthetic set at 6 kept regions of 8: entities grounded in
    regions 6 and 7 keep their slot with an all-zero label row."""
    t_ours, t_theirs = tokenizers()
    ann, feats = flickr.make_synthetic(30, t_ours, feat_dim=16)
    ann_j, feats_j = jax_flickr.make_synthetic(30, t_theirs, feat_dim=16)
    assert ann == ann_j
    for a in ann:
        assert feats.get(a["image_id"])["features"].tobytes() == feats_j.get(a["image_id"])["features"].tobytes()
    kw = dict(max_seq_length=12, max_regions=6, max_entities=3)
    return flickr.Flickr30kDataset(ann, feats, t_ours, **kw), jax_flickr.Flickr30kDataset(ann_j, feats_j, t_theirs,
                                                                                       **kw)


def handmade_datasets():
    """Words of several wordpieces, a caption cut at max_seq_length (its
    late entities dropped), a word index beyond the caption, more entities
    than max_entities, targets partly and wholly beyond max_regions, and an
    entity with no targets."""
    vocab = {w: i for i, w in enumerate(WORDS + ["##s", "##x"])}
    rng = np.random.RandomState(2)
    chunk = {str(i): {"features": rng.randn(2 + 3 * i, 16).astype(np.float32)} for i in range(4)}
    ann = [
        {"image_id": "0", "words": ["w1s", "w2", "w3x", "w4"],
         "entities": [{"word_index": 0, "region_targets": [0, 1]}, {"word_index": 2, "region_targets": [4, 6]},
                      {"word_index": 9, "region_targets": [1]}]},
        {"image_id": "1", "words": [f"w{k}s" for k in range(8)],
         "entities": [{"word_index": 1, "region_targets": [2]}, {"word_index": 6, "region_targets": [0]}]},
        {"image_id": "2", "words": ["w5", "w6", "w7", "w8", "w9"],
         "entities": [{"word_index": k, "region_targets": [k, k + 5]} for k in range(5)]},
        {"image_id": "3", "words": ["w10", "w11"],
         "entities": [{"word_index": 0, "region_targets": [7, 8]}, {"word_index": 1, "region_targets": []}]},
    ]
    kw = dict(max_seq_length=10, max_regions=5, max_entities=3)
    return (flickr.Flickr30kDataset(ann, ChunkFeatures(chunk), BertTokenizer(vocab), **kw),
            jax_flickr.Flickr30kDataset(ann, JaxChunkFeatures(chunk), JaxTokenizer(vocab), **kw))


@pytest.mark.parametrize("make", [synthetic_datasets, handmade_datasets], ids=["synthetic", "handmade"])
def test_flickr_batches_are_byte_identical_to_jax(make):
    ours, theirs = make()
    tail = dict(shuffle=False, drop_last=False, pad_final=True)
    batchers = [Batcher(ours, 4, seed=3, num_workers=2), JaxBatcher(theirs, 4, seed=3, num_workers=2),
                Batcher(ours, 3, **tail), JaxBatcher(theirs, 3, **tail)]
    try:
        for epoch in (0, 1):
            assert_same_batches(batchers[0].epoch(epoch), batchers[1].epoch(epoch))
        assert_same_batches(batchers[2].epoch(0), batchers[3].epoch(0))
    finally:
        for b in batchers:
            b.close()


def test_handmade_entities_keep_their_slots_and_mass():
    ours, _ = handmade_datasets()
    first = ours[(0, None)]  # "w1 ##s w2 w3 ##x w4": entities at words 0 and 2; word 9 is beyond
    assert list(first["flickr_position"]) == [1, 4, -1]
    np.testing.assert_array_equal(first["label"][0], [0.5, 0.5, 0, 0, 0])
    np.testing.assert_array_equal(first["label"][1], [0, 0, 0, 0, 0.5])  # target 6 is cut, mass stays 1/2
    cut = ours[(1, None)]  # 8 two-piece words, 8 tokens fit: word 6 is cut
    assert list(cut["flickr_position"]) == [3, -1, -1]
    assert list(ours[(2, None)]["flickr_position"]) == [1, 2, 3]  # 5 entities, 3 kept
    empty = ours[(3, None)]  # targets 7, 8 both cut; no targets at all
    assert list(empty["flickr_position"]) == [1, 2, -1] and not empty["label"].any()


def head_batch(rng):
    B, TT, TV, E = 3, 8, 6, 3
    input_mask = np.zeros((B, TT), np.int32)
    for i, n in enumerate((8, 6, 5)):
        input_mask[i, :n] = 1
    image_mask = np.ones((B, TV), np.int32)
    image_mask[1, -2:] = 0
    position = np.array([[1, 3, 5], [2, 4, -1], [1, -1, -1]], np.int32)
    label = np.zeros((B, E, TV), np.float32)
    label[0, 0, [1, 2]] = 0.5
    label[0, 1, 4] = 1.0
    label[0, 2, 0] = 0.5  # half the mass cut away
    label[1, 0, 3] = 1.0  # row 1 (weight 0) adds no entities
    label[2, 0, 5] = 1.0
    return {
        "input_ids": rng.randint(0, len(WORDS), (B, TT)).astype(np.int32),
        "token_type_ids": np.zeros((B, TT), np.int32),
        "input_mask": input_mask,
        "visual_embeddings": rng.randn(B, TV, SMALL["visual_embedding_dim"]).astype(np.float32),
        "image_mask": image_mask,
        "flickr_position": position,
        "label": label,
        "example_weight": np.array([1.0, 0.0, 1.0], np.float32),
    }


def port_state(params, jcfg):
    """A Flax flickr model's params as the port's state dict."""
    sd = export_state_dict(params, jcfg)
    sd.update(flickr_attention_state(params["flickr_attention"]))
    return sd


def test_flax_flickr_model_loads_strict(rng):
    jcfg = JaxConfig(**TINY, dtype=jnp.float32)
    params = JaxTask(jcfg, head_type="flickr").init(jax.random.PRNGKey(0), head_batch(rng))["params"]
    assert sorted(params) == ["bert", "flickr_attention"]  # the Flax cls is never called: no params
    sd = port_state(params, jcfg)
    model = load_state(VisualBertForTask(VisualBertConfig(**TINY, dtype=torch.float32), "flickr"), sd)
    assert not hasattr(model, "cls") and not hasattr(model, "classifier")
    np.testing.assert_array_equal(model.flickr_attention.query.weight.detach().numpy(),
                                  np.asarray(unbox(params)["flickr_attention"]["query"]["kernel"]).T)
    with pytest.raises(RuntimeError):
        load_state(model, {k: v for k, v in sd.items() if not k.startswith("flickr_attention.key")})


@pytest.mark.parametrize("flash", [False, True], ids=["einsum", "flash"])
def test_flickr_head_matches_jax(rng, flash):
    jcfg = JaxConfig(**TINY, dtype=jnp.float32, use_flash_attention=flash)
    tcfg = VisualBertConfig(**TINY, dtype=torch.float32, use_flash_attention=flash)
    batch = head_batch(rng)
    jm = JaxTask(jcfg, head_type="flickr")
    params = unbox(jm.init(jax.random.PRNGKey(3), batch)["params"])
    jbatch = jax.tree.map(jnp.asarray, batch)

    def loss_fn(p):
        out = jm.apply({"params": p}, jbatch, deterministic=True)
        return out["loss"], out

    (_, out_j), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(params)
    model = load_state(VisualBertForTask(tcfg, "flickr"), port_state(params, jcfg))
    out_t = model(to_torch(batch))
    out_t["loss"].backward()
    assert out_t["logits"].dtype == torch.float32 and out_t["logits"].shape == (3, 3, 6)
    np.testing.assert_allclose(out_t["logits"].detach().numpy(), out_j["logits"], atol=ATOL, rtol=RTOL)
    for k in ("loss", "accuracy", "upperbound_accuracy"):
        np.testing.assert_allclose(float(out_t[k].detach()), float(out_j[k]), atol=ATOL, rtol=RTOL, err_msg=k)
    assert int(out_t["entity_num"]) == int(out_j["entity_num"]) == 4
    assert float(out_t["upperbound_accuracy"]) == pytest.approx(3.5 / 4)
    want = export_state_dict(grads_j, jcfg)
    want.update(flickr_attention_state(grads_j["flickr_attention"]))
    names = dict(model.named_parameters())
    assert set(names) == set(want)
    for name, p in names.items():
        # the pooler takes no part in the flickr head: no gradient, zeros in JAX
        assert p.grad is not None or name.startswith("bert.pooler."), name
        got = p.grad.numpy() if p.grad is not None else np.zeros_like(want[name])
        np.testing.assert_allclose(got, want[name], atol=ATOL, rtol=RTOL, err_msg=name)


def test_flickr_attention_sums_bf16_products_in_fp32(rng):
    """In bf16 the scores are fp32 sums of the bf16 query and key
    projections' products, not rounded to bf16."""
    cfg = VisualBertConfig(**TINY, dtype=torch.bfloat16)
    head = FlickrAttention(cfg)
    torch.nn.init.normal_(head.query.weight, std=0.5, generator=torch.Generator().manual_seed(0))
    torch.nn.init.normal_(head.key.weight, std=0.5, generator=torch.Generator().manual_seed(1))
    ent = torch.tensor(rng.randn(2, 3, 64), dtype=torch.bfloat16)
    vis = torch.tensor(rng.randn(2, 5, 64), dtype=torch.bfloat16)
    mask = torch.tensor([[1, 1, 1, 1, 0], [1, 1, 1, 1, 1]])
    with torch.no_grad():
        scores = head(ent, vis, mask)
        q = torch.nn.functional.linear(ent, head.query.weight.bfloat16(), head.query.bias.bfloat16())
        k = torch.nn.functional.linear(vis, head.key.weight.bfloat16(), head.key.bias.bfloat16())
    want = torch.einsum("beh,bvh->bev", q.double(), k.double()) / 4.0  # sqrt(64 / 4 heads)
    assert scores.dtype == torch.float32
    np.testing.assert_allclose(scores[1].numpy(), want[1].numpy(), rtol=1e-5, atol=1e-4)
    assert (scores[0, :, 4] < -9000).all()
    assert not torch.equal(scores[1], scores[1].bfloat16().float())


def raw_config(n=40, epochs=2):
    return {
        "task": "flickr", "data": {"synthetic": n, "max_seq_length": 12, "max_regions": 6, "max_entities": 3},
        "model": dict(TINY, dtype="float32"),
        "optimizer": {"learning_rate": 1e-3, "schedule": "none"},
        "train": {"train_batch_size": 8, "eval_batch_size": 8, "num_train_epochs": epochs, "num_workers": 0},
    }


def jax_flickr_parts(monkeypatch, raw, folder):
    """What the JAX ``run_flickr`` hands its ``_run_fit``, with the state
    it would start from."""
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


def port_flickr_trainer(params, jcfg, cfg):
    return port_trainer_from(params, jcfg, cfg, "flickr", flickr_attention_state(params["flickr_attention"]))


def test_registry_trajectory_follows_jax(tmp_path, monkeypatch):
    """Two epochs of 32 training and 8 eval captions through both
    registries from the JAX run's starting weights: every epoch's train and
    val metrics within 2e-4."""
    raw = raw_config()
    parts = jax_flickr_parts(monkeypatch, raw, tmp_path / "probe")
    start = jax.device_get(parts["state"].params)
    jcfg = parts["cfg"].model
    _, want = jax_registry.run(dataclasses.replace(jax_parse_task_config(raw), folder=str(tmp_path / "jax")))
    cfg = dataclasses.replace(parse_task_config(raw), folder=str(tmp_path / "torch"))
    monkeypatch.setattr(registry, "_trainer", lambda c, model, device: port_flickr_trainer(start, jcfg, c))
    trainer, got = registry.run(cfg, "cpu")
    assert trainer.step == 8 and got.epochs_run == want.epochs_run == 2
    keys = [f"{s}_{k}" for s in ("train", "val") for k in ("loss", "accuracy", "upperbound_accuracy", "entity_num")]
    np.testing.assert_allclose([[h[k] for k in keys] for h in got.history],
                               [[h[k] for k in keys] for h in want.history], rtol=2e-4, atol=2e-4)
    assert got.best_epoch == want.best_epoch


def real_rows(collected):
    """(batch, outputs) pairs without the tail-pad rows of the last batch."""
    out = []
    for batch, o in collected:
        n = int(batch["_real_count"])
        out.append(({k: v[:n] if hasattr(v, "shape") and np.ndim(v) else v for k, v in batch.items()},
                    {k: v[:n] if np.ndim(v) else v for k, v in o.items()}))
    return out


@pytest.mark.parametrize("n,divides", [(40, True), (50, False)], ids=["divides", "tail"])
def test_recall_dump_matches_jax(tmp_path, monkeypatch, n, divides):
    """The same weights through both registries' ``evaluate`` with their own
    dump hooks: R@1/5/10 equal on 8 eval captions (one batch); on 10 (8 + 2
    real and 6 repeated) the JAX hook counts the repeats and the port's
    equals the JAX hook over the real rows."""
    raw = raw_config(n=n)
    parts = jax_flickr_parts(monkeypatch, raw, tmp_path / "probe")
    params = jax.device_get(parts["state"].params)
    seen = []

    def jax_hook(collected, folder):
        seen.extend(collected)
        return parts["dump_hook"](collected, folder)

    jax_eval_b = JaxBatcher(parts["eval_ds"], 8, shuffle=False, drop_last=False, pad_final=True)
    want = jax_registry.evaluate(parts["trainer"], parts["state"], jax_eval_b, jax_hook, str(tmp_path))
    cfg = parse_task_config(raw)
    captured = {}
    monkeypatch.setattr(registry, "_run_fit", lambda c, trainer, tr, ev, **kw: captured.update(kw, eval_ds=ev))
    registry.run(dataclasses.replace(cfg, folder=str(tmp_path / "probe_torch")), "cpu")
    trainer = port_flickr_trainer(params, parts["cfg"].model, cfg)
    eval_b = Batcher(captured["eval_ds"], 8, shuffle=False, drop_last=False, pad_final=True)
    got = registry.evaluate(trainer, eval_b, captured["dump_hook"], str(tmp_path))
    for k in ("loss", "accuracy", "upperbound_accuracy", "entity_num"):
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=RTOL, err_msg=k)
    recalls = [f"recall_at_{k}" for k in (1, 5, 10)]
    real = parts["dump_hook"](real_rows(seen), str(tmp_path))
    assert [got[k] for k in recalls] == [real[k] for k in recalls]
    assert all(0 <= got[k] <= 1 for k in recalls) and got["recall_at_1"] <= got["recall_at_5"] <= got["recall_at_10"]
    if divides:
        assert [got[k] for k in recalls] == [want[k] for k in recalls]
    else:
        entities = [int((np.asarray(b["flickr_position"]) >= 0).sum()) for b, _ in seen]
        real_entities = [int((np.asarray(b["flickr_position"]) >= 0).sum()) for b, _ in real_rows(seen)]
        assert sum(entities) - sum(real_entities) == 12  # 6 repeated captions of 2 entities


def test_cli_trains_flickr_and_eval_only_reproduces_it(tmp_path, capsys):
    """A tiny model with the packed attention (plain K1/K2) and the dropout
    site on, 32 training and 8 eval captions, two epochs: finite losses,
    R@k in [0, 1] and not falling in k; ``--eval_only --restore`` gives the
    last epoch's val_ metrics and the same recalls within 1e-6."""
    raw = raw_config()
    raw["model"] = dict(SMALL, dtype="float32", use_flash_attention=True, fast_dropout=True)
    config = tmp_path / "flickr.json"
    config.write_text(json.dumps(raw))
    trainer, result = run_cli(config, tmp_path / "run")
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    last = result.history[-1]
    assert summary["task"] == "flickr" and summary["epochs_run"] == 2 and trainer.step == 8
    assert np.isfinite(last["train_loss"]) and last["val_entity_num"] > 0

    _, again = run_cli(config, tmp_path / "eval", "--eval_only", "--restore", str(tmp_path / "run" / "ckpt"))
    metrics = again.history[0]
    for k in ("loss", "accuracy", "upperbound_accuracy"):
        assert metrics[k] == pytest.approx(last["val_" + k], abs=1e-6)
    recalls = [metrics[f"recall_at_{k}"] for k in (1, 5, 10)]
    assert all(0 <= r <= 1 for r in recalls) and recalls == sorted(recalls)
    assert recalls[0] == pytest.approx(metrics["accuracy"], abs=1e-6)  # R@1 is the head's accuracy


def test_flickr_real_data_is_not_ported(tmp_path):
    """configs/flickr_finetune.json as shipped reads HDF5 features."""
    cfg = load_task_config(os.path.join(REPO, "configs", "flickr_finetune.json"), {"folder": str(tmp_path)})
    with pytest.raises(NotImplementedError, match="H5Features"):
        registry.run(cfg, "cpu")
