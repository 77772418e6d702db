"""Attention-probability collection and the ``flickr_probe`` task in the
port (models/encoder.py's collection, tasks/probing.py, the trainer's
``eval_step(output_attention_probs=True)`` and tasks/registry.py's
``run_flickr_probe``) against the JAX package, on the CPU.

The ``[L, B, H, T, T]`` probabilities, asked for by the caller or by
``cfg.output_attention_weights``, are the fp32 softmax before the cast and
the dropout, and agree with the JAX encoder's in fp32 at atol 2e-5 / rtol
1e-4; with ``use_flash_attention`` the collecting layers take the einsum
path, so the outputs equal the einsum model's bit for bit. The on-device
gather equals the JAX package's numpy ``entity_region_attention`` exactly,
and ``flickr_probe.json`` equals the JAX probe's on the same weights and
split, a split the eval batch does not divide included.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualbert_tpu.config import VisualBertConfig as JaxConfig
from visualbert_tpu.models.encoder import VisualBertModel as JaxModel
from visualbert_tpu.models.visualbert import VisualBertForTask as JaxTask
from visualbert_tpu.tasks import probing as jax_probing
from visualbert_tpu.tasks import registry as jax_registry
from visualbert_tpu.tools.export_torch import export_state_dict
from visualbert_tpu.train.trainer import unbox
from visualbert_tpu.utils.config_io import parse_task_config as jax_parse_task_config
from visualbert_torch.config import VisualBertConfig
from visualbert_torch.models.encoder import VisualBertModel
from visualbert_torch.models.visualbert import VisualBertForTask
from visualbert_torch.tasks import probing, registry
from visualbert_torch.tools.weights import flickr_attention_state, load_state
from visualbert_torch.train.trainer import Trainer
from visualbert_torch.utils.checkpoint import CheckpointManager
from visualbert_torch.utils.config_io import parse_task_config
from test_torch_flickr import head_batch
from test_torch_vqa import to_torch
from test_torch_vqa_advanced import TINY

ATOL, RTOL = 2e-5, 1e-4


def trunk_args(batch):
    mask = np.concatenate([batch["input_mask"], batch["image_mask"]], axis=1)
    return (batch["input_ids"], batch["token_type_ids"], mask, batch["visual_embeddings"])


@pytest.mark.parametrize("via", ["argument", "config"])
@pytest.mark.parametrize("flash", [False, True], ids=["einsum", "flash"])
def test_collected_probabilities_match_jax(rng, via, flash):
    """[L, B, H, T, T] from ``output_attention_probs=True`` or from
    ``cfg.output_attention_weights``, against the JAX encoder's."""
    kw = dict(initializer_range=0.3, use_flash_attention=flash, output_attention_weights=via == "config")
    jcfg, tcfg = JaxConfig(**TINY, dtype=jnp.float32, **kw), VisualBertConfig(**TINY, dtype=torch.float32, **kw)
    batch = head_batch(rng)
    args = trunk_args(batch)
    jm = JaxModel(jcfg)
    params = unbox(jm.init(jax.random.PRNGKey(1), *args)["params"])
    seq_j, _, probs_j = jm.apply({"params": params}, *args, output_attention_probs=via == "argument")
    model = load_state(VisualBertModel(tcfg), export_state_dict({"bert": params}, jcfg, prefix=""))
    t = [torch.tensor(a).long() if a.dtype.kind == "i" else torch.tensor(a) for a in args]
    with torch.no_grad():
        seq_t, _, probs_t = model(*t, output_attention_probs=via == "argument")
    assert probs_t.dtype == torch.float32 and probs_t.shape == (2, 3, 4, 14, 14)
    np.testing.assert_allclose(probs_t.numpy(), probs_j, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(seq_t.numpy(), seq_j, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(probs_t.sum(-1).numpy(), 1.0, rtol=1e-6)
    if flash:  # the collecting layers run the einsum attention
        einsum = load_state(VisualBertModel(tcfg.replace(use_flash_attention=False)), model.state_dict())
        with torch.no_grad():
            seq_e, _, probs_e = einsum(*t, output_attention_probs=via == "argument")
        assert torch.equal(probs_e, probs_t) and torch.equal(seq_e, seq_t)


def test_task_model_returns_attention_weights_as_jax(rng):
    """The flickr model with ``output_attention_probs=True``: the same
    ``attention_weights`` and head outputs as the JAX model's; without the
    argument there are none."""
    jcfg = JaxConfig(**TINY, dtype=jnp.float32, initializer_range=0.3, use_flash_attention=True)
    tcfg = VisualBertConfig(**TINY, dtype=torch.float32, initializer_range=0.3, use_flash_attention=True)
    batch = head_batch(rng)
    jm = JaxTask(jcfg, head_type="flickr")
    params = unbox(jm.init(jax.random.PRNGKey(2), batch)["params"])
    out_j = jm.apply({"params": params}, jax.tree.map(jnp.asarray, batch), output_attention_probs=True)
    sd = export_state_dict(params, jcfg)
    sd.update(flickr_attention_state(params["flickr_attention"]))
    trainer = Trainer(load_state(VisualBertForTask(tcfg, "flickr"), sd), None, None,
                      device="cpu")
    out_t = trainer.eval_step(batch, output_attention_probs=True)
    np.testing.assert_allclose(out_t["attention_weights"].numpy(), out_j["attention_weights"], atol=ATOL, rtol=RTOL)
    for k in ("loss", "accuracy"):
        np.testing.assert_allclose(float(out_t[k]), float(out_j[k]), atol=ATOL, rtol=RTOL)
    assert "attention_weights" not in trainer.eval_step(batch)


@pytest.mark.parametrize("via", ["argument", "config"])
def test_bypass_transformer_refuses_probabilities(rng, via):
    """The split path has no joint probabilities (JAX returns None there)."""
    cfg = VisualBertConfig(**TINY, dtype=torch.float32, bypass_transformer=True,
                           output_attention_weights=via == "config")
    model = VisualBertForTask(cfg, "flickr").init_weights(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="bypass_transformer"):
        model(to_torch(head_batch(rng)), output_attention_probs=via == "argument")


def test_entity_region_gather_equals_jax_numpy(rng):
    L, B, H, T, E, TT, R = 3, 4, 2, 15, 5, 9, 6
    probs = rng.rand(L, B, H, T, T).astype(np.float32)
    position = rng.randint(-1, TT, (B, E)).astype(np.int32)
    got = probing.entity_region_attention(torch.tensor(probs), torch.tensor(position), TT, R)
    want = jax_probing.entity_region_attention(probs, position, TT, R)
    assert got.shape == (L, B, H, E, R)
    np.testing.assert_array_equal(got.numpy(), want)
    label = (rng.rand(B, E, R) > 0.7).astype(np.float32)
    for row_mask in (None, np.array([True, False, True, True])):
        h, n = probing.grounding_counts_from_era(want, position, label, row_mask)
        hj, nj = jax_probing.grounding_counts_from_era(want, position, label, row_mask)
        np.testing.assert_array_equal(h, hj)
        assert n == nj


def probe_config(n, flash, folder, restore):
    return dataclasses.replace(parse_task_config(probe_raw(n, flash)), folder=str(folder), restore_checkpoint=restore)


def probe_raw(n, flash):
    """configs/flickr_probe.json's blocks at a tiny size on synthetic data."""
    return {
        "task": "flickr_probe", "data": {"synthetic": n, "max_seq_length": 12, "max_regions": 6, "max_entities": 3},
        "model": dict(TINY, dtype="float32", initializer_range=0.3, use_flash_attention=flash),
        "optimizer": {"learning_rate": 1e-5, "schedule": "none", "t_total": -1},
        "train": {"eval_batch_size": 8, "num_train_epochs": 0, "num_workers": 0},
    }


@pytest.mark.parametrize("n,flash", [(16, False), (13, True)], ids=["divides", "tail_flash"])
def test_flickr_probe_json_equals_jax(tmp_path, monkeypatch, n, flash):
    """The JAX probe from its own seeded weights, then the port's restoring
    the same weights from its own checkpoint: equal flickr_probe.json."""
    seen = {}

    def jax_restore(cfg, trainer, state):
        seen["params"] = jax.device_get(state.params)
        return state

    jraw = dict(probe_raw(n, flash), restore_checkpoint="(the weights JAX seeds)")
    monkeypatch.setattr(jax_registry, "_restore", jax_restore)
    _, want_fit = jax_registry.run(dataclasses.replace(jax_parse_task_config(jraw), folder=str(tmp_path / "jax")))

    cfg = probe_config(n, flash, tmp_path / "torch", str(tmp_path / "ckpt"))
    params = unbox(seen["params"])
    sd = export_state_dict(params, cfg.model)
    sd.update(flickr_attention_state(params["flickr_attention"]))
    trainer = Trainer(load_state(VisualBertForTask(cfg.model, "flickr"), sd), cfg.optimizer, cfg.train,
                      device="cpu").init_state(init_weights=False)
    CheckpointManager(str(tmp_path / "ckpt")).save(7, trainer)
    _, got_fit = registry.run(cfg, "cpu")

    got = json.loads((tmp_path / "torch" / "flickr_probe.json").read_text())
    want = json.loads((tmp_path / "jax" / "flickr_probe.json").read_text())
    assert got == want and got["entities"] == 2 * n
    assert sorted(got) == ["entities"] + [f"layer_{i}" for i in range(TINY["num_hidden_layers"])]
    assert got_fit.best_metric == want_fit.best_metric == max(v for k, v in got.items() if k != "entities")
    assert (got_fit.best_epoch, got_fit.epochs_run) == (-1, 0)


def test_probe_counts_equal_one_whole_split_collection(tmp_path):
    """The probe's batched, gathered counts equal the counts from one
    [L, B, H, T, T] collection over the whole split, read on the host."""
    from visualbert_torch.data.datasets import flickr
    from visualbert_torch.data.pipeline import Batcher

    cfg = probe_config(13, False, tmp_path / "run", None)
    trainer, result = registry.run(cfg, "cpu")
    got = json.loads((tmp_path / "run" / "flickr_probe.json").read_text())
    tok = registry._tokenizer(cfg)
    ann, feats = flickr.make_synthetic(13, tok, feat_dim=cfg.model.visual_embedding_dim)
    ds = flickr.Flickr30kDataset(ann, feats, tok, max_seq_length=12, max_regions=6, max_entities=3)
    whole = next(Batcher(ds, 13, shuffle=False, drop_last=False).epoch(0))
    probs = trainer.eval_step(whole, output_attention_probs=True)["attention_weights"].numpy()
    hits, total = jax_probing.grounding_counts_by_layer(probs, whole["flickr_position"], whole["label"], 12)
    assert got == {"entities": total, **{f"layer_{i}": float(h) / total for i, h in enumerate(hits)}}
    assert result.best_metric == max(float(h) / total for h in hits)


def test_cli_probe_restores_a_flickr_checkpoint(tmp_path, capsys):
    """``flickr_probe`` through the CLI on a tiny ``flickr`` run's
    checkpoint: one accuracy a layer over the split's entities, the best
    of them printed as the task's metric, and the probe's weights are the
    checkpoint's."""
    from test_torch_flickr import raw_config
    from test_torch_vqa import run_cli

    train = tmp_path / "flickr.json"
    train.write_text(json.dumps(dict(raw_config(n=16, epochs=1), data=probe_raw(16, True)["data"])))
    trainer, _ = run_cli(train, tmp_path / "run")
    probe = tmp_path / "probe.json"
    probe.write_text(json.dumps(dict(probe_raw(16, True), model=dict(TINY, dtype="float32"))))
    prober, result = run_cli(probe, tmp_path / "probe", "--restore", str(tmp_path / "run" / "ckpt"))
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = json.loads((tmp_path / "probe" / "flickr_probe.json").read_text())
    assert got["entities"] == 32 and len(got) == 1 + TINY["num_hidden_layers"]
    assert summary == {"task": "flickr_probe", "best_metric": result.best_metric, "best_epoch": -1, "epochs_run": 0}
    assert result.best_metric == max(v for k, v in got.items() if k.startswith("layer_"))
    for (name, a), b in zip(trainer.model.state_dict().items(), prober.model.state_dict().values()):
        assert torch.equal(a, b), name
