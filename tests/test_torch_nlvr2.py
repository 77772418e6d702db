"""NLVR2 fine-tuning in the port (data/datasets/nlvr2.py,
``screen_features``, the ``nlvr`` head, ``losses.cross_entropy``,
utils/nlvr2_eval.py and tasks/registry.py's ``run_nlvr2`` with its dump
hook) against the JAX package, on the CPU.

Batches are byte-identical to the JAX dataset's through the Batcher, and
``screen_features`` keeps the same boxes. The head's logits, loss, accuracy
and every parameter gradient agree with the JAX model on exported weights in
fp32 with dropout off (atol 2e-5 / rtol 1e-4, the bar the JAX encoder meets
against HF). The official metrics and the CSV report equal the JAX
functions' on the same predictions. The CLI trains a tiny model through the
save-probs attention (the plain K13/K14) and ``--eval_only`` reproduces its
evaluation and report.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualbert_tpu.config import VisualBertConfig as JaxConfig
from visualbert_tpu.data import features as jax_features
from visualbert_tpu.data.datasets import nlvr2 as jax_nlvr2
from visualbert_tpu.data.pipeline import Batcher as JaxBatcher
from visualbert_tpu.models.visualbert import VisualBertForTask as JaxTask
from visualbert_tpu.tools.export_torch import export_state_dict
from visualbert_tpu.train.trainer import unbox
from visualbert_tpu.utils import nlvr2_eval as jax_eval
from visualbert_torch.config import VisualBertConfig
from visualbert_torch.data import features
from visualbert_torch.data.datasets import nlvr2
from visualbert_torch.data.pipeline import Batcher
from visualbert_torch.models.visualbert import VisualBertForTask
from visualbert_torch.tasks import registry
from visualbert_torch.tools.weights import load_state
from visualbert_torch.utils import nlvr2_eval
from test_torch_vqa import SMALL, assert_same_batches, run_cli, to_torch, tokenizers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL, RTOL = 2e-5, 1e-4


def synthetic_datasets():
    t_ours, t_theirs = tokenizers()
    ann, feats = nlvr2.make_synthetic(30, t_ours, feat_dim=16)
    ann_j, feats_j = jax_nlvr2.make_synthetic(30, t_theirs, feat_dim=16)
    assert ann == ann_j
    for a in ann:
        for key in ("img0", "img1"):
            assert feats.get(a[key])["features"].tobytes() == feats_j.get(a[key])["features"].tobytes()
    kw = dict(max_seq_length=12, max_regions_per_image=5)
    return nlvr2.NLVR2Dataset(ann, feats, t_ours, **kw), jax_nlvr2.NLVR2Dataset(ann_j, feats_j, t_theirs, **kw)


def screened_datasets():
    """Ragged region counts with detector confidences (some images with none
    above the threshold), sentences longer than max_seq_length."""
    rng = np.random.RandomState(0)
    chunk, ann = {}, []
    for i in range(13):
        for side in (0, 1):
            n = 1 + (3 * i + side) % 9
            chunk[f"{i}_{side}"] = {"features": rng.randn(n, 16).astype(np.float32),
                                    "objects_conf": (rng.rand(n) * (0.1 if i % 5 == 0 else 1.0)).astype(np.float32)}
        words = " ".join(f"w{(i * 7 + k) % 100}" for k in range(3 + 3 * (i % 5)))
        ann.append({"identifier": f"dev-{i // 4}-{i % 4}-{i % 2}", "sentence": words, "label": i % 2,
                    "img0": f"{i}_0", "img1": f"{i}_1"})
    t_ours, t_theirs = tokenizers()
    kw = dict(max_seq_length=12, max_regions_per_image=6)
    return (nlvr2.NLVR2Dataset(ann, features.ChunkFeatures(chunk), t_ours, **kw),
            jax_nlvr2.NLVR2Dataset(ann, jax_features.ChunkFeatures(chunk), t_theirs, **kw))


@pytest.mark.parametrize("make", [synthetic_datasets, screened_datasets], ids=["synthetic", "screened"])
def test_nlvr2_batches_are_byte_identical_to_jax(make):
    ours, theirs = make()
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


def test_screen_features_matches_jax():
    rng = np.random.RandomState(1)
    feats = rng.randn(12, 8).astype(np.float32)
    confs = [None, rng.rand(12).astype(np.float32), np.full(12, 0.05, np.float32),
             np.array([0.9, 0.2, 0.2, 0.1] * 3, np.float32)]
    for conf in confs:
        for kw in (dict(), dict(threshold=0.5, max_cap=3), dict(min_count=4), dict(max_cap=100)):
            got_f, got_c = features.screen_features(feats, conf, **kw)
            want_f, want_c = jax_features.screen_features(feats, conf, **kw)
            assert got_f.tobytes() == want_f.tobytes() and got_f.shape == want_f.shape
            assert (got_c is None) == (want_c is None)
            if got_c is not None:
                assert got_c.tobytes() == want_c.tobytes()


def head_batch(rng):
    B, TT, TV = 3, 10, 8
    input_mask = np.zeros((B, TT), np.int32)
    for i, n in enumerate((10, 6, 4)):
        input_mask[i, :n] = 1
    image_mask = np.ones((B, TV), np.int32)
    image_mask[2, 2:4] = 0  # the first image of the pair padded
    return {
        "input_ids": rng.randint(0, SMALL["vocab_size"], (B, TT)).astype(np.int32),
        "token_type_ids": np.zeros((B, TT), np.int32),
        "input_mask": input_mask,
        "visual_embeddings": rng.randn(B, TV, SMALL["visual_embedding_dim"]).astype(np.float32),
        "image_mask": image_mask,
        "visual_embeddings_type": np.repeat(np.array([[0] * 4 + [1] * 4], np.int32), B, axis=0),
        "label": np.array([1, 0, 1], np.int32),
        "example_weight": np.array([1.0, 1.0, 0.0], np.float32),  # a tail-pad duplicate
    }


@pytest.mark.parametrize("kernels", [False, True], ids=["einsum", "flash"])
def test_nlvr_head_matches_jax(rng, kernels):
    kw = dict(use_flash_attention=kernels)
    jcfg, tcfg = JaxConfig(**SMALL, dtype=jnp.float32, **kw), VisualBertConfig(**SMALL, dtype=torch.float32, **kw)
    batch = head_batch(rng)
    jm = JaxTask(jcfg, head_type="nlvr")
    params = unbox(jm.init(jax.random.PRNGKey(4), batch)["params"])
    jbatch = jax.tree.map(jnp.asarray, batch)

    def loss_fn(p):
        out = jm.apply({"params": p}, jbatch, deterministic=True)
        return out["loss"], out

    (_, out_j), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(params)
    model = load_state(VisualBertForTask(tcfg, "nlvr"), export_state_dict(params, jcfg))
    out_t = model(to_torch(batch))
    out_t["loss"].backward()
    assert model.classifier.weight.shape == (2, SMALL["hidden_size"])
    np.testing.assert_allclose(out_t["logits"].detach().numpy(), out_j["logits"], atol=ATOL, rtol=RTOL)
    for k in ("loss", "accuracy"):
        np.testing.assert_allclose(float(out_t[k].detach()), float(out_j[k]), atol=ATOL, rtol=RTOL)
    want = export_state_dict(grads_j, jcfg)
    names = dict(model.named_parameters())
    assert set(names) == set(want)
    for name, p in names.items():
        np.testing.assert_allclose(p.grad.numpy(), want[name], atol=ATOL, rtol=RTOL, err_msg=name)


def test_metrics_match_jax():
    rng = np.random.RandomState(2)
    ids = [f"{s}-{set_id}-{pair}-{sent}" for s in ("dev", "test1") for set_id in range(4) for pair in range(3)
           for sent in range(2)] + ["odd", "a-b"]
    labels = {k: int(rng.randint(2)) for k in ids}
    for trial in range(4):
        preds = {k: (v if rng.rand() < 0.2 * (trial + 1) else 1 - v) for k, v in labels.items()}
        for k in ids:
            assert nlvr2_eval.split_identifier(k) == jax_eval.split_identifier(k)
        assert nlvr2_eval.accuracy(preds, labels) == jax_eval.accuracy(preds, labels)
        assert nlvr2_eval.consistency(preds, labels) == jax_eval.consistency(preds, labels)
    assert nlvr2_eval.consistency({}, labels) == jax_eval.consistency({}, labels) == 0.0


def jax_dump(eval_ann, collected, folder):
    """The JAX ``run_nlvr2`` dump hook (visualbert_tpu/tasks/registry.py:496-515)."""
    eval_ids = [a["identifier"] for a in eval_ann]
    labels = {a["identifier"]: int(a["label"]) for a in eval_ann if "label" in a}
    preds = {}
    for batch, out in collected:
        p = np.asarray(out["logits"]).argmax(-1)
        idx = np.asarray(batch["example_index"])
        for j in range(len(p)):
            preds[eval_ids[int(idx[j])]] = int(p[j])
    jax_eval.write_csv_report(str(folder / "nlvr2_report.csv"), sorted(preds.items()))
    return {"official_accuracy": jax_eval.accuracy(preds, labels), "consistency": jax_eval.consistency(preds, labels)}


def test_dump_hook_matches_jax(tmp_path):
    """The same (batch, logits) pairs, the last batch padded with repeats:
    the same CSV and metrics, one row an identifier."""
    ours, _ = screened_datasets()
    eval_ann = ours.annotations
    rng = np.random.RandomState(3)
    collected = [(b, {"logits": rng.randn(len(b["example_index"]), 2).astype(np.float32)})
                 for b in Batcher(ours, 5, shuffle=False, drop_last=False, pad_final=True).epoch(0)]
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    want = jax_dump(eval_ann, collected, tmp_path / "jax")
    got = registry.nlvr2_dump_hook(eval_ann)(collected, str(tmp_path / "torch"))
    assert got == want
    csv = (tmp_path / "torch" / "nlvr2_report.csv").read_text()
    assert csv == (tmp_path / "jax" / "nlvr2_report.csv").read_text()
    assert len(csv.splitlines()) == len(eval_ann) == 13


def test_cli_trains_nlvr2_and_eval_only_reproduces_it(tmp_path, capsys):
    """A tiny model with the save-probs attention (the plain K13/K14) on 40
    synthetic pairs (32 train, 8 eval), two epochs at batch 8: the run writes
    nlvr2_report.csv with one row an eval identifier; ``--eval_only
    --restore`` gives the last epoch's val_ loss and accuracy within 1e-6
    and the same CSV, and its official accuracy and consistency are those of
    the trained run's report against the labels."""
    config = tmp_path / "nlvr2.json"
    config.write_text(json.dumps({
        "task": "nlvr2", "data": {"synthetic": 40, "max_seq_length": 12, "max_regions_per_image": 6},
        "model": dict(SMALL, use_flash_attention=True, flash_save_probs=True, fast_dropout=True),
        "optimizer": {"learning_rate": 1e-3, "schedule": "none"},
        "train": {"train_batch_size": 8, "eval_batch_size": 3, "num_train_epochs": 2, "num_workers": 2},
    }))
    trainer, result = run_cli(config, tmp_path / "run")
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    last = result.history[-1]
    assert summary["task"] == "nlvr2" and summary["epochs_run"] == 2 and trainer.step == 8
    assert np.isfinite(last["train_loss"]) and set(last) >= {"val_loss", "val_accuracy"}
    csv = (tmp_path / "run" / "nlvr2_report.csv").read_text()
    rows = [line.split(",") for line in csv.splitlines()]
    assert [r[0] for r in rows] == sorted(str(i) for i in range(32, 40))
    assert {r[1] for r in rows} <= {"True", "False"}

    _, again = run_cli(config, tmp_path / "eval", "--eval_only", "--restore", str(tmp_path / "run" / "ckpt"))
    metrics = again.history[0]
    assert again.epochs_run == 0
    for k in ("loss", "accuracy"):
        assert metrics[k] == pytest.approx(last["val_" + k], abs=1e-6)
    assert (tmp_path / "eval" / "nlvr2_report.csv").read_text() == csv
    ann, _ = nlvr2.make_synthetic(40, tokenizers()[0], feat_dim=SMALL["visual_embedding_dim"])  # the run's set
    labels = {a["identifier"]: a["label"] for a in ann[32:]}
    preds = {r[0]: int(r[1] == "True") for r in rows}
    assert metrics["official_accuracy"] == nlvr2_eval.accuracy(preds, labels)
    assert metrics["consistency"] == nlvr2_eval.consistency(preds, labels)
    # the synthetic identifiers form one-example groups: both equal the accuracy
    assert metrics["official_accuracy"] == pytest.approx(last["val_accuracy"], abs=1e-6)
    assert metrics["consistency"] == metrics["official_accuracy"]


def test_nlvr2_real_data_is_not_ported(tmp_path):
    """configs/nlvr2_finetune.json as shipped reads HDF5 features."""
    from visualbert_torch.utils.config_io import load_task_config

    cfg = load_task_config(os.path.join(REPO, "configs", "nlvr2_finetune.json"), {"folder": str(tmp_path)})
    with pytest.raises(NotImplementedError, match="H5Features"):
        registry.run(cfg, "cpu")
