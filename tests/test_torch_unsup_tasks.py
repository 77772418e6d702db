"""The unsupervised stack's tasks in the port (``text_pretrain``,
``unsup_pretrain`` with its hybrid sources, ``unsup_vqa``) against the JAX
registry, on the CPU: from the JAX run's starting weights, every epoch's
train and val metrics within 2e-4 over a few ``Trainer`` steps, dropout 0.
The port trains through the fused cross-entropy's plain K4-K6 where JAX
runs its unfused decoder (ROADMAP.md C1). The CLI runs each task with
``--device cpu``; ``--eval_only --restore`` reproduces an epoch's val_
metrics within 1e-6."""

import dataclasses
import json

import jax
import numpy as np
import pytest

from visualbert_tpu.data.tokenization import BertTokenizer as JaxTokenizer
from visualbert_tpu.tasks import registry as jax_registry
from visualbert_tpu.utils.config_io import parse_task_config as jax_parse_task_config
from visualbert_torch.data.text_corpus import PackedCorpus
from visualbert_torch.data.tokenization import BertTokenizer
from visualbert_torch.models.unsupervised import UnsupervisedVisualBert, UnsupervisedVQAModel
from visualbert_torch.tasks import registry
from visualbert_torch.tools.weights import load_state, unsupervised_state
from visualbert_torch.utils.config_io import parse_task_config
from test_torch_vqa import SMALL, WORDS, run_cli
from test_torch_vqa_advanced import ExportedStart, jax_task_parts, port_trainer_from

TOL = 2e-4
MODEL = dict(SMALL, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0, dtype="float32")
TRAIN = {"train_batch_size": 8, "eval_batch_size": 8, "num_train_epochs": 2, "num_workers": 0}


def write_corpus(path):
    """A packed corpus of 24 passages over the synthetic vocabulary."""
    tok = BertTokenizer({w: i for i, w in enumerate(WORDS)})
    PackedCorpus.build([[f"w{i} w{i + 1} w{i + 2}", f"w{i + 3} w{i + 4}"] for i in range(24)], tok).save(str(path))
    return str(path)


def unsup_raw(tmp_path, fused=True, **data):
    (tmp_path / "answers.json").write_text(json.dumps(["a0", "a1", "A2."]))
    d = {"synthetic": 32, "n_regions": 6, "max_seq_length": 12, "text_corpus": write_corpus(tmp_path / "corpus.npz"),
         "text_seq_length": 16, "image_only_ratio": 0.5, "val_synthetic": 12, "task_qa": True,
         "synthetic_answers": 3, "answer_table": str(tmp_path / "answers.json")}
    d.update(data)
    return {"task": "unsup_pretrain", "data": d, "model": dict(MODEL, fused_mlm_xent=fused),
            # no no_decay: the Flax paths alone decide weight decay (C9)
            "optimizer": {"learning_rate": 1e-3, "schedule": "none", "no_decay": []}, "train": TRAIN}


def history(result, keys):
    return [[h[k] for k in keys] for h in result.history]


def run_jax(monkeypatch, raw, folder):
    """The JAX registry's run of ``raw``: (its starting params, its
    FitResult), the params taken where the registry hands them to ``fit``."""
    got = {}
    real_fit = jax_registry.fit

    def fit(trainer, state, **kw):
        got["start"] = jax.device_get(state.params)
        return real_fit(trainer, state, **kw)

    with monkeypatch.context() as m:
        m.setattr(jax_registry, "fit", fit)
        _, result = jax_registry.run(dataclasses.replace(jax_parse_task_config(raw), folder=str(folder)))
    return got["start"], result


def exported_trainer(sd, model_cls):
    """A ``_trainer`` for the port's registry that starts from the state
    dict ``sd``."""
    def trainer(c, model, device):
        assert isinstance(model, model_cls) and device == "cpu"
        return ExportedStart(load_state(model, sd), c.optimizer, c.train, device="cpu")

    return trainer


def test_unsup_pretrain_trajectory_follows_jax(tmp_path, monkeypatch):
    """V&L (4 batches), image-only (ratio 0.5: 2) and text-only (24
    passages: 3) sources, QA co-training through the answer table, a val
    split of 12 (one batch), two epochs: 18 steps."""
    jraw, raw = unsup_raw(tmp_path, fused=False), unsup_raw(tmp_path, fused=True)
    start, want = run_jax(monkeypatch, jraw, tmp_path / "jax")
    cfg = dataclasses.replace(parse_task_config(raw), folder=str(tmp_path / "torch"))
    monkeypatch.setattr(registry, "_trainer", exported_trainer(unsupervised_state(start), UnsupervisedVisualBert))
    got_trainer, got = registry.run(cfg, "cpu")
    assert got_trainer.step == 18 and got.epochs_run == want.epochs_run == 2
    keys = sorted(want.history[0])
    assert sorted(got.history[0]) == keys
    assert {"train_masked_lm_loss", "train_matched_loss", "train_obj_loss", "train_attr_loss", "train_feat_loss",
            "train_masked_tag_loss", "train_qa_loss", "train_qa_accuracy", "val_loss"} <= set(keys)
    np.testing.assert_allclose(history(got, keys), history(want, keys), rtol=TOL, atol=TOL)
    assert got.best_epoch == want.best_epoch and got.best_metric == min(h["val_loss"] for h in got.history)
    assert (tmp_path / "torch" / "ckpt" / "best.pt").exists()


def test_text_pretrain_trajectory_follows_jax(tmp_path, monkeypatch):
    """The synthetic corpus of 40 passages, 16 tokens, two epochs of 5 steps."""
    def raw(fused):
        return {"task": "text_pretrain", "data": {"synthetic": 40, "max_seq_length": 16},
                "model": dict(MODEL, fused_mlm_xent=fused), "optimizer": {"learning_rate": 1e-3, "schedule": "none"},
                "train": TRAIN}

    start, want = run_jax(monkeypatch, raw(False), tmp_path / "jax")
    jcfg = jax_parse_task_config(raw(False)).model
    # the JAX tree, built from a text-only batch, has no visual embeddings;
    # the port's pretraining model holds them, zero here, and never reaches them
    emb = start["bert"]["embeddings"]
    assert "projection" not in emb
    E = jcfg.hidden_size
    emb.update(token_type_embeddings_visual={"embedding": np.zeros((jcfg.type_vocab_size, E), np.float32)},
               position_embeddings_visual={"embedding": np.zeros((jcfg.max_position_embeddings, E), np.float32)},
               projection={"kernel": np.zeros((jcfg.visual_embedding_dim, E), np.float32),
                           "bias": np.zeros(E, np.float32)})
    cfg = dataclasses.replace(parse_task_config(raw(True)), folder=str(tmp_path / "torch"))
    monkeypatch.setattr(registry, "_trainer", lambda c, model, device: port_trainer_from(start, jcfg, c, "pretraining"))
    trainer, got = registry.run(cfg, "cpu")
    assert trainer.step == 10 and got.epochs_run == want.epochs_run == 2
    keys = ("train_loss", "train_masked_lm_loss", "train_mlm_accuracy")
    assert sorted(got.history[0]) == sorted(want.history[0]) == sorted(keys)
    np.testing.assert_allclose(history(got, keys), history(want, keys), rtol=TOL, atol=TOL)
    assert not trainer.optimizer.frozen["bert.pooler.dense.weight"]


def test_text_pretrain_examples_match_jax_registry(tmp_path, monkeypatch):
    """The registry's synthetic corpus and dataset are the JAX registry's."""
    raw = {"task": "text_pretrain", "data": {"synthetic": 12, "max_seq_length": 16}, "model": MODEL, "train": TRAIN}
    parts = jax_task_parts(monkeypatch, raw, tmp_path / "probe")
    captured = {}
    monkeypatch.setattr(registry, "_run_fit", lambda c, trainer, tr, ev, **kw: captured.update(kw, train_ds=tr))
    registry.run(dataclasses.replace(parse_task_config(raw), folder=str(tmp_path / "t")), "cpu")
    assert captured["val_metric"] == "loss"
    ours, theirs = captured["train_ds"], parts["train_ds"]
    assert isinstance(theirs.tokenizer, JaxTokenizer) and len(ours) == len(theirs) == 12
    assert ours.corpus.tokens.tobytes() == theirs.corpus.tokens.tobytes()
    for i in range(len(ours)):
        a, b = ours[(i, np.random.default_rng(i))], theirs[(i, np.random.default_rng(i))]
        assert all(a[k].tobytes() == b[k].tobytes() for k in a) and set(a) == set(b)


def vqa_raw(epochs=2):
    return {"task": "unsup_vqa", "data": {"synthetic": 40, "n_regions": 6, "max_seq_length": 10},
            "model": MODEL, "optimizer": {"learning_rate": 1e-3, "schedule": "none"},
            "train": dict(TRAIN, num_train_epochs=epochs)}


def test_unsup_vqa_trajectory_follows_jax(tmp_path, monkeypatch):
    """32 training and 8 eval questions, two epochs of 4 steps: train and
    val loss and accuracy; the best epoch is the highest val accuracy."""
    start, want = run_jax(monkeypatch, vqa_raw(), tmp_path / "jax")
    cfg = dataclasses.replace(parse_task_config(vqa_raw()), folder=str(tmp_path / "torch"))
    monkeypatch.setattr(registry, "_trainer", exported_trainer(unsupervised_state(start), UnsupervisedVQAModel))
    t, got = registry.run(cfg, "cpu")
    assert t.step == 8 and got.epochs_run == want.epochs_run == 2
    keys = ("train_loss", "train_accuracy", "val_loss", "val_accuracy")
    assert sorted(got.history[0]) == sorted(want.history[0]) == sorted(keys)
    np.testing.assert_allclose(history(got, keys), history(want, keys), rtol=TOL, atol=TOL)
    assert got.best_epoch == want.best_epoch


@pytest.mark.parametrize("task", ["unsup_pretrain", "unsup_vqa"])
def test_cli_trains_and_eval_only_reproduces_it(tmp_path, capsys, task):
    """The port's CLI on the CPU, two epochs; ``--eval_only --restore`` of
    the checkpoint gives the last epoch's val_ metrics within 1e-6."""
    raw = unsup_raw(tmp_path) if task == "unsup_pretrain" else vqa_raw()
    config = tmp_path / "config.json"
    config.write_text(json.dumps(raw))
    trainer, result = run_cli(config, tmp_path / "run")
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    last = result.history[-1]
    assert summary["task"] == task and summary["epochs_run"] == 2 and trainer.device.type == "cpu"
    assert all(np.isfinite(v) for v in last.values())
    metric = "loss" if task == "unsup_pretrain" else "accuracy"
    best = (min if task == "unsup_pretrain" else max)(h["val_" + metric] for h in result.history)
    assert summary["best_metric"] == best
    _, again = run_cli(config, tmp_path / "eval", "--eval_only", "--restore", str(tmp_path / "run" / "ckpt"))
    assert again.epochs_run == 0
    vals = {k[4:]: v for k, v in last.items() if k.startswith("val_")}
    assert set(again.history[0]) == set(vals)
    for k, v in vals.items():
        assert again.history[0][k] == pytest.approx(v, abs=1e-6), k


def test_cli_text_pretrain_trains_on_the_cpu(tmp_path, capsys):
    config = tmp_path / "config.json"
    config.write_text(json.dumps({"task": "text_pretrain", "data": {"synthetic": 24, "max_seq_length": 16},
                                  "model": dict(MODEL, fused_mlm_xent=True, use_flash_attention=True,
                                                fast_dropout=True, hidden_dropout_prob=0.1),
                                  "optimizer": {"learning_rate": 1e-3, "schedule": "none"}, "train": TRAIN}))
    trainer, result = run_cli(config, tmp_path / "run")
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary == {"task": "text_pretrain", "best_metric": None, "best_epoch": -1, "epochs_run": 2}
    assert trainer.step == 6 and result.history[1]["train_loss"] < result.history[0]["train_loss"]


@pytest.mark.parametrize("task", ["unsup_pretrain", "unsup_vqa"])
def test_hdf5_features_without_h5py_raise_naming_it(tmp_path, monkeypatch, task):
    """Real data reads HDF5 features; where h5py is not installed (the
    card's machine) the run stops with an ImportError that names it."""
    import sys

    from test_torch_real_data import real_raw

    cfg = dataclasses.replace(parse_task_config(real_raw(task, tmp_path)), folder=str(tmp_path / "run"))
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        registry.run(cfg, "cpu")


def test_registry_has_every_jax_task():
    assert set(registry.TASKS) == set(jax_registry.TASKS)
    assert len(registry.TASKS) == 11


def test_unsup_pretrain_refuses_string_answers_without_a_table(tmp_path):
    raw = unsup_raw(tmp_path)
    del raw["data"]["answer_table"]
    with pytest.raises(ValueError, match="answer_table"):
        registry.run(dataclasses.replace(parse_task_config(raw), folder=str(tmp_path / "run")), "cpu")


def test_unsup_path_builds_both_sources_of_the_step():
    """tools/unsup_path.py at a narrow width on the CPU: the config's
    geometry (30 text tokens, 36 tags, 36 regions; 64-token text-only
    rows), most MLM labels -1, and a finite train step on each batch."""
    from visualbert_torch.tools import unsup_path

    raw = unsup_path.config()
    raw["model"] = dict(raw["model"], **{k: v for k, v in SMALL.items() if k != "visual_embedding_dim"},
                        visual_embedding_dim=32, dtype="float32")
    trainer, batches = unsup_path.build(device="cpu", batch=4, raw=raw)
    vl, text = batches["vl"], batches["text"]
    assert vl["input_ids"].shape == (4, 30) and vl["visual_tags"].shape == (4, 36)
    assert vl["visual_feats"].shape == (4, 36, 32) and text["input_ids"].shape == (4, 64)
    assert set(text) == {"input_ids", "token_type_ids", "input_mask", "masked_lm_labels"}
    assert trainer.model.ucfg.symbolic_vocab_size == 2003 and trainer.optimizer.cfg.schedule == "none"
    for batch in (vl, text):
        labels = batch["masked_lm_labels"]
        assert 0.5 < float((labels < 0).float().mean()) < 1.0
        assert np.isfinite(float(trainer.train_step(batch)["loss"]))


@pytest.mark.parametrize("args,match", [(["tmp/parent"], "needs a CUDA device"), ([], "usage")])
def test_main_path_ab_runs_only_on_the_card(monkeypatch, args, match):
    """tools/main_path_ab.py, which holds the main path's steps of this tree
    against another checkout's (the check on the code this slice shares),
    refuses without a card or a checkout."""
    import torch

    from visualbert_torch.tools import main_path_ab

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match=match):
        main_path_ab.main(args)


def test_main_path_ab_reports_a_failed_tree(tmp_path):
    from visualbert_torch.tools import main_path_ab

    with pytest.raises(SystemExit, match="failed"):
        main_path_ab.run_tree(str(tmp_path))


@pytest.mark.parametrize("args,match", [(["tmp/parent"], "tinybert_ab: needs a CUDA device"), ([], "usage"),
                                        (["a", "b"], "usage")])
def test_tinybert_ab_runs_only_on_the_card(monkeypatch, args, match):
    """tools/tinybert_ab.py, which holds phase 27's TinyBERT-4 runs of this
    tree against another checkout's, refuses without a card or with other
    than one checkout; its child is Python that names the three TinyBERT-4
    geometries of chip_smoke.py."""
    import torch

    import chip_smoke
    from visualbert_torch.tools import tinybert_ab

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match=match):
        tinybert_ab.main(args)
    compile(tinybert_ab.CHILD, "tinybert_ab", "exec")
    assert sum(g[0].startswith("TinyBERT-4") for g in chip_smoke.GEOMETRIES) == 3
    assert tinybert_ab.EXAMPLES % 128 == 0
