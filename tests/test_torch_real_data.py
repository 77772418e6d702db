"""The tasks that read HDF5 region features, run on real-format files in the
port and in the JAX registry, on the CPU.

Each task's synthetic set is written out as the files a real run reads:
annotations (json, or JSON lines for NLVR2), ``vocab.txt`` (so both
registries take the native tokenizer) and an HDF5 file of the BUTD layout
with its id sidecar. From the JAX run's starting weights (fp32, dropout 0),
every epoch's train and val metrics of the port's run agree within 2e-4,
and ``--eval_only --restore`` of the port's checkpoint gives the last
epoch's val metrics within 1e-6 (COCO pretraining, which has no eval
split: ``--restore`` gives back the trained parameters bit for bit). The
attention probe, an evaluation only, writes the JAX probe's
``flickr_probe.json``."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from visualbert_tpu.tasks import registry as jax_registry
from visualbert_tpu.tools.export_torch import export_state_dict
from visualbert_tpu.train.trainer import unbox
from visualbert_tpu.utils.config_io import parse_task_config as jax_parse_task_config
from visualbert_torch.data.datasets import coco, flickr, nlvr2, unsup_pretrain, unsup_vqa, vqa
from visualbert_torch.data.features import H5_KEYS
from visualbert_torch.data.symbolic import SymbolicVocab
from visualbert_torch.data.tokenization import BertTokenizer
from visualbert_torch.models.unsupervised import UnsupervisedVisualBert
from visualbert_torch.models.visualbert import VisualBertForTask
from visualbert_torch.tasks import registry
from visualbert_torch.tools.weights import flickr_attention_state, load_state, unsupervised_state
from visualbert_torch.train.trainer import Trainer
from visualbert_torch.utils.checkpoint import CheckpointManager
from visualbert_torch.utils.config_io import parse_task_config
from test_torch_unsup_tasks import MODEL, TRAIN, history, run_jax, write_corpus
from test_torch_vqa import WORDS
from test_torch_vqa_advanced import ExportedStart

h5py = pytest.importorskip("h5py")

TOL = 2e-4
F = MODEL["visual_embedding_dim"]
SYM = SymbolicVocab([f"obj{i}" for i in range(32)], [f"attr{i}" for i in range(8)])  # the registries' default


def write_h5(chunk, path, sidecar="json"):
    """A ChunkFeatures dict as the BUTD HDF5 layout (every image the same
    box count) and its id sidecar."""
    ids = list(chunk)
    with h5py.File(path, "w") as f:
        for k in ("features",) + H5_KEYS:
            if k in chunk[ids[0]]:
                f.create_dataset(k, data=np.stack([np.asarray(chunk[i][k]) for i in ids]))
    base = os.path.splitext(str(path))[0]
    if sidecar == "json":
        with open(base + "_ids.json", "w") as f:
            json.dump(ids, f)
    else:
        with open(base + "_ids.txt", "w") as f:
            f.write("\n".join(ids) + "\n")
    return str(path)


def dump(obj, path, lines=False):
    with open(path, "w") as f:
        if lines:
            f.write("\n".join(json.dumps(o) for o in obj) + "\n")
        else:
            json.dump(obj, f)
    return str(path)


def real_raw(task, tmp_path):
    """The raw config of ``task`` on real-format files written under
    ``tmp_path`` from its synthetic set."""
    tok = BertTokenizer({w: i for i, w in enumerate(WORDS)})
    (tmp_path / "vocab.txt").write_text("\n".join(WORDS) + "\n")
    d = {"vocab_file": str(tmp_path / "vocab.txt")}
    h5 = tmp_path / "features.h5"
    train = dict(TRAIN)
    if task == "coco_pretrain":
        ann, feats = coco.make_synthetic(24, tok, feat_dim=F)
        d.update(annotations=dump(ann, tmp_path / "ann.json"), max_seq_length=12, max_regions=10)
    elif task in ("vqa", "vqa_advanced"):
        ann, feats, answers = vqa.make_synthetic(40, tok, n_answers=8, feat_dim=F)
        d.update(train_annotations=dump(ann[:32], tmp_path / "train.json"),
                 eval_annotations=dump(ann[32:], tmp_path / "eval.json"), max_seq_length=14, max_regions=10)
        if task == "vqa":
            d["answer_vocab"] = dump(answers.word_list, tmp_path / "answers.json")
    elif task == "nlvr2":
        ann, feats = nlvr2.make_synthetic(40, tok, feat_dim=F)
        d.update(train_annotations=dump(ann[:32], tmp_path / "train.jsonl", lines=True),
                 eval_annotations=dump(ann[32:], tmp_path / "eval.jsonl", lines=True), max_seq_length=12,
                 max_regions_per_image=6)
    elif task in ("flickr", "flickr_probe"):
        ann, feats = flickr.make_synthetic(40 if task == "flickr" else 13, tok, feat_dim=F)
        d.update(max_seq_length=12, max_regions=8, max_entities=3)
        if task == "flickr":
            d.update(train_annotations=dump(ann[:32], tmp_path / "train.json"),
                     eval_annotations=dump(ann[32:], tmp_path / "eval.json"))
        else:
            d["eval_annotations"] = dump(ann, tmp_path / "eval.json")
            train = {"eval_batch_size": 8, "num_train_epochs": 0, "num_workers": 0}
    elif task == "unsup_pretrain":
        ann, feats = unsup_pretrain.make_synthetic(32, tok, SYM, n_regions=6, feat_dim=F, answers=3)
        (tmp_path / "answer_table.json").write_text(json.dumps(["a0", "a1", "A2."]))
        d.update(annotations=dump(ann, tmp_path / "ann.json"), val_annotations=dump(ann[:12], tmp_path / "val.json"),
                 n_regions=6, max_seq_length=12, text_corpus=write_corpus(tmp_path / "corpus.npz"),
                 text_seq_length=16, image_only_ratio=0.5, task_qa=True, answer_table=str(tmp_path / "answer_table.json"))
    elif task == "unsup_vqa":
        ann, feats, answers = unsup_vqa.make_synthetic(40, tok, SYM, n_regions=6, feat_dim=F)
        d.update(train_annotations=dump(ann[:32], tmp_path / "train.json"),
                 eval_annotations=dump(ann[32:], tmp_path / "eval.json"),
                 answer_list=dump(answers, tmp_path / "answers.json"), n_regions=6, max_seq_length=10)
    d["features_h5"] = write_h5(feats.chunk, h5, sidecar="txt" if task == "nlvr2" else "json")
    optimizer = {"learning_rate": 1e-3, "schedule": "none"}
    if task == "unsup_pretrain":
        optimizer["no_decay"] = []  # the Flax paths alone decide weight decay (C9)
    return {"task": task, "data": d, "model": MODEL, "optimizer": optimizer, "train": train}


def exported(start, jcfg, unsup):
    """The port registry's ``_trainer``, starting from the JAX run's
    weights."""
    def trainer(c, model, device):
        if unsup:
            sd = unsupervised_state(start)
        else:
            sd = export_state_dict(start, jcfg)
            if "flickr_attention" in start:
                sd.update(flickr_attention_state(start["flickr_attention"]))
        return ExportedStart(load_state(model, sd), c.optimizer, c.train, device="cpu")

    return trainer


TASKS = ["coco_pretrain", "vqa", "vqa_advanced", "nlvr2", "flickr", "unsup_pretrain", "unsup_vqa"]


@pytest.mark.parametrize("task", TASKS)
def test_real_files_follow_the_jax_registry_and_eval_only_reproduces_it(tmp_path, monkeypatch, task):
    raw = real_raw(task, tmp_path)
    start, want = run_jax(monkeypatch, raw, tmp_path / "jax")
    cfg = dataclasses.replace(parse_task_config(raw), folder=str(tmp_path / "torch"))
    with monkeypatch.context() as m:
        m.setattr(registry, "_trainer", exported(start, jax_parse_task_config(raw).model, task.startswith("unsup")))
        trainer, got = registry.run(cfg, "cpu")
    assert got.epochs_run == want.epochs_run == 2 and trainer.step > 0
    keys = sorted(want.history[0])
    assert sorted(got.history[0]) == keys and any(k.startswith("train_") for k in keys)
    np.testing.assert_allclose(history(got, keys), history(want, keys), rtol=TOL, atol=TOL)

    ckpt = str(tmp_path / "torch" / "ckpt")
    if task == "coco_pretrain":  # no eval split: the restore gives back the trained parameters
        again_cfg = dataclasses.replace(cfg, folder=str(tmp_path / "again"), restore_checkpoint=ckpt,
                                        train=dataclasses.replace(cfg.train, num_train_epochs=0))
        again, _ = registry.run(again_cfg, "cpu")
        for (k, a), b in zip(trainer.model.state_dict().items(), again.model.state_dict().values()):
            assert torch.equal(a, b), k
        return
    last = {k[4:]: v for k, v in got.history[-1].items() if k.startswith("val_")}
    _, again = registry.run(dataclasses.replace(cfg, folder=str(tmp_path / "eval"), eval_only=True,
                                                restore_checkpoint=ckpt), "cpu")
    assert set(last) <= set(again.history[0]) and last
    for k, v in last.items():
        assert again.history[0][k] == pytest.approx(v, abs=1e-6), k


def test_flickr_probe_on_real_files_equals_jax(tmp_path, monkeypatch):
    """The probe over a real-format eval split (13 captions: a padded last
    batch), from the weights JAX seeds, restored in the port from its own
    checkpoint."""
    seen = {}

    def jax_restore(cfg, trainer, state):
        seen["params"] = jax.device_get(state.params)
        return state

    raw = real_raw("flickr_probe", tmp_path)
    monkeypatch.setattr(jax_registry, "_restore", jax_restore)
    jraw = dict(raw, restore_checkpoint="(the weights JAX seeds)")
    _, want_fit = jax_registry.run(dataclasses.replace(jax_parse_task_config(jraw), folder=str(tmp_path / "jax")))
    cfg = dataclasses.replace(parse_task_config(raw), folder=str(tmp_path / "torch"),
                              restore_checkpoint=str(tmp_path / "ckpt"))
    params = unbox(seen["params"])
    sd = export_state_dict(params, cfg.model)
    sd.update(flickr_attention_state(params["flickr_attention"]))
    trainer = Trainer(load_state(VisualBertForTask(cfg.model, "flickr"), sd), cfg.optimizer, cfg.train,
                      device="cpu").init_state(init_weights=False)
    CheckpointManager(str(tmp_path / "ckpt")).save(3, trainer)
    _, got_fit = registry.run(cfg, "cpu")
    got = json.loads((tmp_path / "torch" / "flickr_probe.json").read_text())
    want = json.loads((tmp_path / "jax" / "flickr_probe.json").read_text())
    assert got == want and got["entities"] > 0 and got_fit.best_metric == want_fit.best_metric


@pytest.mark.parametrize("task", ["coco_pretrain", "nlvr2", "unsup_vqa"])
def test_registry_takes_the_native_tokenizer_for_a_vocab_file(tmp_path, monkeypatch, task):
    """With ``vocab_file`` both registries tokenize through their native
    WordPiece path; the port's datasets equal the JAX datasets' examples."""
    from visualbert_torch.data.fast_tokenizer import FastBertTokenizer

    raw = real_raw(task, tmp_path)
    captured = {}
    monkeypatch.setattr(registry, "_run_fit", lambda c, trainer, tr, ev=None, **kw: captured.update(train=tr))
    monkeypatch.setattr(jax_registry, "_run_fit", lambda c, trainer, tr, ev, **kw: captured.update(jax=tr))
    registry.run(dataclasses.replace(parse_task_config(raw), folder=str(tmp_path / "t")), "cpu")
    jax_registry.run(dataclasses.replace(jax_parse_task_config(raw), folder=str(tmp_path / "j")))
    ours, theirs = captured["train"], captured["jax"]
    assert isinstance(ours.tokenizer, FastBertTokenizer) and ours.tokenizer.native_available
    assert len(ours) == len(theirs)
    for i in range(min(len(ours), 6)):
        a, b = ours[(i, np.random.default_rng(i))], theirs[(i, np.random.default_rng(i))]
        assert set(a) == set(b) and all(np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes() for k in a)


def test_unsup_pretrain_real_files_hold_every_source(tmp_path):
    """The real-data unsup_pretrain run draws V&L, image-only and text-only
    batches from the files (its hybrid mix), with the QA answers mapped
    through the answer table."""
    raw = real_raw("unsup_pretrain", tmp_path)
    cfg = dataclasses.replace(parse_task_config(raw), folder=str(tmp_path / "run"),
                              train=dataclasses.replace(parse_task_config(raw).train, num_train_epochs=1))
    trainer, result = registry.run(cfg, "cpu")
    assert isinstance(trainer.model, UnsupervisedVisualBert) and trainer.step == 4 + 2 + 3
    h = result.history[0]
    assert {"train_obj_loss", "train_qa_loss", "train_masked_lm_loss", "val_loss"} <= set(h)
    assert all(np.isfinite(v) for v in h.values())
