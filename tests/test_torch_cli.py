"""The port's config loading, fit loop, checkpoints and training CLI
(visualbert_torch/utils, train/loop.py, tasks/registry.py, train_cli.py).

Every file in configs/ loads to the same model, optimizer and train values
as the JAX loader gives (the TPU-only fields aside), and unknown keys raise
as they do there. The fit loop and the CLI run a tiny synthetic COCO
pretraining on the CPU (the kernels' plain versions): checkpoints restore
bit for bit and ``--restore`` resumes the run.
"""

import dataclasses
import filecmp
import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualbert_tpu.utils.config_io import load_task_config as jax_load_task_config
from visualbert_torch.config import TPU_ONLY_MODEL_FIELDS, OptimizerConfig, TrainConfig, VisualBertConfig
from visualbert_torch.data.datasets import coco
from visualbert_torch.data.pipeline import Batcher
from visualbert_torch.data.tokenization import BertTokenizer
from visualbert_torch.models.visualbert import VisualBertForTask
from visualbert_torch.train.loop import fit
from visualbert_torch.train.trainer import Trainer
from visualbert_torch.utils.checkpoint import CheckpointManager
from visualbert_torch.utils.config_io import load_task_config, loads_commented_json, parse_task_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.json")))
TINY_MODEL = {"vocab_size": 128, "hidden_size": 32, "num_hidden_layers": 1, "num_attention_heads": 2,
              "intermediate_size": 64, "max_position_embeddings": 64, "visual_embedding_dim": 32,
              "use_flash_attention": True, "fused_mlm_xent": True, "fast_dropout": True, "dtype": "float32"}


def test_commented_json():
    assert loads_commented_json('// c\n{"a": 1,  // t\n # h\n "b": [1, 2,], "s": "x//y#z",}') == {
        "a": 1, "b": [1, 2], "s": "x//y#z"}


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_configs_load_as_in_jax(path):
    ours, theirs = load_task_config(path), jax_load_task_config(path)
    for f in ("task", "folder", "data", "restore_checkpoint", "eval_only"):
        assert getattr(ours, f) == getattr(theirs, f), f
    for f in dataclasses.fields(ours.model):
        got, want = getattr(ours.model, f.name), getattr(theirs.model, f.name)
        if f.name in ("dtype", "param_dtype"):
            got, want = str(got).removeprefix("torch."), jnp.dtype(want).name
        assert got == want, f.name
    assert dataclasses.asdict(ours.optimizer) == dataclasses.asdict(theirs.optimizer)
    for f in dataclasses.fields(ours.train):
        assert getattr(ours.train, f.name) == getattr(theirs.train, f.name), f.name


def test_unknown_keys_raise_and_tpu_only_fields_are_skipped():
    for raw in ({"task": "coco_pretrain", "bogus": 1}, {"task": "coco_pretrain", "model": {"bogus": 1}},
                {"task": "coco_pretrain", "optimizer": {"bogus": 1}}, {"task": "coco_pretrain", "train": {"bogus": 1}}):
        with pytest.raises(KeyError, match="bogus"):
            parse_task_config(raw)
    cfg = parse_task_config({"task": "coco_pretrain", "model": {k: None for k in TPU_ONLY_MODEL_FIELDS},
                             "train": {"steps_per_dispatch": 8, "mesh_shape": [1, 1], "compiler_options": {}}})
    assert cfg.model == VisualBertConfig() and cfg.train == TrainConfig()


def tiny_trainer(seed=0, cls=Trainer, **train):
    cfg = VisualBertConfig.from_dict(TINY_MODEL)
    opt = OptimizerConfig(learning_rate=1e-3, schedule="none", frozen=("pooler",))
    return cls(VisualBertForTask(cfg, "pretraining"), opt, TrainConfig(seed=seed, log_every=1, **train),
               device="cpu").init_state()


def tiny_batcher(n=16, batch=4):
    t = BertTokenizer({w: i for i, w in enumerate(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
                                                  + [f"w{i}" for i in range(40)])})
    ann, feats = coco.make_synthetic(n, t, feat_dim=32)
    return Batcher(coco.CocoCaptionsDataset(ann, feats, t, max_seq_length=16, max_regions=10), batch)


class ScoredEvalTrainer(Trainer):
    """A Trainer whose eval step also reports the next of ``scores``."""

    def eval_step(self, batch):
        return dict(super().eval_step(batch), score=torch.tensor(next(self.scores)))


def test_fit_tracks_the_best_epoch_and_stops_on_patience(tmp_path):
    """Scores 0.5, 0.75, 0.625: epoch 1 is best, epoch 2 is one past it and
    patience is 1, so the run stops there; best.pt is epoch 1's checkpoint."""
    trainer = tiny_trainer(num_train_epochs=5, patience=1, cls=ScoredEvalTrainer)
    trainer.scores = iter([0.5, 0.75, 0.625, 0.25, 0.125])
    data = tiny_batcher()
    result = fit(trainer, data.epoch, lambda: [next(data.epoch(0))], checkpoint_dir=str(tmp_path),
                 val_metric="score")
    assert (result.best_metric, result.best_epoch, result.epochs_run) == (0.75, 1, 3)
    assert trainer.step == 3 * 4
    assert [h["val_score"] for h in result.history] == [0.5, 0.75, 0.625]
    assert all(np.isfinite(h["train_loss"]) and np.isfinite(h["val_loss"]) for h in result.history)
    assert CheckpointManager(str(tmp_path)).latest_step() == 12
    assert filecmp.cmp(tmp_path / "best.pt", tmp_path / "step_8.pt", shallow=False)


def test_fit_saves_a_checkpoint_when_it_fails(tmp_path):
    trainer = tiny_trainer()
    data = tiny_batcher()

    def failing(epoch):
        yield next(data.epoch(epoch))
        raise RuntimeError("data source broke")

    with pytest.raises(RuntimeError, match="broke"):
        fit(trainer, failing, checkpoint_dir=str(tmp_path))
    assert CheckpointManager(str(tmp_path)).latest_step() == 1


def test_checkpoint_restores_the_trainer_bit_for_bit(tmp_path):
    trainer = tiny_trainer(seed=1)
    for batch in tiny_batcher().epoch(0):
        trainer.train_step(batch)
    ckpt = CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in (2, 3, trainer.step):
        ckpt.save(step, trainer)
    assert sorted(os.listdir(tmp_path)) == ["step_3.pt", "step_4.pt"]
    fresh = ckpt.restore(tiny_trainer(seed=2))
    assert fresh.step == trainer.step == fresh.optimizer.step_count == 4
    for (k, a), (_, b) in zip(trainer.model.state_dict().items(), fresh.model.state_dict().items()):
        assert torch.equal(a, b), k
    for k in trainer.optimizer.m:
        assert torch.equal(trainer.optimizer.m[k], fresh.optimizer.m[k])
        assert torch.equal(trainer.optimizer.v[k], fresh.optimizer.v[k])
    assert torch.equal(trainer.dropout_generator.get_state(), fresh.dropout_generator.get_state())
    # the tie survives the load, and both go on to the same next step
    assert fresh.model.cls.predictions.decoder.weight is fresh.model.bert.embeddings.word_embeddings.weight
    batch = next(tiny_batcher().epoch(1))
    assert float(trainer.train_step(batch)["loss"]) == float(fresh.train_step(batch)["loss"])


def test_cli_trains_and_restore_resumes(tmp_path, capsys):
    from visualbert_torch.train_cli import main

    config = tmp_path / "tiny.json"
    config.write_text("// a synthetic COCO pretraining run\n" + json.dumps({
        "task": "coco_pretrain",
        "data": {"synthetic": 40, "max_seq_length": 16, "max_regions": 10},
        "model": dict(TINY_MODEL, remat=False, scan_layers=True),
        "optimizer": {"learning_rate": 1e-3, "schedule": "warmup_linear", "warmup": 0.1, "t_total": 100},
        "train": {"train_batch_size": 8, "num_train_epochs": 2, "steps_per_dispatch": 8, "log_every": 2,
                  "num_workers": 2},
    }))
    trainer, result = main(["--config", str(config), "--folder", str(tmp_path / "run"), "--device", "cpu"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary == {"task": "coco_pretrain", "best_metric": None, "best_epoch": -1, "epochs_run": 2}
    assert trainer.step == 10 and all(np.isfinite(h["train_loss"]) for h in result.history)
    assert trainer.optimizer.frozen["bert.pooler.dense.weight"]  # pretraining freezes the pooler
    assert sorted(os.listdir(tmp_path / "run" / "ckpt")) == ["step_10.pt", "step_5.pt"]
    assert (tmp_path / "run" / "run_0.log").read_text().count("epoch 1:") == 1

    resumed, _ = main(["--config", str(config), "--folder", str(tmp_path / "run2"),
                       "--restore", str(tmp_path / "run" / "ckpt"), "--device", "cpu"])
    assert resumed.step == 20 and resumed.optimizer.step_count == 20
    assert sorted(os.listdir(tmp_path / "run2" / "ckpt")) == ["step_15.pt", "step_20.pt"]
    with pytest.raises(NotImplementedError, match="A6"):
        main(["--config", str(config), "--folder", str(tmp_path / "run3"), "--restore", str(tmp_path / "x.th"),
              "--device", "cpu"])


def test_cli_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    """There is no CUDA device here: without ``--device cpu`` the CLI exits
    with an error that says so, before it builds anything."""
    from visualbert_torch.train_cli import main

    assert not torch.cuda.is_available()
    for device in ([], ["--device", "cuda"]):
        with pytest.raises(SystemExit) as exc:
            main(["--config", os.path.join(REPO, "configs", "vqa_synth.json"), "--folder", str(tmp_path), *device])
        assert "--device cpu" in str(exc.value.code)  # a message: the process exits with status 1
    assert not os.listdir(tmp_path)
