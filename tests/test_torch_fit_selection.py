"""Best-epoch selection by a lower-is-better metric in the port's task runner
(``visualbert_torch/tasks/registry.py::_run_fit``), against its counterpart
in ``visualbert_tpu/tasks/registry.py``: a task that selects by ``"loss"``
keeps its lowest-loss epoch as ``best.pt``, and ``coco_pretrain`` selects by
loss as the JAX task does."""

import dataclasses
import filecmp

import numpy as np

from visualbert_tpu.tasks import registry as jax_registry
from visualbert_tpu.utils.config_io import parse_task_config as jax_parse_task_config
from visualbert_torch.data.datasets import vqa
from visualbert_torch.models.visualbert import VisualBertForTask
from visualbert_torch.tasks import registry
from visualbert_torch.utils.checkpoint import CheckpointManager
from visualbert_torch.utils.config_io import parse_task_config

TINY = {"vocab_size": 128, "hidden_size": 32, "num_hidden_layers": 1, "num_attention_heads": 2,
        "intermediate_size": 64, "max_position_embeddings": 64, "visual_embedding_dim": 32, "dtype": "float32"}


def test_run_fit_selects_the_lowest_loss_epoch(tmp_path):
    """Four epochs of a tiny VQA run at a large learning rate (its eval loss
    goes up and down), selected by ``val_metric="loss"``: the best metric is
    the lowest epoch loss, the best epoch is that epoch and best.pt holds its
    checkpoint."""
    cfg = dataclasses.replace(parse_task_config({
        "task": "vqa", "data": {"synthetic": 40, "max_seq_length": 12, "max_regions": 6},
        "model": TINY, "optimizer": {"learning_rate": 0.05, "schedule": "none"},
        "train": {"train_batch_size": 8, "eval_batch_size": 8, "num_train_epochs": 4, "num_workers": 0},
    }), folder=str(tmp_path))
    tok = registry._tokenizer(cfg)
    ann, feats, vocab = vqa.make_synthetic(40, tok, n_answers=8, feat_dim=32)

    def ds(a):
        return vqa.VQADataset(a, feats, tok, vocab, max_seq_length=12, max_regions=6)

    model = VisualBertForTask(cfg.model, head_type="vqa", num_answers=len(vocab))
    trainer, result = registry._run_fit(cfg, registry._trainer(cfg, model, "cpu"), ds(ann[:32]), ds(ann[32:]),
                                        val_metric="loss")
    losses = [h["val_loss"] for h in result.history]
    assert len(losses) == 4 and len(set(losses)) == 4
    best = int(np.argmin(losses))
    assert result.best_metric == min(losses) and result.best_epoch == best
    steps_per_epoch = trainer.step // 4
    ckpt = tmp_path / "ckpt"
    assert CheckpointManager(str(ckpt)).latest_step() == trainer.step
    assert filecmp.cmp(ckpt / "best.pt", ckpt / f"step_{(best + 1) * steps_per_epoch}.pt", shallow=False)


def test_coco_pretrain_selects_by_loss_as_jax(tmp_path):
    """coco_pretrain has no eval split and selects by loss in both packages,
    so neither ever improves on its starting best of +inf."""
    raw = {"task": "coco_pretrain", "data": {"synthetic": 16, "max_seq_length": 12, "max_regions": 6},
           "model": TINY, "train": {"train_batch_size": 8, "num_train_epochs": 1, "num_workers": 0}}
    _, got = registry.run(dataclasses.replace(parse_task_config(raw), folder=str(tmp_path / "torch")), "cpu")
    _, want = jax_registry.run(dataclasses.replace(jax_parse_task_config(raw), folder=str(tmp_path / "jax")))
    assert got.best_metric == want.best_metric == float("inf")
    assert got.best_epoch == want.best_epoch == -1
