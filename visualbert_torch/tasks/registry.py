"""Tasks: build (model, datasets) for a task and run the fit loop
(counterpart of ``visualbert_tpu/tasks/registry.py``; the reference's
``visualbert/models/train.py`` dataset dispatch, train.py:148-191).

The port has ``coco_pretrain``; the other tasks wait for their heads and
datasets (ROADMAP.md A7). A task supports ``data: {"synthetic": N}`` for
smoke runs and real-data paths (documented per task).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Dict

import torch

from visualbert_torch.data.pipeline import Batcher, prefetch
from visualbert_torch.data.tokenization import BertTokenizer
from visualbert_torch.models.visualbert import VisualBertForTask
from visualbert_torch.train.loop import fit
from visualbert_torch.train.trainer import Trainer
from visualbert_torch.utils.checkpoint import CheckpointManager, load_trainer_state
from visualbert_torch.utils.config_io import TaskConfig
from visualbert_torch.utils.logging import add_run_folder, get_logger

log = get_logger(__name__)

TASKS: Dict[str, Callable] = {}


def register(name):
    def deco(fn):
        TASKS[name] = fn
        return fn

    return deco


def _tokenizer(cfg: TaskConfig) -> BertTokenizer:
    vocab_file = cfg.data.get("vocab_file")
    if vocab_file:
        # the pure-Python tokenizer; the JAX package's native fast path is
        # byte-exact with it and is not ported (ROADMAP.md A7)
        return BertTokenizer.from_file(vocab_file)
    if "synthetic" not in cfg.data:
        # training over the toy vocabulary would silently produce garbage
        raise ValueError(
            "data.vocab_file is required for real-data configs (the synthetic toy vocabulary is only "
            "used when data.synthetic is set); point it at the bert-base-uncased vocab.txt"
        )
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "?"] + [f"w{i}" for i in range(100)]
    return BertTokenizer({w: i for i, w in enumerate(words)})


def _trainer(cfg: TaskConfig, model) -> Trainer:
    """A Trainer on the CUDA card when there is one, else on the CPU (where
    every kernel runs its plain version)."""
    device = "cuda" if torch.cuda.is_available() else "cpu"
    return Trainer(model, cfg.optimizer, cfg.train, device=device)


def _default_frozen_pooler(cfg: TaskConfig) -> TaskConfig:
    """Pretraining tasks: the reference excludes the pooler from
    optimization (model_wrapper.py:104). Applied only when the config left
    ``optimizer.frozen`` unset (None); an explicit ``[]`` trains everything."""
    if cfg.optimizer.frozen is not None:
        return cfg
    return dataclasses.replace(cfg, optimizer=dataclasses.replace(cfg.optimizer, frozen=("pooler",)))


def _restore(cfg: TaskConfig, trainer: Trainer) -> Trainer:
    """Load the port's own checkpoint: a checkpoint directory (its latest
    step) or one ``step_<N>.pt`` / ``best.pt`` file."""
    path = cfg.restore_checkpoint
    if path.endswith((".th", ".pth", ".bin")):
        raise NotImplementedError(f"{path}: importing reference torch checkpoints is not ported yet (ROADMAP.md A7)")
    if os.path.isdir(path):
        path = CheckpointManager(path).path()
    load_trainer_state(trainer, path)
    log.info("restored checkpoint %s (step %d)", path, trainer.step)
    return trainer


def _run_fit(cfg: TaskConfig, trainer: Trainer, train_ds):
    """Fit ``trainer`` on ``train_ds``, checkpointing into ``<folder>/ckpt``.
    The port's one task has no eval split, so no eval Batcher is built."""
    if cfg.eval_only:
        raise NotImplementedError("eval_only runs the evaluate/dump hooks, not ported yet (ROADMAP.md A7)")
    trainer.init_state()
    if cfg.restore_checkpoint:
        _restore(cfg, trainer)
    train_b = Batcher(train_ds, cfg.train.train_batch_size, seed=cfg.train.seed, num_workers=cfg.train.num_workers)
    try:
        result = fit(trainer, lambda e: prefetch(train_b.epoch(e)), checkpoint_dir=os.path.join(cfg.folder, "ckpt"))
    finally:
        train_b.close()
    return trainer, result


# ---- tasks ----


@register("coco_pretrain")
def run_coco_pretrain(cfg: TaskConfig):
    """COCO-caption MLM + sentence-image alignment pretraining. Real data:
    ``annotations`` (a json list of {"image_id", "captions"}), region
    features in ``features_dir`` (``<image_id>.npy``) and ``vocab_file``."""
    from visualbert_torch.data.datasets import coco as coco_ds

    tok = _tokenizer(cfg)
    d = cfg.data
    if "synthetic" in d:
        ann, feats = coco_ds.make_synthetic(int(d["synthetic"]), tok, feat_dim=cfg.model.visual_embedding_dim)
    else:
        if "features_h5" in d:
            raise NotImplementedError("HDF5 features are not ported (no h5py on the card's machine; ROADMAP.md A7)")
        from visualbert_torch.data.features import NpyFolderFeatures

        with open(d["annotations"]) as f:
            ann = json.load(f)
        feats = NpyFolderFeatures(d["features_dir"])
    ds = coco_ds.CocoCaptionsDataset(
        ann, feats, tok,
        max_seq_length=int(d.get("max_seq_length", 128)),
        max_regions=int(d.get("max_regions", 100)),
        two_sentence=bool(d.get("two_sentence", True)),
    )
    model = VisualBertForTask(cfg.model, head_type="pretraining")
    cfg = _default_frozen_pooler(cfg)
    return _run_fit(cfg, _trainer(cfg, model), ds)


def run(cfg: TaskConfig):
    """Run ``cfg.task``; returns (trainer, FitResult). Logs are teed into
    ``run_N.log`` in the run folder."""
    if cfg.task not in TASKS:
        raise KeyError(f"unknown task {cfg.task}; the port has {sorted(TASKS)} (ROADMAP.md A7 for the others)")
    handler = add_run_folder(cfg.folder)
    try:
        log.info("running task %s -> %s", cfg.task, cfg.folder)
        return TASKS[cfg.task](cfg)
    finally:
        get_logger().removeHandler(handler)
        handler.close()
