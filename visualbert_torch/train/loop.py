"""Epoch-based training loop with per-epoch eval, metric rollups, patience
early stop and best-checkpoint tracking (counterpart of
``visualbert_tpu/train/loop.py``; the reference's ``train.py:232-414``
control flow).

Datasets are callables that build iterables of numpy batch dicts (see
``data/pipeline.py``). Metrics are global sums over examples, as in the JAX
package. One train step runs per batch: the JAX loop's
``steps_per_dispatch`` fuses steps into one TPU dispatch and has no
counterpart here.

Under a mesh every rank runs this loop on its slice of each batch; the
Trainer hands every rank the global metrics, so every rank keeps the same
epoch history and makes the same early-stop, best-epoch and
``save_every`` decisions.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from visualbert_torch.config import TrainConfig
from visualbert_torch.parallel import distributed
from visualbert_torch.train.trainer import Trainer
from visualbert_torch.utils.checkpoint import CheckpointManager
from visualbert_torch.utils.logging import get_logger

log = get_logger(__name__)


class MetricAccumulator:
    """Weighted running means (weight = batch size)."""

    def __init__(self):
        self.sums: Dict[str, float] = {}
        self.weights: Dict[str, float] = {}

    def update(self, metrics: Dict[str, Any], weight: float):
        for k, v in metrics.items():
            try:
                x = float(v)
            except (TypeError, ValueError):
                continue
            self.sums[k] = self.sums.get(k, 0.0) + x * weight
            self.weights[k] = self.weights.get(k, 0.0) + weight

    def means(self) -> Dict[str, float]:
        return {k: self.sums[k] / max(self.weights[k], 1e-12) for k in self.sums}


@dataclasses.dataclass
class FitResult:
    best_metric: float
    best_epoch: int
    epochs_run: int
    history: list


def _batch_size(batch) -> int:
    return len(next(v for k, v in batch.items() if v is not None and not k.startswith("_")))


def _example_count(batch) -> float:
    """Real examples in an eval batch: model scalars are means over the
    non-duplicate rows (``example_weight`` from ``Batcher(pad_final=True)``),
    so weighting by this count makes the epoch rollup exact."""
    if "_real_count" in batch:
        return float(batch["_real_count"])
    if "example_weight" in batch:
        return float(np.sum(batch["example_weight"]))
    return float(_batch_size(batch))


def evaluate(trainer: Trainer, batches: Iterable[Dict[str, np.ndarray]],
             collect: Optional[Callable[[Dict, Dict], None]] = None) -> Dict[str, float]:
    """The split-level means of ``trainer.eval_step``'s scalar outputs over
    ``batches``, each batch weighted by its real example count;
    ``collect(batch, outputs)`` sees every batch and its outputs."""
    acc = MetricAccumulator()
    for batch in batches:
        out = trainer.eval_step(batch)
        acc.update({k: v for k, v in out.items() if torch.is_tensor(v) and v.dim() == 0}, _example_count(batch))
        if collect is not None:
            collect(batch, out)
    return acc.means()


def fit(
    trainer: Trainer,
    train_data: Callable[[int], Iterable[Dict[str, np.ndarray]]],
    eval_data: Optional[Callable[[], Iterable[Dict[str, np.ndarray]]]] = None,
    *,
    checkpoint_dir: Optional[str] = None,
    val_metric: str = "accuracy",
    val_metric_higher_is_better: bool = True,
) -> FitResult:
    """Run the fit loop of ``trainer.train_config`` on ``trainer`` (its
    state is updated in place).

    ``train_data(epoch)`` / ``eval_data()`` build fresh batch iterators. On
    any failure a checkpoint is saved before the exception propagates."""
    cfg = trainer.train_config
    ckpt = CheckpointManager(checkpoint_dir) if checkpoint_dir else None
    best = -np.inf if val_metric_higher_is_better else np.inf
    best_epoch = -1
    history = []
    try:
        for epoch in range(cfg.num_train_epochs):
            epoch_metrics = _train_epoch(trainer, train_data(epoch), cfg, ckpt, epoch)
            if eval_data is not None:
                epoch_metrics.update({"val_" + k: v for k, v in evaluate(trainer, eval_data()).items()})
            history.append(epoch_metrics)
            log.info("epoch %d: %s", epoch, {k: round(v, 4) for k, v in epoch_metrics.items()})

            current = epoch_metrics.get("val_" + val_metric)
            improved = current is not None and (current > best if val_metric_higher_is_better else current < best)
            if improved:
                best, best_epoch = current, epoch
            if ckpt:
                ckpt.save(trainer.step, trainer, is_best=improved)
            # patience early stop on the best validation epoch (train.py:398-400)
            if current is not None and epoch - best_epoch >= cfg.patience:
                log.info("early stop at epoch %d (best %.4f @ %d)", epoch, best, best_epoch)
                break
    except (KeyboardInterrupt, Exception):
        # checkpoint-on-failure, then re-raise (reference train.py:404-414);
        # not under a multi-rank launch, whose save is collective and would
        # wait for ranks that did not fail
        if ckpt is not None and not distributed.is_distributed():
            log.warning("interrupted/failed: checkpoint saved to %s", ckpt.save(trainer.step, trainer))
        raise
    return FitResult(best_metric=float(best), best_epoch=best_epoch, epochs_run=len(history), history=history)


def _train_epoch(trainer: Trainer, batches, cfg: TrainConfig, ckpt, epoch: int) -> Dict[str, float]:
    acc = MetricAccumulator()
    t0 = time.time()
    n_batches = 0
    accum = cfg.gradient_accumulation_steps
    # reading a step's metrics waits for the device, so step N's are read
    # after step N+1 is enqueued
    deferred = None

    def roll_up(metrics, weight):
        nonlocal n_batches
        n_batches += 1
        acc.update(metrics, weight)
        if cfg.log_every and n_batches % cfg.log_every == 0:
            log.info("epoch %d step %d loss=%.4f (%.2f s/batch)", epoch, n_batches,
                     acc.means().get("loss", float("nan")), (time.time() - t0) / n_batches)
        if ckpt and cfg.save_every and n_batches % cfg.save_every == 0:
            ckpt.save(trainer.step, trainer)

    for batch in batches:
        bs = _batch_size(batch)
        if accum > 1:
            # [accum, micro, ...] for the trainer's microbatch loop; '_' keys
            # are host-side metadata
            batch = {k: v if v is None or k.startswith("_") else v.reshape((accum, bs // accum) + v.shape[1:])
                     for k, v in batch.items()}
        metrics = trainer.train_step(batch)
        if deferred is not None:
            roll_up(*deferred)
        deferred = (metrics, bs)
    if deferred is not None:
        roll_up(*deferred)
    return {"train_" + k: v for k, v in acc.means().items()}
