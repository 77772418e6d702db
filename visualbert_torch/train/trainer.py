"""Training step (counterpart of ``visualbert_tpu/train/trainer.py``).

The JAX Trainer compiles forward, backward, microbatch accumulation and the
BertAdam update into one XLA program; here the same step runs eagerly:
``Trainer.init_state()`` builds the weights from ``TrainConfig.seed`` and the
optimizer state, ``Trainer.train_step(batch)`` runs one update and
``Trainer.eval_step(batch)`` one forward without dropout. Parameters and
moments are fp32; compute follows ``model.cfg.dtype``.

Dropout seeds come from one ``torch.Generator`` seeded from
``TrainConfig.seed``: every dropout site draws a fresh int32 seed from it at
every step, so a run is reproducible from its seed.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from visualbert_torch.config import OptimizerConfig, TrainConfig
from visualbert_torch.train.optimizer import BertAdam


def to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """numpy/tensor batch -> device tensors; integer arrays become int64
    (torch's index type), except ``images``, which keeps its wire dtype
    (uint8 pixels, normalized on the device, or fp32); keys starting with
    '_' are host metadata."""
    out = {}
    for k, v in batch.items():
        if v is None or k.startswith("_"):
            continue
        t = torch.as_tensor(v)
        if k != "images" and t.dtype in (torch.int8, torch.int16, torch.int32, torch.uint8):
            t = t.long()
        out[k] = t.to(device, non_blocking=True)
    return out


class Trainer:
    """Owns the model, the optimizer and the dropout generator of a run, on
    ``device`` (``"cuda"`` for the kernels; ``"cpu"`` runs their plain
    versions and must be asked for)."""

    def __init__(self, model: torch.nn.Module, opt_config: OptimizerConfig, train_config: TrainConfig,
                 device):
        self.model = model
        self.opt_config = opt_config
        self.train_config = train_config
        self.device = torch.device(device)
        self.optimizer: Optional[BertAdam] = None
        self.step = 0
        self.dropout_generator = torch.Generator()

    def init_state(self, init_weights: bool = True) -> "Trainer":
        """Seeded weights (unless loaded already: ``init_weights=False``),
        fresh BertAdam moments, the step counter and dropout generator reset."""
        seed = self.train_config.seed
        if init_weights:
            self.model.init_weights(torch.Generator().manual_seed(seed))
        self.model.to(self.device)
        self.optimizer = BertAdam(self.model.named_parameters(), self.opt_config,
                                  decay=getattr(self.model, "decays", None))
        self.step = 0
        self.dropout_generator = torch.Generator().manual_seed(seed + 1)
        return self

    def _grads(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        out = self.model(batch, self.dropout_generator)
        out["loss"].backward()
        return {k: v.detach() for k, v in out.items() if torch.is_tensor(v) and v.dim() == 0}

    def train_step(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """One update. ``batch`` leaves are [B, ...], or [accum, micro, ...]
        with ``gradient_accumulation_steps`` = accum > 1 (gradients and
        metrics are averaged over the microbatches). Returns scalar metrics
        as device tensors (reading them waits for the device)."""
        if self.optimizer is None:
            raise RuntimeError("call init_state() before train_step()")
        batch = to_device(batch, self.device)
        for p in self.model.parameters():
            p.grad = None
        accum = self.train_config.gradient_accumulation_steps
        if accum > 1:
            metrics = None
            for i in range(accum):
                m = self._grads({k: v[i] for k, v in batch.items()})
                metrics = m if metrics is None else {k: metrics[k] + m[k] for k in m}
            metrics = {k: v / accum for k, v in metrics.items()}
            for p in self.model.parameters():
                if p.grad is not None:
                    p.grad /= accum
        else:
            metrics = self._grads(batch)

        if self.train_config.nan_guard and not bool(torch.isfinite(metrics["loss"])):
            # keep parameters and moments; the step counter still advances
            metrics["skipped_nonfinite"] = torch.ones((), device=self.device)
        else:
            self.optimizer.step()
            if self.train_config.nan_guard:
                metrics["skipped_nonfinite"] = torch.zeros((), device=self.device)
        self.step += 1
        return metrics

    @torch.no_grad()
    def eval_step(self, batch: Dict, output_attention_probs: bool = False) -> Dict[str, torch.Tensor]:
        """The model's outputs on ``batch`` with dropout off and no
        gradients (JAX ``Trainer.eval_step_fn``); with
        ``output_attention_probs`` also the encoder's ``attention_weights``
        ``[L, B, H, T, T]``."""
        return self.model(to_device(batch, self.device), output_attention_probs=output_attention_probs)
