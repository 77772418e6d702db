"""BertAdam (counterpart of ``visualbert_tpu/train/optimizer.py``; reference
``visualbert/pytorch_pretrained_bert/optimization.py:185-302``).

The three quirks that ``torch.optim.AdamW`` does not have:

1. no bias correction: the update is ``m / (sqrt(v) + eps)`` from step 0;
2. each parameter tensor's gradient is clipped to ``max_grad_norm`` by its
   own norm, inside the step (:272-273);
3. the schedule multiplier is taken at the step count BEFORE the increment,
   so under a warmup schedule the first update has learning rate 0.

Weight decay is decoupled and masked by name (no decay for biases and
LayerNorms, model_wrapper.py:106-110). Parameters whose name contains a
``frozen`` substring (the pooler in COCO pretraining, JAX
``tasks/registry.py:87-96``) get no update, while their moments still move
(JAX ``optimizer.py:214-224``). Moments are fp32. The schedule is evaluated
in float32 scalars, as the JAX package's traced schedule is.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from visualbert_torch.config import OptimizerConfig

f32 = np.float32


def make_schedule(name: Optional[str], warmup: float, t_total: int) -> Callable[[int], np.float32]:
    """The lr multiplier at a step (reference optimization.py:83-182)."""
    warmup = max(float(warmup), 0.0)
    if name in (None, "none") or t_total < 0:
        return lambda step: f32(1.0)
    t = f32(t_total)
    wu = f32(max(warmup, 1e-12))

    def progress(step):
        return f32(step) / t

    if name == "warmup_constant":
        return lambda step: progress(step) / wu if progress(step) < f32(warmup) else f32(1.0)
    if name == "warmup_linear":
        def fn(step):
            p = progress(step)
            if p < f32(warmup):
                return p / wu
            return max((p - f32(1.0)) / f32(warmup - 1.0), f32(0.0))
        return fn
    if name == "warmup_cosine":
        def fn(step):
            p = progress(step)
            if p < f32(warmup):
                return p / wu
            after = (p - f32(warmup)) / f32(1.0 - warmup)
            return f32(0.5) * (f32(1.0) + np.cos(f32(math.pi * 0.5 * 2.0) * after, dtype=np.float32))
        return fn
    raise ValueError(f"unknown schedule {name}")


def decays(name: str, no_decay: Iterable[str] = ()) -> bool:
    """Whether a parameter gets weight decay: not for biases or norms
    (JAX ``default_decay_mask``), nor any ``no_decay`` substring."""
    lname = name.lower()
    if "bias" in lname or "norm" in lname:
        return False
    return not any(s.lower() in lname for s in no_decay)


class BertAdam:
    """BertAdam over ``named_params`` (unique parameters, as
    ``module.named_parameters()`` yields them)."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]], cfg: OptimizerConfig):
        self.cfg = cfg
        self.params: Dict[str, torch.nn.Parameter] = dict(named_params)
        self.schedule = make_schedule(cfg.schedule, cfg.warmup, cfg.t_total)
        self.step_count = 0
        self.m = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in self.params.items()}
        self.v = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in self.params.items()}
        self.decay = {k: decays(k, cfg.no_decay) for k in self.params}
        frozen = cfg.frozen or ()
        self.frozen = {k: any(s in k for s in frozen) for k in self.params}

    def lr(self) -> float:
        """The learning rate of the next update."""
        return float(f32(self.cfg.learning_rate) * self.schedule(self.step_count))

    @torch.no_grad()
    def step(self) -> None:
        """One update from the parameters' ``.grad`` (None counts as zero)."""
        cfg = self.cfg
        lr_t = self.lr()
        for k, p in self.params.items():
            g = p.grad.float() if p.grad is not None else torch.zeros_like(self.m[k])
            if cfg.max_grad_norm > 0:
                norm = torch.sqrt(torch.sum(g * g))
                g = g * torch.clamp(cfg.max_grad_norm / (norm + 1e-6), max=1.0)
            m, v = self.m[k], self.v[k]
            m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
            if self.frozen[k]:
                continue
            upd = m / (torch.sqrt(v) + cfg.eps)
            if cfg.weight_decay > 0 and self.decay[k]:
                upd = upd + cfg.weight_decay * p.float()
            p.sub_((lr_t * upd).to(p.dtype))
        self.step_count += 1
