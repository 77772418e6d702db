"""BertAdam (counterpart of ``visualbert_tpu/train/optimizer.py``; reference
``visualbert/pytorch_pretrained_bert/optimization.py:185-302``).

The three quirks that ``torch.optim.AdamW`` does not have:

1. no bias correction: the update is ``m / (sqrt(v) + eps)`` from step 0;
2. each parameter tensor's gradient is clipped to ``max_grad_norm`` by its
   own norm, inside the step (:272-273). As in the JAX package, whose model
   keeps each layer's Q, K and V projections as ONE tensor [E, 3, H, D]
   (``models/encoder.py:169-185``) and clips it by one norm
   (``train/optimizer.py:78-91``), each layer's three
   ``attention.self.{query,key,value}.weight`` tensors are clipped by their
   joint norm, and so are the three biases (:func:`clip_groups`);
3. the schedule multiplier is taken at the step count BEFORE the increment,
   so under a warmup schedule the first update has learning rate 0.

Weight decay is decoupled and masked by name (no decay for biases,
LayerNorms and the detector's batch-norm scales, model_wrapper.py:106-110;
JAX ``default_decay_mask``). A model whose names do not carry JAX's
decision (the unsupervised stack's LXRT names, ROADMAP.md C9) hands its own
``decays(name, no_decay)``. Parameters whose name contains a
``frozen`` substring (the pooler in COCO pretraining, JAX
``tasks/registry.py:87-96``) get no update, while their moments still move
(JAX ``optimizer.py:214-224``). Moments are fp32. The schedule is evaluated
in float32 scalars, as the JAX package's traced schedule is.

Under tensor parallelism each rank holds a block of some tensors
(``parallel/mesh.py``); their clip norm is that of the WHOLE tensor (of the
whole Q/K/V group), so the squared norms of those clip groups are summed
over the model group, in one all-reduce, before the clip.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

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


# a FrozenBatchNorm's scale under its torchvision name: ``bnK.weight`` or a
# downsample branch's ``downsample.1.weight`` (JAX ``.../bnK/scale``)
_BN_SCALE = re.compile(r"(?:^|.*\.)(?:bn\d+|downsample\.1)\.weight")


def decays(name: str, no_decay: Iterable[str] = ()) -> bool:
    """Whether a parameter gets weight decay, as JAX's
    ``default_decay_mask`` decides on its paths: not for biases, norms or
    batch-norm scales (a Flax path ending in ``/bias`` or ``/scale`` or
    holding ``norm``), nor any ``no_decay`` substring. A batch norm's
    running mean and var do decay, as they do in JAX."""
    lname = name.lower()
    if "bias" in lname or "norm" in lname or _BN_SCALE.fullmatch(name):
        return False
    return not any(s.lower() in lname for s in no_decay)


_QKV = re.compile(r"(.*attention\.self\.)(?:query|key|value)\.(weight|bias)")


def clip_groups(names: Iterable[str]) -> List[List[str]]:
    """Parameter names grouped by the norm their gradients are clipped by:
    each layer's query/key/value weights together, their biases together,
    every other parameter alone."""
    groups: Dict[object, List[str]] = {}
    for k in names:
        m = _QKV.fullmatch(k)
        groups.setdefault(m.groups() if m else k, []).append(k)
    return list(groups.values())


class BertAdam:
    """BertAdam over ``named_params`` (unique parameters, as
    ``module.named_parameters()`` yields them); ``decay(name, no_decay)``
    decides weight decay, :func:`decays` by default. ``split`` names the
    parameters that this rank holds a block of, split over ``model_group``."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]], cfg: OptimizerConfig,
                 decay: Optional[Callable[[str, Iterable[str]], bool]] = None, split: Iterable[str] = (),
                 model_group=None):
        self.cfg = cfg
        self.params: Dict[str, torch.nn.Parameter] = dict(named_params)
        self.schedule = make_schedule(cfg.schedule, cfg.warmup, cfg.t_total)
        self.step_count = 0
        self.m = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in self.params.items()}
        self.v = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in self.params.items()}
        decay = decays if decay is None else decay
        self.decay = {k: decay(k, cfg.no_decay) for k in self.params}
        frozen = cfg.frozen or ()
        self.frozen = {k: any(s in k for s in frozen) for k in self.params}
        self.clip_groups = clip_groups(self.params)
        split = set(split)
        self.model_group = model_group if split else None
        # a clip group is split whole or not at all (Q, K and V alike)
        self.split_groups = [i for i, g in enumerate(self.clip_groups) if split & set(g)]

    def lr(self) -> float:
        """The learning rate of the next update."""
        return float(f32(self.cfg.learning_rate) * self.schedule(self.step_count))

    @torch.no_grad()
    def step(self) -> None:
        """One update from the parameters' ``.grad`` (None counts as zero)."""
        cfg = self.cfg
        lr_t = self.lr()
        grads = {k: p.grad.float() if p.grad is not None else torch.zeros_like(self.m[k])
                 for k, p in self.params.items()}
        scale = {}
        if cfg.max_grad_norm > 0:
            sq = [sum(torch.sum(grads[k] * grads[k]) for k in group) for group in self.clip_groups]
            if self.model_group is not None and self.split_groups:
                # the whole tensors' squared norms: one all-reduce
                total = torch.stack([sq[i] for i in self.split_groups])
                dist.all_reduce(total, group=self.model_group)
                for j, i in enumerate(self.split_groups):
                    sq[i] = total[j]
            for group, sq_norm in zip(self.clip_groups, sq):
                s = torch.clamp(cfg.max_grad_norm / (torch.sqrt(sq_norm) + 1e-6), max=1.0)
                scale.update((k, s) for k in group)
        for k, p in self.params.items():
            g = grads[k] * scale[k] if k in scale else grads[k]
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
