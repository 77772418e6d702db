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

Under a (data, model) mesh (``Trainer(mesh=...)``, JAX ``:72-113``) every
rank builds the full seeded weights, then keeps its shard
(``parallel/mesh.py::shard_module``); each rank's generator draws the same
seeds and each dropout site offsets them by the rank's data index (and
model index, for attention probabilities). The model runs inside
``losses.global_denominators`` of the data group; after the backward one
all-reduce (SUM) over the data group of a flat fp32 buffer of every
gradient gives the gradient of the global loss, and one more of the scalar
metrics gives every rank the global values (the ``nan_guard`` decision
reads the reduced loss, so every rank makes it alike). Then BertAdam.
Under tensor parallelism the gradients of the parameters that the model
group holds whole are model rank 0's on every peer first (one broadcast):
the peers compute them from equal tensors, but CUDA's embedding backward
sums a row's many duplicate indices in no fixed order (the token-type
tables', 12,800-16,384 a step on the main path), and replicas must not
drift apart.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch
import torch.distributed as dist

from visualbert_torch.config import OptimizerConfig, TrainConfig
from visualbert_torch.models import losses
from visualbert_torch.parallel.mesh import (Mesh, model_split_dim, shard_module, shard_params, split_parameter_names,
                                            unshard_module)
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


def _sum_scalars(out: Dict, group) -> Dict:
    """The 0-d tensors of ``out`` summed over ``group`` in one all-reduce."""
    names = [k for k, v in out.items() if torch.is_tensor(v) and v.dim() == 0]
    if group is None or not names:
        return out
    total = torch.stack([out[k].detach().float() for k in names])
    dist.all_reduce(total, group=group)
    return dict(out, **{k: total[i] for i, k in enumerate(names)})


class Trainer:
    """Owns the model, the optimizer and the dropout generator of a run, on
    ``device`` (``"cuda"`` for the kernels; ``"cpu"`` runs their plain
    versions and must be asked for), and this rank's place in ``mesh``
    (None: one process)."""

    def __init__(self, model: torch.nn.Module, opt_config: OptimizerConfig, train_config: TrainConfig,
                 device, mesh: Optional[Mesh] = None):
        self.model = model
        self.opt_config = opt_config
        self.train_config = train_config
        self.device = torch.device(device)
        self.mesh = mesh
        self.optimizer: Optional[BertAdam] = None
        self.step = 0
        self.dropout_generator = torch.Generator()
        self._sharded = False

    @property
    def data_group(self):
        return None if self.mesh is None else self.mesh.data_group

    def init_state(self, init_weights: bool = True) -> "Trainer":
        """Seeded weights (unless loaded already: ``init_weights=False``),
        cut to this rank's shard, fresh BertAdam moments, the step counter
        and dropout generator reset."""
        seed = self.train_config.seed
        if self._sharded:  # a second init_state starts from the whole parameters again
            unshard_module(self.model, self.mesh)
        if init_weights:
            self.model.init_weights(torch.Generator().manual_seed(seed))
        self.model.to(self.device)
        shard_module(self.model, self.mesh)
        self._sharded = True
        self.optimizer = BertAdam(self.model.named_parameters(), self.opt_config,
                                  decay=getattr(self.model, "decays", None),
                                  split=split_parameter_names(self.model, self.mesh),
                                  model_group=None if self.mesh is None else self.mesh.model_group)
        self.step = 0
        self.dropout_generator = torch.Generator().manual_seed(seed + 1)
        return self

    @contextlib.contextmanager
    def gathered(self):
        """The model with its full parameters on every rank within the block
        (e.g. to load a reference checkpoint into it), cut back to the
        rank's shard after; collective over the model group."""
        unshard_module(self.model, self.mesh)
        try:
            yield self.model
        finally:
            shard_module(self.model, self.mesh)

    def reshard_state(self, state: Dict) -> Dict:
        """A full checkpoint state (``utils/checkpoint.py::trainer_state``,
        written at any mesh shape) -> this rank's shard of it (JAX
        ``reshard_state``, ``:284-300``)."""
        opt = state["optimizer"]
        return dict(state, model=shard_params(state["model"], self.mesh),
                    optimizer=dict(opt, m=shard_params(opt["m"], self.mesh), v=shard_params(opt["v"], self.mesh)))

    def _grads(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        with losses.global_denominators(self.data_group):
            out = self.model(batch, self.dropout_generator)
        out["loss"].backward()
        return {k: v.detach() for k, v in out.items() if torch.is_tensor(v) and v.dim() == 0}

    def _collective_grads(self, params, collective) -> None:
        """``collective`` on one flat fp32 buffer of ``params``' gradients
        (a parameter without a gradient counts as zero), written back."""
        flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1).float()
                          for p in params])
        collective(flat)
        off = 0
        for p in params:
            p.grad = flat[off: off + p.numel()].view_as(p).to(p.dtype)
            off += p.numel()

    def _reduce_grads(self) -> None:
        mesh = self.mesh
        if mesh.model_group is not None:
            whole = [p for k, p in self.model.named_parameters() if model_split_dim(k) is None]
            self._collective_grads(whole, lambda t: dist.broadcast(t, src=mesh.model_root, group=mesh.model_group))
        if mesh.data_group is not None:
            self._collective_grads(list(self.model.parameters()),
                                   lambda t: dist.all_reduce(t, group=mesh.data_group))

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
        if self.mesh is not None:
            self._reduce_grads()
            metrics = _sum_scalars(metrics, self.data_group)

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
        ``[L, B, H, T, T]``. Under a mesh the scalars are the global ones;
        every other output is this rank's rows."""
        with losses.global_denominators(self.data_group):
            out = self.model(to_device(batch, self.device), output_attention_probs=output_attention_probs)
        return _sum_scalars(out, self.data_group)
