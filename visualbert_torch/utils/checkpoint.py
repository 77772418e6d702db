"""Checkpoints of a ``Trainer`` over ``torch.save`` (counterpart of
``visualbert_tpu/utils/checkpoint.py``, which uses orbax).

Reference behaviour (``model_wrapper.py:163-221``, ``pytorch_misc.py:110-152``):
numbered checkpoints per epoch and mid-epoch, a ``best`` copy tracking the
validation metric, resume from the latest, the oldest removed beyond
``max_to_keep``. A checkpoint file ``step_<N>.pt`` holds the model's state
dict, BertAdam's moments and step count, the trainer's step and the state of
its dropout generator, so a restored trainer continues the same run.

Under a (data, model) mesh (JAX ``:21-76``) a checkpoint is still one full
file: every rank takes part in gathering the tensors split over the model
axis (``parallel/mesh.py::gather_params``), rank 0 writes, and barriers
fence the write; every rank reads the whole file and keeps its shard
(``Trainer.reshard_state``), so a checkpoint written at one mesh shape
restores at any other.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Optional

import torch

from visualbert_torch.parallel import distributed
from visualbert_torch.parallel.mesh import gather_params

_STEP_FILE = re.compile(r"step_(\d+)\.pt")


def trainer_state(trainer) -> dict:
    """The trainer's full state; collective over the model group under a
    mesh (the split tensors are gathered)."""
    opt, mesh = trainer.optimizer, trainer.mesh
    return {
        "step": trainer.step,
        "model": gather_params(trainer.model.state_dict(), mesh),
        "optimizer": {"step_count": opt.step_count, "m": gather_params(opt.m, mesh),
                      "v": gather_params(opt.v, mesh)},
        "dropout_generator": trainer.dropout_generator.get_state(),
    }


def load_trainer_state(trainer, path: str):
    """Load the checkpoint file ``path`` into ``trainer`` (built and
    ``init_state``-ed with the same model and optimizer settings, at any
    mesh shape)."""
    state = torch.load(path, map_location=trainer.device, weights_only=True)
    if trainer.mesh is not None:
        state = trainer.reshard_state(state)
    trainer.model.load_state_dict(state["model"], strict=True)
    opt = trainer.optimizer
    with torch.no_grad():
        for name in ("m", "v"):
            saved, own = state["optimizer"][name], getattr(opt, name)
            if set(saved) != set(own):
                raise KeyError(f"{path}: optimizer {name} keys differ from the model's parameters")
            for k, t in own.items():
                t.copy_(saved[k])
    opt.step_count = int(state["optimizer"]["step_count"])
    trainer.step = int(state["step"])
    trainer.dropout_generator.set_state(state["dropout_generator"].cpu())
    return trainer


class CheckpointManager:
    """``step_<N>.pt`` files and a ``best.pt`` copy in ``directory``."""

    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def _steps(self):
        return sorted(int(m.group(1)) for name in os.listdir(self.directory) if (m := _STEP_FILE.fullmatch(name)))

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def save(self, step: int, trainer, is_best: bool = False) -> str:
        """Write ``step_<step>.pt`` (and ``best.pt`` with ``is_best``); under
        a multi-rank launch every rank calls this, rank 0 writes."""
        path = self._path(step)
        state = trainer_state(trainer)
        distributed.barrier()
        if distributed.rank() == 0:
            tmp = path + ".tmp"
            torch.save(state, tmp)
            os.replace(tmp, path)  # a crash mid-write leaves the previous file whole
            if is_best:
                shutil.copyfile(path, os.path.join(self.directory, "best.pt"))
            for s in self._steps()[: -self.max_to_keep]:
                os.remove(self._path(s))
        distributed.barrier()
        return path

    def path(self, step: Optional[int] = None) -> str:
        """The file of ``step``, by default the latest."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return self._path(step)

    def restore(self, trainer, step: Optional[int] = None):
        return load_trainer_state(trainer, self.path(step))
