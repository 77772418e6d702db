"""Weight bridge: a ``{torch_name: np.ndarray}`` state dict, as
``visualbert_tpu/tools/export_torch.py::export_state_dict`` emits it from
Flax params, loaded into a port module with ``strict=True``.

The port never imports the JAX package; whoever holds a Flax checkpoint
exports it on the JAX side and hands the arrays over.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def load_state(module: torch.nn.Module, state: Mapping[str, np.ndarray]) -> torch.nn.Module:
    """Copy ``state`` into ``module``: every key must match a parameter and
    every parameter must be covered (the tied MLM decoder appears under
    both of its names). Shapes must agree."""
    tensors: Dict[str, torch.Tensor] = {k: torch.tensor(np.asarray(v)) for k, v in state.items()}
    module.load_state_dict(tensors, strict=True)
    return module

