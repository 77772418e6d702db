"""Weight bridge: a ``{torch_name: np.ndarray}`` state dict, as
``visualbert_tpu/tools/export_torch.py::export_state_dict`` emits it from
Flax params, loaded into a port module with ``strict=True``.

The port never imports the JAX package; whoever holds a Flax checkpoint
exports it on the JAX side and hands the arrays over. ``export_state_dict``
emits no ``flickr_attention`` entries: :func:`flickr_attention_state` turns
that Flax subtree into them, with numpy only. :func:`detector_model_state`
joins the two exports of a Flax ``VisualBertDetectorModel`` (its ``bert``
subtree through ``export_state_dict``, its ``detector`` subtree through
``export_resnet50_state_dict``) under the port model's prefixes.
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


def flickr_attention_state(subtree: Mapping) -> Dict[str, np.ndarray]:
    """The Flax ``flickr_attention`` params (``{"query"|"key": {"kernel",
    "bias"}}``, leaves plain or boxed) as the reference-named entries
    ``flickr_attention.{query,key}.{weight,bias}`` (the names
    ``visualbert_tpu/tools/import_torch.py`` reads); a kernel [in, out]
    becomes a weight [out, in]."""
    out = {}
    for name in ("query", "key"):
        dense = subtree[name]
        out[f"flickr_attention.{name}.weight"] = np.asarray(getattr(dense["kernel"], "value", dense["kernel"]),
                                                            np.float32).T
        out[f"flickr_attention.{name}.bias"] = np.asarray(getattr(dense["bias"], "value", dense["bias"]),
                                                          np.float32)
    return out


def detector_model_state(bert_state: Mapping[str, np.ndarray],
                         detector_state: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The state dict of the port's ``VisualBertDetectorModel`` from the two
    exports of a Flax one: ``bert_state`` is ``export_state_dict`` of its
    ``bert`` subtree (keys ``bert.*`` and the head's ``classifier.*`` or
    ``cls.*``), ``detector_state`` is ``export_resnet50_state_dict`` of its
    ``detector`` subtree (torchvision keys). They land under ``bert.`` and
    ``detector.``."""
    out = {f"bert.{k}": np.asarray(v) for k, v in bert_state.items()}
    out.update((f"detector.{k}", np.asarray(v)) for k, v in detector_state.items())
    return out
