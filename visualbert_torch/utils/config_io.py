"""Comment-tolerant JSON config loading into typed dataclasses (counterpart
of ``visualbert_tpu/utils/config_io.py``).

A config file is parsed once into explicit dataclasses and unknown keys are
an error, as in the JAX package. The one difference: the JAX config's
TPU-only fields (``config.TPU_ONLY_MODEL_FIELDS`` in the ``model`` block,
``config.TPU_ONLY_TRAIN_FIELDS`` in the ``train`` block) change no math and
are skipped, so every file in ``configs/`` loads unchanged.
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Any, Dict, Optional

from visualbert_torch.config import TPU_ONLY_TRAIN_FIELDS, OptimizerConfig, TrainConfig, VisualBertConfig

_TRAILING_COMMA = re.compile(r",\s*([}\]])")


def _strip_comments(text: str) -> str:
    """Remove //- and #-comments outside of strings."""
    out = []
    in_str = False
    escape = False
    i = 0
    n = len(text)
    while i < n:
        ch = text[i]
        if in_str:
            out.append(ch)
            if escape:
                escape = False
            elif ch == "\\":
                escape = True
            elif ch == '"':
                in_str = False
            i += 1
            continue
        if ch == '"':
            in_str = True
            out.append(ch)
            i += 1
            continue
        if ch == "#" or (ch == "/" and i + 1 < n and text[i + 1] == "/"):
            while i < n and text[i] != "\n":
                i += 1
            continue
        out.append(ch)
        i += 1
    return "".join(out)


def loads_commented_json(text: str) -> Dict:
    return json.loads(_TRAILING_COMMA.sub(r"\1", _strip_comments(text)))


def load_config_file(path: str) -> Dict:
    with open(path) as f:
        return loads_commented_json(f.read())


@dataclasses.dataclass(frozen=True)
class TaskConfig:
    """Top-level run configuration."""

    task: str                      # a task of tasks/registry.py (ROADMAP.md A6-A8 for the others)
    folder: str = "runs/default"   # output folder (checkpoints + logs)
    data: Dict[str, Any] = dataclasses.field(default_factory=dict)
    model: VisualBertConfig = dataclasses.field(default_factory=VisualBertConfig.base)
    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    restore_checkpoint: Optional[str] = None   # a checkpoint directory or file of the port
    eval_only: bool = False


def _build(dc_cls, d: Dict):
    known = {f.name for f in dataclasses.fields(dc_cls)}
    unknown = set(d) - known
    if unknown:
        raise KeyError(f"unknown {dc_cls.__name__} keys: {sorted(unknown)}")
    return dc_cls(**d)


def parse_task_config(raw: Dict, overrides: Optional[Dict] = None) -> TaskConfig:
    raw = dict(raw)
    if overrides:
        raw.update({k: v for k, v in overrides.items() if v is not None})
    model = VisualBertConfig.from_dict(raw.pop("model", {}))
    opt_d = dict(raw.pop("optimizer", {}))
    for k in ("no_decay", "frozen"):
        if isinstance(opt_d.get(k), list):
            opt_d[k] = tuple(opt_d[k])
    optimizer = _build(OptimizerConfig, opt_d)
    train = _build(TrainConfig, {k: v for k, v in raw.pop("train", {}).items() if k not in TPU_ONLY_TRAIN_FIELDS})
    return _build(TaskConfig, dict(raw, model=model, optimizer=optimizer, train=train))


def load_task_config(path: str, overrides: Optional[Dict] = None) -> TaskConfig:
    return parse_task_config(load_config_file(path), overrides)
