"""The port's main path, built for a run on one CUDA card: the COCO-caption
pretraining train step at bert-base (ROADMAP.md), driven through
``Trainer``.

The model block is ``configs/coco_pretrain.json``'s with ``fused_mlm_xent``
off (its kernels, K4-K6, are not ported yet); the batch is
``synth_batch``'s 96 x (128 text + 100 regions), 2048-d features, 24 MLM
slots; BertAdam runs with the pooler frozen, schedule "none", lr 1e-4.
``chip_smoke.py`` and ``tools/profile_step.py`` both drive this.
"""

from __future__ import annotations

import json
import os
import subprocess

B, TT, TV, DV, N_PRED = 96, 128, 100, 2048, 24
CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                      "configs", "coco_pretrain.json")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def read_model_block(path: str) -> dict:
    """The ``model`` block of a comment-JSON config: ``//`` comments outside
    strings are dropped before parsing."""
    lines = []
    with open(path) as f:
        for line in f:
            in_str = False
            for i, ch in enumerate(line):
                if ch == '"' and line[i - 1:i] != "\\":
                    in_str = not in_str
                elif not in_str and line.startswith("//", i):
                    line = line[:i]
                    break
            lines.append(line)
    return json.loads("".join(lines))["model"]


def model_block() -> dict:
    """configs/coco_pretrain.json's model block without the fused MLM
    cross-entropy."""
    block = read_model_block(CONFIG)
    block["fused_mlm_xent"] = False
    return block


def build(block: dict, device="cuda"):
    """A Trainer over the pretraining model at bert-base width and depth on
    ``device``, with seeded random weights, and one synthetic batch there."""
    from visualbert_torch.config import OptimizerConfig, TrainConfig, VisualBertConfig
    from visualbert_torch.models.visualbert import VisualBertForTask
    from visualbert_torch.tools.synth import synth_batch
    from visualbert_torch.train.trainer import Trainer, to_device

    trainer = Trainer(
        VisualBertForTask(VisualBertConfig.from_dict(block), "pretraining"),
        OptimizerConfig(learning_rate=1e-4, schedule="none", frozen=("pooler",)),
        TrainConfig(seed=0),
        device=device,
    ).init_state()
    return trainer, to_device(synth_batch(B, tt=TT, tv=TV, dv=DV, n_pred=N_PRED), device)
