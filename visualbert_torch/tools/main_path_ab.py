"""The main path's train steps of this tree and of another checkout, in turns.

    python -m visualbert_torch.tools.main_path_ab tmp/parent

Runs ``chip_smoke.py``'s ``run_slice`` (its phases 5-6: the
``configs/coco_pretrain.json`` block as shipped and with
``"use_fused_layer_norm": true``, STEPS steps each, launches checked) in a
fresh process of each tree, in the order other, this, this, other, and
prints each run's median steps and then one JSON line. Each tree builds
its own kernels. It tells a change to code the main path shares (the
Trainer, BertAdam, the data pipeline) from the host's drift between calls.
Needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CHILD = """
import json, torch
import chip_smoke as cs
from visualbert_torch.tools.main_path import card_line, model_block
card, block, out = card_line(), model_block(), {}
for what, blk, per in (("as shipped", block, cs.PER_STEP),
                       ("fused LayerNorm", dict(block, use_fused_layer_norm=True), cs.FUSED_PER_STEP)):
    out[what] = cs.run_slice(torch, blk, card, per, "main path, " + what)[1]["median_ms"]
    torch.cuda.empty_cache()
print("AB " + json.dumps(out), flush=True)
"""


def run_tree(tree: str, child: str = CHILD, tool: str = "main_path_ab") -> dict:
    """The numbers that ``child`` prints on its "AB " line, run in a process
    of its own from ``tree`` (by default the median steps of its main
    path)."""
    proc = subprocess.run([sys.executable, "-c", child], cwd=tree, capture_output=True, text=True, timeout=1800)
    lines = [line for line in proc.stdout.splitlines() if line.startswith("AB ")]
    if proc.returncode or not lines:
        raise SystemExit(f"{tool}: the run in {tree} failed:\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return json.loads(lines[-1][3:])


def in_turns(argv, child: str, tool: str):
    """Run ``child`` from another checkout (``argv``'s one entry) and from
    this tree in the order other, this, this, other on the card, print each
    run and then {"card", "runs"} as one JSON line; returns the runs."""
    if len(argv) != 1:
        raise SystemExit(f"usage: python -m visualbert_torch.tools.{tool} <another checkout>")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit(f"{tool}: needs a CUDA device")
    from visualbert_torch.tools.main_path import card_line

    other = os.path.abspath(argv[0])
    card = card_line()
    runs = []
    for name, tree in (("other", other), ("this", REPO), ("this", REPO), ("other", other)):
        r = dict(tree=name, **run_tree(tree, child, tool))
        runs.append(r)
        print(f"{name} ({tree}): {json.dumps({k: v for k, v in r.items() if k != 'tree'})}  [{card}]", flush=True)
    print(json.dumps({"card": card, "runs": runs}), flush=True)
    return runs


def main(argv=None):
    in_turns(sys.argv[1:] if argv is None else argv, CHILD, "main_path_ab")


if __name__ == "__main__":
    main()
