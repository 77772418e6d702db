"""Phase 27's TinyBERT-4 runs of this tree and of another checkout, in turns.

    python -m visualbert_torch.tools.tinybert_ab tmp/parent

Runs ``chip_smoke.py``'s ``run_geometry_cli`` (its phase 27) on the
geometries whose label starts with "TinyBERT-4" (Jiao et al. 2020: L = 4,
H = 312, A = 12, I = 1200 in bf16, as shipped, with ``"packed_qkv":
false`` and with ``"flash_save_probs": true``), EXAMPLES / 128 train steps
each through the CLI with launches and forms checked, in a fresh process of
each tree, in the order other, this, this, other. Each run gives each
geometry's median step (steps 2.., as phase 27 times them) and, from
``tools/profile_step.py``'s ``profile_trainer`` on the same model block at
the main path's batch (``tools/main_path.py``), the profiled step's wall
time, device busy time and the device's idle share. Each tree builds its
own kernels. Needs a CUDA card.
"""

from __future__ import annotations

import sys

from visualbert_torch.tools.main_path_ab import in_turns

EXAMPLES = 128 * 10  # ten steps a geometry: nine timed
CHILD = f"""
import json, torch
import chip_smoke as cs
from visualbert_torch.tools import main_path, profile_step
card, out = main_path.card_line(), {{}}
cs.GEOMETRY_EXAMPLES = {EXAMPLES}
cs.GEOMETRIES = tuple(g for g in cs.GEOMETRIES if g[0].startswith("TinyBERT-4"))
for label, (_, _, ms) in cs.run_geometry_cli(torch, card).items():
    out[label] = dict(step_ms=ms)
for label, fields in cs.GEOMETRIES:
    trainer, batch = main_path.build(dict(main_path.model_block(), **fields))
    s = profile_step.profile_trainer(card, trainer, batch)
    out[label].update(profiled_wall_ms=s["wall_ms_per_step"], busy_ms=s["device_busy_ms_per_step"],
                      idle_share=s["device_idle_share"])
    del trainer, batch
    torch.cuda.empty_cache()
print("AB " + json.dumps(out), flush=True)
"""


def main(argv=None):
    in_turns(sys.argv[1:] if argv is None else argv, CHILD, "tinybert_ab")


if __name__ == "__main__":
    main()
