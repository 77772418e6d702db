"""The port's main path, built for a run on one CUDA card: the COCO-caption
pretraining train step at bert-base (ROADMAP.md), driven through
``Trainer``.

The model block is ``configs/coco_pretrain.json``'s, unchanged (packed
attention K1/K2, the dropout site kernels on K3's body, fused MLM
cross-entropy K4-K6); the batch is the config's 128 pairs in
``synth_batch``'s geometry: 128 text tokens + 100 regions, 2048-d
features, 24 MLM slots; BertAdam runs with the pooler frozen, schedule
"none", lr 1e-4. ``chip_smoke.py`` and
``tools/profile_step.py`` both drive this.
"""

from __future__ import annotations

import os
import subprocess

B, TT, TV, DV, N_PRED = 128, 128, 100, 2048, 24
CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                      "configs", "coco_pretrain.json")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, iters: int) -> float:
    """Milliseconds a call of ``fn`` on the current CUDA stream, from CUDA
    events around ``iters`` calls after one warm-up call."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def model_block() -> dict:
    """configs/coco_pretrain.json's model block."""
    from visualbert_torch.utils.config_io import load_config_file

    return load_config_file(CONFIG)["model"]


def packed_attention_inputs(device):
    """K1/K2's inputs at the main path's shapes (B=128, T=228, H=12, D=64):
    qkv [B, T, H*3*D], qb, a key bias with padded text and regions and dout,
    bf16, from RandomState(0)."""
    import numpy as np
    import torch

    H, D, T = 12, 64, TT + TV
    F = 3 * H * D
    rng = np.random.RandomState(0)
    qkv = torch.tensor(rng.randn(B, T, F), dtype=torch.bfloat16, device=device)
    qb = torch.tensor(rng.randn(F) * 0.1, dtype=torch.bfloat16, device=device)
    mask = np.ones((B, T), np.float32)
    mask[::3, TT - 20:TT] = 0  # some padded text
    mask[1::4, T - 30:] = 0    # some padded regions
    key_bias = torch.tensor((1.0 - mask) * -10000.0, device=device)
    dout = torch.tensor(rng.randn(B, T, H * D), dtype=torch.bfloat16, device=device)
    return qkv, qb, key_bias, dout


def layer_norm_inputs(device, N=B * (TT + TV), H=768):
    """K7-K10's inputs at the main path's rows (N = 128 x 228 = 29,184, H =
    768): x, res, dy bf16 [N, H] and fp32 scale, bias [H], from
    RandomState(2)."""
    import numpy as np
    import torch

    rng = np.random.RandomState(2)
    x, res, dy = (torch.tensor(rng.randn(N, H), dtype=torch.bfloat16, device=device) for _ in range(3))
    scale = torch.tensor(1.0 + 0.1 * rng.randn(H), dtype=torch.float32, device=device)
    bias = torch.tensor(0.1 * rng.randn(H), dtype=torch.float32, device=device)
    return x, res, dy, scale, bias


def build(block: dict, device="cuda", mesh=None):
    """A Trainer over the pretraining model at bert-base width and depth on
    ``device``, with seeded random weights, and one synthetic batch there;
    under a (data, model) ``mesh``, this rank's shard of both (the batch's
    rows of its data index)."""
    from visualbert_torch.config import OptimizerConfig, TrainConfig, VisualBertConfig
    from visualbert_torch.models.visualbert import VisualBertForTask
    from visualbert_torch.ops.limits import check_kernel_limits
    from visualbert_torch.tools.synth import synth_batch
    from visualbert_torch.train.trainer import Trainer, to_device

    cfg = VisualBertConfig.from_dict(block)
    check_kernel_limits(cfg, device)
    trainer = Trainer(
        VisualBertForTask(cfg, "pretraining"),
        OptimizerConfig(learning_rate=1e-4, schedule="none", frozen=("pooler",)),
        TrainConfig(seed=0),
        device=device,
        mesh=mesh,
    ).init_state()
    batch = synth_batch(B, tt=TT, tv=TV, dv=DV, n_pred=N_PRED)
    if mesh is not None:
        per = B // mesh.data_size
        batch = {k: v[mesh.data_index * per: (mesh.data_index + 1) * per] for k, v in batch.items()}
    return trainer, to_device(batch, device)
