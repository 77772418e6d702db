"""Where the time of the port's train step goes, on one CUDA card.

    python -m visualbert_torch.tools.profile_step

Builds the main path with ``tools/main_path.py`` (the ``model`` block of
configs/coco_pretrain.json, bert-base, a synthetic 128 x (128 + 100) batch,
dropout on, BertAdam), warms up, then runs STEPS
train steps under ``torch.profiler`` and prints, per step: host
wall time, device busy time (union of kernel intervals), the device's idle
share, and device time by kernel group and by kernel; then the optimizer
step alone, timed with CUDA events, and the peak device memory of the
steps (``torch.cuda.max_memory_allocated``). It does so for the block as
the config ships it, with ``"use_fused_layer_norm": true`` (K9/K10), and
with that and ``"packed_qkv": false`` (K11/K12) or ``"flash_save_probs":
true`` (K13/K14), each ending in one JSON line.
"""

from __future__ import annotations

import json
import statistics
import time

import torch

from visualbert_torch.tools import main_path

STEPS = 5   # profiled train steps
WARMUP = 3  # steps before profiling (the first builds kernels and cuBLAS plans)
TOP = 30    # kernels listed by name
# BertAdam runs inside this profiler range; kernels in its device-side span
# form the "optimizer (BertAdam)" group, the rest are grouped by name
ANNOTATION = "bertadam_step"

# kernel-name patterns -> group (first match wins); a pattern is a substring
# or a tuple of substrings that must all appear
GROUPS = (
    ("K11 heads-major attention fwd", ("hm_fwd_kernel",)),
    ("K12 heads-major attention bwd", ("hm_dq_kernel", "hm_dkv_kernel")),
    ("K13 save-probs attention fwd", ("attn_sp_fwd",)),
    ("K14 save-probs attention bwd", ("attn_sp_bwd",)),
    ("K1 attention fwd", ("packed_fwd_kernel",)),
    ("K2 attention bwd", ("packed_dq_kernel", "packed_dkv_kernel")),
    ("K3 dropout mask", ("dropout_mask_kernel",)),
    ("K3 dropout site fwd / bwd", ("dropout_fwd_kernel", "dropout_bwd_kernel")),
    ("K4 xent fwd", ("xent_fwd",)),
    ("K5 xent dx", ("xent_dx", ("xent_bwd_kernel", "false"))),  # xent_bwd_kernel<HID, false> and its reduce
    ("K6 xent dE", (("xent_bwd_kernel", "true"),)),
    ("K7/K9 LayerNorm fwd", ("ln_fwd_kernel",)),
    ("K8/K10 LayerNorm bwd", ("ln_bwd",)),
    ("matmul (cuBLAS)", ("gemm", "xmma", "cutlass", "nvjet", "sm90_", "sm80_", "cublas")),
    ("copy / cast", ("copy", "Copy", "to_copy")),
    ("reduction", ("reduce", "Reduce", "norm", "softmax", "Softmax")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "Elementwise")),
)


def group_of(name: str) -> str:
    for group, patterns in GROUPS:
        if any(all(p in name for p in ((k,) if isinstance(k, str) else k)) for k in patterns):
            return group
    return "other"


def kernel_intervals(prof):
    out = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.end > e.time_range.start:
            out.append((e.time_range.start, e.time_range.end, e.name))
    return out


def busy_us(intervals):
    total, cur_s, cur_e = 0.0, None, None
    for s, e, _ in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA device")
    card = main_path.card_line()
    block = main_path.model_block()
    fused = dict(block, use_fused_layer_norm=True)
    for what, b in (("as shipped", block), ("fused LayerNorm", fused),
                    ("fused LayerNorm, packed_qkv false", dict(fused, packed_qkv=False)),
                    ("fused LayerNorm, flash_save_probs", dict(fused, flash_save_probs=True))):
        print(f"== main path, {what}: {json.dumps(b)}")
        profile(card, b)
        torch.cuda.empty_cache()


def profile(card, block):
    trainer, batch = main_path.build(block)
    opt_step = trainer.optimizer.step

    def step_in_range():
        with torch.profiler.record_function(ANNOTATION):
            opt_step()

    trainer.optimizer.step = step_in_range
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(WARMUP):
        float(trainer.train_step(batch)["loss"])
    torch.cuda.synchronize()

    walls = []
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(STEPS):
            t0 = time.perf_counter()
            float(trainer.train_step(batch)["loss"])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)

    ivs = kernel_intervals(prof)
    # the optimizer's kernels run inside the device-side range of its annotation
    opt_ranges = [(s, e) for s, e, name in ivs if name == ANNOTATION]
    ivs = [iv for iv in ivs if iv[2] != ANNOTATION]
    by_group, by_name = {}, {}
    for s, e, name in ivs:
        in_opt = any(a <= s and e <= b for a, b in opt_ranges)
        g = "optimizer (BertAdam)" if in_opt else group_of(name)
        by_group[g] = by_group.get(g, 0.0) + (e - s)
        by_name[name] = by_name.get(name, 0.0) + (e - s)

    # the optimizer alone, timed with CUDA events on the last step's grads
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        opt_step()
    end.record()
    torch.cuda.synchronize()
    opt_ms = start.elapsed_time(end) / 3
    n = STEPS
    wall_ms = statistics.median(walls) * 1e3
    busy_ms = busy_us(ivs) / 1e3 / n
    summary = {
        "card": card,
        "model_block": block,
        "batch": len(batch["input_ids"]),
        "steps": n,
        "wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "kernels_per_step": len(ivs) / n,
        "pairs_per_s": len(batch["input_ids"]) / (wall_ms / 1e3),
        "optimizer_ms_cuda_events": opt_ms,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "groups_ms_per_step": {k: v / 1e3 / n for k, v in sorted(by_group.items(), key=lambda kv: -kv[1])},
    }
    print(f"card: {card}")
    print(f"step: wall {wall_ms:.2f} ms (median of {n}), device busy {busy_ms:.2f} ms, "
          f"idle share {summary['device_idle_share']:.3f}, {summary['kernels_per_step']:.0f} kernels/step")
    print(f"  optimizer step alone (CUDA events): {opt_ms:.3f} ms; peak memory {summary['peak_memory_gib']:.3f} GiB")
    for g, v in summary["groups_ms_per_step"].items():
        print(f"  {g:24s} {v:9.3f} ms/step  {v / busy_ms:6.1%} of busy")
    print(f"top {TOP} kernels by device time (ms/step):")
    for name, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]:
        print(f"  {v / 1e3 / n:8.3f}  {name[:140]}")
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
