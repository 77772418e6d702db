"""Where the time of the port's train step goes, on one CUDA card.

    python -m visualbert_torch.tools.profile_step [--path main|vcr|unsup|unsup_e2e]

``--path main`` (the default) builds the main path with ``tools/main_path.py`` (the ``model`` block of
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

``--path vcr`` builds the VCR train step of ``tools/vcr_path.py``
(configs/vcr_finetune_qa.json at its full size: 32 questions, 768 x 768
uint8 images, 20 boxes, 4 x 128 tokens; ResNet50 detector + bert-base) and
profiles it the same way, with the cuDNN convolutions as a group of their
own; then the detector's forward and backward alone (its kernels by
group); each of its convolutions and each FrozenBatchNorm alone, forward
and backward at the shapes and strides one step gives them, their device
time summed and split by kernel group (so a 1 x 1 convolution that cuDNN
runs as a GEMM counts as a convolution), the convolutions' FLOPs counted
from the layer shapes and their rate; RoIAlign's forward and backward
alone at the step's shapes (CUDA events); what is left of the detector's
time; and the encoder's share as the step's busy time less the
detector's and the optimizer's. It ends in one JSON line.

``--path unsup`` builds the unsupervised pretraining step of
``tools/unsup_path.py`` (configs/unsup_pretrain.json at its full width: 144
rows, bert-base, 1600 objects / 400 attributes) and profiles it the same
way on each source of the hybrid mix: the V&L batch (30 text tokens + 36
tags + 36 regions), the text-only batch (64 tokens) and the image-only batch
(36 tags + 36 regions), one JSON line each.

``--path unsup_e2e`` builds the end-to-end unsupervised step of
``tools/unsup_e2e_path.py`` (the detector in the training graph: ResNet50
over 32 uint8 768 x 768 images, 36 boxes each, feeding the bert-base
three-stream encoder; the batch cut from the config's 144 to 32) and
profiles it the same way, then the detector's forward and backward alone,
and ends in one JSON line.
"""

from __future__ import annotations

import argparse
import json
import math
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
DETECTOR_KEYS = ("images", "boxes", "box_mask", "classes", "segms")

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
    ("convolution (cuDNN)", ("fprop", "dgrad", "wgrad", "convolve", "nchwToNhwc", "nhwcToNchw", "cudnn")),
    ("max pool", ("max_pool",)),
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


def main(argv=None):
    p = argparse.ArgumentParser(description="device time of the port's train step by kernel group")
    p.add_argument("--path", choices=("main", "vcr", "unsup", "unsup_e2e"), default="main",
                   help="main: COCO pretraining at bert-base; vcr: the VCR step with the detector; unsup: the "
                        "unsupervised pretraining step on its V&L, text-only and image-only batches; unsup_e2e: the "
                        "unsupervised step with the detector in the graph")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA device")
    card = main_path.card_line()
    if args.path == "vcr":
        profile_vcr(card)
        return
    if args.path == "unsup":
        profile_unsup(card)
        return
    if args.path == "unsup_e2e":
        profile_unsup_e2e(card)
        return
    block = main_path.model_block()
    fused = dict(block, use_fused_layer_norm=True)
    for what, b in (("as shipped", block), ("fused LayerNorm", fused),
                    ("fused LayerNorm, packed_qkv false", dict(fused, packed_qkv=False)),
                    ("fused LayerNorm, flash_save_probs", dict(fused, flash_save_probs=True))):
        print(f"== main path, {what}: {json.dumps(b)}")
        profile(card, b)
        torch.cuda.empty_cache()


def rows(batch) -> int:
    """The batch's leading dimension."""
    return len(next(iter(batch.values())))


def profile(card, block):
    trainer, batch = main_path.build(block)
    summary = profile_trainer(card, trainer, batch)
    summary["model_block"] = block
    print(json.dumps(summary))


def profile_trainer(card, trainer, batch):
    """Profile STEPS train steps of ``trainer`` on ``batch``; prints the
    breakdown and returns it as a dict."""
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

    ivs, by_group, by_name = grouped(prof)

    # the optimizer alone, timed with CUDA events on the last step's grads
    opt_ms = main_path.cuda_ms(opt_step, 3)
    n = STEPS
    wall_ms = statistics.median(walls) * 1e3
    busy_ms = busy_us(ivs) / 1e3 / n
    summary = {
        "card": card,
        "batch": rows(batch),
        "steps": n,
        "wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "kernels_per_step": len(ivs) / n,
        "pairs_per_s": rows(batch) / (wall_ms / 1e3),
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
    print_top(by_name, n)
    return summary


def grouped(prof):
    """(kernel intervals, device us by group, device us by kernel name) of a
    profile; kernels inside the device-side range of ANNOTATION form the
    optimizer's group."""
    ivs = kernel_intervals(prof)
    opt_ranges = [(s, e) for s, e, name in ivs if name == ANNOTATION]
    ivs = [iv for iv in ivs if iv[2] != ANNOTATION]
    by_group, by_name = {}, {}
    for s, e, name in ivs:
        in_opt = any(a <= s and e <= b for a, b in opt_ranges)
        g = "optimizer (BertAdam)" if in_opt else group_of(name)
        by_group[g] = by_group.get(g, 0.0) + (e - s)
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    return ivs, by_group, by_name


def print_top(by_name, n):
    print(f"top {TOP} kernels by device time (ms/step):")
    for name, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]:
        print(f"  {v / 1e3 / n:8.3f}  {name[:140]}")


def detector_calls(det, batch, generator):
    """The convolutions and FrozenBatchNorms of one detector forward with
    grad, as the step makes them, in call order: (kind, fn, input shape,
    strides, dtype, input needs a gradient, FLOPs of forward + backward).
    A convolution's FLOPs are 2 x its output elements x C_in x k x k each
    for the forward, the weight gradient and, where the input needs one, the
    input gradient."""
    from visualbert_torch.models import detector as dm

    calls = []
    conv = dm.conv

    def recording_conv(x, layer, dtype):
        y = conv(x, layer, dtype)
        flop = 2 * y.numel() * layer.in_channels * layer.kernel_size[0] * layer.kernel_size[1]
        calls.append(("convolution", lambda t: conv(t, layer, dtype), tuple(x.shape), x.stride(), x.dtype,
                      x.requires_grad, flop * (3 if x.requires_grad else 2)))
        return y

    def on_bn(module, args):
        x = args[0]
        calls.append(("FrozenBatchNorm", module, tuple(x.shape), x.stride(), x.dtype, x.requires_grad, 0))

    hooks = [m.register_forward_pre_hook(on_bn) for m in det.modules() if isinstance(m, dm.FrozenBatchNorm)]
    dm.conv = recording_conv
    try:
        det(*(batch[k] for k in DETECTOR_KEYS), generator, batch["image_hw"])
    finally:
        dm.conv = conv
        for h in hooks:
            h.remove()
    return calls


def calls_alone(calls, kind):
    """Each call of ``kind`` alone, forward + backward at its step shape and
    strides, once to warm up and once under the profiler. Inputs and
    output gradients are strided views of one random buffer a dtype, so the
    profile holds no kernel but the calls' own (the backward runs on
    autograd's thread, outside any range the calling thread marks): (device
    ms, device ms by kernel group, FLOPs, input elements)."""
    def extent(shape, stride):
        return 1 + sum((n - 1) * st for n, st in zip(shape, stride))

    mine = [c for c in calls if c[0] == kind]
    runs, need = [], {}
    for _, fn, shape, stride, dtype, req, _ in mine:
        x = torch.empty_strided(shape, stride, dtype=dtype, device="cuda").normal_().requires_grad_(req)
        y = fn(x)
        need[dtype] = max(need.get(dtype, 0), extent(shape, stride))
        need[y.dtype] = max(need.get(y.dtype, 0), extent(y.shape, y.stride()))
        runs.append((fn, shape, stride, dtype, req, tuple(y.shape), y.stride(), y.dtype))
        y.backward(torch.randn_like(y))
        del x, y
    pool = {dt: torch.randn(n, device="cuda").to(dt) for dt, n in need.items()}
    views = [(fn, pool[dt].as_strided(shape, stride).detach().requires_grad_(req), pool[ydt].as_strided(yshape, ystride))
             for fn, shape, stride, dt, req, yshape, ystride, ydt in runs]
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for fn, x, dy in views:
            fn(x).backward(dy)
            x.grad = None
        torch.cuda.synchronize()
    ivs = kernel_intervals(prof)
    groups = {}
    for s, e, name in ivs:
        groups[group_of(name)] = groups.get(group_of(name), 0.0) + (e - s) / 1e3
    return (busy_us(ivs) / 1e3, dict(sorted(groups.items(), key=lambda kv: -kv[1])), sum(c[6] for c in mine),
            sum(math.prod(c[2]) for c in mine))


def profile_unsup(card):
    """The unsupervised step (tools/unsup_path.py) profiled on each source's
    batch."""
    from visualbert_torch.tools import unsup_path

    raw = unsup_path.config()
    print(f"== unsupervised step: model block {json.dumps(raw['model'])}, optimizer {json.dumps(raw['optimizer'])} "
          f"(schedule none)")
    trainer, batches = unsup_path.build(raw=raw)
    for source, batch in batches.items():
        T = sum(batch[k].shape[1] for k in ("input_ids", "visual_tags", "visual_feats") if k in batch)
        print(f"-- source {source}: {rows(batch)} rows, T = {T}")
        summary = profile_trainer(card, trainer, batch)
        summary.update(path="unsup", source=source, seq_len=T)
        print(json.dumps(summary))
        torch.cuda.empty_cache()


def detector_alone(card, det_step):
    """``det_step`` (the detector's forward and backward) alone, STEPS
    times under the profiler: (device busy ms a step, device ms by group)."""
    det_step()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(STEPS):
            det_step()
        torch.cuda.synchronize()
    ivs, by_group, by_name = grouped(prof)
    busy = busy_us(ivs) / 1e3 / STEPS
    groups = {k: v / 1e3 / STEPS for k, v in sorted(by_group.items(), key=lambda kv: -kv[1])}
    print(f"detector forward + backward alone: device busy {busy:.2f} ms  [{card}]")
    for g, v in groups.items():
        print(f"  {g:24s} {v:9.3f} ms  {v / busy:6.1%} of the detector's busy time")
    print_top(by_name, STEPS)
    return busy, groups


def profile_unsup_e2e(card):
    """The end-to-end unsupervised step (tools/unsup_e2e_path.py) profiled,
    then its detector alone."""
    from visualbert_torch.tools import unsup_e2e_path

    raw = unsup_e2e_path.config()
    print(f"== end-to-end unsupervised step: model block {json.dumps(raw['model'])}, optimizer "
          f"{json.dumps(raw['optimizer'])} (schedule none), {unsup_e2e_path.BATCH} images of "
          f"{unsup_e2e_path.IMAGE_SIZE} x {unsup_e2e_path.IMAGE_SIZE} (the config's 144 cut to fit the card)")
    trainer, batch = unsup_e2e_path.build(raw=raw)
    summary = profile_trainer(card, trainer, batch)
    det = trainer.model.detector

    def det_step():
        out = det(batch["images"], batch["boxes"], batch["box_mask"], generator=trainer.dropout_generator)
        (out["obj_reps_raw"].float().mean() + out["obj_logits"].mean()).backward()

    for p in trainer.model.parameters():
        p.grad = None
    busy, groups = detector_alone(card, det_step)
    for p in trainer.model.parameters():
        p.grad = None
    opt = summary["groups_ms_per_step"].get("optimizer (BertAdam)", 0.0)
    summary.update(path="unsup_e2e", images_per_s=summary["pairs_per_s"], detector_busy_ms=busy,
                   detector_groups_ms=groups,
                   encoder_and_heads_ms=summary["device_busy_ms_per_step"] - busy - opt)
    print(f"encoder and heads (step busy - detector - optimizer): {summary['encoder_and_heads_ms']:.2f} ms  [{card}]")
    print(json.dumps(summary))


def profile_vcr(card):
    """The VCR step (tools/vcr_path.py) profiled; then the detector alone,
    its convolutions and FrozenBatchNorms each alone, and RoIAlign alone."""
    from visualbert_torch.ops.roi_align import roi_align
    from visualbert_torch.tools import vcr_path

    raw = vcr_path.config()
    print(f"== VCR step: model block {json.dumps(raw['model'])}, optimizer {json.dumps(raw['optimizer'])} "
          f"(schedule none)")
    trainer, batch = vcr_path.build(raw=raw)
    summary = profile_trainer(card, trainer, batch)
    det = trainer.model.detector

    def det_step():
        out = det(*(batch[k] for k in DETECTOR_KEYS), trainer.dropout_generator, batch["image_hw"])
        (out["obj_reps"].float().mean() + out["cnn_regularization_loss"]).backward()

    for p in trainer.model.parameters():
        p.grad = None
    det_busy, det_groups = detector_alone(card, det_step)

    calls = detector_calls(det, batch, trainer.dropout_generator)
    parts = {}
    for kind in ("convolution", "FrozenBatchNorm"):
        ms, groups, flops, elements = calls_alone(calls, kind)
        n = sum(1 for c in calls if c[0] == kind)
        parts[kind] = dict(calls=n, ms=ms, groups_ms=groups, flop=flops, input_elements=elements)
        rate = f", {flops / 1e12:.3f} TFLOP, {flops / ms / 1e9:.1f} TFLOP/s" if flops else ""
        print(f"detector {kind}s alone ({n} calls at the step's shapes, forward + backward, device ms under the "
              f"profiler): {ms:.2f} ms{rate}, {elements / 1e9:.3f} G input elements; by group: "
              + ", ".join(f"{g} {v:.2f}" for g, v in groups.items()) + f"  [{card}]")
    for p in trainer.model.parameters():
        p.grad = None

    img = batch["images"]
    # the trunk's output: stride 16, layer3's channels
    fm_shape = (img.shape[0], det.layer3[-1].conv3.out_channels, img.shape[1] // 16, img.shape[2] // 16)
    fm = torch.randn(fm_shape, dtype=trainer.model.cfg.dtype, device="cuda", requires_grad=True)
    boxes = batch["boxes"]

    def roi_step():
        roi_align(fm, boxes, 7, 0, 1 / 16).float().sum().backward()

    roi_ms = main_path.cuda_ms(roi_step, 10)
    with torch.no_grad():
        roi_fwd_ms = main_path.cuda_ms(lambda: roi_align(fm, boxes, 7, 0, 1 / 16), 10)
    busy, opt = summary["device_busy_ms_per_step"], summary["groups_ms_per_step"].get("optimizer (BertAdam)", 0.0)
    rest = det_busy - parts["convolution"]["ms"] - parts["FrozenBatchNorm"]["ms"] - roi_ms
    summary.update(
        path="vcr",
        detector_busy_ms=det_busy,
        detector_groups_ms=det_groups,
        detector_alone=parts,
        detector_rest_ms=rest,
        roi_align_fwd_bwd_ms_cuda_events=roi_ms,
        roi_align_fwd_ms_cuda_events=roi_fwd_ms,
        encoder_and_heads_ms=busy - det_busy - opt,
        images_per_s=summary["pairs_per_s"],
    )
    print(f"RoIAlign on {list(fm_shape)} x {list(boxes.shape)} boxes (CUDA events): forward {roi_fwd_ms:.3f} ms, "
          f"forward + backward {roi_ms:.3f} ms; the detector's busy time less its convolutions, FrozenBatchNorms "
          f"and RoIAlign alone: {rest:.2f} ms; encoder and heads (step busy - detector - optimizer): "
          f"{summary['encoder_and_heads_ms']:.2f} ms  [{card}]")
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
