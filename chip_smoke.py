#!/usr/bin/env python3
"""Smoke run of the PyTorch port (visualbert_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one result per line; any failure raises and the script exits
non-zero without printing the final line:

1. needs a CUDA device (there is no CPU path); prints the card's name and
   power limit as nvidia-smi reports them;
2. builds the CUDA kernels from visualbert_torch/csrc (nvcc, sm_90a) and
   prints the build time;
3. holds each kernel against its plain PyTorch version on the card at the
   shapes of the main path: K3 (dropout mask, [96, 228, 768]) must equal its
   bit-exact twin; K1 and K2 (packed attention forward and backward,
   B=96, T=228, H=12, D=64, bf16, padded keys) at dropout 0 and 0.1 must
   agree within a few bf16 ulps; kernel and plain times from CUDA events;
4. drives the main path, the COCO-caption pretraining train step at
   bert-base width (the `model` block of configs/coco_pretrain.json with
   fused_mlm_xent off): random seeded weights, a synthetic batch of
   96 x (128 text + 100 regions), dropout on, bf16 compute, fp32 parameters
   and BertAdam state with the pooler frozen, schedule "none", lr 1e-4,
   STEPS steps on one repeated batch. Losses must be finite and fall, and
   every step must launch exactly 12 K1, 12 K2 and 25 K3. A 2-layer model
   with dropout off must give the same loss through the kernels as through
   the einsum attention path;
5. prints the kernel table as one JSON line, then
   {"ok": true, "device": {...}} as the last line.
"""

import json
import math
import os
import statistics
import sys
import time

STEPS = 10
REPO = os.path.dirname(os.path.abspath(__file__))
# Tolerances. The kernels round unnormalised probabilities to bf16 where the
# plain version rounds normalised ones, and sum in another order. Each limit
# is about 4x the readings of two H100 runs at dropout 0 and 0.1 (in brackets).
OUT_TOL = 2e-2      # K1 out, max |kernel - plain| / max |plain|  [5.3e-3, 4.7e-3]
DQKV_TOL = 6e-3     # K2 dqkv, same measure                       [1.7e-3, 1.5e-3]
DB_TOL = 2e-3       # K2 qkv-bias gradient, same measure          [4.5e-4, 4.5e-4]
STATS_TOL = 1e-5    # K1 fp32 softmax statistics, absolute        [1.9e-6, 1.9e-6]
SLICE_REL_TOL = 2e-2  # kernel path vs einsum path loss, bf16 model


def log(msg):
    print(msg, flush=True)


def cuda_time_ms(fn, iters):
    import torch

    fn()  # warm-up
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(a, b):
    a, b = a.float(), b.float()
    return float((a - b).abs().max()), float((a - b).abs().max() / b.abs().max().clamp_min(1e-6))


def check_kernels(torch, card):
    import numpy as np

    from visualbert_torch.ops import flash_attention as fa
    from visualbert_torch.ops.dropout import dropout_mask, dropout_mask_reference
    from visualbert_torch.tools.main_path import B, TT, TV

    dev = torch.device("cuda")
    rows = []

    # K3: dropout mask at the hidden-state shape
    shape, rate = (B, TT + TV, 768), 0.1
    got = dropout_mask(shape, rate, 1234, torch.int8, dev)
    want = dropout_mask_reference(shape, rate, 1234, torch.int8, dev)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    keep = float(got.float().mean())
    n = got.numel()
    sigma = (rate * (1 - rate) / n) ** 0.5
    same = torch.equal(got, dropout_mask(shape, rate, 1234, torch.int8, dev))
    differ = not torch.equal(got, dropout_mask(shape, rate, 1235, torch.int8, dev))
    ms = cuda_time_ms(lambda: dropout_mask(shape, rate, 7, torch.int8, dev), 50)
    plain_ms = cuda_time_ms(lambda: dropout_mask_reference(shape, rate, 7, torch.int8, dev), 5)
    log(f"K3 dropout mask {list(shape)}: max_abs_err {err} (tol 0, bit-exact twin); keep rate {keep:.6f} "
        f"(|{keep - (1 - rate):.2e}| <= 4 sigma {4 * sigma:.2e}); same seed same mask {same}; "
        f"new seed new mask {differ}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms  [{card}]")
    if err != 0 or abs(keep - (1 - rate)) > 4 * sigma or not same or not differ:
        raise SystemExit("K3 disagrees with its plain version")
    rows.append(dict(name="dropout_mask", route="cuda", source="visualbert_torch/csrc/dropout.cu",
                     replaces="visualbert_tpu/ops/dropout.py:61", max_abs_err=err, ms=ms, plain_ms=plain_ms))

    # K1, K2: packed attention at the main path's shapes, padded keys
    H, D, T = 12, 64, TT + TV
    F = 3 * H * D
    rng = np.random.RandomState(0)
    qkv = torch.tensor(rng.randn(B, T, F), dtype=torch.bfloat16, device=dev)
    qb = torch.tensor(rng.randn(F) * 0.1, dtype=torch.bfloat16, device=dev)
    mask = np.ones((B, T), np.float32)
    mask[::3, TT - 20:TT] = 0  # some padded text
    mask[1::4, T - 30:] = 0    # some padded regions
    key_bias = torch.tensor((1.0 - mask) * -10000.0, device=dev)
    dout = torch.tensor(rng.randn(B, T, H * D), dtype=torch.bfloat16, device=dev)
    k1 = dict(name="packed_attention_fwd", route="cuda", source="visualbert_torch/csrc/flash_attention.cu",
              replaces="visualbert_tpu/ops/flash_attention.py:249", max_abs_err=0.0)
    k2 = dict(name="packed_attention_bwd", route="cuda", source="visualbert_torch/csrc/flash_attention.cu",
              replaces="visualbert_tpu/ops/flash_attention.py:307", max_abs_err=0.0)
    for rate in (0.0, 0.1):
        out, stats = fa.packed_attention_fwd(qkv, qb, key_bias, H, rate, 99)
        out_r, stats_r = fa.packed_attention_fwd_reference(qkv, qb, key_bias, H, rate, 99)
        dqkv, dqb = fa.packed_attention_bwd(qkv, qb, key_bias, dout, out_r, stats_r, H, rate, 99)
        dqkv_r, dqb_r = fa.packed_attention_bwd_reference(qkv, qb, key_bias, dout, out_r, stats_r, H, rate, 99)
        torch.cuda.synchronize()
        e_out, r_out = rel_err(out, out_r)
        e_st = float((stats - stats_r).abs().max())
        e_dq, r_dq = rel_err(dqkv, dqkv_r)
        e_db, r_db = rel_err(dqb, dqb_r)
        log(f"K1 attention fwd rate {rate}: out max_abs_err {e_out:.3e} (rel {r_out:.3e}, tol {OUT_TOL}); "
            f"stats max_abs_err {e_st:.3e} (tol {STATS_TOL})")
        log(f"K2 attention bwd rate {rate}: dqkv max_abs_err {e_dq:.3e} (rel {r_dq:.3e}, tol {DQKV_TOL}); "
            f"dqkv_bias max_abs_err {e_db:.3e} (rel {r_db:.3e}, tol {DB_TOL})")
        if not (r_out <= OUT_TOL and e_st <= STATS_TOL and r_dq <= DQKV_TOL and r_db <= DB_TOL):
            raise SystemExit(f"K1/K2 disagree with their plain versions at rate {rate}")
        k1["max_abs_err"] = max(k1["max_abs_err"], e_out)
        k2["max_abs_err"] = max(k2["max_abs_err"], e_dq)
    rate = 0.1  # the main path's attention dropout
    k1["ms"] = cuda_time_ms(lambda: fa.packed_attention_fwd(qkv, qb, key_bias, H, rate, 5), 20)
    k1["plain_ms"] = cuda_time_ms(lambda: fa.packed_attention_fwd_reference(qkv, qb, key_bias, H, rate, 5), 5)
    k2["ms"] = cuda_time_ms(lambda: fa.packed_attention_bwd(qkv, qb, key_bias, dout, out_r, stats_r, H, rate, 5), 20)
    k2["plain_ms"] = cuda_time_ms(
        lambda: fa.packed_attention_bwd_reference(qkv, qb, key_bias, dout, out_r, stats_r, H, rate, 5), 5)
    # without dropout: what Philox costs inside K1/K2
    k1_ms0 = cuda_time_ms(lambda: fa.packed_attention_fwd(qkv, qb, key_bias, H, 0.0, 5), 20)
    k2_ms0 = cuda_time_ms(lambda: fa.packed_attention_bwd(qkv, qb, key_bias, dout, out_r, stats_r, H, 0.0, 5), 20)
    # useful FLOPs: QK^T and PV forward; the backward's dV, dP, dQ, dK (its
    # S recomputations, one per pass, are extra work not counted here)
    gflop = 2.0 * B * H * T * T * D / 1e9
    for k, n_mm, ms0 in ((k1, 2, k1_ms0), (k2, 4, k2_ms0)):
        log(f"{k['name']} [{B}, {T}, {F}] dropout {rate}: kernel {k['ms']:.4f} ms "
            f"({n_mm * gflop / k['ms']:.1f} TFLOP/s useful), plain {k['plain_ms']:.4f} ms; "
            f"dropout 0: kernel {ms0:.4f} ms  [{card}]")
    rows += [k1, k2]
    return rows


def check_slice_reference(torch, model_block):
    """Kernels vs the einsum attention path on the same 2-layer bert-base-wide
    weights, dropout off: the losses must agree."""
    from visualbert_torch.config import VisualBertConfig
    from visualbert_torch.models.visualbert import VisualBertForTask
    from visualbert_torch.tools.synth import synth_batch
    from visualbert_torch.train.trainer import to_device

    cfg = VisualBertConfig.from_dict(model_block).replace(num_hidden_layers=2)
    batch = to_device(synth_batch(8, seed=3), "cuda")
    losses = {}
    for flash in (True, False):
        torch.manual_seed(0)
        m = VisualBertForTask(cfg.replace(use_flash_attention=flash), "pretraining")
        m.init_weights(torch.Generator().manual_seed(5)).to("cuda")
        with torch.no_grad():
            losses[flash] = float(m(batch)["loss"])
    rel = abs(losses[True] - losses[False]) / abs(losses[False])
    log(f"slice reference (2 layers, B=8, dropout off): kernel-path loss {losses[True]:.6f}, "
        f"einsum-path loss {losses[False]:.6f}, rel diff {rel:.2e} (tol {SLICE_REL_TOL})")
    if not rel <= SLICE_REL_TOL:
        raise SystemExit("kernel path and einsum path disagree")


def run_slice(torch, model_block, card):
    from visualbert_torch.ops import dropout as dropout_ops
    from visualbert_torch.ops import flash_attention as fa
    from visualbert_torch.tools.main_path import B, build

    trainer, batch = build(model_block)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    counters = (fa.packed_attention_fwd, fa.packed_attention_bwd, dropout_ops.dropout_mask)
    for c in counters:
        c.launches = 0
    losses, times = [], []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        metrics = trainer.train_step(batch)
        loss = float(metrics["loss"])  # waits for the step
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
    launches = [c.launches for c in counters]

    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    log(f"slice losses ({STEPS} steps, one repeated batch): " + ", ".join(f"{x:.5f}" for x in losses))
    log(f"slice launches over {STEPS} steps: K1 {launches[0]}, K2 {launches[1]}, K3 {launches[2]} "
        f"(per step {launches[0] / STEPS:g}, {launches[1] / STEPS:g}, {launches[2] / STEPS:g}; want 12, 12, 25)")
    med = statistics.median(times[1:])
    log(f"slice step time: median {med * 1e3:.2f} ms over steps 2..{STEPS} (first step {times[0] * 1e3:.1f} ms), "
        f"{B / med:.1f} pairs/s, peak memory {peak_gb:.2f} GiB  [{card}]")
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit("non-finite loss")
    if not losses[-1] < losses[0]:
        raise SystemExit("loss did not fall on the repeated batch")
    if launches != [12 * STEPS, 12 * STEPS, 25 * STEPS]:
        raise SystemExit(f"unexpected kernel launch counts {launches}")
    return dict(zip(("packed_attention_fwd", "packed_attention_bwd", "dropout_mask"), launches))


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's kernels need one")
    sys.path.insert(0, REPO)
    from visualbert_torch.ops import _build
    from visualbert_torch.tools.main_path import card_line, model_block

    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    lib = _build.library()
    log(f"kernels: {lib.path.name} from {len(_build.sources())} sources, "
        f"{'built by nvcc in %.1f s' % lib.build_seconds if lib.build_seconds else 'already built'}, "
        f"ready after {time.perf_counter() - t0:.1f} s")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas: " + line.strip())

    rows = check_kernels(torch, card)

    block = model_block()
    log(f"model block: {json.dumps(block)}")
    check_slice_reference(torch, block)
    launches = run_slice(torch, block, card)

    for r in rows:
        r["launches"] = launches[r["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
