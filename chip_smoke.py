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
   shapes of the main path: K3 (dropout mask, [128, 228, 768]) must equal
   its bit-exact twin; K1 and K2 (packed attention forward and backward,
   B=128, T=228, H=12, D=64, bf16, padded keys) at dropout 0 and 0.1 must
   agree within a few bf16 ulps; K4, K5 and K6 (the fused MLM
   cross-entropy: forward, dx, d embedding and d bias) at N = 128 x 24 =
   3072 rows, H=768, V=30522, bf16, 15 % of labels -1 and a non-uniform
   cotangent, within the limits below; kernel and plain times from CUDA
   events;
4. a 2-layer model with dropout off gives the same loss through the kernels
   (K1/K2 attention, K4-K6 cross-entropy) as through the einsum attention
   and the unfused decoder;
5. drives the main path, the COCO-caption pretraining train step at
   bert-base width and depth with the `model` block of
   configs/coco_pretrain.json unchanged: random seeded weights, a synthetic
   batch of the config's 128 pairs x (128 text + 100 regions), dropout on,
   bf16 compute, fp32 parameters and BertAdam state with the pooler frozen,
   schedule "none", lr 1e-4, STEPS steps on one repeated batch. Losses must
   be finite and fall, and every step must launch exactly 12 K1, 12 K2,
   25 K3 and one each of K4, K5 and K6;
6. runs the training CLI (`visualbert_torch.train_cli`) on
   configs/coco_pretrain.json with its data block swapped for a synthetic
   COCO set of CLI_EXAMPLES pairs and one epoch: 4 steps at the config's
   batch of 128, through the dataset, the Batcher, the fit loop and a
   checkpoint at the end of the epoch. Its losses must be finite, every step
   must launch each kernel as in phase 5, and the checkpoint must load back
   into a fresh model bit for bit. The run's folder is a temporary
   directory, removed at the end;
7. prints the kernel table as one JSON line (launches from phase 5), then
   {"ok": true, "device": {...}} as the last line.
"""

import contextlib
import io
import json
import math
import os
import shutil
import statistics
import sys
import tempfile
import time

STEPS = 10
CLI_EXAMPLES = 512
REPO = os.path.dirname(os.path.abspath(__file__))
# Tolerances. The kernels round unnormalised probabilities to bf16 where the
# plain version rounds normalised ones, and sum in another order. Each limit
# is about 4x the readings of H100 runs at these shapes (in brackets; K1/K2
# at dropout 0 and 0.1).
OUT_TOL = 2e-2      # K1 out, max |kernel - plain| / max |plain|  [4.9e-3, 4.4e-3]
DQKV_TOL = 6e-3     # K2 dqkv, same measure                       [1.5e-3, 1.4e-3]
# the qkv-bias gradient is bf16: one ulp of its largest entry is 3.9e-3 of it
DB_TOL = 8e-3       # K2 qkv-bias gradient, same measure          [9.5e-4, 1.9e-3]
STATS_TOL = 1e-5    # K1 fp32 softmax statistics, absolute        [9.5e-7, 9.5e-7]
# K4-K6 sum the same fp32 products of bf16 operands in another order
XENT_TOL = 3e-5     # K4 nll and lse, absolute                    [7.6e-6, 1.9e-6]
ARGMAX_MARGIN = 1e-3  # K4 argmax must equal the plain one where the plain top-2 gap exceeds this
DX_TOL = 1.2e-2     # K5 dx (bf16), max |kernel - plain| / max |plain|  [2.8e-3]
DE_TOL = 1.8e-2     # K6 d embedding (bf16), same measure         [4.4e-3]
DBIAS_TOL = 2e-6    # K6 d bias (fp32), same measure              [4.3e-7]
SLICE_REL_TOL = 2e-2  # kernel path vs einsum + unfused path loss, bf16 model

KERNELS = (  # name, wrapper module, source, the TPU kernel it replaces
    ("packed_attention_fwd", "flash_attention", "flash_attention.cu", "visualbert_tpu/ops/flash_attention.py:249"),
    ("packed_attention_bwd", "flash_attention", "flash_attention.cu", "visualbert_tpu/ops/flash_attention.py:307"),
    ("dropout_mask", "dropout", "dropout.cu", "visualbert_tpu/ops/dropout.py:61"),
    ("mlm_xent_fwd", "mlm_xent", "mlm_xent.cu", "visualbert_tpu/ops/mlm_xent.py:52"),
    ("mlm_xent_dx", "mlm_xent", "mlm_xent.cu", "visualbert_tpu/ops/mlm_xent.py:145"),
    ("mlm_xent_de", "mlm_xent", "mlm_xent.cu", "visualbert_tpu/ops/mlm_xent.py:170"),
)
PER_STEP = (12, 12, 25, 1, 1, 1)  # launches of K1..K6 per train step


def log(msg):
    print(msg, flush=True)


def counters():
    """The launch-counting wrappers of K1..K6."""
    import importlib

    return [getattr(importlib.import_module(f"visualbert_torch.ops.{mod}"), name) for name, mod, _, _ in KERNELS]


def read_launches():
    return [c.launches for c in counters()]


def zero_launches():
    for c in counters():
        c.launches = 0


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
    rows = {}

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
    rows["dropout_mask"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)

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
    k1, k2 = dict(max_abs_err=0.0), dict(max_abs_err=0.0)
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
    del out_r, dqkv_r
    rate = 0.1  # the main path's attention dropout
    k1["ms"] = cuda_time_ms(lambda: fa.packed_attention_fwd(qkv, qb, key_bias, H, rate, 5), 20)
    k1["plain_ms"] = cuda_time_ms(lambda: fa.packed_attention_fwd_reference(qkv, qb, key_bias, H, rate, 5), 3)
    k2["ms"] = cuda_time_ms(lambda: fa.packed_attention_bwd(qkv, qb, key_bias, dout, out, stats, H, rate, 5), 20)
    k2["plain_ms"] = cuda_time_ms(
        lambda: fa.packed_attention_bwd_reference(qkv, qb, key_bias, dout, out, stats, H, rate, 5), 3)
    # without dropout: what Philox costs inside K1/K2
    k1_ms0 = cuda_time_ms(lambda: fa.packed_attention_fwd(qkv, qb, key_bias, H, 0.0, 5), 20)
    k2_ms0 = cuda_time_ms(lambda: fa.packed_attention_bwd(qkv, qb, key_bias, dout, out, stats, H, 0.0, 5), 20)
    # useful FLOPs: QK^T and PV forward; the backward's dV, dP, dQ, dK (its
    # S recomputations, one per pass, are extra work not counted here)
    gflop = 2.0 * B * H * T * T * D / 1e9
    for name, k, n_mm, ms0 in (("packed_attention_fwd", k1, 2, k1_ms0), ("packed_attention_bwd", k2, 4, k2_ms0)):
        log(f"{name} [{B}, {T}, {F}] dropout {rate}: kernel {k['ms']:.4f} ms "
            f"({n_mm * gflop / k['ms']:.1f} TFLOP/s useful), plain {k['plain_ms']:.4f} ms; "
            f"dropout 0: kernel {ms0:.4f} ms  [{card}]")
    rows["packed_attention_fwd"], rows["packed_attention_bwd"] = k1, k2
    return rows


def check_xent(torch, card):
    """K4-K6 against their plain versions at the main path's rows."""
    import numpy as np

    from visualbert_torch.ops import mlm_xent as xe
    from visualbert_torch.tools.main_path import B, N_PRED

    N, H, V = B * N_PRED, 768, 30522
    dev = torch.device("cuda")
    rng = np.random.RandomState(1)
    x = torch.tensor(rng.randn(N, H), dtype=torch.bfloat16, device=dev)
    emb = torch.tensor(rng.randn(V, H) * 0.05, dtype=torch.bfloat16, device=dev)
    bias = torch.tensor(rng.randn(V) * 0.1, dtype=torch.float32, device=dev)
    labels = rng.randint(0, V, N)
    labels[rng.rand(N) < 0.15] = -1
    g = torch.tensor(np.where(labels >= 0, rng.uniform(0.5, 1.5, N), 0.0), dtype=torch.float32, device=dev)
    lab = torch.tensor(np.maximum(labels, 0), dtype=torch.int32, device=dev)  # -1 computed as 0, as mlm_xent does

    nll, lse, am = xe.mlm_xent_fwd(x, emb, bias, lab)
    nll_r, lse_r, am_r = xe.mlm_xent_fwd_reference(x, emb, bias, lab)
    top = torch.topk(xe._logits(x, emb, bias), 2, dim=-1).values
    clear = (top[:, 0] - top[:, 1]) > ARGMAX_MARGIN
    differ = am != am_r
    e_nll = float((nll - nll_r).abs().max())
    e_lse = float((lse - lse_r).abs().max())
    bad_clear, bad_close = int((differ & clear).sum()), int((differ & ~clear).sum())
    log(f"K4 xent fwd [{N}, {H}] x [{V}, {H}]: nll max_abs_err {e_nll:.3e}, lse max_abs_err {e_lse:.3e} "
        f"(tol {XENT_TOL}); argmax differs on {bad_clear} rows with top-2 gap > {ARGMAX_MARGIN} (must be 0) "
        f"and on {bad_close} of the {int((~clear).sum())} rows closer than that")
    if not (e_nll <= XENT_TOL and e_lse <= XENT_TOL and bad_clear == 0):
        raise SystemExit("K4 disagrees with its plain version")
    del top, clear, differ

    # the backward of both sides gets the plain lse
    dx = xe.mlm_xent_dx(x, emb, bias, lab, lse_r, g)
    dx_r = xe.mlm_xent_dx_reference(x, emb, bias, lab, lse_r, g)
    de, db = xe.mlm_xent_de(x, emb, bias, lab, lse_r, g)
    de_r, db_r = xe.mlm_xent_de_reference(x, emb, bias, lab, lse_r, g)
    torch.cuda.synchronize()
    e_dx, r_dx = rel_err(dx, dx_r)
    e_de, r_de = rel_err(de, de_r)
    e_db, r_db = rel_err(db, db_r)
    log(f"K5 xent dx: max_abs_err {e_dx:.3e} (rel {r_dx:.3e}, tol {DX_TOL})")
    log(f"K6 xent dE: max_abs_err {e_de:.3e} (rel {r_de:.3e}, tol {DE_TOL}); "
        f"db max_abs_err {e_db:.3e} (rel {r_db:.3e}, tol {DBIAS_TOL})")
    if not (r_dx <= DX_TOL and r_de <= DE_TOL and r_db <= DBIAS_TOL):
        raise SystemExit("K5/K6 disagree with their plain versions")
    del dx_r, de_r, db_r

    rows = {
        "mlm_xent_fwd": dict(max_abs_err=max(e_nll, e_lse), n_mm=1,
                             ms=cuda_time_ms(lambda: xe.mlm_xent_fwd(x, emb, bias, lab), 10),
                             plain_ms=cuda_time_ms(lambda: xe.mlm_xent_fwd_reference(x, emb, bias, lab), 3)),
        "mlm_xent_dx": dict(max_abs_err=e_dx, n_mm=2,
                            ms=cuda_time_ms(lambda: xe.mlm_xent_dx(x, emb, bias, lab, lse, g), 10),
                            plain_ms=cuda_time_ms(lambda: xe.mlm_xent_dx_reference(x, emb, bias, lab, lse, g), 3)),
        "mlm_xent_de": dict(max_abs_err=max(e_de, e_db), n_mm=2,
                            ms=cuda_time_ms(lambda: xe.mlm_xent_de(x, emb, bias, lab, lse, g), 10),
                            plain_ms=cuda_time_ms(lambda: xe.mlm_xent_de_reference(x, emb, bias, lab, lse, g), 3)),
    }
    gflop = 2.0 * N * V * H / 1e9  # one N x V x H product
    for name, r in rows.items():
        log(f"{name} [{N}, {H}] x [{V}, {H}]: kernel {r['ms']:.4f} ms ({r.pop('n_mm') * gflop / r['ms']:.1f} "
            f"TFLOP/s in its products), plain {r['plain_ms']:.4f} ms  [{card}]")
    return rows


def check_slice_reference(torch, model_block):
    """The kernel path (K1/K2 attention, K4-K6 cross-entropy) vs the einsum
    attention and the unfused decoder on the same 2-layer bert-base-wide
    weights, dropout off: the losses must agree."""
    from visualbert_torch.config import VisualBertConfig
    from visualbert_torch.models.visualbert import VisualBertForTask
    from visualbert_torch.tools.synth import synth_batch
    from visualbert_torch.train.trainer import to_device

    cfg = VisualBertConfig.from_dict(model_block).replace(num_hidden_layers=2)
    batch = to_device(synth_batch(8, seed=3), "cuda")
    losses = {}
    for kernels in (True, False):
        m = VisualBertForTask(cfg.replace(use_flash_attention=kernels, fused_mlm_xent=kernels), "pretraining")
        m.init_weights(torch.Generator().manual_seed(5)).to("cuda")
        with torch.no_grad():
            out = m(batch)
        losses[kernels] = (float(out["loss"]), float(out["masked_lm_loss"]))
    rel = [abs(a - b) / abs(b) for a, b in zip(losses[True], losses[False])]
    log(f"slice reference (2 layers, B=8, dropout off): kernel path loss {losses[True][0]:.6f} "
        f"(MLM {losses[True][1]:.6f}), einsum + unfused path loss {losses[False][0]:.6f} "
        f"(MLM {losses[False][1]:.6f}), rel diff {rel[0]:.2e} / {rel[1]:.2e} (tol {SLICE_REL_TOL})")
    if not max(rel) <= SLICE_REL_TOL:
        raise SystemExit("kernel path and einsum + unfused path disagree")


def run_slice(torch, model_block, card):
    from visualbert_torch.tools.main_path import B, build

    trainer, batch = build(model_block)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    zero_launches()
    losses, times = [], []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        metrics = trainer.train_step(batch)
        loss = float(metrics["loss"])  # waits for the step
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
    launches = read_launches()

    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    log(f"slice losses ({STEPS} steps, one repeated batch): " + ", ".join(f"{x:.5f}" for x in losses))
    log(f"slice launches over {STEPS} steps: "
        + ", ".join(f"K{i + 1} {n} ({n / STEPS:g}/step)" for i, n in enumerate(launches))
        + f"; want {'/'.join(map(str, PER_STEP))} per step")
    med = statistics.median(times[1:])
    log(f"slice step time: median {med * 1e3:.2f} ms over steps 2..{STEPS} (first step {times[0] * 1e3:.1f} ms), "
        f"{B / med:.1f} pairs/s, peak memory {peak_gb:.2f} GiB  [{card}]")
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit("non-finite loss")
    if not losses[-1] < losses[0]:
        raise SystemExit("loss did not fall on the repeated batch")
    if launches != [n * STEPS for n in PER_STEP]:
        raise SystemExit(f"unexpected kernel launch counts {launches}")
    return launches


def run_cli(torch, card):
    """One epoch of a synthetic COCO set through the training CLI, with the
    model, optimizer and train blocks of configs/coco_pretrain.json."""
    from visualbert_torch import train_cli
    from visualbert_torch.models.visualbert import VisualBertForTask
    from visualbert_torch.tools.main_path import CONFIG
    from visualbert_torch.train.trainer import Trainer
    from visualbert_torch.utils.checkpoint import CheckpointManager
    from visualbert_torch.utils.config_io import load_config_file

    raw = load_config_file(CONFIG)
    d = raw["data"]
    raw["data"] = dict({k: d[k] for k in ("max_seq_length", "max_regions", "two_sentence")}, synthetic=CLI_EXAMPLES)
    raw["train"] = dict(raw["train"], num_train_epochs=1)
    folder = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        path = os.path.join(folder, "coco_synthetic.json")
        with open(path, "w") as f:
            json.dump(raw, f)
        out = io.StringIO()
        zero_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            trainer, result = train_cli.main(["--config", path, "--folder", os.path.join(folder, "run")])
        wall = time.perf_counter() - t0
        launches = read_launches()
        steps = trainer.step
        epoch = result.history[0]
        log(f"cli: {out.getvalue().strip()}; {steps} steps at batch {raw['train']['train_batch_size']} on "
            f"{trainer.device}, {wall:.1f} s with set-up; epoch means: "
            + ", ".join(f"{k} {v:.5f}" for k, v in sorted(epoch.items())))
        log("cli launches: " + ", ".join(f"K{i + 1} {n}" for i, n in enumerate(launches))
            + f"; want {'/'.join(map(str, PER_STEP))} per step")
        if trainer.device.type != "cuda" or steps != CLI_EXAMPLES // raw["train"]["train_batch_size"]:
            raise SystemExit(f"the CLI ran {steps} steps on {trainer.device}")
        if not all(math.isfinite(v) for v in epoch.values()):
            raise SystemExit("non-finite loss in the CLI run")
        if launches != [n * steps for n in PER_STEP]:
            raise SystemExit(f"unexpected kernel launch counts in the CLI run {launches}")

        ckpt = CheckpointManager(os.path.join(folder, "run", "ckpt"))
        fresh = Trainer(VisualBertForTask(trainer.model.cfg, "pretraining"), trainer.opt_config,
                        trainer.train_config, device="cuda").init_state()
        ckpt.restore(fresh)
        same = [torch.equal(a, b) for a, b in zip(trainer.model.state_dict().values(),
                                                    fresh.model.state_dict().values())]
        same += [torch.equal(trainer.optimizer.m[k], fresh.optimizer.m[k])
                 and torch.equal(trainer.optimizer.v[k], fresh.optimizer.v[k]) for k in trainer.optimizer.m]
        log(f"cli checkpoint {os.path.basename(ckpt.path())}: {sum(same)} of {len(same)} tensors "
            f"(weights, BertAdam moments) equal after reload, step {fresh.step}")
        if not all(same) or fresh.step != steps or fresh.optimizer.step_count != steps:
            raise SystemExit("the CLI's checkpoint does not reload bit for bit")
    finally:
        shutil.rmtree(folder, ignore_errors=True)


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
        if "registers" in line or "spill" in line or "entry function" in line:
            log("  ptxas: " + line.strip())

    rows = check_kernels(torch, card)
    rows.update(check_xent(torch, card))
    torch.cuda.empty_cache()

    block = model_block()
    log(f"model block: {json.dumps(block)}")
    check_slice_reference(torch, block)
    launches = run_slice(torch, block, card)
    torch.cuda.empty_cache()
    run_cli(torch, card)

    table = [dict(name=name, route="cuda", source=f"visualbert_torch/csrc/{src}", replaces=replaces, launches=n,
                  **rows[name]) for (name, _, src, replaces), n in zip(KERNELS, launches)]
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
