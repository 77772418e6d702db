"""K2's streamed passes at head dim 128 (``csrc/flash_attention_packed.cu``
step 7) timed at a fixed number of blocks and a growing number of steps a
block, to split a pass's time into a block's fixed cost and its cost a
step.

    python -m visualbert_torch.tools.attn_streamed_steps

At 12 heads, the batch and T pairs of ``SHAPES`` all give 3072 blocks a
pass (cdiv(T, 128) x H x B) and T / 64 steps a block. For dropout 0 and
0.1 and each pair, it prints the dQ and the dK/dV pass's device time
(``torch.profiler`` over ROUNDS calls of the bf16 wrapper) and, from the
least-squares line through the pairs, each pass's fixed part and its part
a step. It needs the card: without one it exits with an error.
"""

from __future__ import annotations

import subprocess
import sys

H, D, DTYPE = 12, 128, "bfloat16"
SHAPES = ((256, 128), (128, 256), (64, 512), (32, 1024))  # (B, T): 3072 blocks a pass
ROUNDS = 10


def inputs(torch, B, T):
    """qkv, qkv bias, key bias (about a fifth of each row's keys padded)
    and dout of the packed layout at (B, T), from RandomState(0)."""
    import numpy as np

    rng = np.random.RandomState(0)
    F, dt = 3 * H * D, getattr(torch, DTYPE)
    qkv = torch.tensor(rng.randn(B, T, F), dtype=dt, device="cuda")
    qb = torch.tensor(rng.randn(F) * 0.1, dtype=dt, device="cuda")
    mask = np.ones((B, T), np.float32)
    mask[::3, T // 2 - 20:T // 2] = 0
    mask[1::4, T - T // 8:] = 0
    key_bias = torch.tensor((1.0 - mask) * -10000.0, device="cuda")
    dout = torch.tensor(rng.randn(B, T, H * D), dtype=dt, device="cuda")
    return qkv, qb, key_bias, dout


def pass_ms(torch, fa, qkv, qb, key_bias, dout, rate):
    """{"dq": ms, "dkv": ms}: each streamed pass's device time a call."""
    out, stats = fa.packed_attention_fwd_reference(qkv, qb, key_bias, H, rate, 5)
    for _ in range(3):
        fa.packed_attention_bwd(qkv, qb, key_bias, dout, out, stats, H, rate, 5)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(ROUNDS):
            fa.packed_attention_bwd(qkv, qb, key_bias, dout, out, stats, H, rate, 5)
        torch.cuda.synchronize()
    return {("dq" if "dq_kernel" in e.key else "dkv"): e.device_time_total / e.count / 1e3
            for e in prof.key_averages() if "streamed_d" in e.key}


def fit(steps, ms):
    """(fixed, a step) of the least-squares line ms = fixed + steps x a step."""
    n = len(steps)
    mx, my = sum(steps) / n, sum(ms) / n
    slope = sum((x - mx) * (y - my) for x, y in zip(steps, ms)) / sum((x - mx) ** 2 for x in steps)
    return my - slope * mx, slope


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("attn_streamed_steps: no CUDA device")
    from visualbert_torch.ops import flash_attention as fa

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    for rate in (0.0, 0.1):
        got = {"dq": [], "dkv": []}
        for B, T in SHAPES:
            ms = pass_ms(torch, fa, *inputs(torch, B, T), rate)
            for k in got:
                got[k].append(ms[k])
            print(f"rate {rate} B={B} T={T} ({T // 64} steps a block): dQ pass {ms['dq']:.4f} ms, dK/dV pass "
                  f"{ms['dkv']:.4f} ms  [{card}]", flush=True)
            torch.cuda.empty_cache()
        steps = [T // 64 for _, T in SHAPES]
        for k, name in (("dq", "dQ pass"), ("dkv", "dK/dV pass")):
            fixed, step = fit(steps, got[k])
            print(f"rate {rate} {name}: {fixed:.4f} ms fixed, {step:.4f} ms a step (3072 blocks)  [{card}]",
                  flush=True)


if __name__ == "__main__":
    main()
