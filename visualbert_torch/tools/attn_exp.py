"""Sweep of the attention experiment variants (K15) against the production
packed attention (K1/K2) on one CUDA card, at B=96, T=228, H=12, D=64
(the counterpart of ``scripts/attn_exp.py``'s ``main``):

    python -m visualbert_torch.tools.attn_exp [variant ...]   (default: every VARIANTS entry)

Inputs as the TPU script makes them: ``RandomState(0)``, qkv x 0.3, qb x
0.02, dout x 0.01 (bf16), a zero key bias. For each variant: max |out -
K1's| and max |dqkv - K2's| at dropout 0, each backward fed its own
forward's out and statistic; then the forward and forward + backward times
at dropout 0.1, each the best of 3 runs of 30 calls timed with CUDA events,
beside the card's name and power limit. The first line times K1/K2
themselves; "base" is K15 with ``make_variant``'s defaults. Runs only on the
card: without one it exits with an error.
"""

from __future__ import annotations

import sys

import numpy as np

B, T, H, D = 96, 228, 12, 64
F = 3 * H * D
CALLS, RUNS = 30, 3
RATE = 0.1


def inputs(device):
    """qkv [B, T, F], qb [F], key bias [B, T], dout [B, T, H*D] as the TPU
    scripts make them."""
    import torch

    rng = np.random.RandomState(0)
    qkv = torch.tensor(rng.randn(B, T, F).astype(np.float32) * 0.3).to(device, torch.bfloat16)
    qb = torch.tensor(rng.randn(F).astype(np.float32) * 0.02).to(device, torch.bfloat16)
    key_bias = torch.zeros((B, T), dtype=torch.float32, device=device)
    dout = torch.tensor(rng.randn(B, T, F // 3).astype(np.float32) * 0.01).to(device, torch.bfloat16)
    return qkv, qb, key_bias, dout


def best_ms(fn):
    """The best of RUNS runs of CALLS calls fn(i), ms a call (CUDA events)."""
    import torch

    fn(0)  # warm-up
    best = float("inf")
    for _ in range(RUNS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for i in range(CALLS):
            fn(i)
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / CALLS)
    return best


def sweep(name, fwd, bwd, data, ref, card):
    """Check a (fwd, bwd) pair against K1/K2 at dropout 0 (``ref`` = (out,
    dqkv), or None for K1/K2 themselves), time it at dropout 0.1, print one
    line and return its numbers. fwd(qkv, qb, key_bias, rate, seed) and
    bwd(qkv, qb, key_bias, dout, out, stats, rate, seed)."""
    qkv, qb, key_bias, dout = data
    out, stats = fwd(qkv, qb, key_bias, 0.0, 0)
    dqkv, _ = bwd(qkv, qb, key_bias, dout, out, stats, 0.0, 0)
    row = {}
    if ref is not None:
        row["max_abs_out"] = float((out.float() - ref[0].float()).abs().max())
        row["max_abs_dqkv"] = float((dqkv.float() - ref[1].float()).abs().max())

    def fb(i):
        o, s = fwd(qkv, qb, key_bias, RATE, i)
        return bwd(qkv, qb, key_bias, dout, o, s, RATE, i)

    row["fwd_ms"] = best_ms(lambda i: fwd(qkv, qb, key_bias, RATE, i))
    row["fwd_bwd_ms"] = best_ms(fb)
    errs = "" if ref is None else f"max|Δout|={row['max_abs_out']:.2e} max|Δdqkv|={row['max_abs_dqkv']:.2e}  "
    print(f"{name:18s} {errs}fwd {row['fwd_ms']:7.4f}  fwd+bwd {row['fwd_bwd_ms']:7.4f}  "
          f"(bwd ~{row['fwd_bwd_ms'] - row['fwd_ms']:7.4f}) ms  [{card}]", flush=True)
    return row, (out, dqkv)


def start(what):
    """The card, its nvidia-smi line and the inputs; exits without a card."""
    import torch

    from visualbert_torch.tools.main_path import card_line

    if not torch.cuda.is_available():
        raise SystemExit(f"{what}: no CUDA device; the kernels run only on the card")
    card = card_line()
    print(f"{what}: B={B} T={T} H={H} D={D}, times at dropout {RATE}, best of {RUNS} x {CALLS} calls  [{card}]",
          flush=True)
    return card, inputs(torch.device("cuda"))


def k1k2(card, data):
    """K1/K2's line; returns (their numbers, (out, dqkv) at dropout 0)."""
    from visualbert_torch.ops import flash_attention as fa

    return sweep("K1/K2", lambda *a: fa.packed_attention_fwd(*a[:3], H, *a[3:]),
                 lambda *a: fa.packed_attention_bwd(*a[:6], H, *a[6:]), data, None, card)


def main(argv=None):
    """Prints one line a variant; returns {name: numbers}, K1/K2's under "K1/K2"."""
    from visualbert_torch.ops import attention_exp as ae

    names = list(sys.argv[1:] if argv is None else argv) or list(ae.VARIANTS)
    unknown = [n for n in names if n not in ae.VARIANTS]
    if unknown:
        raise SystemExit(f"attn_exp: unknown variants {unknown}; choose from {list(ae.VARIANTS)}")
    card, data = start("attn_exp")
    results = {}
    results["K1/K2"], ref = k1k2(card, data)
    for name in names:
        kw = ae.VARIANTS[name] or {}
        results[name], _ = sweep(name, lambda *a, kw=kw: ae.attn_exp_fwd(*a[:3], H, *a[3:], **kw),
                                 lambda *a, kw=kw: ae.attn_exp_bwd(*a[:6], H, *a[6:], **kw), data, ref, card)
    return results


if __name__ == "__main__":
    main()
