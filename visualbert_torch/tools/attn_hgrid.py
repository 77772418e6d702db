"""Sweep of the 2-D (batch, head-group) grid attention (K16) against the
production packed attention (K1/K2) on one CUDA card, at B=96, T=228, H=12,
D=64 (the counterpart of ``scripts/attn_hgrid.py``'s ``main``):

    python -m visualbert_torch.tools.attn_hgrid [hg ...]   (default: 6 4 2; any divisor of H)

The inputs, checks and timings are ``tools/attn_exp.py``'s: max |out -
K1's| and max |dqkv - K2's| at dropout 0, then the forward and forward +
backward times at dropout 0.1, best of 3 runs of 30 calls (CUDA events),
beside the card's name and power limit. Runs only on the card: without one
it exits with an error.
"""

from __future__ import annotations

import sys

from visualbert_torch.tools.attn_exp import H, k1k2, start, sweep


def main(argv=None):
    """Prints one line an hg; returns {"hg=<n>": numbers}, K1/K2's under "K1/K2"."""
    from visualbert_torch.ops import attention_exp as ae

    args = list(sys.argv[1:] if argv is None else argv)
    try:
        hgs = [int(a) for a in args] or [6, 4, 2]
    except ValueError:
        raise SystemExit(f"attn_hgrid: hg values must be integers, got {args}")
    bad = [hg for hg in hgs if hg < 1 or H % hg]
    if bad:
        raise SystemExit(f"attn_hgrid: hg must divide H={H}, got {bad}")
    card, data = start("attn_hgrid")
    results = {}
    results["K1/K2"], ref = k1k2(card, data)
    for hg in hgs:
        results[f"hg={hg}"], _ = sweep(f"hg={hg}", lambda *a, hg=hg: ae.attn_hgrid_fwd(*a[:3], H, *a[3:], hg=hg),
                                       lambda *a, hg=hg: ae.attn_hgrid_bwd(*a[:6], H, *a[6:], hg=hg), data, ref,
                                       card)
    return results


if __name__ == "__main__":
    main()
