"""fp32 K4-K6 (``csrc/mlm_xent_f32.cu``) as built and with a choice of its
design changed, each held against the plain versions and timed in turns
beside them, on one CUDA card:

    python -m visualbert_torch.tools.xent_f32_steps

At the main path's N = 3072 rows and V = 30522, widths 768 and 2048, fp32,
seeded as ``chip_smoke.py``'s K4-K6 inputs (15 % of the labels -1, g 0
there), each build of ``csrc/mlm_xent_f32.cu`` alone (BUILDS):

* "two blocks an SM": ``-DVB_F32_NTH=128``, 64-row tiles of 4 warps, two
  blocks an SM (the logits' tile and the thread's 8 x 16 block as built);
* "ring of 4": ``-DVB_F32_STAGES=4``, four ring slots an operand.

Every build is held against the plain versions (nll, lse absolute; dx,
dE, db relative to the largest plain value; argmax exactly) at
``chip_smoke.py``'s fp32 limits first. Then K4, K5 and K6 of each build and
the plain versions are timed with CUDA events (ROUNDS rounds, each the best
of 2 runs of 5 calls (3 at 2048), the builds in turn, in reverse in every
other round) and printed with each build's registers, local (spill) bytes,
shared bytes and blocks an SM. Every line carries the card's name and power
limit; the last line is the numbers as one JSON object. Runs only on the
card: without one it exits with an error.
"""

from __future__ import annotations

import ctypes
import json
import shutil

from visualbert_torch.ops import _build

ROUNDS = 2
WIDTHS = (768, 2048)
REL_TOL = ABS_TOL = 1e-4  # chip_smoke.py's F32_REL_TOL / F32_ABS_TOL
BUILDS = {"two blocks an SM": ["-DVB_F32_NTH=128"], "ring of 4": ["-DVB_F32_STAGES=4"]}


class Lib:
    """One build of csrc/mlm_xent_f32.cu with its entry points typed."""

    def __init__(self, path):
        self.lib = ctypes.CDLL(str(path))
        for name, argtypes in _build._SIGNATURES.items():
            if name.startswith("vb_xent_f32"):
                fn = getattr(self.lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int

    def __getattr__(self, name):
        return getattr(self.lib, name)


def build_all():
    """Compile csrc/mlm_xent_f32.cu once for each of BUILDS (one nvcc each,
    all at once); returns ({name: Lib}, seconds)."""
    import time

    out = _build.BUILD_ROOT / "xent_f32_steps"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    paths = {name: out / f"{name.replace(' ', '_')}.so" for name in BUILDS}
    t0 = time.perf_counter()
    results = _build._run_all([[_build.find_nvcc(), *_build.ARCH_FLAGS, *_build.NVCC_FLAGS, *defines, "-shared",
                                "-I", str(_build.CSRC), str(_build.CSRC / "mlm_xent_f32.cu"), "-o", str(paths[name])]
                               for name, defines in BUILDS.items()])
    seconds = time.perf_counter() - t0
    for cmd, rc, text in results:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{text}")
    return {name: Lib(p) for name, p in paths.items()}, seconds


def inputs(torch, H, N=3072, V=30522):
    """chip_smoke.py's K4-K6 inputs in fp32 at width H: x, E, bias, labels, g."""
    import numpy as np

    rng = np.random.RandomState(1)
    x = torch.tensor(rng.randn(N, H), dtype=torch.float32, device="cuda")
    emb = torch.tensor(rng.randn(V, H) * 0.05, dtype=torch.float32, device="cuda")
    bias = torch.tensor(rng.randn(V) * 0.1, dtype=torch.float32, device="cuda")
    labels = rng.randint(0, V, N)
    labels[rng.rand(N) < 0.15] = -1
    g = torch.tensor(np.where(labels >= 0, rng.uniform(0.5, 1.5, N), 0.0), dtype=torch.float32, device="cuda")
    return x, emb, bias, torch.tensor(np.maximum(labels, 0), dtype=torch.int32, device="cuda"), g


def best_ms(torch, fn, iters, reps=2):
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        best = min(best, a.elapsed_time(b) / iters)
    return best


def launches(xe, lib, data, lse, sms):
    """K4, K5, K6 of one build, launched as their wrappers launch them."""
    x, emb, bias, lab, g = data

    def run(out):
        code, *res = out
        if code != 0:
            raise RuntimeError(f"CUDA error {code}")
        return res

    return (lambda: run(xe.launch_f32_fwd(lib, x, emb, bias, lab, sms)),
            lambda: run(xe.launch_f32_dx(lib, x, emb, bias, lab, lse, g, sms)),
            lambda: run(xe.launch_f32_de(lib, x, emb, bias, lab, lse, g)))


def main(argv=None):
    """Prints one line a check and a timing; returns the numbers."""
    import torch

    from visualbert_torch.ops import mlm_xent as xe
    from visualbert_torch.tools.main_path import card_line

    if argv:
        raise SystemExit(f"xent_f32_steps: takes no arguments, got {argv}")
    if not torch.cuda.is_available():
        raise SystemExit("xent_f32_steps: no CUDA device; the kernels run only on the card")
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    sms = xe.sm_count(torch.device("cuda"))
    libs, seconds = build_all()
    builds = {"as built": _build.library(), **libs}
    print(f"xent_f32_steps: {len(BUILDS)} builds in {seconds:.1f} s  [{card}]", flush=True)
    result = dict(card=card, info={}, errors={}, ms={})
    for H in WIDTHS:
        data = inputs(torch, H)
        nll_r, lse_r, am_r = xe.mlm_xent_fwd_reference(*data[:4])
        dx_r = xe.mlm_xent_dx_reference(*data[:4], lse_r, data[4])
        de_r, db_r = xe.mlm_xent_de_reference(*data[:4], lse_r, data[4])
        fns = {}
        for name, lib in builds.items():
            k4, k5, k6 = launches(xe, lib, data, lse_r, sms)
            (nll, lse, am), (dx,), (de, db) = k4(), k5(), k6()
            torch.cuda.synchronize()
            errs = dict(nll=float((nll - nll_r).abs().max()), lse=float((lse - lse_r).abs().max()),
                        argmax=int((am != am_r).sum()),
                        **{k: float((a - b).abs().max() / b.abs().max())
                           for k, a, b in (("dx", dx, dx_r), ("dE", de, de_r), ("db", db, db_r))})
            info = [[lib.vb_xent_f32_info(k, w, H) for w in range(4)] for k in (0, 1, 2)]
            print(f"H={H} {name}: {json.dumps(errs)}; registers, local bytes, shared bytes, blocks an SM of K5, K6, "
                  f"K4: {info}  [{card}]", flush=True)
            if not (errs["nll"] <= ABS_TOL and errs["lse"] <= ABS_TOL and errs["argmax"] == 0
                    and max(errs["dx"], errs["dE"], errs["db"]) <= REL_TOL):
                raise SystemExit(f"xent_f32_steps: {name} at H={H} disagrees with the plain versions")
            result["errors"][f"{H} {name}"], result["info"][f"{H} {name}"] = errs, info
            fns[name] = (k4, k5, k6)
        fns["plain"] = (lambda: xe.mlm_xent_fwd_reference(*data[:4]),
                        lambda: xe.mlm_xent_dx_reference(*data[:4], lse_r, data[4]),
                        lambda: xe.mlm_xent_de_reference(*data[:4], lse_r, data[4]))
        times = {name: [[], [], []] for name in fns}
        order = list(fns)
        for r in range(ROUNDS):
            for name in (order if r % 2 == 0 else order[::-1]):
                for k in range(3):
                    times[name][k].append(best_ms(torch, fns[name][k], 3 if H > 1024 else 5))
        for name, t in times.items():
            print(f"H={H} {name}: K4 / K5 / K6 ms " + " / ".join(f"{min(v):.4f}-{max(v):.4f}" for v in t)
                  + f"  [{card}]", flush=True)
            result["ms"][f"{H} {name}"] = t
        del data, dx_r, de_r, db_r
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    import sys

    main(sys.argv[1:])
