"""The steps of K5/K6's design (``csrc/mlm_xent.cu::xent_bwd_kernel``), left
out in turn and timed beside the kernels as built, on one CUDA card:

    python -m visualbert_torch.tools.xent_steps [OTHER_CHECKOUT]

At the main path's shapes and inputs (``chip_smoke.py``'s: N = 128 x 24 =
3072 rows, V = 30522, H = 768, bf16, seeded), each build of
``csrc/mlm_xent.cu`` alone with the switches of BUILDS:

* "no copy": ``-DVB_XENT_NO_COPY``, no streamed tile after a block's first
  is copied (the kernel reads the first again): what the copies cost that
  the products do not hide;
* "no logits": ``-DVB_XENT_NO_LOGITS``, the logits are zeros, no first
  product;
* "no product": ``-DVB_XENT_NO_PRODUCT``, no second product;
* the pairs "no logits, no product" (the copies and the dlog math alone)
  and "no copy, no product" (the logits alone, on one tile); all three
  left out: what a tile costs without a copy or a product (its barriers,
  the logits' exchange and the dlog math); and those with
  ``-DVB_XENT_NO_DLOG`` too (no dlog math, no dlog tile): the barriers and
  the blocks' own loads and stores, K5's reduce pass with them.

Given the root of another tree of the repository (an earlier commit
unpacked with ``git archive``), the tool also builds that tree's
``mlm_xent.cu`` alone and compares the machine code (SASS, ``cuobjdump``,
as ``tools/attn_ab.py`` does) of the kernels whose source both trees share
(K4's, at both widths, and K5's reduce pass) instruction by instruction.

A build with a step left out gives wrong results: the tool only times it,
and holds the kernels as built against their plain versions first. K5 (its
kernel and the reduce pass) and K6 are timed with CUDA events: ROUNDS
rounds, each the best of 3 runs of 30 calls (``tools/attn_exp.py::
best_ms``), the builds in turn, in reverse in every other round; the least
and the largest round are printed, with each build's registers, local
bytes, shared bytes and blocks an SM. Every line carries the card's name
and power limit; the last line is the numbers as one JSON object. Runs only
on the card: without one it exits with an error.
"""

from __future__ import annotations

import ctypes
import json
import shutil

from visualbert_torch.ops import _build

ROUNDS = 3
H = 768
DX_TOL, DE_TOL, DBIAS_TOL = 1.2e-2, 1.8e-2, 2e-6  # chip_smoke.py's limits for K5/K6
BUILDS = {
    "no copy": ["-DVB_XENT_NO_COPY"],
    "no logits": ["-DVB_XENT_NO_LOGITS"],
    "no product": ["-DVB_XENT_NO_PRODUCT"],
    "no logits, no product": ["-DVB_XENT_NO_LOGITS", "-DVB_XENT_NO_PRODUCT"],
    "no copy, no product": ["-DVB_XENT_NO_COPY", "-DVB_XENT_NO_PRODUCT"],
    "no copy, no logits, no product": ["-DVB_XENT_NO_COPY", "-DVB_XENT_NO_LOGITS", "-DVB_XENT_NO_PRODUCT"],
    "no copy, no logits, no product, no dlog": ["-DVB_XENT_NO_COPY", "-DVB_XENT_NO_LOGITS", "-DVB_XENT_NO_PRODUCT",
                                                "-DVB_XENT_NO_DLOG"],
}
FNS = ("vb_xent_geometry", "vb_xent_info", "vb_xent_dx", "vb_xent_de")
SHARED_KERNELS = {  # the kernels of mlm_xent.cu that an earlier tree may share: part of each mangled name
    "K4 forward, 768": "xent_fwd_kernelILi768", "K4 forward, 1024": "xent_fwd_kernelILi1024",
    "K4 merge": "xent_fwd_merge_kernel", "K5 reduce, 768": "xent_dx_reduce_kernelILi768",
    "K5 reduce, 1024": "xent_dx_reduce_kernelILi1024",
}


def build_all():
    """Compile csrc/mlm_xent.cu once for each of BUILDS (one nvcc each, all
    at once); returns ({name: CDLL}, seconds)."""
    import time

    nvcc = _build.find_nvcc()
    out = _build.BUILD_ROOT / "xent_steps"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    paths = {name: out / f"{name.replace(' ', '_').replace(',', '')}.so" for name in BUILDS}
    t0 = time.perf_counter()
    results = _build._run_all([[nvcc, *_build.ARCH_FLAGS, *_build.NVCC_FLAGS, *defines, "-shared", "-I",
                                str(_build.CSRC), str(_build.CSRC / "mlm_xent.cu"), "-o", str(paths[name])]
                               for name, defines in BUILDS.items()])
    seconds = time.perf_counter() - t0
    for cmd, rc, text in results:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{text}")
    libs = {name: ctypes.CDLL(str(p)) for name, p in paths.items()}
    for lib in libs.values():
        for fn in FNS:
            getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
    return libs, seconds


def compare_sass(other, card):
    """Build ``other``'s mlm_xent.cu alone and compare the SASS of
    SHARED_KERNELS with this tree's; {kernel: (same, instructions here,
    instructions there)}, or None without cuobjdump."""
    import subprocess
    from pathlib import Path

    from visualbert_torch.tools.attn_ab import sass_of

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        print(f"sass: no cuobjdump, not compared  [{card}]", flush=True)
        return None
    out = _build.BUILD_ROOT / "xent_steps"
    trees = {"this": _build.CSRC, "other": Path(other) / "visualbert_torch" / "csrc"}
    paths = {name: out / f"sass_{name}.so" for name in trees}
    for cmd, rc, text in _build._run_all([[_build.find_nvcc(), *_build.ARCH_FLAGS, *_build.NVCC_FLAGS, "-shared",
                                           "-I", str(src), str(src / "mlm_xent.cu"), "-o", str(paths[name])]
                                          for name, src in trees.items()]):
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{text}")
    sass = {name: sass_of(subprocess.run([tool, "-sass", str(p)], capture_output=True, text=True,
                                         check=True).stdout, SHARED_KERNELS) for name, p in paths.items()}
    res = {}
    for k in SHARED_KERNELS:
        a, b = sass["this"].get(k, []), sass["other"].get(k, [])
        res[k] = (bool(a) and a == b, len(a), len(b))
        print(f"sass of {k}: {len(a)} instructions here, {len(b)} in {other}, the same: {res[k][0]}  [{card}]",
              flush=True)
    return res


def inputs(torch, device):
    """chip_smoke.py's K4-K6 inputs at width H: x, embedding, bias, labels,
    g, and the plain lse."""
    import numpy as np

    from visualbert_torch.ops import mlm_xent as xe
    from visualbert_torch.tools.main_path import B, N_PRED

    N, V = B * N_PRED, 30522
    rng = np.random.RandomState(1)
    x = torch.tensor(rng.randn(N, H), dtype=torch.bfloat16, device=device)
    emb = torch.tensor(rng.randn(V, H) * 0.05, dtype=torch.bfloat16, device=device)
    bias = torch.tensor(rng.randn(V) * 0.1, dtype=torch.float32, device=device)
    labels = rng.randint(0, V, N)
    labels[rng.rand(N) < 0.15] = -1
    g = torch.tensor(np.where(labels >= 0, rng.uniform(0.5, 1.5, N), 0.0), dtype=torch.float32, device=device)
    lab = torch.tensor(np.maximum(labels, 0), dtype=torch.int32, device=device)
    _, lse, _ = xe.mlm_xent_fwd_reference(x, emb, bias, lab)
    return x, emb, bias, lab, lse, g


def calls(lib, data, sms):
    """K5 and K6 from one library, launched as their wrappers launch them."""
    from visualbert_torch.ops import mlm_xent as xe

    def check(code, what):
        if code != 0:
            raise RuntimeError(f"{what}: CUDA error {code}")

    def dx(_):
        code, out = xe.launch_dx(lib, *data, sms)
        check(code, "K5")
        return out

    def de(_):
        code, out, db = xe.launch_de(lib, *data)
        check(code, "K6")
        return out, db

    return dx, de


def rel(a, b):
    return float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-6))


def main(argv=None):
    """Prints one line a check and a timing; returns the numbers."""
    import torch

    from visualbert_torch.ops import mlm_xent as xe
    from visualbert_torch.tools.attn_exp import best_ms
    from visualbert_torch.tools.main_path import card_line

    if argv and len(argv) > 1:
        raise SystemExit(f"xent_steps: takes at most one argument (another checkout), got {argv}")
    if not torch.cuda.is_available():
        raise SystemExit("xent_steps: no CUDA device; the kernels run only on the card")
    card = card_line()
    dev = torch.device("cuda")
    sms = xe.sm_count(dev)
    data = inputs(torch, dev)
    libs, seconds = build_all()
    builds = {"as built": _build.library(), **libs}
    N, V = data[0].shape[0], data[1].shape[0]
    print(f"xent_steps: N={N} V={V} H={H}; {len(BUILDS)} builds in {seconds:.1f} s  [{card}]", flush=True)

    dx_fn, de_fn = calls(builds["as built"], data, sms)
    dx, (de, db) = dx_fn(0), de_fn(0)
    errors = (rel(dx, xe.mlm_xent_dx_reference(*data)),) + tuple(
        rel(a, b) for a, b in zip((de, db), xe.mlm_xent_de_reference(*data)))
    torch.cuda.synchronize()
    print(f"as built against the plain versions: dx {errors[0]:.3e} (tol {DX_TOL}), dE {errors[1]:.3e} (tol "
          f"{DE_TOL}), db {errors[2]:.3e} (tol {DBIAS_TOL})  [{card}]", flush=True)
    if not (errors[0] <= DX_TOL and errors[1] <= DE_TOL and errors[2] <= DBIAS_TOL):
        raise SystemExit("xent_steps: the kernels as built disagree with their plain versions")
    del dx, de, db

    info = {name: [[lib.vb_xent_info(k, w, H) for w in range(4)] for k in (0, 1)] for name, lib in builds.items()}
    fns = {name: calls(lib, data, sms) for name, lib in builds.items()}
    times = {name: ([], []) for name in builds}
    order = list(builds)
    for r in range(ROUNDS):
        for name in (order if r % 2 == 0 else order[::-1]):
            for k, fn in enumerate(fns[name]):
                times[name][k].append(best_ms(fn))
    for name in builds:
        k5, k6 = times[name]
        print(f"{name}: K5 {min(k5):.4f}-{max(k5):.4f} ms, K6 {min(k6):.4f}-{max(k6):.4f} ms; registers, local "
              f"bytes, shared bytes, blocks an SM of K5 and K6: {info[name]}  [{card}]", flush=True)
    result = dict(card=card, errors=errors, info=info,
                  ms={name: dict(K5=times[name][0], K6=times[name][1]) for name in builds})
    if argv:
        result["sass"] = compare_sass(argv[0], card)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    import sys

    main(sys.argv[1:])
