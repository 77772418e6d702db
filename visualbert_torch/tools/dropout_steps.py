"""The steps of K3's design and of the dropout site (``csrc/dropout.cu``),
left out in turn and timed beside the kernels as built, on one CUDA card:

    python -m visualbert_torch.tools.dropout_steps [OTHER_CHECKOUT]

At the main path's hidden-state shape ([128, 228, 768], bf16, rate 0.1;
K3's mask int8), each build of ``csrc/dropout.cu`` alone with the switches
of BUILDS, into ``visualbert_torch/_build/dropout_steps/``:

* "one call": ``-DVB_DROPOUT_ONE_CALL``, K3 makes one Philox call and one
  4-element store a thread, as the first design did: what 4 calls and 16 B
  stores a thread buy;
* "resident grid": ``-DVB_DROPOUT_RESIDENT``, the three kernels on a grid of
  resident blocks (the occupancy query x the SMs) in place of one group of
  16 a thread;
* "regen mask": ``-DVB_DROPOUT_REGEN_MASK``, the site backward draws its bits
  again from the seed in place of reading the forward's.

Every build must give the kernels' outputs bit for bit (the same bits, the
same products). Beside them, timed in the same rounds: the eager site the
port ran before the site kernels (K3 as built, then the cast, the rescale
and the product; its backward ``dy * m``), ``F.dropout`` and
``aten.native_dropout_backward`` (the library's dropout, never on the
path), and a device-to-device copy of the site forward's bytes. The public
wrappers are also called as a caller calls them (each call allocating its
outputs), with their host time a call: those calls are the only launches
the wrappers' counts see here (the builds' checks and the timing rounds
launch through ``ops/dropout.py::launch_*``, uncounted), and the tool's
calls of K3's wrapper are the only ones since no training path launches
K3's mask.

Given the root of another tree of the repository (an earlier commit
unpacked with ``git archive``), the tool also builds that tree's
``dropout.cu`` alone and times its K3 in the same rounds; a tree from
before the site kernels (no ``vb_dropout_fwd``: one Philox call a thread in
one-shot blocks) has K3's entry point alone, with this tree's signature.

Kernels are timed with CUDA events, launched directly on preallocated
tensors (a wrapper's host time a call is of the order of K3's device time
and would hide it): ROUNDS rounds, each the best of 3 runs of 30 calls
(``tools/attn_exp.py::best_ms``), the builds in turn, in reverse in every
other round; the least and the largest round are printed, with each build's
registers, local bytes and blocks an SM of each kernel and its achieved
TB/s. Every line carries the card's name and power limit; the last line is
the numbers as one JSON object. Runs only on the card: without one it exits
with an error.
"""

from __future__ import annotations

import ctypes
import json
import shutil
from pathlib import Path

from visualbert_torch.ops import _build

ROUNDS = 3
RATE, SEED = 0.1, 4321
BUILDS = {
    "one call": ["-DVB_DROPOUT_ONE_CALL"],
    "resident grid": ["-DVB_DROPOUT_RESIDENT"],
    "regen mask": ["-DVB_DROPOUT_REGEN_MASK"],
}
KERNELS = ("mask", "fwd", "bwd")  # K3, the site forward, the site backward
# the kernels each build is timed on: what its step changes
TIMED = {"one call": ("mask",), "resident grid": KERNELS, "regen mask": ("bwd",)}
FNS = ("vb_dropout_info", "vb_dropout_mask", "vb_dropout_fwd", "vb_dropout_bwd")


def _compile(jobs, out):
    """Build {name: (csrc directory, defines)} alone into ``out``; {name: path}."""
    nvcc = _build.find_nvcc()
    paths = {name: out / f"{name.replace(' ', '_')}.so" for name in jobs}
    results = _build._run_all([[nvcc, *_build.ARCH_FLAGS, *_build.NVCC_FLAGS, *defines, "-shared", "-I", str(src),
                                str(src / "dropout.cu"), "-o", str(paths[name])]
                               for name, (src, defines) in jobs.items()])
    for cmd, rc, text in results:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{text}")
    return paths


def _load(path, signatures):
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def build_all(other=None):
    """Compile csrc/dropout.cu once for each of BUILDS, and with another
    checkout that tree's alone too (one nvcc each, all at once); returns
    ({name: Build}, seconds)."""
    import time

    out = _build.BUILD_ROOT / "dropout_steps"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    jobs = {name: (_build.CSRC, defines) for name, defines in BUILDS.items()}
    if other is not None:
        jobs["other"] = (Path(other) / "visualbert_torch" / "csrc", [])
    t0 = time.perf_counter()
    paths = _compile(jobs, out)
    seconds = time.perf_counter() - t0
    builds = {name: Build(name, _load(paths[name], {fn: _build._SIGNATURES[fn] for fn in FNS})) for name in BUILDS}
    if other is not None:
        first = "vb_dropout_fwd" not in (Path(other) / "visualbert_torch" / "csrc" / "dropout.cu").read_text()
        fns = ("vb_dropout_mask",) if first else FNS
        builds["other"] = Build("other", _load(paths["other"], {fn: _build._SIGNATURES[fn] for fn in fns}),
                                first_design=first)
    return builds, seconds


class Build:
    """K3 and the site kernels of one library, launched as this checkout's
    wrappers launch them; a first-design library: K3 alone."""

    def __init__(self, name, lib, first_design=False):
        self.name, self.lib, self.first_design = name, lib, first_design

    def _check(self, code, what):
        if code != 0:
            raise RuntimeError(f"{self.name} {what}: CUDA error {code}")

    def kernels(self):
        return ("mask",) if self.first_design else KERNELS

    def info(self):
        """{kernel: [registers, local bytes, shared bytes, blocks an SM]} at
        the tool's dtypes, or None for a first-design library."""
        from visualbert_torch.ops import dropout as dr

        if self.first_design:
            return None
        return {k: [self.lib.vb_dropout_info(n, w, code) for w in range(4)]
                for k, n, code in (("mask", dr.MASK, 0), ("fwd", dr.SITE_FWD, 1), ("bwd", dr.SITE_BWD, 1))}

    def mask(self, out):
        from visualbert_torch.ops import dropout as dr

        self._check(dr.launch_mask(self.lib, out, RATE, SEED), "K3")
        return out

    def fwd(self, x, y, bits):
        from visualbert_torch.ops import dropout as dr

        self._check(dr.launch_fwd(self.lib, x, y, bits, RATE, SEED), "site forward")
        return y, bits

    def bwd(self, dy, bits, dx):
        from visualbert_torch.ops import dropout as dr

        self._check(dr.launch_bwd(self.lib, dy, bits, dx, RATE, SEED), "site backward")
        return dx


def data(dev):
    """x and dy bf16 [128, 228, 768] from RandomState(3), and the outputs'
    buffers: K3's int8 mask, y, the bits, dx."""
    import numpy as np
    import torch

    from visualbert_torch.tools.main_path import B, TT, TV

    shape = (B, TT + TV, 768)
    rng = np.random.RandomState(3)
    x, dy = (torch.tensor(rng.randn(*shape), dtype=torch.float32, device=dev).to(torch.bfloat16) for _ in range(2))
    out = torch.empty(shape, dtype=torch.int8, device=dev)
    bits = torch.empty(-(-x.numel() // 8), dtype=torch.uint8, device=dev)
    return dict(x=x, dy=dy, mask=out, y=torch.empty_like(x), bits=bits, dx=torch.empty_like(x))


def check(builds, d, card):
    """Every build's kernels against the plain versions, bit for bit."""
    import torch

    from visualbert_torch.ops import dropout as dr

    mask_r = dr.dropout_mask_reference(d["x"].shape, RATE, SEED, torch.int8, d["x"].device)
    y_r, bits_r = dr.dropout_fwd_reference(d["x"], RATE, SEED)
    dx_r = dr.dropout_bwd_reference(d["dy"], bits_r, RATE)
    for name, b in builds.items():
        same = {"mask": torch.equal(b.mask(torch.empty_like(d["mask"])), mask_r)}
        if not b.first_design:
            y, bits = b.fwd(d["x"], torch.empty_like(d["y"]), torch.empty_like(d["bits"]))
            same["fwd"] = torch.equal(y, y_r) and torch.equal(bits, bits_r)
            same["bwd"] = torch.equal(b.bwd(d["dy"], bits_r, torch.empty_like(d["dx"])), dx_r)
        torch.cuda.synchronize()
        print(f"{name}: bit for bit with the plain versions: {same}  [{card}]", flush=True)
        if not all(same.values()):
            raise SystemExit(f"dropout_steps: {name} differs from the plain versions")


def moved_bytes(d):
    """Each kernel's bytes: K3 its mask; the forward x, y and the bits; the
    backward dy, the bits and dx."""
    x, bits = d["x"], d["bits"]
    n = x.numel() * x.element_size()
    return {"mask": d["mask"].numel(), "fwd": 2 * n + bits.numel(), "bwd": 2 * n + bits.numel()}


def wrappers(d, card):
    """The public wrappers called as a caller calls them, each call
    allocating its outputs: ms a call by CUDA events over back-to-back
    calls, and the host's time a call with the card idle first."""
    import time

    import torch

    from visualbert_torch.ops import dropout as dr
    from visualbert_torch.tools.attn_exp import best_ms

    x, dy = d["x"], d["dy"]
    _, bits = dr.dropout_fwd(x, RATE, SEED)
    calls = {"mask": lambda i: dr.dropout_mask(x.shape, RATE, SEED + i, torch.int8, x.device),
             "fwd": lambda i: dr.dropout_fwd(x, RATE, SEED + i),
             "bwd": lambda i: dr.dropout_bwd(dy, bits, RATE)}
    res = {}
    for k, fn in calls.items():
        ms = best_ms(fn)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(30):
            fn(i)
        host_us = (time.perf_counter() - t0) / 30 * 1e6
        torch.cuda.synchronize()
        res[k] = dict(ms=ms, host_us=host_us)
    print("wrappers as called: " + ", ".join(f"{k} {r['ms']:.4f} ms a call, host {r['host_us']:.1f} us a call"
                                              for k, r in res.items()) + f"  [{card}]", flush=True)
    return res


def yardsticks(d):
    """{name: fn(i)} of what the site kernels are held against: the eager
    site, the library's dropout and a copy of the forward's bytes."""
    import torch
    import torch.nn.functional as F

    from visualbert_torch.ops import dropout as dr

    x, dy = d["x"], d["dy"]
    lib = _build.library()
    mask = d["mask"]
    dr.launch_mask(lib, mask, RATE, SEED)
    m = mask.to(x.dtype) * (1.0 / (1.0 - RATE))
    keep = F.dropout(x, RATE, training=True) != 0
    src = torch.empty(moved_bytes(d)["fwd"] // 2, dtype=torch.uint8, device=x.device)
    dst = torch.empty_like(src)

    def eager_fwd(_):
        dr.launch_mask(lib, mask, RATE, SEED)
        return x * (mask.to(x.dtype) * (1.0 / (1.0 - RATE)))

    return {"eager site fwd": eager_fwd,
            "eager site bwd": lambda _: dy * m,
            "F.dropout fwd": lambda _: F.dropout(x, RATE, training=True),
            "F.dropout bwd": lambda _: torch.ops.aten.native_dropout_backward(dy, keep, 1.0 / (1.0 - RATE)),
            "copy of the forward's bytes": lambda _: dst.copy_(src)}


def main(argv=None):
    """Prints one line a check and a timing; returns the numbers."""
    import sys

    import torch

    from visualbert_torch.tools.attn_exp import best_ms
    from visualbert_torch.tools.main_path import card_line

    argv = sys.argv[1:] if argv is None else argv
    if len(argv) > 1 or (argv and not (Path(argv[0]) / "visualbert_torch" / "csrc" / "dropout.cu").exists()):
        raise SystemExit(f"dropout_steps: takes at most one argument, the root of another checkout, got {argv}")
    if not torch.cuda.is_available():
        raise SystemExit("dropout_steps: no CUDA device; the kernels run only on the card")
    card = card_line()
    dev = torch.device("cuda")
    d = data(dev)
    other = argv[0] if argv else None
    libs, seconds = build_all(other)
    lib = _build.library()
    builds = {"as built": Build("as built", lib), **libs}
    print(f"dropout_steps: {list(d['x'].shape)} bf16 rate {RATE}; {len(libs)} builds in {seconds:.1f} s  [{card}]",
          flush=True)
    info = {name: b.info() for name, b in builds.items()}
    for name, i in info.items():
        print(f"{name}: registers, local bytes, shared bytes, blocks an SM of K3, site fwd, site bwd: {i}  [{card}]",
              flush=True)
        if i is not None and any(k[1] for k in i.values()):
            raise SystemExit(f"dropout_steps: {name} spills to local memory")
    check(builds, d, card)

    fns = {name: {"mask": lambda _, b=b: b.mask(d["mask"]),
                  "fwd": lambda _, b=b: b.fwd(d["x"], d["y"], d["bits"]),
                  "bwd": lambda _, b=b: b.bwd(d["dy"], d["bits"], d["dx"])} for name, b in builds.items()}
    timed = {name: TIMED.get(name, b.kernels()) for name, b in builds.items()}
    fns["yardsticks"] = yardsticks(d)
    timed["yardsticks"] = tuple(fns["yardsticks"])
    times = {name: {k: [] for k in ks} for name, ks in timed.items()}
    order = list(timed)
    for r in range(ROUNDS):
        for name in (order if r % 2 == 0 else order[::-1]):
            for k in timed[name]:
                times[name][k].append(best_ms(fns[name][k]))
    moved = moved_bytes(d)
    for name, ks in times.items():
        print(f"{name}: " + ", ".join(
            f"{k} {min(t):.4f}-{max(t):.4f} ms" + (f" ({moved[k] / min(t) / 1e9:.3f} TB/s)" if k in moved else "")
            for k, t in ks.items()) + f"  [{card}]", flush=True)
    result = dict(card=card, shape=list(d["x"].shape), rate=RATE, info=info, ms=times, bytes=moved,
                  wrappers=wrappers(d, card))
    if other is not None:
        result["other"] = str(other)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
