"""The steps of K10's design (``csrc/layer_norm.cu::ln_bwd_kernel``), left
out in turn and timed beside the kernels as built, on one CUDA card:

    python -m visualbert_torch.tools.ln_steps [OTHER_CHECKOUT]

At the main path's shapes and inputs (``chip_smoke.py``'s:
``tools/main_path.py::layer_norm_inputs``, N = 128 x 228 = 29,184 rows, H =
768, bf16, rate 0.1), each build of ``csrc/layer_norm.cu`` alone with the
switches of BUILDS, into ``visualbert_torch/_build/ln_steps/``:

* "regen mask": ``-DVB_LN_REGEN_MASK``, K10 draws its keep bits again from
  the seed (two Philox calls a lane chunk), as the first design did, in
  place of reading K9's: what saving the bits buys;
* "sync loads": ``-DVB_LN_SYNC_LOADS``, every row copy a plain load and
  store: what the ring's asynchronous copies buy;
* "2 stages", "4 stages": the ring a stage shorter or longer
  (``-DVB_LN_STAGES``).

"regen mask" and "sync loads" must give K8's and K10's outputs bit for bit
(the same mask, the same arithmetic, the same grid). The stage builds fit
another number of blocks on an SM, so their grid and partial rows differ:
their dx and dres must be bit for bit, dscale and dbias within
``chip_smoke.py``'s limit.

Given the root of another tree of the repository (an earlier commit
unpacked with ``git archive``), the tool also builds that tree's
``layer_norm.cu`` alone, compares the machine code (SASS, ``cuobjdump``, as
``tools/attn_ab.py`` does) of K7-K10's vector forms (every dtype and chunk
count: the widths that are a multiple of 8 up to 1024) and of the reduce
pass with this tree's instruction by instruction, and times K7-K10 of both
trees in turns. That tree's entry points may be the first design's, before
K9 saved its bits (``FIRST_DESIGN_SIGNATURES``): its K10 then regenerates the
mask from the seed.

Kernels are timed with CUDA events: ROUNDS rounds, each the best of 3 runs
of 30 calls (``tools/attn_exp.py::best_ms``), the builds in turn, in reverse
in every other round; the least and the largest round are printed, with
each build's registers, local bytes, shared bytes and blocks an SM of K7-K10.
Every line carries the card's name and power limit; the last line is the
numbers as one JSON object. Runs only on the card: without one it exits
with an error.
"""

from __future__ import annotations

import ctypes
import json
import shutil
from pathlib import Path

from visualbert_torch.ops import _build

ROUNDS = 3
RATE, SEED, EPS = 0.1, 4321, 1e-12
LN_Y_TOL, LN_DW_TOL = 1e-2, 1.2e-6  # chip_smoke.py's limits for K7-K10
BUILDS = {
    "regen mask": ["-DVB_LN_REGEN_MASK"],
    "sync loads": ["-DVB_LN_SYNC_LOADS"],
    "2 stages": ["-DVB_LN_STAGES=2"],
    "4 stages": ["-DVB_LN_STAGES=4"],
}
SAME_GRID = ("regen mask", "sync loads")  # builds whose outputs must equal K8/K10 as built in every bit
FNS = ("vb_ln_geometry", "vb_ln_info", "vb_ln_fwd", "vb_ln_bwd")
KERNELS = ("K7", "K8", "K9", "K10")
_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
# the entry points of csrc/layer_norm.cu before K9 saved its bits: no bits
# pointer, and geometry 2 the backward's blocks an SM
FIRST_DESIGN_SIGNATURES = {
    "vb_ln_geometry": [_I],
    "vb_ln_fwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _U, _U, _F, _P],
    "vb_ln_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _U, _U, _F, _P],
}
# K7/K9 (ln_fwd_kernel<T, NC, DROPOUT>) and K8/K10 (ln_bwd_kernel<T, NC,
# DROPOUT>) at every dtype and chunk count, and the reduce pass: part of
# each mangled name (the any-width forms' kernels match none)
SHARED_KERNELS = {f"{k} {t} NC={nc}": f"{fn}I{m}Li{nc}ELb{d}EE"
                  for k, fn, d in (("K7", "ln_fwd_kernel", 0), ("K9", "ln_fwd_kernel", 1),
                                   ("K8", "ln_bwd_kernel", 0), ("K10", "ln_bwd_kernel", 1))
                  for t, m in (("bf16", "13__nv_bfloat16"), ("fp16", "6__half"), ("fp32", "f"))
                  for nc in (1, 2, 3, 4)}
SHARED_KERNELS["K8/K10 reduce"] = "ln_bwd_reduce_kernel"


def _compile(jobs, out):
    """Build {name: (csrc directory, defines)} alone into ``out``; {name: path}."""
    nvcc = _build.find_nvcc()
    paths = {name: out / f"{name.replace(' ', '_')}.so" for name in jobs}
    results = _build._run_all([[nvcc, *_build.ARCH_FLAGS, *_build.NVCC_FLAGS, *defines, "-shared", "-I", str(src),
                                str(src / "layer_norm.cu"), "-o", str(paths[name])]
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
    """Compile csrc/layer_norm.cu once for each of BUILDS, and with another
    checkout also this tree's and that tree's alone (one nvcc each, all at
    once); returns ({name: Build}, {name: .so path}, seconds)."""
    import time

    out = _build.BUILD_ROOT / "ln_steps"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    jobs = {name: (_build.CSRC, defines) for name, defines in BUILDS.items()}
    if other is not None:
        jobs["this"] = (_build.CSRC, [])
        jobs["other"] = (Path(other) / "visualbert_torch" / "csrc", [])
    t0 = time.perf_counter()
    paths = _compile(jobs, out)
    seconds = time.perf_counter() - t0
    builds = {name: Build(name, _load(paths[name], {fn: _build._SIGNATURES[fn] for fn in FNS}))
              for name in BUILDS}
    if other is not None:
        first = "vb_ln_info" not in (Path(other) / "visualbert_torch" / "csrc" / "layer_norm.cu").read_text()
        sig = FIRST_DESIGN_SIGNATURES if first else {fn: _build._SIGNATURES[fn] for fn in FNS}
        builds["other"] = Build("other", _load(paths["other"], sig), first_design=first)
    return builds, paths, seconds


class Build:
    """K7-K10 of one library, launched as this checkout's wrappers launch
    them (or, for a first-design library, as its wrappers did)."""

    def __init__(self, name, lib, first_design=False):
        self.name, self.lib, self.first_design = name, lib, first_design

    def _check(self, code, what):
        if code != 0:
            raise RuntimeError(f"{self.name} {what}: CUDA error {code}")

    def info(self, H, dtype_code):
        """[[registers, local bytes, shared bytes, blocks an SM] of K7..K10],
        or None for a first-design library (it has no query)."""
        if self.first_design:
            return None
        return [[self.lib.vb_ln_info(k, w, H, dtype_code) for w in range(4)] for k in (7, 8, 9, 10)]

    def fwd(self, x, res, scale, bias, dropout):
        """(y, mu, rstd, bits or None) of K7 or K9."""
        import torch

        from visualbert_torch.ops import layer_norm as ln

        if not self.first_design:
            code, *out = ln.launch_fwd(self.lib, x, res, scale, bias, EPS, dropout, RATE, SEED)
            self._check(code, "K9" if dropout else "K7")
            return tuple(out)
        N, H = x.shape
        y = torch.empty_like(x)
        mu = torch.empty(N, dtype=torch.float32, device=x.device)
        rstd = torch.empty(N, dtype=torch.float32, device=x.device)
        code = self.lib.vb_ln_fwd(x.data_ptr(), res.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
                                  mu.data_ptr(), rstd.data_ptr(), N, H, ln._DTYPE_CODES[x.dtype], EPS, int(dropout),
                                  *ln._dropout_args(RATE if dropout else 0.0, SEED), _build.stream_ptr(x.device))
        self._check(code, "K9" if dropout else "K7")
        return y, mu, rstd, None

    def bwd(self, x, res, scale, mu, rstd, dy, bits, dropout, sms):
        """(dx, dres or None, dscale, dbias) of K8 or K10 (on ``bits``, or
        for a first-design library on the seed)."""
        import torch

        from visualbert_torch.ops import layer_norm as ln

        if not self.first_design:
            code, *out = ln.launch_bwd(self.lib, x, res, scale, mu, rstd, dy, bits if dropout else None,
                                       RATE if dropout else 0.0, sms, SEED)
            self._check(code, "K10" if dropout else "K8")
            return tuple(out)
        N, H = x.shape
        blocks = max(1, min(self.lib.vb_ln_geometry(2) * sms, -(-N // self.lib.vb_ln_geometry(1))))
        dx = torch.empty_like(x)
        dres = torch.empty_like(res) if dropout else None
        part = torch.empty((blocks, 2, H), dtype=torch.float32, device=x.device)
        dscale = torch.empty(H, dtype=torch.float32, device=x.device)
        dbias = torch.empty(H, dtype=torch.float32, device=x.device)
        code = self.lib.vb_ln_bwd(x.data_ptr(), res.data_ptr(), scale.data_ptr(), mu.data_ptr(), rstd.data_ptr(),
                                  dy.data_ptr(), dx.data_ptr(), None if dres is None else dres.data_ptr(),
                                  part.data_ptr(), dscale.data_ptr(), dbias.data_ptr(), N, H, blocks,
                                  ln._DTYPE_CODES[x.dtype], int(dropout),
                                  *ln._dropout_args(RATE if dropout else 0.0, SEED), _build.stream_ptr(x.device))
        self._check(code, "K10" if dropout else "K8")
        return dx, dres, dscale, dbias

    def calls(self, data, mu, rstd, bits, sms):
        """{kernel: fn(i)} launching K7..K10 on ``data``, K8/K10 on the plain
        mu, rstd and K10 on ``bits`` (K9's as built)."""
        x, res, dy, scale, bias = data
        return {"K7": lambda _: self.fwd(x, res, scale, bias, False),
                "K8": lambda _: self.bwd(x, res, scale, mu, rstd, dy, None, False, sms),
                "K9": lambda _: self.fwd(x, res, scale, bias, True),
                "K10": lambda _: self.bwd(x, res, scale, mu, rstd, dy, bits, True, sms)}


def rel(a, b):
    return float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-6))


def check(builds, data, sms, card):
    """Hold K8/K10 of every build (and K7/K9 of another tree) against the
    plain versions and against the kernels as built; returns the errors and
    the plain mu, rstd and K9's bits as built."""
    import torch

    from visualbert_torch.ops import layer_norm as ln

    x, res, dy, scale, bias = data
    _, mu, rstd, bits_r = ln.dropout_add_layer_norm_fwd_reference(x, res, scale, bias, RATE, SEED, EPS)
    k10_r = ln.dropout_add_layer_norm_bwd_reference(x, res, scale, mu, rstd, dy, bits_r, RATE)
    k8_r = ln.add_layer_norm_bwd_reference(x, res, scale, mu, rstd, dy)
    base = builds["as built"]
    _, _, _, bits = base.fwd(x, res, scale, bias, True)
    if not torch.equal(bits, bits_r):
        raise SystemExit("ln_steps: K9's keep bits as built differ from the plain version's")
    want = {"K10": base.bwd(x, res, scale, mu, rstd, dy, bits, True, sms),
            "K8": base.bwd(x, res, scale, mu, rstd, dy, None, False, sms)}
    plain = {"K10": k10_r, "K8": (k8_r[0], None) + tuple(k8_r[1:])}
    errors = {}
    for name, b in builds.items():
        errors[name] = {}
        for k in ("K8", "K10"):
            got = b.bwd(x, res, scale, mu, rstd, dy, bits, k == "K10", sms)
            torch.cuda.synchronize()
            pairs = [(g, w, p) for g, w, p in zip(got, want[k], plain[k]) if w is not None]
            r_d = max(rel(g, p) for g, _, p in pairs[:-2])
            r_w = max(rel(g, p) for g, _, p in pairs[-2:])
            same = [torch.equal(g, w) for g, w, _ in pairs]
            errors[name][k] = dict(rel_dx=r_d, rel_dw=r_w, same_as_built=all(same), same_dx=all(same[:-2]))
            print(f"{name} {k}: dx{', dres' if k == 'K10' else ''} rel {r_d:.3e} (tol {LN_Y_TOL}), dscale, dbias "
                  f"rel {r_w:.3e} (tol {LN_DW_TOL}); bit for bit as built: {all(same)} (dx, dres: "
                  f"{all(same[:-2])})  [{card}]", flush=True)
            if not (r_d <= LN_Y_TOL and r_w <= LN_DW_TOL):
                raise SystemExit(f"ln_steps: {name}'s {k} disagrees with its plain version")
            if name in SAME_GRID + ("as built",) and not all(same):
                raise SystemExit(f"ln_steps: {name}'s {k} differs from the kernel as built")
            if name in BUILDS and not all(same[:-2]):
                raise SystemExit(f"ln_steps: {name}'s {k} dx differs from the kernel as built")
    return errors, mu, rstd, bits


def compare_sass(paths, other, card):
    """The SASS of SHARED_KERNELS in this tree's and ``other``'s
    layer_norm.cu; {kernel: (same, instructions here, instructions there)},
    or None without cuobjdump."""
    import subprocess

    from visualbert_torch.tools.attn_ab import sass_of

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        print(f"sass: no cuobjdump, not compared  [{card}]", flush=True)
        return None
    sass = {name: sass_of(subprocess.run([tool, "-sass", str(paths[name])], capture_output=True, text=True,
                                         check=True).stdout, SHARED_KERNELS) for name in ("this", "other")}
    res = {}
    for k in SHARED_KERNELS:
        a, b = sass["this"].get(k, []), sass["other"].get(k, [])
        res[k] = (bool(a) and a == b, len(a), len(b))
        print(f"sass of {k}: {len(a)} instructions here, {len(b)} in {other}, the same: {res[k][0]}  [{card}]",
              flush=True)
    return res


def main(argv=None):
    """Prints one line a check and a timing; returns the numbers."""
    import sys

    import torch

    from visualbert_torch.ops import layer_norm as ln
    from visualbert_torch.tools.attn_exp import best_ms
    from visualbert_torch.tools.main_path import card_line, layer_norm_inputs

    argv = sys.argv[1:] if argv is None else argv
    if len(argv) > 1 or (argv and not (Path(argv[0]) / "visualbert_torch" / "csrc" / "layer_norm.cu").exists()):
        raise SystemExit(f"ln_steps: takes at most one argument, the root of another checkout, got {argv}")
    if not torch.cuda.is_available():
        raise SystemExit("ln_steps: no CUDA device; the kernels run only on the card")
    card = card_line()
    dev = torch.device("cuda")
    sms = _build.sm_count(dev)
    data = layer_norm_inputs(dev)
    N, H = data[0].shape
    other = argv[0] if argv else None
    libs, paths, seconds = build_all(other)
    builds = {"as built": Build("as built", _build.library()), **libs}
    print(f"ln_steps: N={N} H={H} bf16 rate {RATE}; {len(paths)} builds in {seconds:.1f} s  [{card}]", flush=True)
    info = {name: b.info(H, ln._DTYPE_CODES[data[0].dtype]) for name, b in builds.items()}
    for name, i in info.items():
        print(f"{name}: registers, local bytes, shared bytes, blocks an SM of K7, K8, K9, K10: {i}  [{card}]",
              flush=True)
        if i is not None and any(k[1] for k in i):
            raise SystemExit(f"ln_steps: {name} spills to local memory")
    errors, mu, rstd, bits = check(builds, data, sms, card)

    fns = {name: b.calls(data, mu, rstd, bits, sms) for name, b in builds.items()}
    timed = {name: KERNELS if name in ("as built", "other") else ("K8", "K10") for name in builds}
    times = {name: {k: [] for k in timed[name]} for name in builds}
    order = list(builds)
    for r in range(ROUNDS):
        for name in (order if r % 2 == 0 else order[::-1]):
            for k in timed[name]:
                times[name][k].append(best_ms(fns[name][k]))
    for name in builds:
        print(f"{name}: " + ", ".join(f"{k} {min(t):.4f}-{max(t):.4f} ms" for k, t in times[name].items())
              + f"  [{card}]", flush=True)
    result = dict(card=card, shape=dict(N=N, H=H, rate=RATE), errors=errors, info=info, ms=times)
    if other is not None:
        result["other"] = str(other)
        result["sass"] = compare_sass(paths, other, card)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
