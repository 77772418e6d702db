"""The steps of K1/K2's design (``csrc/flash_attention_packed.cu``), two of
them left out in turn and timed beside the kernels as built, and the issue
rate of one Philox call, on one CUDA card:

    python -m visualbert_torch.tools.attn_steps

At the main path's shapes and inputs (``tools/main_path.py::
packed_attention_inputs``: B=128, T=228, H=12, D=64, bf16, padded keys):

* "as built": K1/K2 as the kernel library builds them;
* "philox per row" (step 2 left out): the source built with
  ``-DVB_PACKED_PHILOX_PER_ROW``, each lane making the Philox calls of both
  its rows, so twice the calls and no shuffle;
* "sync loads" (step 3 left out): built with ``-DVB_PACKED_SYNC_LOADS``,
  plain 16-byte loads and stores in place of ``cp.async``, so every tile
  lands before the products that follow it start and no copy overlaps one;
* "sp sync loads": K13/K14 (``csrc/flash_attention_sp.cu``, on the same
  design) built with ``-DVB_PACKED_SYNC_LOADS``: K14's probability tiles
  (and every other tile) land before their products start, so what the
  asynchronous copies buy is the difference to K13/K14 as built, on K1/K2's
  inputs with the bias added (K13 takes the biased projection).

Steps 1 and 4 have no build of their own: step 1 alone is K16 (``chip_smoke.py``
phase 3 times it beside K1/K2), and the design has no ``mma.sync`` path.

Every build is held against the plain versions at dropout 0 and 0.1 (out,
stats, dqkv, the bias gradient; K13/K14's out, probabilities and dqkv;
within ``chip_smoke.py``'s limits) and against the as-built outputs (bit
for bit is printed, not required). Then K1 and K2 (its two kernels), and
K13 and K14 in their builds, are timed at dropout 0.1 and 0 with CUDA
events: ROUNDS rounds, each the best of 3 runs of 30 calls
(``tools/attn_exp.py::best_ms``), the builds in turn, in reverse in every
other round; the least and the largest round are printed.

The Philox rate: ``csrc/bench/philox_rate.cu`` runs ``attn_philox`` with the
kernels' four keep-bit compares in one wave of resident blocks and reads
each block's SM clock (``clock64``): the cycles one warp's call takes a
sub-partition, and from them what K1's and K2's warp calls at this shape
would take alone. (Its second form, K3's counter and key, gives
``chip_smoke.py`` K3's Philox bound.) Every line carries the card's name and power limit; the
last line is the numbers as one JSON object. Runs only on the card: without
one it exits with an error.
"""

from __future__ import annotations

import ctypes
import json
import math
import shutil
import statistics

from visualbert_torch.ops import _build

ROUNDS = 4
H, D = 12, 64
SEED = 5
# chip_smoke.py's limits for K1/K2 (max |kernel - plain| / max |plain|,
# statistics absolute)
OUT_TOL, DQKV_TOL, DB_TOL, STATS_TOL = 2e-2, 6e-3, 8e-3, 1e-5
# chip_smoke.py's limits for K13/K14 (out, dqkv as above; each probability
# within one bf16 ulp of its plain value)
SP_OUT_TOL, SP_DQKV_TOL = 8e-3, 8e-3
BUILDS = {  # name: (source under csrc, nvcc defines)
    "philox per row": ("flash_attention_packed.cu", ["-DVB_PACKED_PHILOX_PER_ROW"]),
    "sync loads": ("flash_attention_packed.cu", ["-DVB_PACKED_SYNC_LOADS"]),
    "sp sync loads": ("flash_attention_sp.cu", ["-DVB_PACKED_SYNC_LOADS"]),
    "philox rate": ("bench/philox_rate.cu", []),
}
PHILOX_THREADS, PHILOX_CALLS = 256, 4096
# csrc/bench/philox_rate.cu's forms: attention dropout's calls (K1/K2), the
# dropout mask's (K3)
PHILOX_FORMS = {"attention": 0, "mask": 1}
SUB_PARTITIONS = 4  # of an SM: each issues one warp instruction a cycle


PACKED_FNS = ("vb_attn_packed_fwd", "vb_attn_packed_bwd", "vb_attn_packed_info")
SP_FNS = ("vb_attn_sp_fwd", "vb_attn_sp_bwd", "vb_attn_sp_info")


def build_all():
    """Compile each of BUILDS alone into a shared library (one nvcc each,
    all at once); returns ({name: CDLL}, seconds, ptxas log)."""
    import time

    nvcc = _build.find_nvcc()
    out = _build.BUILD_ROOT / "steps"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    paths = {name: out / f"{name.replace(' ', '_')}.so" for name in BUILDS}
    t0 = time.perf_counter()
    results = _build._run_all([[nvcc, *_build.ARCH_FLAGS, *_build.NVCC_FLAGS, *defines, "-shared", "-I",
                                str(_build.CSRC), str(_build.CSRC / src), "-o", str(paths[name])]
                               for name, (src, defines) in BUILDS.items()])
    seconds = time.perf_counter() - t0
    for cmd, rc, text in results:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{text}")
    libs = {name: ctypes.CDLL(str(p)) for name, p in paths.items()}
    for name, fns in (("philox per row", PACKED_FNS), ("sync loads", PACKED_FNS), ("sp sync loads", SP_FNS)):
        for fn in fns:
            getattr(libs[name], fn).argtypes = _build._SIGNATURES[fn]
            getattr(libs[name], fn).restype = ctypes.c_int
    libs["philox rate"] = bind_philox_bench(paths["philox rate"])
    return libs, seconds, "".join(text for _, _, text in results)


def bind_philox_bench(path):
    """Load a build of csrc/bench/philox_rate.cu with its entry points typed."""
    bench = ctypes.CDLL(str(path))
    bench.vb_philox_blocks_per_sm.argtypes = [ctypes.c_int, ctypes.c_int]
    bench.vb_philox_rate.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint,
                                     ctypes.c_uint, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    for fn in (bench.vb_philox_blocks_per_sm, bench.vb_philox_rate):
        fn.restype = ctypes.c_int
    return bench


def build_philox_bench():
    """csrc/bench/philox_rate.cu built alone (one nvcc, no PyTorch headers:
    seconds) into ``_build/philox_bench/``; returns it loaded and typed."""
    src, defines = BUILDS["philox rate"]
    out = _build.BUILD_ROOT / "philox_bench"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    path = out / "philox_rate.so"
    [(cmd, rc, text)] = _build._run_all([[_build.find_nvcc(), *_build.ARCH_FLAGS, *_build.NVCC_FLAGS, *defines,
                                          "-shared", "-I", str(_build.CSRC), str(_build.CSRC / src), "-o",
                                          str(path)]])
    if rc != 0:
        raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{text}")
    return bind_philox_bench(path)


class PackedBuild:
    """K1/K2's three kernels from one library, called as their wrappers call
    them, with the head groups of this build's own occupancy."""

    def __init__(self, name, lib, B, T, n_sm):
        from visualbert_torch.ops import flash_attention as fa

        self.name, self.lib = name, lib
        info = [[lib.vb_attn_packed_info(k, w, T) for w in range(4)] for k in range(3)]
        if min(i[3] for i in info) < 1:
            raise RuntimeError(f"{name}: a kernel fits no block an SM at T={T}")
        self.hg = [fa.head_group(B, H, n_sm, i[3]) for i in info]
        self.info = info  # registers, local bytes, shared bytes, blocks an SM

    def _check(self, code, what):
        if code != 0:
            raise RuntimeError(f"{self.name} {what}: CUDA error {code}")

    def fwd(self, qkv, qb, key_bias, rate, seed):
        from visualbert_torch.ops.flash_attention import launch_packed_fwd

        code, out, stats = launch_packed_fwd(self.lib, qkv, qb, key_bias, H, rate, seed, self.hg[0])
        self._check(code, "forward")
        return out, stats

    def bwd(self, qkv, qb, key_bias, dout, out, stats, rate, seed):
        from visualbert_torch.ops.flash_attention import launch_packed_bwd

        code, dqkv, dqb = launch_packed_bwd(self.lib, qkv, qb, key_bias, dout, out, stats, H, rate, seed, *self.hg[1:])
        self._check(code, "backward")
        return dqkv, dqb

    def calls(self, data, rate):
        """(forward, backward) of this build on ``data`` at ``rate`` as
        closures, the backward on this build's forward outputs."""
        qkv, qb, key_bias, dout = data
        out, stats = self.fwd(qkv, qb, key_bias, rate, SEED)
        return (lambda: self.fwd(qkv, qb, key_bias, rate, SEED),
                lambda: self.bwd(qkv, qb, key_bias, dout, out, stats, rate, SEED))


class SpBuild(PackedBuild):
    """K13/K14's three kernels from one library, called as their wrappers
    call them, with the head groups of this build's own occupancy."""

    def __init__(self, name, lib, B, T, n_sm):
        from visualbert_torch.ops import flash_attention as fa

        self.name, self.lib = name, lib
        info = [[lib.vb_attn_sp_info(k, w, T) for w in range(4)] for k in range(3)]
        if min(i[3] for i in info) < 1:
            raise RuntimeError(f"{name}: a kernel fits no block an SM at T={T}")
        self.hg = [fa.head_group(B, H, n_sm, i[3]) for i in info]
        self.info = info

    def fwd(self, qkv, key_bias, rate, seed):
        from visualbert_torch.ops.flash_attention import launch_sp_fwd

        code, out, probs = launch_sp_fwd(self.lib, qkv, key_bias, H, rate, seed, self.hg[0])
        self._check(code, "K13")
        return out, probs

    def bwd(self, qkv, probs, dout, out, rate, seed):
        from visualbert_torch.ops.flash_attention import launch_sp_bwd

        code, dqkv, _ = launch_sp_bwd(self.lib, qkv, probs, probs.stride(2), dout, out, H, rate, seed, *self.hg[1:])
        self._check(code, "K14")
        return dqkv

    def calls(self, data, rate):
        qkv, key_bias, dout = data
        out, probs = self.fwd(qkv, key_bias, rate, SEED)
        return (lambda: self.fwd(qkv, key_bias, rate, SEED), lambda: self.bwd(qkv, probs, dout, out, rate, SEED))


def check_sp(builds, data, card):
    """K13/K14 as built and with synchronous copies against the plain
    versions (out, dqkv; each probability within one bf16 ulp) and against
    each other; raises on a disagreement with the plain versions."""
    import torch

    from visualbert_torch.ops import flash_attention as fa

    qkv, key_bias, dout = data
    errs = {b.name: {} for b in builds}
    for rate in (0.0, 0.1):
        out_r, probs_r = fa.packed_attention_sp_fwd_reference(qkv, key_bias, H, rate, SEED)
        dqkv_r = fa.packed_attention_sp_bwd_reference(qkv, probs_r, dout, out_r, H, rate, SEED)
        ulp = torch.ldexp(torch.ones_like(probs_r, dtype=torch.float32),
                          torch.frexp(probs_r.float().abs().clamp_min(2.0 ** -126))[1] - 8).clamp_min(2.0 ** -126)
        first = None
        for b in builds:
            out, probs = b.fwd(qkv, key_bias, rate, SEED)
            dqkv = b.bwd(qkv, probs, dout, out, rate, SEED)
            torch.cuda.synchronize()
            e = dict(out=_rel(out, out_r), probs_ulps=float(((probs.float() - probs_r.float()).abs() / ulp).max()),
                     dqkv=_rel(dqkv, dqkv_r))
            same = None if first is None else all(torch.equal(x, y) for x, y in zip((out, probs, dqkv), first))
            first = first or (out, probs, dqkv)
            errs[b.name][f"rate {rate}"] = dict(e, same_as_built=same)
            print(f"{b.name} K13/K14 rate {rate}: out {e['out']:.3e} (tol {SP_OUT_TOL}), probs {e['probs_ulps']:g} "
                  f"bf16 ulps (tol 1), dqkv {e['dqkv']:.3e} (tol {SP_DQKV_TOL})"
                  f"{'' if same is None else f'; bit for bit as built: {same}'}  [{card}]", flush=True)
            if not (e["out"] <= SP_OUT_TOL and e["probs_ulps"] <= 1 and e["dqkv"] <= SP_DQKV_TOL):
                raise SystemExit(f"attn_steps: {b.name} K13/K14 disagree with the plain versions at rate {rate}")
        del out_r, probs_r, dqkv_r, ulp, first
    return errs


def print_times(builds, times, card, what):
    base = times[builds[0].name]
    for b in builds:
        t = times[b.name]
        text = "; ".join(f"{k} {min(v):.4f}-{max(v):.4f} ms" + ("" if b is builds[0] else
                                                                f" ({min(v) / min(base[k]) - 1:+.1%})")
                         for k, v in t.items())
        print(f"{b.name} {what}: {text}  [{card}]", flush=True)


def _rel(a, b):
    return float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-6))


def check(builds, data, card):
    """Each build against the plain versions, the others also against the
    as-built outputs; raises on a disagreement. Returns {name: errors}."""
    import torch

    from visualbert_torch.ops import flash_attention as fa

    qkv, qb, key_bias, dout = data
    errs = {b.name: {} for b in builds}
    for rate in (0.0, 0.1):
        out_r, stats_r = fa.packed_attention_fwd_reference(qkv, qb, key_bias, H, rate, SEED)
        dqkv_r, db_r = fa.packed_attention_bwd_reference(qkv, qb, key_bias, dout, out_r, stats_r, H, rate, SEED)
        first = None
        for b in builds:
            out, stats = b.fwd(qkv, qb, key_bias, rate, SEED)
            dqkv, db = b.bwd(qkv, qb, key_bias, dout, out_r, stats_r, rate, SEED)
            torch.cuda.synchronize()
            e = dict(out=_rel(out, out_r), stats=float((stats - stats_r).abs().max()), dqkv=_rel(dqkv, dqkv_r),
                     db=_rel(db, db_r))
            same = None if first is None else all(torch.equal(x, y) for x, y in zip((out, stats, dqkv, db), first))
            first = first or (out, stats, dqkv, db)
            errs[b.name][f"rate {rate}"] = dict(e, same_as_built=same)
            print(f"{b.name} rate {rate}: out {e['out']:.3e} (tol {OUT_TOL}), stats {e['stats']:.3e} (tol "
                  f"{STATS_TOL}), dqkv {e['dqkv']:.3e} (tol {DQKV_TOL}), bias gradient {e['db']:.3e} (tol {DB_TOL})"
                  f"{'' if same is None else f'; bit for bit as built: {same}'}  [{card}]", flush=True)
            if not (e["out"] <= OUT_TOL and e["stats"] <= STATS_TOL and e["dqkv"] <= DQKV_TOL and e["db"] <= DB_TOL):
                raise SystemExit(f"attn_steps: {b.name} disagrees with the plain versions at rate {rate}")
        del out_r, dqkv_r
    return errs


def time_builds(builds, data):
    """{name: {"fwd 0.1": [ms a round], ...}}: each build's forward and
    backward at both rates, the builds in turn and reversed in every other
    round; a round's time is tools/attn_exp.py's best of 3 runs of 30
    calls."""
    from visualbert_torch.tools.attn_exp import best_ms

    times = {b.name: {} for b in builds}
    for r in range(ROUNDS):
        for b in (builds if r % 2 == 0 else builds[::-1]):
            for rate in (0.1, 0.0):
                fwd, bwd = b.calls(data, rate)
                times[b.name].setdefault(f"fwd {rate}", []).append(best_ms(lambda i: fwd()))
                times[b.name].setdefault(f"bwd {rate}", []).append(best_ms(lambda i: bwd()))
                del fwd, bwd
    return times


def philox_rate(lib, n_sm, card, form="attention"):
    """Cycles one warp's Philox call of ``form`` (PHILOX_FORMS; with its
    compares) takes an SM sub-partition, and the effective SM clock, from
    one wave of blocks."""
    import torch

    from visualbert_torch.ops.philox import keep_threshold

    per_sm = lib.vb_philox_blocks_per_sm(PHILOX_FORMS[form], PHILOX_THREADS)
    if per_sm < 1:
        raise RuntimeError(f"philox rate ({form}): no block fits an SM")
    blocks = n_sm * per_sm
    dev = torch.device("cuda")
    sink = torch.empty(blocks * PHILOX_THREADS, dtype=torch.int32, device=dev)
    cycles = torch.empty(blocks, dtype=torch.int64, device=dev)
    args = (PHILOX_FORMS[form], blocks, PHILOX_THREADS, PHILOX_CALLS, SEED, keep_threshold(0.1), sink.data_ptr(),
            cycles.data_ptr(), _build.stream_ptr(dev))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(2):  # the first launch warms up
        start.record()
        code = lib.vb_philox_rate(*args)
        end.record()
        torch.cuda.synchronize()
        if code != 0:
            raise RuntimeError(f"philox rate ({form}): CUDA error {code}")
    cyc = statistics.median(cycles.tolist())
    warp_calls = per_sm * PHILOX_THREADS // 32 * PHILOX_CALLS / SUB_PARTITIONS
    res = dict(blocks_per_sm=per_sm, cycles_per_warp_call=cyc / warp_calls, ms=start.elapsed_time(end),
               sm_ghz=cyc / (start.elapsed_time(end) * 1e6))
    print(f"philox rate ({form}): {res['cycles_per_warp_call']:.2f} cycles a warp call a sub-partition ({per_sm} "
          f"blocks of {PHILOX_THREADS} an SM, {PHILOX_CALLS} calls a thread, {res['ms']:.4f} ms, SM clock "
          f"{res['sm_ghz']:.3f} GHz by clock64 over the events)  [{card}]", flush=True)
    return res


def philox_alone_ms(rate, B, T, n_sm, calls_per_iteration=1):
    """What one pass's warp calls at shape (B, T) would take at ``rate``
    alone: a warp calls once per (16-row slice, 8-column block) that holds a
    position below T in both, i.e. ceil(T/16) * ceil(T/8) times a pair."""
    warp_calls = B * H * math.ceil(T / 16) * math.ceil(T / 8) * calls_per_iteration
    return warp_calls / (n_sm * SUB_PARTITIONS) * rate["cycles_per_warp_call"] / (rate["sm_ghz"] * 1e6)


def main(argv=None):
    """Prints one line a check and a timing; returns the numbers."""
    import torch

    from visualbert_torch.tools.main_path import card_line, packed_attention_inputs

    if argv:
        raise SystemExit(f"attn_steps: takes no arguments, got {argv}")
    if not torch.cuda.is_available():
        raise SystemExit("attn_steps: no CUDA device; the kernels run only on the card")
    card = card_line()
    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    data = packed_attention_inputs(dev)
    B, T, _ = data[0].shape
    libs, seconds, _ = build_all()
    print(f"attn_steps: B={B} T={T} H={H} D={D}; {len(BUILDS)} builds in {seconds:.1f} s  [{card}]", flush=True)
    builds = [PackedBuild("as built", _build.library(), B, T, n_sm)]
    builds += [PackedBuild(name, libs[name], B, T, n_sm) for name in ("philox per row", "sync loads")]
    for b in builds:
        print(f"{b.name}: hg {b.hg}; registers, local bytes, shared bytes, blocks an SM of the forward, dQ pass, "
              f"dK/dV pass: {b.info}  [{card}]", flush=True)
    errors = check(builds, data, card)
    times = time_builds(builds, data)
    print_times(builds, times, card, "K1/K2")
    qkv, qb, key_bias, dout = data
    sp_data = (qkv + qb, key_bias, dout)  # K13 takes the biased projection
    sp_builds = [SpBuild("as built", _build.library(), B, T, n_sm), SpBuild("sp sync loads", libs["sp sync loads"],
                                                                          B, T, n_sm)]
    for b in sp_builds:
        print(f"{b.name}: K13/K14 hg {b.hg}; registers, local bytes, shared bytes, blocks an SM of the forward, dQ "
              f"pass, dK/dV pass: {b.info}  [{card}]", flush=True)
    sp_errors = check_sp(sp_builds, sp_data, card)
    sp_times = time_builds(sp_builds, sp_data)
    print_times(sp_builds, sp_times, card, "K13/K14")
    rate = philox_rate(libs["philox rate"], n_sm, card)
    alone = {name: dict(fwd=philox_alone_ms(rate, B, T, n_sm, n), bwd=2 * philox_alone_ms(rate, B, T, n_sm, n))
             for name, n in (("as built", 1), ("philox per row", 2))}
    for name, a in alone.items():
        share = {p: min(times[name][f"{p} 0.1"]) - min(times[name][f"{p} 0.0"]) for p in ("fwd", "bwd")}
        print(f"{name}: its Philox calls alone at that rate {a['fwd']:.4f} ms forward, {a['bwd']:.4f} ms backward; "
              f"dropout 0.1 - dropout 0 {share['fwd']:.4f} / {share['bwd']:.4f} ms  [{card}]", flush=True)
    result = dict(card=card, shape=dict(B=B, T=T, H=H, D=D), errors=errors, times=times,
                  builds={b.name: dict(hg=b.hg, info=b.info) for b in builds}, philox=dict(rate, alone=alone),
                  save_probs=dict(errors=sp_errors, times=sp_times,
                                  builds={b.name: dict(hg=b.hg, info=b.info) for b in sp_builds}))
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
