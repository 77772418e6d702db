"""K1/K2 (``csrc/flash_attention_packed.cu``) and K15/K16
(``csrc/flash_attention_exp.cu``) of this checkout against those of another
checkout of the repository, on one CUDA card:

    python -m visualbert_torch.tools.attn_ab OTHER_CHECKOUT

OTHER_CHECKOUT is the root of another tree of the repository (an earlier
commit unpacked with ``git archive``). The packed source of each tree is
built alone, with its own headers and the kernel library's flags, into a
shared library ("this" and "other"). Both are launched through this
checkout's ``launch_packed_*`` at the main path's shapes
(``tools/main_path.py::packed_attention_inputs``), each with the head groups
of its own occupancy query, and printed with each kernel's registers, local
bytes, shared memory and blocks an SM. Their outputs (out, stats, dqkv, the
bias gradient) must agree with the plain versions within ``attn_steps``'s
limits and with each other bit for bit, at dropout 0 and 0.1; then both are
timed in turns (``tools/attn_steps.py``'s rounds). Each tree's K15/K16
source is built alone too and launched through this checkout's
``launch_exp_*`` (the entry points keep their signatures) at the same
shapes: every ``VARIANTS`` entry and K16 at hg 6, 4 and 2, forward and
backward at dropout 0.1, the trees in turns (EXP_ROUNDS rounds of
``tools/attn_exp.py``'s best of 3 runs of 30 calls). Where the toolkit has
``cuobjdump``, each kernel's machine code (SASS) in the two builds is
compared instruction by instruction, addresses and encodings dropped: K1/K2
and, built alone to ``cubin``, K11/K12 (``csrc/flash_attention.cu``) and
K13/K14 (``csrc/flash_attention_sp.cu``), which share ``hopper_attn.cuh``.
Every line names the card and its power limit; the last line is the
numbers as one JSON object. Runs only on the card: without one it exits
with an error.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import time
from pathlib import Path

from visualbert_torch.ops import _build

SOURCE = Path("visualbert_torch") / "csrc" / "flash_attention_packed.cu"
KERNELS = {"forward": "fwd_kernel", "dQ pass": "dq_kernel", "dK/dV pass": "dkv_kernel"}
EXP_SOURCE = SOURCE.parent / "flash_attention_exp.cu"
EXP_FNS = ("vb_attn_exp_fwd", "vb_attn_exp_bwd")
EXP_ROUNDS = 2
# the other sources on hopper_attn.cuh: {source: {kernel: part of its mangled name}}
OTHER_SOURCES = {
    "flash_attention.cu": {"K11 forward": "hm_fwd_kernel", "K12 dQ pass": "hm_dq_kernel",
                           "K12 dK/dV pass": "hm_dkv_kernel"},
    "flash_attention_sp.cu": {"K13 forward": "attn_sp_fwd_kernel", "K14 dQ pass": "attn_sp_bwd_dq_kernel",
                              "K14 dK/dV pass": "attn_sp_bwd_dkv_kernel"},
}


def bind(path, fns):
    lib = ctypes.CDLL(str(path))
    for fn in fns:
        getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def build(trees):
    """Each tree {name: root} built alone, one nvcc a source, all at once:
    ({name: (packed CDLL, path)}, {name: K15/K16 CDLL}, {name: {other
    source: cubin path}})."""
    from visualbert_torch.tools.attn_steps import PACKED_FNS

    nvcc = _build.find_nvcc()
    out = _build.BUILD_ROOT / "ab"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    paths = {name: out / f"{name}.so" for name in trees}
    exp_paths = {name: out / f"{name}_exp.so" for name in trees}
    cubins = {name: {src: out / f"{name}_{Path(src).stem}.cubin" for src in OTHER_SOURCES} for name in trees}
    cmds = []
    for name, root in trees.items():
        flags = [nvcc, *_build.ARCH_FLAGS, *_build.NVCC_FLAGS, "-I", str(root / SOURCE.parent)]
        cmds.append([*flags, "-shared", str(root / SOURCE), "-o", str(paths[name])])
        cmds.append([*flags, "-shared", str(root / EXP_SOURCE), "-o", str(exp_paths[name])])
        cmds += [[*flags, "-cubin", str(root / SOURCE.parent / src), "-o", str(cubins[name][src])]
                 for src in OTHER_SOURCES]
    for cmd, rc, text in _build._run_all(cmds):
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{text}")
    libs = {name: (bind(path, PACKED_FNS), path) for name, path in paths.items()}
    return libs, {name: bind(path, EXP_FNS) for name, path in exp_paths.items()}, cubins


# the instantiations of K1/K2 and K4-K6 that earlier trees may not have
# (fp16, head dim 128): compare_sass and tools/xent_steps.py skip them
OTHER_FORMS = ("6__half", "Li128E")


def sass_of(text, kernels=KERNELS, skip=()):
    """{kernel: [instructions]} from ``cuobjdump -sass`` output: each
    function's instructions without their addresses and encodings, its
    branch labels renumbered in order of use, keyed by the role in
    ``kernels`` ({role: part of the mangled name}) its name names; a name
    holding any part of ``skip`` is left out."""
    out, cur, labels = {}, None, {}

    def label(m):
        return f".L{labels.setdefault(m.group(0), len(labels))}"

    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            left_out = any(part in m.group(1) for part in skip)
            cur = None if left_out else next((k for k, pat in kernels.items() if pat in m.group(1)), None)
            labels = {}
            if cur is not None:
                out[cur] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
        if m and cur is not None:
            out[cur].append(re.sub(r"\.L_x_\d+", label, m.group(1)))
    return out


def compare_sass(libs, cubins, card):
    """Per kernel (K1/K2's three, K11-K14's six): whether the two builds'
    SASS is the same instruction for instruction, and each build's
    instruction count; None without cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        print(f"sass: no cuobjdump, not compared  [{card}]", flush=True)
        return None

    def dump(path, kernels):
        return sass_of(subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                                      check=True).stdout, kernels, OTHER_FORMS)

    sass = {name: dump(path, KERNELS) for name, (_, path) in libs.items()}
    for src, kernels in OTHER_SOURCES.items():
        for name in sass:
            sass[name].update(dump(cubins[name][src], kernels))
    res = {}
    for k in [*KERNELS, *(k for kernels in OTHER_SOURCES.values() for k in kernels)]:
        a, b = sass["this"].get(k, []), sass["other"].get(k, [])
        res[k] = dict(same=bool(a) and a == b, instructions=[len(a), len(b)])
        print(f"sass of the {k}: {len(a)} instructions here, {len(b)} in the other tree, the same: "
              f"{res[k]['same']}  [{card}]", flush=True)
    return res


def exp_times(exp_libs, data, card):
    """K15 (every VARIANTS entry) and K16 (hg 6, 4, 2) of each tree's build
    at dropout 0.1: {case: {tree: {"fwd": [ms a round], "bwd": [...]}}},
    the trees in turns, reversed in every other round; each backward on its
    own build's forward outputs."""
    from visualbert_torch.ops import attention_exp as ae
    from visualbert_torch.tools.attn_exp import best_ms
    from visualbert_torch.tools.attn_steps import H, SEED

    qkv, qb, key_bias, dout = data
    B = qkv.shape[0]
    cases = {name: kw or {} for name, kw in ae.VARIANTS.items()}
    cases.update({f"hg={hg}": dict(hg=hg) for hg in (6, 4, 2)})
    times = {case: {name: {"fwd": [], "bwd": []} for name in exp_libs} for case in cases}
    for r in range(EXP_ROUNDS):
        for name in (list(exp_libs) if r % 2 == 0 else list(exp_libs)[::-1]):
            lib = exp_libs[name]
            for case, kw in cases.items():
                sched = ae.schedules(B, H, **kw)
                pre, nomax, fdrop = (bool(kw.get(f)) for f in ("prescale", "nomax", "fdrop"))

                def fwd(_):
                    code, out, stats = ae.launch_exp_fwd(lib, qkv, qb, key_bias, H, 0.1, SEED, *sched["forward"],
                                                         pre, nomax)
                    if code != 0:
                        raise RuntimeError(f"{name} {case} forward: CUDA error {code}")
                    return out, stats

                out, stats = fwd(0)

                def bwd(_):
                    code, *_ = ae.launch_exp_bwd(lib, qkv, qb, key_bias, dout, out, stats, H, 0.1, SEED,
                                                 *sched["backward"], pre, fdrop)
                    if code != 0:
                        raise RuntimeError(f"{name} {case} backward: CUDA error {code}")

                times[case][name]["fwd"].append(best_ms(fwd))
                times[case][name]["bwd"].append(best_ms(bwd))
                del out, stats
    for case, t in times.items():
        a, b = t["this"], t["other"]
        text = "; ".join(f"{p} {min(a[p]):.4f}-{max(a[p]):.4f} ms here, {min(b[p]):.4f}-{max(b[p]):.4f} in the "
                         f"other tree ({min(a[p]) / min(b[p]) - 1:+.1%})" for p in ("fwd", "bwd"))
        print(f"K{16 if case.startswith('hg=') else 15} {case}, dropout 0.1: {text}  [{card}]", flush=True)
    return times


def main(argv=None):
    import sys

    import torch

    from visualbert_torch.tools import attn_steps
    from visualbert_torch.tools.main_path import card_line, packed_attention_inputs

    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1 or not (Path(argv[0]) / SOURCE).exists():
        raise SystemExit(f"attn_ab: takes the root of another checkout that holds {SOURCE}, got {argv}")
    if not torch.cuda.is_available():
        raise SystemExit("attn_ab: no CUDA device; the kernels run only on the card")
    card = card_line()
    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    data = packed_attention_inputs(dev)
    B, T, _ = data[0].shape
    t0 = time.perf_counter()
    libs, exp_libs, cubins = build({"this": _build.CSRC.parent.parent, "other": Path(argv[0]).resolve()})
    print(f"attn_ab: B={B} T={T} H={attn_steps.H}; the builds in {time.perf_counter() - t0:.1f} s  [{card}]",
          flush=True)
    builds = [attn_steps.PackedBuild(name, lib, B, T, n_sm) for name, (lib, _) in libs.items()]
    for b in builds:
        print(f"{b.name}: hg {b.hg}; registers, local bytes, shared bytes, blocks an SM of the forward, dQ pass, "
              f"dK/dV pass: {b.info}  [{card}]", flush=True)
    errors = attn_steps.check(builds, data, card)
    if not all(e["same_as_built"] for e in errors["other"].values()):
        raise SystemExit("attn_ab: the two trees' K1/K2 differ in their outputs")
    times = attn_steps.time_builds(builds, data)
    attn_steps.print_times(builds, times, card, "K1/K2")
    exp = exp_times(exp_libs, data, card)
    sass = compare_sass(libs, cubins, card)
    result = dict(card=card, shape=dict(B=B, T=T, H=attn_steps.H), other=str(argv[0]), errors=errors, times=times,
                  exp_times=exp, builds={b.name: dict(hg=b.hg, info=b.info) for b in builds}, sass=sass)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
