"""K1/K2 (``csrc/flash_attention_packed.cu``) of this checkout against those
of another checkout of the repository, on one CUDA card:

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
timed in turns (``tools/attn_steps.py``'s rounds). Where the toolkit has
``cuobjdump``, each kernel's machine code (SASS) in the two builds is
compared instruction by instruction, addresses and encodings dropped.
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


def build(trees):
    """{name: (CDLL, path)}: the packed source of each tree {name: root}
    built alone (one nvcc each, all at once)."""
    from visualbert_torch.tools.attn_steps import PACKED_FNS

    nvcc = _build.find_nvcc()
    out = _build.BUILD_ROOT / "ab"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    paths = {name: out / f"{name}.so" for name in trees}
    results = _build._run_all([[nvcc, *_build.ARCH_FLAGS, *_build.NVCC_FLAGS, "-shared", "-I",
                                str(root / SOURCE.parent), str(root / SOURCE), "-o", str(paths[name])]
                               for name, root in trees.items()])
    for cmd, rc, text in results:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{text}")
    libs = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(str(path))
        for fn in PACKED_FNS:
            getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = (lib, path)
    return libs


def sass_of(text, kernels=KERNELS):
    """{kernel: [instructions]} from ``cuobjdump -sass`` output: each
    function's instructions without their addresses and encodings, its
    branch labels renumbered in order of use, keyed by the role in
    ``kernels`` ({role: part of the mangled name}) its name names."""
    out, cur, labels = {}, None, {}

    def label(m):
        return f".L{labels.setdefault(m.group(0), len(labels))}"

    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = next((k for k, pat in kernels.items() if pat in m.group(1)), None)
            labels = {}
            if cur is not None:
                out[cur] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
        if m and cur is not None:
            out[cur].append(re.sub(r"\.L_x_\d+", label, m.group(1)))
    return out


def compare_sass(libs, card):
    """Per kernel: whether the two builds' SASS is the same instruction for
    instruction, and each build's instruction count; None without cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        print(f"sass: no cuobjdump, not compared  [{card}]", flush=True)
        return None
    sass = {name: sass_of(subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                                         check=True).stdout) for name, (_, path) in libs.items()}
    res = {}
    for k in KERNELS:
        a, b = sass["this"].get(k, []), sass["other"].get(k, [])
        res[k] = dict(same=bool(a) and a == b, instructions=[len(a), len(b)])
        print(f"sass of the {k}: {len(a)} instructions here, {len(b)} in the other tree, the same: "
              f"{res[k]['same']}  [{card}]", flush=True)
    return res


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
    libs = build({"this": _build.CSRC.parent.parent, "other": Path(argv[0]).resolve()})
    print(f"attn_ab: B={B} T={T} H={attn_steps.H}; 2 builds in {time.perf_counter() - t0:.1f} s  [{card}]", flush=True)
    builds = [attn_steps.PackedBuild(name, lib, B, T, n_sm) for name, (lib, _) in libs.items()]
    for b in builds:
        print(f"{b.name}: hg {b.hg}; registers, local bytes, shared bytes, blocks an SM of the forward, dQ pass, "
              f"dK/dV pass: {b.info}  [{card}]", flush=True)
    errors = attn_steps.check(builds, data, card)
    if not all(e["same_as_built"] for e in errors["other"].values()):
        raise SystemExit("attn_ab: the two trees' K1/K2 differ in their outputs")
    times = attn_steps.time_builds(builds, data)
    attn_steps.print_times(builds, times, card, "K1/K2")
    sass = compare_sass(libs, card)
    result = dict(card=card, shape=dict(B=B, T=T, H=attn_steps.H), other=str(argv[0]), errors=errors, times=times,
                  builds={b.name: dict(hg=b.hg, info=b.info) for b in builds}, sass=sass)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
