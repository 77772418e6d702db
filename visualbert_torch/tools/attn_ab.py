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
``tools/attn_exp.py``'s best of 3 runs of 30 calls). Each tree's
K11/K12 (``csrc/flash_attention.cu``) and K13/K14
(``csrc/flash_attention_sp.cu``), which share ``hopper_attn.cuh``, are
built alone too and launched through this checkout's ``launch_hm_*`` and
``launch_sp_*`` (the bf16, D = 64 entry points keep their signatures) at
the same shapes, on the same biased q, k, v: each against the plain
versions within ``chip_smoke.py``'s limits, the two trees bit for bit at
dropout 0 and 0.1 (each backward on this tree's forward outputs), then
timed in turns (``tools/attn_steps.py``'s rounds). The backwards K2, K12
and K14 at head dims 16 and 32 (bf16, fp16: SMALL_FORMS; SMALL_PAIRS) are
launched on this tree's small-row forms and on the other tree's route,
padded to 64 as its wrapper did (the pads and cuts timed with it), each on
the plain forward's outputs and against the plain backward, in turns. K2
at head dim 128 (bf16, fp16) on each tree's form (this tree's streamed
passes, an earlier tree's passes that held a head's rows; STREAMED_SHAPES,
on the plain forward's outputs) against the plain backward, then in turns
(:func:`streamed_ab`). The forwards K1 and K11 at head dims 16 and 32
(bf16, fp16: SMALL_FORMS; SMALL_FWD_PAIRS) on this tree's small-row forms
and on the other tree's route, padded to 64 as its wrapper did, each
against the plain forward, in turns beside
``scaled_dot_product_attention`` (:func:`small_forwards_ab`). Where the
toolkit has ``cuobjdump``, the machine code (SASS) of every kernel both
trees build (K1/K2 in bf16 and fp16 at every head dim, K11-K14 in every
form, K15/K16, and beside them the kernels of ``mlm_xent.cu``, which
includes hopper_attn.cuh too, and of the fp32 ``flash_attention_f32.cu``:
SASS_ONLY_SOURCES) is compared instruction by instruction, addresses and
encodings dropped (``tools/xent_steps.py::compare_all_sass``); kernels one
tree alone builds are listed.

A run takes every part of PARTS in that order; ``--only`` takes some of
them, comma-separated (those above the fp32 part share one build of the
trees), for example K1's and K11's small forms against the other tree's
padded route and the SASS alone:

    python -m visualbert_torch.tools.attn_ab OTHER_CHECKOUT --only small_forwards,sass

The fp32 part (``--only f32``; ``csrc/flash_attention_f32.cu``: K1/K11's
forward, K13's forward and the backward of K2, K12 and K14): each tree's
source is built alone and launched through this checkout's
``launch_f32_*`` (a build whose backward blocks own whole pairs through
:class:`WholePairs`) at the main path's B, T and padded keys
in fp32 at head dims F32_DIMS: every pair against the plain versions within
``chip_smoke.py``'s fp32 limits at dropout 0 and 0.1 (the two trees sum in
other orders: their gap is printed, not held), each tree's dropout masks
against the plain mask at T = 64 (identity V and dO), registers, local
(spill) bytes, shared bytes and blocks an SM of each kernel, the trees timed
in turns beside ``scaled_dot_product_attention`` in fp32, and every kernel
both trees build compared instruction by instruction (K1/K11's forward,
F32_SASS, also printed apart).

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
HM_OUT_TOL, HM_DQKV_TOL = 1.6e-2, 8e-3  # chip_smoke.py's limits for K11/K12
SP_DQKV_TOL = 8e-3  # chip_smoke.py's limit for K14
OTHER_SOURCES = ("flash_attention.cu", "flash_attention_sp.cu")  # K11/K12, K13/K14: also on hopper_attn.cuh


def bind(path, fns):
    lib = ctypes.CDLL(str(path))
    for fn in fns:
        getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    return lib


HM_FNS = ("vb_attn_hm_fwd", "vb_attn_hm_bwd", "vb_attn_hm_info")
# the backwards' other forms (SMALL_FORMS): K2's, K12's, K14's
PACKED_X_FNS = ("vb_attn_packed_x_fwd", "vb_attn_packed_x_bwd", "vb_attn_packed_x_info")
HM_X_FNS = ("vb_attn_hm_x_fwd", "vb_attn_hm_x_bwd", "vb_attn_hm_x_info")
# built for their machine code alone: the other source that includes
# hopper_attn.cuh (K4-K6) and the fp32 attention kernels
SASS_ONLY_SOURCES = ("mlm_xent.cu", "flash_attention_f32.cu")
SP_X_FNS = ("vb_attn_sp_x_bwd", "vb_attn_sp_x_info")


def build(trees):
    """Each tree {name: root} built alone, one nvcc a source, all at once:
    ({name: (packed CDLL, path)}, {name: K15/K16 CDLL}, {name: {other
    source: (CDLL, path)}}, {name: [every library's path, SASS_ONLY_SOURCES'
    too]})."""
    from visualbert_torch.tools.attn_steps import PACKED_FNS, SP_FNS

    nvcc = _build.find_nvcc()
    out = _build.BUILD_ROOT / "ab"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    paths = {name: out / f"{name}.so" for name in trees}
    exp_paths = {name: out / f"{name}_exp.so" for name in trees}
    others = {name: {src: out / f"{name}_{Path(src).stem}.so" for src in OTHER_SOURCES} for name in trees}
    sass_only = {name: [out / f"{name}_{Path(src).stem}.so" for src in SASS_ONLY_SOURCES] for name in trees}
    cmds = []
    for name, root in trees.items():
        flags = [nvcc, *_build.ARCH_FLAGS, *_build.NVCC_FLAGS, "-I", str(root / SOURCE.parent)]
        cmds.append([*flags, "-shared", str(root / SOURCE), "-o", str(paths[name])])
        cmds.append([*flags, "-shared", str(root / EXP_SOURCE), "-o", str(exp_paths[name])])
        cmds += [[*flags, "-shared", str(root / SOURCE.parent / src), "-o", str(others[name][src])]
                 for src in OTHER_SOURCES]
        cmds += [[*flags, "-shared", str(root / SOURCE.parent / src), "-o", str(path)]
                 for src, path in zip(SASS_ONLY_SOURCES, sass_only[name])]
    for cmd, rc, text in _build._run_all(cmds):
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{text}")
    libs = {name: (bind(path, PACKED_FNS + PACKED_X_FNS), path) for name, path in paths.items()}
    fns = {"flash_attention.cu": HM_FNS + HM_X_FNS, "flash_attention_sp.cu": SP_FNS + SP_X_FNS}
    sass_paths = {name: [paths[name], exp_paths[name], *others[name].values(), *sass_only[name]] for name in trees}
    others = {name: {src: (bind(path, fns[src]), path) for src, path in srcs.items()} for name, srcs in others.items()}
    return libs, {name: bind(path, EXP_FNS) for name, path in exp_paths.items()}, others, sass_paths


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


def sass_texts(paths):
    """{tree: the ``cuobjdump -sass`` text of its libraries} ({tree: [paths]});
    None without cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    return {name: "\n".join(subprocess.run([tool, "-sass", str(p)], capture_output=True, text=True, check=True).stdout
                            for p in ps) for name, ps in paths.items()}


def compare_sass(paths, card):
    """Every kernel both trees build (``paths``: {tree: [its libraries]}),
    instruction by instruction, and the kernels one tree alone builds
    (``tools/xent_steps.py::compare_all_sass``); None without cuobjdump."""
    from visualbert_torch.tools.xent_steps import compare_all_sass

    texts = sass_texts(paths)
    if texts is None:
        print(f"sass: no cuobjdump, not compared  [{card}]", flush=True)
        return None
    return compare_all_sass(texts, card, taken=())


# the instantiations of K1/K2 and K4-K6 that earlier trees may not have
# (fp16, head dim 128): tools/xent_steps.py skips them
OTHER_FORMS = ("6__half", "Li128E")


SMALL_FORMS = (("bfloat16", 16), ("float16", 16), ("bfloat16", 32), ("float16", 32))
# the backwards with small-row forms: (their library's source, None for the
# packed source; their info entry point)
SMALL_PAIRS = {"K2": (None, "vb_attn_packed_x_info"), "K12": ("flash_attention.cu", "vb_attn_hm_x_info"),
               "K14": ("flash_attention_sp.cu", "vb_attn_sp_x_info")}


def small_head_inputs(dtype, D, H, rate, seed):
    """K2's inputs at the main path's B and T in ``dtype`` at head dim D
    (f32_inputs's key bias), with the plain forward's out and stats and the
    plain backward: (qkv, qb, key_bias, dout, out, stats, (dqkv, dqb))."""
    import torch

    from visualbert_torch.ops import flash_attention as fa

    qkv, qb, key_bias, dout = f32_inputs(D, H=H)["packed"]
    dt = getattr(torch, dtype)
    qkv, qb, dout = qkv.to(dt), qb.to(dt), dout.to(dt)
    out, stats = fa.packed_attention_fwd_reference(qkv, qb, key_bias, H, rate, seed)
    want = fa.packed_attention_bwd_reference(qkv, qb, key_bias, dout, out, stats, H, rate, seed)
    return qkv, qb, key_bias, dout, out, stats, want


def small_pair_inputs(pair, dtype, D, H, rate, seed):
    """The backward ``pair``'s inputs on small_head_inputs's numbers (K12:
    the biased q, k, v heads-major; K14: the biased packed qkv with the
    plain forward's probabilities in K13's row layout), the plain forward's
    outputs among them, and the plain backward's outputs: (inputs, want)."""
    from visualbert_torch.ops import flash_attention as fa

    qkv, qb, key_bias, dout, out, stats, want = small_head_inputs(dtype, D, H, rate, seed)
    if pair == "K2":
        return dict(qkv=qkv, qb=qb, key_bias=key_bias, dout=dout, out=out, stats=stats), want
    B, T, _ = qkv.shape
    x = (qkv + qb).contiguous()
    if pair == "K12":
        x5 = x.view(B, T, H, 3, D).permute(0, 3, 2, 1, 4).contiguous()
        d4 = dout.view(B, T, H, D).permute(0, 2, 1, 3).contiguous()
        o4, st = fa.heads_major_attention_fwd_reference(x5, key_bias, rate, seed)
        want = (fa.heads_major_attention_bwd_reference(x5, key_bias, d4, o4, st, rate, seed),)
        return dict(qkv=x5, key_bias=key_bias, dout=d4, out=o4, stats=st), want
    o, probs = fa.packed_attention_sp_fwd_reference(x, key_bias, H, rate, seed)
    want = (fa.packed_attention_sp_bwd_reference(x, probs, dout, o, H, rate, seed),)
    return dict(qkv=x, key_bias=key_bias, dout=dout, out=o, probs=fa.padded_probs(probs)), want


def small_pair_call(pair, lib, d, H, rate, seed, D, dp, hg):
    """The backward ``pair`` from ``lib`` at head dim dp on small_pair_inputs's
    ``d`` (zero-padded to dp and the gradients cut back, as the wrappers do):
    (CUDA code, (dqkv,) or for K2 (dqkv, dqb))."""
    import math

    from visualbert_torch.ops import flash_attention as fa

    scale = 1.0 / math.sqrt(D)
    if pair == "K2":
        c, dq, db = fa.launch_packed_x_bwd(lib, fa.pad_heads(d["qkv"], H, 3, dp), fa.pad_heads(d["qb"], H, 3, dp),
                                           d["key_bias"], fa.pad_heads(d["dout"], H, 1, dp),
                                           fa.pad_heads(d["out"], H, 1, dp), d["stats"], H, rate, seed, *hg, scale)
        return c, (fa.unpad_heads(dq, H, 3, D), fa.unpad_heads(db, H, 3, D))
    if pair == "K12":
        c, dq = fa.launch_hm_x_bwd(lib, fa.pad_heads_major(d["qkv"], dp), d["key_bias"],
                                   fa.pad_heads_major(d["dout"], dp), fa.pad_heads_major(d["out"], dp), d["stats"],
                                   rate, seed, *hg, scale)
        return c, (fa.unpad_heads_major(dq, D),)
    probs = d["probs"]
    c, dq = fa.launch_sp_x_bwd(lib, fa.pad_heads(d["qkv"], H, 3, dp), probs, probs.stride(2),
                               fa.pad_heads(d["dout"], H, 1, dp), fa.pad_heads(d["out"], H, 1, dp), H, rate, seed,
                               *hg, scale)
    return c, (fa.unpad_heads(dq, H, 3, D),)


def small_pair_errors(pair, got, want):
    """{output: error} and whether all are within their limits: dqkv (and
    K2's dqb) by max |kernel - plain| / max |plain|, at attn_steps's limits
    for K2, chip_smoke.py's for K12 and K14."""
    from visualbert_torch.tools import attn_steps

    e = dict(dqkv=attn_steps._rel(got[0], want[0]))
    if pair == "K2":
        e["dqb"] = attn_steps._rel(got[1], want[1])
        return e, e["dqkv"] <= attn_steps.DQKV_TOL and e["dqb"] <= attn_steps.DB_TOL
    return e, e["dqkv"] <= (HM_DQKV_TOL if pair == "K12" else SP_DQKV_TOL)


def small_forms_ab(libs, others, n_sm, card, rate=0.1):
    """K2, K12 and K14 (SMALL_PAIRS) in SMALL_FORMS at the main path's B, T
    and 12 heads, dropout ``rate``, on the plain forward's outputs: this
    tree's form at the head dim (unpadded) and the other tree's route (heads
    zero-padded to 64, its D = 64 form, the gradients cut back, pads and
    cuts in its time), each against the plain backward (small_pair_errors's
    limits), then timed in turns (tools/attn_exp.py's best of 3 runs of 30
    calls, F32_ROUNDS rounds): {"<pair> <dtype> D=<D>": {tree: dict(errors,
    hg, ms)}}."""
    import torch

    from visualbert_torch.ops import flash_attention as fa
    from visualbert_torch.tools import attn_steps
    from visualbert_torch.tools.attn_exp import best_ms

    H, seed, res = attn_steps.H, attn_steps.SEED, {}
    for pair, (src, info) in SMALL_PAIRS.items():
        for dtype, D in SMALL_FORMS:
            d, want = small_pair_inputs(pair, dtype, D, H, rate, seed)
            B, T = d["key_bias"].shape
            code = 0 if dtype == "bfloat16" else 1
            calls, form = {}, f"{pair} {dtype} D={D}"
            for name in ("this", "other"):
                lib = libs[name][0] if src is None else others[name][src][0]
                dp = D if name == "this" else 64
                hg = [fa.head_group(B, H, n_sm, getattr(lib, info)(code, dp, k, 3, T)) for k in (1, 2)]

                def call(lib=lib, dp=dp, hg=hg, name=name):
                    c, got = small_pair_call(pair, lib, d, H, rate, seed, D, dp, hg)
                    if c != 0:
                        raise RuntimeError(f"{name} {form}: CUDA error {c}")
                    return got

                got = call()
                torch.cuda.synchronize()
                e, ok = small_pair_errors(pair, got, want)
                print(f"{name} {form} (head dim {dp}, hg {hg}): " + ", ".join(f"{k} {v:.3e}" for k, v in e.items())
                      + f"  [{card}]", flush=True)
                if not ok:
                    raise SystemExit(f"attn_ab: {name}'s {form} disagrees with the plain version")
                calls[name] = call
                res.setdefault(form, {})[name] = dict(errors=e, hg=hg, ms=[])
                del got
            for r in range(F32_ROUNDS):
                for name in (list(calls) if r % 2 == 0 else list(calls)[::-1]):
                    res[form][name]["ms"].append(best_ms(lambda i, c=calls[name]: c()))
            a, b = res[form]["this"]["ms"], res[form]["other"]["ms"]
            print(f"{form}, dropout {rate}: {min(a):.4f}-{max(a):.4f} ms here (unpadded), {min(b):.4f}-{max(b):.4f} "
                  f"ms in the other tree (padded to 64, pads and cuts included): {min(b) / min(a):.2f}x  [{card}]",
                  flush=True)
            del d, want, calls
            torch.cuda.empty_cache()
    return res


# the forwards with small-row forms since this tree: (their library's
# source, None for the packed source; their info entry point)
SMALL_FWD_PAIRS = {"K1": (None, "vb_attn_packed_x_info"), "K11": ("flash_attention.cu", "vb_attn_hm_x_info")}


def small_fwd_call(pair, lib, d, H, rate, seed, D, dp, hg):
    """The forward ``pair`` from ``lib`` at head dim dp on small_pair_inputs's
    ``d`` (zero-padded to dp and the output cut back, as the wrappers do):
    (CUDA code, out, stats)."""
    import math

    from visualbert_torch.ops import flash_attention as fa

    scale = 1.0 / math.sqrt(D)
    if pair == "K1":
        c, out, stats = fa.launch_packed_x_fwd(lib, fa.pad_heads(d["qkv"], H, 3, dp), fa.pad_heads(d["qb"], H, 3, dp),
                                               d["key_bias"], H, rate, seed, hg, scale)
        return c, fa.unpad_heads(out, H, 1, D), stats
    c, out, stats = fa.launch_hm_x_fwd(lib, fa.pad_heads_major(d["qkv"], dp), d["key_bias"], rate, seed, hg, scale)
    return c, fa.unpad_heads_major(out, D), stats


def small_forwards_ab(libs, others, n_sm, card, rate=0.1):
    """K1 and K11 (SMALL_FWD_PAIRS) in SMALL_FORMS at the main path's B, T
    and 12 heads, dropout ``rate``: this tree's form at the head dim
    (unpadded) and the other tree's route (heads zero-padded to 64, its D =
    64 form, the output cut back, pads and cuts in its time), each against
    the plain forward (attn_steps's OUT_TOL and STATS_TOL), then timed in
    turns (tools/attn_exp.py's best of 3 runs of 30 calls, F32_ROUNDS
    rounds) beside scaled_dot_product_attention on the same biased q, k, v
    in the same dtype: {"<pair> <dtype> D=<D>": {tree: dict(errors, hg, ms),
    "sdpa_ms": [...]}}."""
    import torch

    from visualbert_torch.ops import flash_attention as fa
    from visualbert_torch.tools import attn_steps
    from visualbert_torch.tools.attn_exp import best_ms

    H, seed, res = attn_steps.H, attn_steps.SEED, {}
    for pair, (src, info) in SMALL_FWD_PAIRS.items():
        for dtype, D in SMALL_FORMS:
            d, _ = small_pair_inputs("K2" if pair == "K1" else "K12", dtype, D, H, rate, seed)
            B, T = d["key_bias"].shape
            want = (d["out"], d["stats"])  # the plain forward's
            q, k, v = fa._split_heads(d["qkv"] + d["qb"], H) if pair == "K1" else d["qkv"].unbind(1)
            q, k, v = (t.contiguous() for t in (q, k, v))
            mask = d["key_bias"].to(q.dtype)[:, None, None, :]
            code = 0 if dtype == "bfloat16" else 1
            calls, form = {}, f"{pair} {dtype} D={D}"
            for name in ("this", "other"):
                lib = libs[name][0] if src is None else others[name][src][0]
                dp = D if name == "this" else 64
                hg = fa.head_group(B, H, n_sm, getattr(lib, info)(code, dp, 0, 3, T))

                def call(lib=lib, dp=dp, hg=hg, name=name):
                    c, out, stats = small_fwd_call(pair, lib, d, H, rate, seed, D, dp, hg)
                    if c != 0:
                        raise RuntimeError(f"{name} {form}: CUDA error {c}")
                    return out, stats

                out, stats = call()
                torch.cuda.synchronize()
                e = dict(out=attn_steps._rel(out, want[0]), stats=float((stats - want[1]).abs().max()))
                print(f"{name} {form} (head dim {dp}, hg {hg}): out {e['out']:.3e} (tol {attn_steps.OUT_TOL}), "
                      f"stats {e['stats']:.3e} (tol {attn_steps.STATS_TOL})  [{card}]", flush=True)
                if not (e["out"] <= attn_steps.OUT_TOL and e["stats"] <= attn_steps.STATS_TOL):
                    raise SystemExit(f"attn_ab: {name}'s {form} disagrees with the plain version")
                calls[name] = call
                res.setdefault(form, {})[name] = dict(errors=e, hg=hg, ms=[])
                del out, stats
            res[form]["sdpa_ms"] = []
            sdpa = torch.nn.functional.scaled_dot_product_attention
            calls["sdpa"] = lambda: sdpa(q, k, v, attn_mask=mask, dropout_p=rate)
            with torch.no_grad():
                for r in range(F32_ROUNDS):
                    for name in (list(calls) if r % 2 == 0 else list(calls)[::-1]):
                        ms = best_ms(lambda i, c=calls[name]: c())
                        (res[form]["sdpa_ms"] if name == "sdpa" else res[form][name]["ms"]).append(ms)
            a, b, c = res[form]["this"]["ms"], res[form]["other"]["ms"], res[form]["sdpa_ms"]
            print(f"{form}, dropout {rate}: {min(a):.4f}-{max(a):.4f} ms here (unpadded), {min(b):.4f}-{max(b):.4f} "
                  f"ms in the other tree (padded to 64, pads and cuts included): {min(b) / min(a):.2f}x; SDPA "
                  f"{min(c):.4f}-{max(c):.4f} ms: {min(a) / min(c):.2f}x SDPA's  [{card}]", flush=True)
            del d, want, calls, q, k, v
            torch.cuda.empty_cache()
    return res


# K2 at head dim 128: (B, T) at 12 heads, the main path's and a T that
# passes which hold a head's rows still take (256 at most)
STREAMED_SHAPES = ((128, 228), (8, 256))


class BiasRows:
    """A packed build for ``launch_packed_x_bwd`` at head dim 128: its own
    ``vb_attn_packed_x_bias_rows`` where it has one; a build from before the
    streamed passes (it has none) writes one row of bias partials a batch
    row."""

    def __init__(self, lib):
        self.lib = lib

    def __getattr__(self, name):
        return getattr(self.lib, name)

    def vb_attn_packed_x_bias_rows(self, dh, T):
        fn = getattr(self.lib, "vb_attn_packed_x_bias_rows", None)
        return 1 if fn is None else fn(dh, T)


def streamed_ab(libs, n_sm, card, rate=0.1):
    """K2 at head dim 128 in bf16 and fp16 at STREAMED_SHAPES, dropout
    ``rate``, from each tree's packed build (head groups from its own
    occupancy query; this tree's streamed passes take none), on the plain
    forward's outputs: dqkv and dqb against the plain backward within
    ``attn_steps``'s limits, then the trees timed in turns (best of 3 runs
    of 30 calls, F32_ROUNDS rounds): {"<dtype> B=<B> T=<T>": {tree:
    dict(errors, ms)}}."""
    import math

    import torch

    from visualbert_torch.ops import flash_attention as fa
    from visualbert_torch.tools import attn_steps
    from visualbert_torch.tools.attn_exp import best_ms

    H, seed, res = attn_steps.H, attn_steps.SEED, {}
    for dtype in ("bfloat16", "float16"):
        code, dt = (0 if dtype == "bfloat16" else 1), getattr(torch, dtype)
        for B, T in STREAMED_SHAPES:
            qkv, qb, key_bias, dout = f32_inputs(128, B, T, H)["packed"]
            qkv, qb, dout = qkv.to(dt), qb.to(dt), dout.to(dt)
            out, stats = fa.packed_attention_fwd_reference(qkv, qb, key_bias, H, rate, seed)
            want = fa.packed_attention_bwd_reference(qkv, qb, key_bias, dout, out, stats, H, rate, seed)
            form, calls = f"{dtype} B={B} T={T}", {}
            for name, (lib, _) in libs.items():
                build = BiasRows(lib)
                hg = [fa.head_group(B, H, n_sm, max(1, lib.vb_attn_packed_x_info(code, 128, k, 3, T))) for k in (1, 2)]

                def call(build=build, hg=hg, name=name):
                    c, dq, db = fa.launch_packed_x_bwd(build, qkv, qb, key_bias, dout, out, stats, H, rate, seed, *hg,
                                                       1.0 / math.sqrt(128))
                    if c != 0:
                        raise RuntimeError(f"{name} K2 {form}: CUDA error {c}")
                    return dq, db

                got = call()
                torch.cuda.synchronize()
                e = dict(dqkv=attn_steps._rel(got[0], want[0]), dqb=attn_steps._rel(got[1], want[1]))
                print(f"{name} K2 {form} at head dim 128 (hg {hg}): dqkv {e['dqkv']:.3e}, dqb {e['dqb']:.3e}  "
                      f"[{card}]", flush=True)
                if not (e["dqkv"] <= attn_steps.DQKV_TOL and e["dqb"] <= attn_steps.DB_TOL):
                    raise SystemExit(f"attn_ab: {name}'s K2 {form} at head dim 128 disagrees with the plain version")
                calls[name] = call
                res.setdefault(form, {})[name] = dict(errors=e, ms=[])
            for r in range(F32_ROUNDS):
                for name in (list(calls) if r % 2 == 0 else list(calls)[::-1]):
                    res[form][name]["ms"].append(best_ms(lambda i, c=calls[name]: c()))
            a, b = res[form]["this"]["ms"], res[form]["other"]["ms"]
            print(f"K2 {form} at head dim 128, dropout {rate}: {min(a):.4f}-{max(a):.4f} ms here, {min(b):.4f}-"
                  f"{max(b):.4f} ms in the other tree: {min(b) / min(a):.2f}x  [{card}]", flush=True)
            del qkv, qb, key_bias, dout, out, stats, want, calls
            torch.cuda.empty_cache()
    return res


class HmBuild:
    """K11/K12's three kernels (bf16, D = 64) from one library, called as
    their wrapper calls them, with the head groups of this build's own
    occupancy; the interface of tools/attn_steps.py's builds."""

    def __init__(self, name, lib, B, T, n_sm):
        from visualbert_torch.ops import flash_attention as fa
        from visualbert_torch.tools.attn_steps import H

        self.name, self.lib = name, lib
        info = [[lib.vb_attn_hm_info(k, w, T) for w in range(4)] for k in range(3)]
        if min(i[3] for i in info) < 1:
            raise RuntimeError(f"{name}: a kernel fits no block an SM at T={T}")
        self.hg = [fa.head_group(B, H, n_sm, i[3]) for i in info]
        self.info = info

    def _check(self, code, what):
        if code != 0:
            raise RuntimeError(f"{self.name} {what}: CUDA error {code}")

    def fwd(self, qkv5, key_bias, rate, seed):
        from visualbert_torch.ops.flash_attention import launch_hm_fwd

        code, out, stats = launch_hm_fwd(self.lib, qkv5, key_bias, rate, seed, self.hg[0])
        self._check(code, "K11")
        return out, stats

    def bwd(self, qkv5, key_bias, dout4, out, stats, rate, seed):
        from visualbert_torch.ops.flash_attention import launch_hm_bwd

        code, dqkv = launch_hm_bwd(self.lib, qkv5, key_bias, dout4, out, stats, rate, seed, *self.hg[1:])
        self._check(code, "K12")
        return dqkv

    def calls(self, data, rate):
        from visualbert_torch.tools.attn_steps import SEED

        qkv5, key_bias, dout4 = data
        out, stats = self.fwd(qkv5, key_bias, rate, SEED)
        return (lambda: self.fwd(qkv5, key_bias, rate, SEED),
                lambda: self.bwd(qkv5, key_bias, dout4, out, stats, rate, SEED))


def variant_ab(others, data, n_sm, card):
    """K11/K12 and K13/K14 of both trees on the main path's biased q, k, v:
    against the plain versions (chip_smoke.py's limits), the trees bit for
    bit at dropout 0 and 0.1, then timed in turns. Returns {pair: dict(errors,
    same, times, builds)}."""
    import torch

    from visualbert_torch.ops import flash_attention as fa
    from visualbert_torch.tools import attn_steps

    H, SEED = attn_steps.H, attn_steps.SEED
    qkv, qb, key_bias, dout = data
    B, T, F = qkv.shape
    D = F // (3 * H)
    biased = (qkv + qb).contiguous()
    hm_data = (biased.view(B, T, H, 3, D).permute(0, 3, 2, 1, 4).contiguous(), key_bias,
               dout.view(B, T, H, D).permute(0, 2, 1, 3).contiguous())
    res = {}
    for pair, cls, src, pdata in (("K11/K12", HmBuild, "flash_attention.cu", hm_data),
                                  ("K13/K14", attn_steps.SpBuild, "flash_attention_sp.cu", (biased, key_bias, dout))):
        builds = [cls(name, others[name][src][0], B, T, n_sm) for name in ("this", "other")]
        for b in builds:
            print(f"{b.name} {pair}: hg {b.hg}; registers, local bytes, shared bytes, blocks an SM of the forward, "
                  f"dQ pass, dK/dV pass: {b.info}  [{card}]", flush=True)
        same = {}
        if pair == "K13/K14":
            errors = attn_steps.check_sp(builds, pdata, card)
            same = {k: v["same_as_built"] for k, v in errors["other"].items()}
        else:
            qkv5, kb, dout4 = pdata
            errors = {}
            for rate in (0.0, 0.1):
                out_r, stats_r = fa.heads_major_attention_fwd_reference(qkv5, kb, rate, SEED)
                dq_r = fa.heads_major_attention_bwd_reference(qkv5, kb, dout4, out_r, stats_r, rate, SEED)
                got = []
                for b in builds:
                    out, stats = b.fwd(qkv5, kb, rate, SEED)
                    dq = b.bwd(qkv5, kb, dout4, out_r, stats_r, rate, SEED)
                    torch.cuda.synchronize()
                    e = dict(out=attn_steps._rel(out, out_r), stats=float((stats - stats_r).abs().max()),
                             dqkv=attn_steps._rel(dq, dq_r))
                    errors.setdefault(b.name, {})[f"rate {rate}"] = e
                    print(f"{b.name} K11/K12 rate {rate}: out {e['out']:.3e} (tol {HM_OUT_TOL}), stats "
                          f"{e['stats']:.3e} (tol {attn_steps.STATS_TOL}), dqkv {e['dqkv']:.3e} (tol {HM_DQKV_TOL})  "
                          f"[{card}]", flush=True)
                    if not (e["out"] <= HM_OUT_TOL and e["stats"] <= attn_steps.STATS_TOL and e["dqkv"] <= HM_DQKV_TOL):
                        raise SystemExit(f"attn_ab: {b.name} K11/K12 disagree with the plain versions at rate {rate}")
                    got.append((out, stats, dq))
                same[f"rate {rate}"] = all(torch.equal(x, y) for x, y in zip(*got))
                del out_r, stats_r, dq_r, got
        print(f"{pair}: the two trees' outputs bit for bit: {same}  [{card}]", flush=True)
        if not all(same.values()):
            raise SystemExit(f"attn_ab: the two trees' {pair} differ in their outputs")
        times = attn_steps.time_builds(builds, pdata)
        attn_steps.print_times(builds, times, card, pair)
        res[pair] = dict(errors=errors, same=same, times=times, builds={b.name: dict(hg=b.hg, info=b.info)
                                                                          for b in builds})
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


F32_SOURCE = SOURCE.parent / "flash_attention_f32.cu"
F32_FNS = ("vb_attn_f32_fwd", "vb_attn_f32_bwd", "vb_attn_f32_hm_fwd", "vb_attn_f32_hm_bwd", "vb_attn_f32_sp_fwd",
           "vb_attn_f32_sp_bwd", "vb_attn_f32_info", "vb_attn_f32_sp_info")
F32_DIMS = (16, 64, 128)  # head dims the fp32 kernels are compared at
F32_REL_TOL, F32_ABS_TOL = 1e-4, 1e-4  # chip_smoke.py's fp32 limits (out, dqkv, bias gradient; stats)
F32_ROUNDS = 2
F32_PAIRS = ("K1/K2", "K11/K12", "K13/K14")
# K1/K11's fp32 forward, one instantiation a padded head dim, printed apart
F32_SASS = {f"K1/K11 fp32 forward at DP {dp}": f"attn_f32_tiled_fwd_kernelILi{dp}E" for dp in (16, 64, 128)}


def build_f32(trees):
    """Each tree's ``flash_attention_f32.cu`` built alone ({name: root}),
    one nvcc a tree, all at once: {name: (CDLL, path)}."""
    nvcc = _build.find_nvcc()
    out = _build.BUILD_ROOT / "ab_f32"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    paths = {name: out / f"{re.sub(r'[^A-Za-z0-9_]', '_', name)}_f32.so" for name in trees}
    cmds = [[nvcc, *_build.ARCH_FLAGS, *_build.NVCC_FLAGS, "-I",
             str(root / SOURCE.parent), "-shared", str(root / F32_SOURCE), "-o", str(paths[name])]
            for name, root in trees.items()]
    for cmd, rc, text in _build._run_all(cmds):
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{text}")
    return {name: (bind(path, F32_FNS), path) for name, path in paths.items()}


class WholePairs:
    """A build of ``flash_attention_f32.cu`` from before its backward was
    tiled (it has no ``vb_attn_f32_geometry``), for ``launch_f32_bwd``: its
    blocks own whole (batch row, head) pairs and write one row of bias
    partials a batch row, a tile longer than any T."""

    def __init__(self, lib):
        self.lib = lib

    def __getattr__(self, name):
        return getattr(self.lib, name)

    def vb_attn_f32_geometry(self, which):
        return 1 << 30 if which == 0 else -1


def f32_inputs(D, B=None, T=None, H=12):
    """fp32 inputs at head dim D (main_path's B and T and its padded keys
    unless given), from RandomState(0): {"packed": (qkv, qb, key_bias,
    dout), "heads_major": (qkv5 with the bias, key_bias, dout4), "sp": (the
    biased packed qkv, key_bias, dout), "H": H}."""
    import numpy as np
    import torch

    from visualbert_torch.tools import main_path

    B = main_path.B if B is None else B
    T = main_path.TT + main_path.TV if T is None else T
    dev, F = torch.device("cuda"), 3 * H * D
    rng = np.random.RandomState(0)
    qkv = torch.tensor(rng.randn(B, T, F), dtype=torch.float32, device=dev)
    qb = torch.tensor(rng.randn(F) * 0.1, dtype=torch.float32, device=dev)
    mask = np.ones((B, T), np.float32)
    mask[::3, max(0, min(main_path.TT, T) - 20):min(main_path.TT, T)] = 0
    mask[1::4, max(1, T - 30):] = 0
    key_bias = torch.tensor((1.0 - mask) * -10000.0, device=dev)
    dout = torch.tensor(rng.randn(B, T, H * D), dtype=torch.float32, device=dev)
    biased = (qkv + qb).contiguous()
    hm = (biased.view(B, T, H, 3, D).permute(0, 3, 2, 1, 4).contiguous(), key_bias,
          dout.view(B, T, H, D).permute(0, 2, 1, 3).contiguous())
    return {"packed": (qkv, qb, key_bias, dout), "heads_major": hm, "sp": (biased, key_bias, dout), "H": H}


class F32Build:
    """One build of ``flash_attention_f32.cu`` called through this
    checkout's ``launch_f32_*``: each pair's forward and backward."""

    def __init__(self, name, lib):
        self.name = name
        self.lib = lib if hasattr(lib, "vb_attn_f32_geometry") else WholePairs(lib)

    def _check(self, code, what):
        if code != 0:
            raise RuntimeError(f"{self.name} {what}: CUDA error {code}")

    def info(self, D):
        """{pair: [[registers, local bytes, shared bytes, blocks an SM] of
        the forward, dQ pass, dK/dV pass]} at head dim D."""
        f32 = [[self.lib.vb_attn_f32_info(k, w, D) for w in range(4)] for k in range(3)]
        sp = [[self.lib.vb_attn_f32_sp_info(k, w, D) for w in range(4)] for k in range(3)]
        return {"K1/K2": f32, "K11/K12": f32, "K13/K14": sp}

    def fwd(self, pair, data, rate, seed):
        from visualbert_torch.ops import flash_attention as fa

        if pair == "K1/K2":
            qkv, qb, key_bias, _ = data["packed"]
            code, *res = fa.launch_f32_fwd(self.lib, qkv, qb, key_bias, data["H"], rate, seed)
        elif pair == "K11/K12":
            qkv5, key_bias, _ = data["heads_major"]
            code, *res = fa.launch_f32_hm_fwd(self.lib, qkv5, key_bias, rate, seed)
        else:
            x, key_bias, _ = data["sp"]
            code, *res = fa.launch_f32_sp_fwd(self.lib, x, key_bias, data["H"], rate, seed)
        self._check(code, pair + " forward")
        return tuple(res)

    def bwd(self, pair, data, fwd_out, rate, seed):
        """The backward on ``fwd_out`` (out and stats, or out and probs):
        (dqkv,) or, for K1/K2, (dqkv, dqb)."""
        from visualbert_torch.ops import flash_attention as fa

        out, second = fwd_out
        if pair == "K1/K2":
            qkv, qb, key_bias, dout = data["packed"]
            code, *res = fa.launch_f32_bwd(self.lib, qkv, qb, key_bias, dout, out, second, data["H"], rate, seed)
        elif pair == "K11/K12":
            qkv5, key_bias, dout4 = data["heads_major"]
            code, *res = fa.launch_f32_hm_bwd(self.lib, qkv5, key_bias, dout4, out, second, rate, seed)
        else:
            x, _, dout = data["sp"]
            code, *res = fa.launch_f32_sp_bwd(self.lib, x, second, second.stride(2), dout, out, data["H"], rate,
                                              seed)
        self._check(code, pair + " backward")
        return tuple(res)


def f32_reference(pair, data, rate, seed):
    """The plain versions of a pair: (forward outputs, backward outputs on
    them)."""
    from visualbert_torch.ops import flash_attention as fa

    H = data["H"]
    if pair == "K1/K2":
        qkv, qb, key_bias, dout = data["packed"]
        out, stats = fa.packed_attention_fwd_reference(qkv, qb, key_bias, H, rate, seed)
        return (out, stats), fa.packed_attention_bwd_reference(qkv, qb, key_bias, dout, out, stats, H, rate, seed)
    if pair == "K11/K12":
        qkv5, key_bias, dout4 = data["heads_major"]
        out, stats = fa.heads_major_attention_fwd_reference(qkv5, key_bias, rate, seed)
        return (out, stats), (fa.heads_major_attention_bwd_reference(qkv5, key_bias, dout4, out, stats, rate, seed),)
    x, key_bias, dout = data["sp"]
    out, probs = fa.packed_attention_sp_fwd_reference(x, key_bias, H, rate, seed)
    return (out, fa.padded_probs(probs)), (fa.packed_attention_sp_bwd_reference(x, probs, dout, out, H, rate, seed),)


def f32_errors(pair, got_fwd, got_bwd, ref_fwd, ref_bwd):
    """{output: error}: out, dqkv and dqb by max |kernel - plain| / max
    |plain|, stats absolute, K13's bf16 probabilities in bf16 ulps."""
    import torch

    from visualbert_torch.tools import attn_steps

    e = dict(out=attn_steps._rel(got_fwd[0], ref_fwd[0]))
    if pair == "K13/K14":
        d = (got_fwd[1].float() - ref_fwd[1].float()).abs()
        ulp = torch.ldexp(torch.ones_like(d), torch.frexp(ref_fwd[1].float().abs().clamp_min(1e-38))[1] - 8)
        e["probs_ulps"] = float((d / ulp).max())
    else:
        e["stats"] = float((got_fwd[1] - ref_fwd[1]).abs().max())
    e["dqkv"] = attn_steps._rel(got_bwd[0], ref_bwd[0])
    if len(ref_bwd) > 1:
        e["dqb"] = attn_steps._rel(got_bwd[1], ref_bwd[1])
    return e


def f32_within(e):
    return (all(e[k] <= F32_REL_TOL for k in ("out", "dqkv", "dqb") if k in e)
            and e.get("stats", 0.0) <= F32_ABS_TOL and e.get("probs_ulps", 0.0) <= 1.0)


MASK_RATE, MASK_SEED = 0.1, 11  # the dropout of mask_data's runs


def mask_data(dtype, D=64, B=3, T=64, H=2):
    """Inputs on the card whose outputs show the dropout mask, in
    f32_inputs's form: V and dO the identity on their first T <= D columns,
    zero biases, so that out[i, j] is the dropped p[i, j] and the dK/dV
    pass's dv[j, i] the same."""
    import numpy as np
    import torch

    dev = torch.device("cuda")
    x = torch.tensor(np.random.RandomState(5).randn(B, T, H, 3, D), dtype=dtype, device=dev)
    x[:, :, :, 2] = torch.eye(T, D, dtype=dtype, device=dev)[None, :, None]
    qkv = x.reshape(B, T, 3 * H * D).contiguous()
    key_bias = torch.zeros((B, T), device=dev)
    dout = torch.eye(T, D, dtype=dtype, device=dev)[None, :, None].expand(B, T, H, D).reshape(B, T, H * D).contiguous()
    return {"packed": (qkv, torch.zeros(3 * H * D, dtype=dtype, device=dev), key_bias, dout),
            "heads_major": (x.permute(0, 3, 2, 1, 4).contiguous(), key_bias,
                            dout.view(B, T, H, D).permute(0, 2, 1, 3).contiguous()),
            "sp": (qkv, key_bias, dout), "H": H}


def shows_the_plain_mask(pair, out, dqkv, data):
    """Whether a pair's out and dqkv on ``data`` (mask_data's, dropout
    MASK_RATE at MASK_SEED) are zero exactly where the plain mask drops."""
    import torch

    from visualbert_torch.ops import flash_attention as fa

    key_bias = data["sp"][1]
    (B, T), H = key_bias.shape, data["H"]
    if pair == "K11/K12":
        p_d, dv = out[..., :T], dqkv[:, 2, ..., :T].transpose(-1, -2)
    else:
        p_d = out.view(B, T, H, -1).permute(0, 2, 1, 3)[..., :T]
        dv = dqkv.view(B, T, H, 3, -1)[:, :, :, 2].permute(0, 2, 3, 1)[:, :, :T]
    keep = fa.attention_keep_reference(MASK_SEED, B, H, T, MASK_RATE, key_bias.device)
    return bool(torch.equal(p_d != 0, keep) and torch.equal(dv != 0, keep))


def f32_masks(builds, card):
    """Each build's dropout masks on mask_data at D = 64, T = 64, in every
    pair, against the plain (and the bf16 kernels') mask: {name: {pair:
    equal}}."""
    import torch

    data, res = mask_data(torch.float32), {}
    for b in builds:
        res[b.name] = {}
        for pair in F32_PAIRS:
            fo = b.fwd(pair, data, MASK_RATE, MASK_SEED)
            dq = b.bwd(pair, data, fo, MASK_RATE, MASK_SEED)[0]
            torch.cuda.synchronize()
            res[b.name][pair] = shows_the_plain_mask(pair, fo[0], dq, data)
        print(f"{b.name} fp32 keep masks equal to the plain (bf16 kernels') mask: {res[b.name]}  [{card}]", flush=True)
    return res


def f32_check(builds, D, data, card, seed=5):
    """Each build against the plain versions at dropout 0 and 0.1 (fp32
    limits; raises on a disagreement), and the two builds' largest
    difference (their sums run in other orders: not bit for bit)."""
    import torch

    from visualbert_torch.tools import attn_steps

    errs = {b.name: {} for b in builds}
    for pair in F32_PAIRS:
        for rate in (0.0, 0.1):
            ref_fwd, ref_bwd = f32_reference(pair, data, rate, seed)
            got = []
            for b in builds:
                fo = b.fwd(pair, data, rate, seed)
                bo = b.bwd(pair, data, ref_fwd, rate, seed)
                torch.cuda.synchronize()
                e = f32_errors(pair, fo, bo, ref_fwd, ref_bwd)
                errs[b.name][f"{pair} rate {rate}"] = e
                print(f"{b.name} fp32 {pair} D={D} rate {rate}: " + ", ".join(f"{k} {v:.3e}" for k, v in e.items())
                      + f" (limits {F32_REL_TOL} relative, stats {F32_ABS_TOL}, probabilities 1 ulp)  [{card}]",
                      flush=True)
                if not f32_within(e):
                    raise SystemExit(f"attn_ab: {b.name}'s fp32 {pair} at D={D} disagree with the plain versions")
                got.append((fo[0], bo[0]))
            if len(got) == 2:
                gap = max(attn_steps._rel(x, y) for x, y in zip(*got))
                print(f"fp32 {pair} D={D} rate {rate}: the two builds' out and dqkv differ by at most {gap:.3e} of "
                      f"the largest value  [{card}]", flush=True)
            del ref_fwd, ref_bwd, got
    return errs


def f32_times(builds, D, data, card, rate=0.1, seed=5):
    """Each pair's forward and backward (on its own forward's outputs) at
    dropout ``rate``, the builds in turns (reversed in every other round) for
    F32_ROUNDS rounds of tools/attn_exp.py's best of 3 runs of 30 calls,
    beside scaled_dot_product_attention in fp32 on the same biased q, k, v:
    {name: {"K1/K2 fwd": [ms a round], ...}, "sdpa": {...}}."""
    import torch

    from visualbert_torch.tools.attn_exp import best_ms

    times = {b.name: {} for b in builds}
    for r in range(F32_ROUNDS):
        for b in (builds if r % 2 == 0 else builds[::-1]):
            for pair in F32_PAIRS:
                fo = b.fwd(pair, data, rate, seed)
                times[b.name].setdefault(f"{pair} fwd", []).append(best_ms(lambda i: b.fwd(pair, data, rate, seed)))
                times[b.name].setdefault(f"{pair} bwd", []).append(
                    best_ms(lambda i: b.bwd(pair, data, fo, rate, seed)))
                del fo
    q5, key_bias, dout4 = data["heads_major"]
    q, k, v = (t.contiguous() for t in q5.unbind(1))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = key_bias[:, None, None, :]
    with torch.no_grad():
        fwd = best_ms(lambda i: sdpa(q, k, v, attn_mask=mask, dropout_p=rate))
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    o = sdpa(*leaves, attn_mask=mask, dropout_p=rate)
    bwd = best_ms(lambda i: torch.autograd.grad(o, leaves, dout4, retain_graph=True))
    times["sdpa"] = {"fwd": [fwd], "bwd": [bwd]}
    base = builds[0].name
    for b in builds:
        t = times[b.name]
        text = "; ".join(f"{k} {min(v):.4f}-{max(v):.4f} ms" + ("" if b.name == base else
                                                                f" ({min(v) / min(times[base][k]) - 1:+.1%})")
                         for k, v in t.items())
        print(f"{b.name} fp32 D={D}, dropout {rate}: {text}  [{card}]", flush=True)
    print(f"scaled_dot_product_attention fp32 D={D}, dropout {rate}: forward {fwd:.4f} ms, backward {bwd:.4f} ms  "
          f"[{card}]", flush=True)
    return times


def compare_f32_sass(libs, card):
    """Every fp32 kernel both builds have, instruction by instruction
    (``tools/xent_steps.py::compare_all_sass``), and K1/K11's forward
    (F32_SASS) in each; None without cuobjdump."""
    from visualbert_torch.tools.xent_steps import compare_all_sass

    texts = sass_texts({name: [path] for name, (_, path) in libs.items()})
    if texts is None:
        print(f"sass: no cuobjdump, not compared  [{card}]", flush=True)
        return None
    res = dict(all=compare_all_sass(texts, card, taken=()), k1={})
    sass = {name: sass_of(text, F32_SASS) for name, text in texts.items()}
    for k in F32_SASS:
        a, b = sass["this"].get(k, []), sass["other"].get(k, [])
        res["k1"][k] = dict(same=bool(a) and a == b, instructions=[len(a), len(b)])
        print(f"sass of the {k}: {len(a)} instructions here, {len(b)} in the other tree, the same: "
              f"{res['k1'][k]['same']}  [{card}]", flush=True)
    return res


def f32_ab(trees, card):
    """The fp32 kernels of each tree ({"this": root, "other": root}): built
    alone, registers, spills, shared bytes and blocks an SM, held against
    the plain versions and their masks, timed in turns beside SDPA at
    F32_DIMS; K1/K11's SASS compared between the trees. Returns the
    numbers."""
    import torch

    t0 = time.perf_counter()
    libs = build_f32(trees)
    print(f"attn_ab fp32: {', '.join(trees)} built in {time.perf_counter() - t0:.1f} s  [{card}]", flush=True)
    builds = [F32Build(name, lib) for name, (lib, _) in libs.items()]
    res = dict(masks=f32_masks(builds, card), dims={})
    for D in F32_DIMS:
        info = {b.name: b.info(D) for b in builds}
        for b in builds:
            for pair, kernels in info[b.name].items():
                print(f"{b.name} fp32 {pair} D={D}: registers, local bytes, shared bytes, blocks an SM of the "
                      f"forward, dQ pass, dK/dV pass: {kernels}  [{card}]", flush=True)
        data = f32_inputs(D)
        errors = f32_check(builds, D, data, card)
        times = f32_times(builds, D, data, card)
        res["dims"][D] = dict(info=info, errors=errors, times=times)
        del data
        torch.cuda.empty_cache()
    res["sass"] = compare_f32_sass(libs, card)
    if not all(all(v.values()) for v in res["masks"].values()):
        raise SystemExit("attn_ab: an fp32 build drops other positions than the plain mask")
    return res


# the parts of a run, in its order: K1/K2 at the main path's shapes, K11-K14
# (variant_ab), the backwards' small forms, the forwards' small forms,
# K2's streamed passes, K15/K16, the SASS, the fp32 kernels (f32_ab)
PARTS = ("k1k2", "variants", "small_forms", "small_forwards", "streamed", "exp", "sass", "f32")


def parse(argv):
    """(the other checkout, the parts to run) of attn_ab's arguments:
    OTHER_CHECKOUT [--only PART,PART,...]."""
    rest, parts = list(argv), PARTS
    while "--only" in rest:
        i = rest.index("--only")
        parts = tuple(rest[i + 1].split(",")) if i + 1 < len(rest) else ()
        del rest[i:i + 2]
    if len(rest) != 1 or not (Path(rest[0]) / SOURCE).exists():
        raise SystemExit(f"attn_ab: takes the root of another checkout that holds {SOURCE} (and --only with some "
                         f"of {','.join(PARTS)}), got {argv}")
    if not parts or not set(parts) <= set(PARTS):
        raise SystemExit(f"attn_ab: --only takes some of {','.join(PARTS)}, got {argv}")
    return rest[0], parts


def main(argv=None):
    import sys

    import torch

    from visualbert_torch.tools import attn_steps
    from visualbert_torch.tools.main_path import card_line, packed_attention_inputs

    other, parts = parse(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        raise SystemExit("attn_ab: no CUDA device; the kernels run only on the card")
    card = card_line()
    trees = {"this": _build.CSRC.parent.parent, "other": Path(other).resolve()}
    result = dict(card=card, other=str(other))
    if set(parts) - {"f32"}:
        dev = torch.device("cuda")
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        data = packed_attention_inputs(dev)
        B, T, _ = data[0].shape
        t0 = time.perf_counter()
        libs, exp_libs, others, sass_paths = build(trees)
        print(f"attn_ab: B={B} T={T} H={attn_steps.H}; the builds in {time.perf_counter() - t0:.1f} s  [{card}]",
              flush=True)
        result["shape"] = dict(B=B, T=T, H=attn_steps.H)
    if "k1k2" in parts:
        builds = [attn_steps.PackedBuild(name, lib, B, T, n_sm) for name, (lib, _) in libs.items()]
        for b in builds:
            print(f"{b.name}: hg {b.hg}; registers, local bytes, shared bytes, blocks an SM of the forward, dQ "
                  f"pass, dK/dV pass: {b.info}  [{card}]", flush=True)
        errors = attn_steps.check(builds, data, card)
        if not all(e["same_as_built"] for e in errors["other"].values()):
            raise SystemExit("attn_ab: the two trees' K1/K2 differ in their outputs")
        times = attn_steps.time_builds(builds, data)
        attn_steps.print_times(builds, times, card, "K1/K2")
        result.update(errors=errors, times=times, builds={b.name: dict(hg=b.hg, info=b.info) for b in builds})
    if "variants" in parts:
        result["variants"] = variant_ab(others, data, n_sm, card)
    if "small_forms" in parts:
        result["small_forms"] = small_forms_ab(libs, others, n_sm, card)
    if "small_forwards" in parts:
        result["small_forwards"] = small_forwards_ab(libs, others, n_sm, card)
    if "streamed" in parts:
        result["streamed"] = streamed_ab(libs, n_sm, card)
    if "exp" in parts:
        result["exp_times"] = exp_times(exp_libs, data, card)
    if "sass" in parts:
        result["sass"] = compare_sass(sass_paths, card)
    if "f32" in parts:
        result["f32"] = f32_ab(trees, card)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
