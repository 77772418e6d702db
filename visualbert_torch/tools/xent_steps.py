"""The steps of K4's and K5/K6's designs (``csrc/mlm_xent.cu::xent_fwd_kernel``
and ``::xent_bwd_kernel``), left out in turn and timed beside the kernels as
built, on one CUDA card:

    python -m visualbert_torch.tools.xent_steps [OTHER_CHECKOUT]

At the main path's shapes and inputs (``chip_smoke.py``'s: N = 128 x 24 =
3072 rows, V = 30522, H = 768, bf16, seeded), each build of
``csrc/mlm_xent.cu`` alone with the switches of BUILDS. K4's (FWD_BUILDS):

* "fwd sync loads": ``-DVB_XENT_FWD_SYNC_LOADS``, plain loads and stores in
  place of ``cp.async``: each thread waits for its copy of a tile before
  its products of the tile three back, so no copy runs under them (right
  results);
* "fwd split K": ``-DVB_XENT_FWD_SPLIT_K``, width 768 on the form width 1024
  takes: both warpgroups on the same 64 rows of x, each half of K, partial
  logits exchanged in shared memory (K5's split), so a block keeps 64 rows
  and reads E from L2 twice as often (right results);
* "fwd no stats": ``-DVB_XENT_FWD_NO_STATS``, the logits only;
* "fwd no logits": ``-DVB_XENT_FWD_NO_LOGITS``, the statistics of the bias
  alone, no ``wgmma``: the copies and the statistics.

K5/K6's:

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
``mlm_xent.cu`` alone, compares the machine code (SASS, ``cuobjdump``, as
``tools/attn_ab.py`` does) of the kernels whose source both trees share
(K5's and K6's, at both widths, K5's reduce pass and K4's merge pass)
instruction by instruction, and times that tree's K4 beside this one's in
the same rounds ("other K4"), launched as its wrapper launched it (its own
tiling from its ``vb_xent_geometry``, splits for four blocks an SM), and
that tree's K4 on this tree's plan ("other K4, this plan"), K5 and K6
("other K5", "other K6"); K4's SASS is compared at
both widths too, and both trees' K4-K6 are timed at width 1024 ("at
1024").

With ``--wide`` (``python -m visualbert_torch.tools.xent_steps --wide
[OTHER_CHECKOUT]``) the tool takes the wide form instead (``xent_wide_*``,
bf16 and fp16 above width 1024: K4 a 128 x 128 tile a block, K5/K6 a
thread-block cluster a row block and split): ``csrc/mlm_xent.cu`` built
alone and, given another checkout, that tree's source alone. At N = 3072,
V = 30522 and widths WIDE_WIDTHS (1088, 2048, 2560), in each dtype of
WIDE_DTYPES, this tree's K4, K5 and K6 are held to their plain versions
(chip_smoke.py's limits: nll and lse, the argmax where the top two logits
are apart, dx and dE; db to :func:`db_exact`'s; nll and lse also printed
against :func:`fwd_exact`'s) and must repeat bit for bit; the other tree's wide kernels (bf16 only where it has no fp16 wide
form), K5 and K6 on this tree's plan (``ops/mlm_xent.py::wide_dx_plan``:
the entry points take the splits) and K4 on its own (as its wrapper
planned it), are held likewise and printed. All are timed in turns with
cuBLAS's products in the same dtype (K4: ``x @ E^T``; K5, K6: that and
the second product); in bf16 at 2048 and 2560 this tree's K5 is also
timed on each vocabulary split count of WIDE_SPLITS ("wide K5 splits",
the support for ``ops/mlm_xent.py::WIDE_BLOCK_TILES``) and its K4 on the
splits that fill one to four waves ("wide K4 splits", the support for
``WIDE_FWD_BLOCK_TILES``), each printed with its busiest slot's tiles as
the plan models them and which one the plan takes. The SASS of every
kernel both trees build is compared, but the wide K4 (WIDE_TAKEN, the
kernel redesigned here): the forms up to 1024 in both dtypes, the merge
and reduce passes and the bf16 wide K5/K6 must match the other tree's.
Each tree's wide kernels are printed with registers, local bytes, shared
bytes, blocks an SM and (K5, K6) clusters at once. At WIDE_EXACT_WIDTHS
(4160, 6144, 8192) K4 alone is held to :func:`fwd_exact`'s nll and lse
(XENT_TOL), beside the plain version's own distance from them.

K4 as built is also timed on the splits that fill one to four waves of
one block an SM, at both widths ("K4 splits"), each printed with the
busiest SM's tiles as ``ops/mlm_xent.py::fwd_plan`` models them (a block's
tiles plus FWD_BLOCK_TILES, times its waves) and which one the plan takes.

A build with a step left out may give wrong results: the tool holds the
kernels as built against their plain versions first, and the builds marked
right above against the kernels as built. K4 (its kernel and the merge
pass), K5 (its kernel and the reduce pass) and K6 are timed with CUDA
events: ROUNDS rounds, each the best of 3 runs of 30 calls
(``tools/attn_exp.py::best_ms``), the builds in turn, in reverse in every
other round; K4 in the K4 builds, K5/K6 in theirs, all three as built. The
least and the largest round are printed, with each build's registers, local
bytes, shared bytes and blocks an SM. Every line carries the card's name and
power limit; the last line is the numbers as one JSON object. Runs only on
the card: without one it exits with an error.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil

from visualbert_torch.ops import _build

ROUNDS = 3
H = 768
DX_TOL, DE_TOL, DBIAS_TOL = 1.2e-2, 1.8e-2, 2e-6  # chip_smoke.py's limits for K5/K6
XENT_TOL = 3e-5  # chip_smoke.py's limit for K4's nll and lse (absolute)
FWD_BUILDS = {
    "fwd sync loads": ["-DVB_XENT_FWD_SYNC_LOADS"],
    "fwd split K": ["-DVB_XENT_FWD_SPLIT_K"],
    "fwd no stats": ["-DVB_XENT_FWD_NO_STATS"],
    "fwd no logits": ["-DVB_XENT_FWD_NO_LOGITS"],
}
EXACT_FWD_BUILDS = ("fwd sync loads", "fwd split K")  # right results: held against K4 as built
BWD_BUILDS = {
    "no copy": ["-DVB_XENT_NO_COPY"],
    "no logits": ["-DVB_XENT_NO_LOGITS"],
    "no product": ["-DVB_XENT_NO_PRODUCT"],
    "no logits, no product": ["-DVB_XENT_NO_LOGITS", "-DVB_XENT_NO_PRODUCT"],
    "no copy, no product": ["-DVB_XENT_NO_COPY", "-DVB_XENT_NO_PRODUCT"],
    "no copy, no logits, no product": ["-DVB_XENT_NO_COPY", "-DVB_XENT_NO_LOGITS", "-DVB_XENT_NO_PRODUCT"],
    "no copy, no logits, no product, no dlog": ["-DVB_XENT_NO_COPY", "-DVB_XENT_NO_LOGITS", "-DVB_XENT_NO_PRODUCT",
                                                "-DVB_XENT_NO_DLOG"],
}
BUILDS = {**FWD_BUILDS, **BWD_BUILDS}
FNS = ("vb_xent_geometry", "vb_xent_info", "vb_xent_fwd", "vb_xent_dx", "vb_xent_de", "vb_xent_wide_geometry",
       "vb_xent_wide_info", "vb_xent_wide_fwd", "vb_xent_wide_dx", "vb_xent_wide_de", "vb_xent_f16_wide_info",
       "vb_xent_f16_wide_fwd", "vb_xent_f16_wide_dx", "vb_xent_f16_wide_de", "vb_error_string")
WIDE_WIDTHS = (1088, 2048, 2560)
WIDE_DTYPES = ("bfloat16", "float16")
WIDE_SPLITS = (1, 2, 3, 4, 5, 6, 8, 10, 12, 16)  # the wide K5's vocabulary splits the sweep times
WIDE_TAKEN = ("xent_wide_fwd_kernel",)  # the kernels the --wide comparison expects to differ: part of each name
WIDE_EXACT_WIDTHS = (4160, 6144, 8192)  # K4 held to the exact products alone, untimed, at these too
SHARED_KERNELS = {  # the kernels of mlm_xent.cu that an earlier tree may share: part of each mangled name
    "K4, 768": "xent_fwd_kernelILi768E", "K4, 1024": "xent_fwd_kernelILi1024E",
    "K5, 768": "xent_bwd_kernelILi768ELb0E", "K6, 768": "xent_bwd_kernelILi768ELb1E",
    "K5, 1024": "xent_bwd_kernelILi1024ELb0E", "K6, 1024": "xent_bwd_kernelILi1024ELb1E",
    "K5 reduce, 768": "xent_dx_reduce_kernelILi768", "K5 reduce, 1024": "xent_dx_reduce_kernelILi1024",
    "K4 merge": "xent_fwd_merge_kernel",
}


def bind(path):
    """Load a build of csrc/mlm_xent.cu with the entry points of FNS it has
    typed."""
    lib = ctypes.CDLL(str(path))
    for fn in FNS:
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
            getattr(lib, fn).restype = _build.restype(fn)
    return lib


def build_all(builds=BUILDS, sources=None):
    """Compile csrc/mlm_xent.cu once for each of ``builds`` ({name: -D
    switches}; one nvcc each, all at once), from the directory
    ``sources[name]`` where given; returns ({name: CDLL}, seconds)."""
    import time

    nvcc = _build.find_nvcc()
    out = _build.BUILD_ROOT / "xent_steps"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    paths = {name: out / f"{name.replace(' ', '_').replace(',', '')}.so" for name in builds}
    src = {name: (sources or {}).get(name, _build.CSRC) for name in builds}
    t0 = time.perf_counter()
    results = _build._run_all([[nvcc, *_build.ARCH_FLAGS, *_build.NVCC_FLAGS, *defines, "-shared", "-I",
                                str(src[name]), str(src[name] / "mlm_xent.cu"), "-o", str(paths[name])]
                               for name, defines in builds.items()])
    seconds = time.perf_counter() - t0
    for cmd, rc, text in results:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{text}")
    return {name: bind(p) for name, p in paths.items()}, seconds


def sass_texts(other, card):
    """Build this tree's and ``other``'s mlm_xent.cu alone: ({"this": SASS,
    "other": SASS} as ``cuobjdump -sass`` prints them, or None without
    cuobjdump; the other tree's library)."""
    import subprocess
    from pathlib import Path

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = _build.BUILD_ROOT / "xent_steps"
    trees = {"this": _build.CSRC, "other": Path(other) / "visualbert_torch" / "csrc"}
    paths = {name: out / f"sass_{name}.so" for name in trees}
    for cmd, rc, text in _build._run_all([[_build.find_nvcc(), *_build.ARCH_FLAGS, *_build.NVCC_FLAGS, "-shared",
                                           "-I", str(src), str(src / "mlm_xent.cu"), "-o", str(paths[name])]
                                          for name, src in trees.items()]):
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{text}")
    if not Path(tool).exists():
        print(f"sass: no cuobjdump, not compared  [{card}]", flush=True)
        return None, bind(paths["other"])
    texts = {name: subprocess.run([tool, "-sass", str(p)], capture_output=True, text=True, check=True).stdout
             for name, p in paths.items()}
    return texts, bind(paths["other"])


def compare_sass(other, card, kernels=SHARED_KERNELS):
    """Build ``other``'s mlm_xent.cu alone and compare the SASS of
    ``kernels`` with this tree's; ({kernel: (same, instructions here,
    instructions there)}, or None without cuobjdump; the other tree's
    library)."""
    from visualbert_torch.tools.attn_ab import OTHER_FORMS, sass_of

    texts, other_lib = sass_texts(other, card)
    if texts is None:
        return None, other_lib
    sass = {name: sass_of(text, kernels, OTHER_FORMS) for name, text in texts.items()}
    res = {}
    for k in kernels:
        a, b = sass["this"].get(k, []), sass["other"].get(k, [])
        res[k] = (bool(a) and a == b, len(a), len(b))
        print(f"sass of {k}: {len(a)} instructions here, {len(b)} in {other}, the same: {res[k][0]}  [{card}]",
              flush=True)
    return res, other_lib


def anonymous(name):
    """A mangled name without its anonymous namespace's tag, which differs
    between builds of the same source at two paths."""
    return re.sub(r"_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}", "_GLOBAL__N_", name)


def sass_functions(text):
    """{function (:func:`anonymous` name): its instructions} of every function
    in ``cuobjdump -sass`` output, as ``tools/attn_ab.py::sass_of`` reads
    them (no addresses or encodings, branch labels renumbered in order of
    use)."""
    out, cur, labels = {}, None, {}

    def label(m):
        return f".L{labels.setdefault(m.group(0), len(labels))}"

    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur, labels = anonymous(m.group(1)), {}
            out[cur] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
        if m and cur is not None:
            out[cur].append(re.sub(r"\.L_x_\d+", label, m.group(1)))
    return out


def compare_all_sass(texts, card, taken=WIDE_TAKEN):
    """Every kernel both trees build, but those whose names hold a part of
    ``taken``, instruction by instruction: {"compared": {kernel: (same,
    instructions here, there)}, "only_here": [...], "only_there": [...]};
    one line a kernel and a summary."""
    here, there = sass_functions(texts["this"]), sass_functions(texts["other"])
    compared = {}
    for name in sorted(set(here) & set(there)):
        if any(part in name for part in taken):
            continue
        compared[name] = (here[name] == there[name], len(here[name]), len(there[name]))
        print(f"sass of {name}: {len(here[name])} instructions here, {len(there[name])} there, the same: "
              f"{compared[name][0]}  [{card}]", flush=True)
    only_here, only_there = sorted(set(here) - set(there)), sorted(set(there) - set(here))
    print(f"sass: {sum(c[0] for c in compared.values())} of the {len(compared)} kernels both trees build (but "
          f"{', '.join(taken)}) the same; only here: {only_here}; only there: {only_there}  [{card}]", flush=True)
    return dict(compared=compared, only_here=only_here, only_there=only_there)


def inputs(torch, device, width=H, dtype="bfloat16"):
    """chip_smoke.py's K4-K6 inputs at ``width`` in ``dtype``: x, embedding,
    bias, labels, g, and the plain lse."""
    import numpy as np

    from visualbert_torch.ops import mlm_xent as xe
    from visualbert_torch.tools.main_path import B, N_PRED

    N, V = B * N_PRED, 30522
    rng = np.random.RandomState(1)
    x = torch.tensor(rng.randn(N, width), dtype=torch.float32).to(getattr(torch, dtype)).to(device)
    emb = torch.tensor(rng.randn(V, width) * 0.05, dtype=torch.float32).to(getattr(torch, dtype)).to(device)
    bias = torch.tensor(rng.randn(V) * 0.1, dtype=torch.float32, device=device)
    labels = rng.randint(0, V, N)
    labels[rng.rand(N) < 0.15] = -1
    g = torch.tensor(np.where(labels >= 0, rng.uniform(0.5, 1.5, N), 0.0), dtype=torch.float32, device=device)
    lab = torch.tensor(np.maximum(labels, 0), dtype=torch.int32, device=device)
    _, lse, _ = xe.mlm_xent_fwd_reference(x, emb, bias, lab)
    return x, emb, bias, lab, lse, g


def db_exact(x, emb, bias, labels, lse, g):
    """K6's d bias [V] fp64 with the logits' products summed exactly (in
    fp64), on the fp32 lse the plain version is given: the wide forms' db
    is held to this, since the plain version's own fp32 sums of 2560
    products drift beyond chip_smoke.py's DBIAS_TOL (its db 3.4e-6 from
    this at 2560, the cluster kernel's 3.1e-7, on an NVIDIA H100 80GB HBM3
    at 700 W)."""
    import torch

    lg = torch.matmul(x.double(), emb.double().t()) + bias.double()
    p = torch.exp(lg - lse.double()[:, None])
    del lg
    p[torch.arange(p.shape[0], device=p.device), labels.long()] -= 1.0
    return (p * g.double()[:, None]).sum(0)


def fwd_exact(x, emb, bias, labels):
    """K4's (nll, lse) [N] fp64 with the logits' products summed exactly (in
    fp64): the wide K4's nll and lse are held to these, since the plain
    version's own fp32 sums of thousands of products drift beyond
    chip_smoke.py's XENT_TOL at 6144 and 8192 (``--wide`` prints both
    distances, WIDE_EXACT_WIDTHS)."""
    import torch

    lg = torch.matmul(x.double(), emb.double().t()) + bias.double()
    lse = torch.logsumexp(lg, dim=-1)
    return lse - lg.gather(1, labels.long()[:, None])[:, 0], lse


def check(code, what):
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def fwd_on(lib, data, S, per):
    """K4 from one library on S vocabulary splits of ``per`` tiles, its
    partials allocated here as its wrapper allocates them."""
    import torch

    x, emb, bias, lab = data[:4]
    (N, H_), V = x.shape, emb.shape[0]
    pf = torch.empty((4, S, N), dtype=torch.float32, device=x.device)
    pi = torch.empty((S, N), dtype=torch.int32, device=x.device)
    out = [torch.empty(N, dtype=dt, device=x.device) for dt in (torch.float32, torch.float32, torch.int32)]
    stream = _build.stream_ptr(x.device)

    def fwd(_):
        check(lib.vb_xent_fwd(x.data_ptr(), emb.data_ptr(), bias.data_ptr(), lab.data_ptr(), N, V, H_, S, per,
                              pf.data_ptr(), pi.data_ptr(), *(t.data_ptr() for t in out), stream), "K4")
        return out

    return fwd


def first_design_call(lib, data, sms):
    """K4 of a library launched as K4's first design's wrapper launched it:
    the library's own tiling, splits for about four blocks an SM."""
    from visualbert_torch.ops import mlm_xent as xe

    (N, H_), V = data[0].shape, data[1].shape[0]
    rows, tile = lib.vb_xent_geometry(1, H_), lib.vb_xent_geometry(3, H_)
    return fwd_on(lib, data, *xe.splits(-(-N // rows), -(-V // tile), sms))


def sweep_splits(N, V, rows, tile, sms, block_tiles=None):
    """The vocabulary splits of K4 at N rows and V vocabulary rows, for a
    tiling of ``rows`` x rows a block and ``tile`` vocabulary rows a tile,
    that fill one to four waves of one block an SM on ``sms`` SMs: a list of
    (splits, tiles a split, waves, the busiest SM's tiles as
    ops/mlm_xent.py::fwd_plan models them with ``block_tiles`` a block's
    fixed cost, FWD_BLOCK_TILES by default)."""
    from visualbert_torch.ops import mlm_xent as xe

    row_blocks, n_tiles = -(-N // rows), -(-V // tile)
    out = []
    for waves in range(1, 5):
        per = -(-n_tiles // max(1, waves * sms // row_blocks))
        S = -(-n_tiles // per)  # no split empty
        w = -(-row_blocks * S // sms)
        out.append((S, per, w, w * (per + (xe.FWD_BLOCK_TILES if block_tiles is None else block_tiles))))
    return out


def split_sweep(lib, data, sms):
    """K4 of a library on each of :func:`sweep_splits` at ``data``'s shape:
    ({name: launch}, {name: its sweep_splits entry})."""
    (N, H_), V = data[0].shape, data[1].shape[0]
    facts = {f"{H_}: {f[0]} splits": f
             for f in sweep_splits(N, V, lib.vb_xent_geometry(1, H_), lib.vb_xent_geometry(3, H_), sms)}
    return {name: fwd_on(lib, data, f[0], f[1]) for name, f in facts.items()}, facts


def fwd_call(lib, data, sms):
    """K4 from one library, launched as its wrapper launches it."""
    from visualbert_torch.ops import mlm_xent as xe

    def fwd(_):
        code, *out = xe.launch_fwd(lib, *data[:4], sms)
        check(code, "K4")
        return out

    return fwd


def calls(lib, data, sms):
    """K5 and K6 from one library, launched as their wrappers launch them."""
    from visualbert_torch.ops import mlm_xent as xe

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


def dist(a, b):
    """max |a - b| in fp64."""
    return float((a.double() - b.double()).abs().max())


def wide_sweep_splits(N, V, rows, tile, clusters):
    """The wide K5's vocabulary splits of WIDE_SPLITS and the plan's own at
    N rows and V vocabulary rows, for ``rows`` resident x rows a cluster and
    ``tile`` vocabulary rows a tile, with ``clusters`` clusters at once: a
    list of (splits, tiles a split, waves of clusters, the busiest cluster
    slot's tiles as ops/mlm_xent.py::wide_dx_plan models them), no split
    empty and no count twice."""
    from visualbert_torch.ops import mlm_xent as xe

    row_blocks, n_tiles = -(-N // rows), -(-V // tile)
    planned = xe.wide_dx_plan(N, V, 64, rows, tile, 64, clusters)["grid"][2]
    out = {}
    for want in sorted({*WIDE_SPLITS, planned}):
        per = -(-n_tiles // min(want, n_tiles))
        S = -(-n_tiles // per)
        w = -(-row_blocks * S // clusters)
        out[S] = (S, per, w, w * (per + xe.WIDE_BLOCK_TILES))
    return list(out.values())


def wide_fwd_on(lib, data, S, per):
    """The wide K4 of one build, in ``data``'s dtype, on S vocabulary splits
    of ``per`` tiles, its partials allocated here as its wrapper allocates
    them."""
    import torch

    from visualbert_torch.ops import mlm_xent as xe

    x, emb, bias, lab = data[:4]
    (N, H), V = x.shape, emb.shape[0]
    pf = torch.empty((4, S, N), dtype=torch.float32, device=x.device)
    pi = torch.empty((S, N), dtype=torch.int32, device=x.device)
    out = [torch.empty(N, dtype=dt, device=x.device) for dt in (torch.float32, torch.float32, torch.int32)]
    entry, stream = getattr(lib, xe._WIDE_ENTRY[x.dtype] + "fwd"), _build.stream_ptr(x.device)

    def k4(_):
        check(entry(x.data_ptr(), emb.data_ptr(), bias.data_ptr(), lab.data_ptr(), N, V, H, S, per, pf.data_ptr(),
                    pi.data_ptr(), *(t.data_ptr() for t in out), stream), "wide K4")
        return out

    return k4


def wide_calls(lib, data, S, per):
    """The wide K5 (on S vocabulary splits of ``per`` tiles) and K6 of one
    build of csrc/mlm_xent.cu on ``data``, in its dtype."""
    import torch

    from visualbert_torch.ops import mlm_xent as xe

    x, emb, bias, lab, lse, g = data
    (N, H), V = x.shape, emb.shape[0]
    part = torch.empty((S, N, H), dtype=torch.float32, device=x.device)
    dx, de = torch.empty_like(x), torch.empty_like(emb)
    db = torch.empty(V, dtype=torch.float32, device=x.device)
    stream = _build.stream_ptr(x.device)
    ptrs = (x.data_ptr(), emb.data_ptr(), bias.data_ptr(), lab.data_ptr(), lse.data_ptr(), g.data_ptr())
    prefix = xe._WIDE_ENTRY[x.dtype]

    def k5(_):
        check(getattr(lib, prefix + "dx")(*ptrs, N, V, H, S, per, part.data_ptr(), dx.data_ptr(), stream), "wide K5")
        return dx

    def k6(_):
        check(getattr(lib, prefix + "de")(*ptrs, N, V, H, de.data_ptr(), db.data_ptr(), stream), "wide K6")
        return de, db

    return k5, k6


def wide_main(other, card):
    """The ``--wide`` mode (see the module's note): prints one line a check
    and a timing; returns the numbers."""
    import torch

    from visualbert_torch.ops import mlm_xent as xe
    from visualbert_torch.tools.attn_exp import best_ms

    dev = torch.device("cuda")
    sms = xe.sm_count(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    builds, sources = {"this": []}, {}
    if other:
        from pathlib import Path

        builds["other"] = []
        sources["other"] = Path(other) / "visualbert_torch" / "csrc"
    libs, seconds = build_all(builds, sources)
    print(f"xent_steps --wide: {len(builds)} builds in {seconds:.1f} s  [{card}]", flush=True)
    sass = None
    if other:
        texts, _ = sass_texts(other, card)
        sass = compare_all_sass(texts, card) if texts is not None else None
    errors, info, times, splits = {}, {}, {}, {}
    this = libs["this"]
    for H in WIDE_WIDTHS:
        for dtype in WIDE_DTYPES:
            data = inputs(torch, dev, H, dtype)
            x, emb, bias, lab = data[:4]
            N, V = x.shape[0], emb.shape[0]
            rows, tile, cols = (this.vb_xent_wide_geometry(w) for w in (2, 4, 5))
            clusters = xe.wide_clusters(this, 0, H, x.dtype)
            plan = xe.wide_dx_plan(N, V, H, rows, tile, cols, clusters)
            nll_r, lse_r, am_r = xe.mlm_xent_fwd_reference(x, emb, bias, lab)
            top = torch.topk(xe._logits(x, emb, bias), 2, dim=-1).values
            clear = (top[:, 0] - top[:, 1]) > 1e-3
            del top
            dx_r = xe.mlm_xent_dx_reference(*data)
            de_r, db_r = xe.mlm_xent_de_reference(*data)
            db64 = db_exact(*data)
            nll64, lse64 = fwd_exact(x, emb, bias, lab)
            at = f"{dtype} at {H}"
            print(f"{at}: the plain version against the exact products: db {rel(db_r, db64):.3e}, nll "
                  f"{dist(nll_r, nll64):.3e}, lse {dist(lse_r, lse64):.3e}  [{card}]", flush=True)
            prefix = xe._WIDE_ENTRY[x.dtype]
            fns = {}
            for tree in (t for t in libs if hasattr(libs[t], prefix + "fwd")):
                lib = libs[tree]
                fwd = (xe._wide_fwd_plan_of(lib, N, V, H, sms) if tree == "this"  # the other as its wrapper planned
                       else xe.fwd_plan(N, V, H, lib.vb_xent_wide_geometry(1), lib.vb_xent_wide_geometry(3), sms))
                k4 = wide_fwd_on(lib, data, fwd["grid"][1], fwd["per"])
                k5, k6 = wide_calls(lib, data, plan["grid"][2], plan["per"])
                got = tuple(t.clone() for t in k4(0)) + (k5(0).clone(),) + tuple(t.clone() for t in k6(0))
                again = tuple(k4(0)) + (k5(0),) + k6(0)
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                nll, lse, am, dx, de, db = got
                bad = int(((am != am_r) & clear).sum())
                e = (float((nll - nll_r).abs().max()), float((lse - lse_r).abs().max()), rel(dx, dx_r),
                     rel(de, de_r), rel(db, db64), rel(db, db_r), dist(nll, nll64), dist(lse, lse64))
                errors[f"{tree} {at}"] = e + (bad,)
                infos = getattr(lib, prefix + "info")
                info[f"{tree} {at}"] = [[infos(k, w, H) for w in range(5 if k < 2 else 4)] for k in (0, 1, 2)]
                print(f"{tree} wide K4-K6 {at}: nll {e[0]:.3e}, lse {e[1]:.3e} (tol {XENT_TOL}; against the exact "
                      f"products' {e[6]:.3e}, {e[7]:.3e}), argmax differs on "
                      f"{bad} rows with a top-2 gap > 1e-3; dx {e[2]:.3e} (tol {DX_TOL}), dE {e[3]:.3e} (tol "
                      f"{DE_TOL}), db {e[4]:.3e} against the exact products' (tol {DBIAS_TOL}; {e[5]:.3e} against "
                      f"the plain version's); two calls bit for bit: {same}; K4 grid {fwd['grid']}, K5 grid "
                      f"{plan['grid']}; K5, K6, K4 registers, local bytes, shared bytes, blocks an SM (clusters at "
                      f"once) {info[f'{tree} {at}']}  [{card}]", flush=True)
                if tree == "this" and not (max(e[:2]) <= XENT_TOL and bad == 0 and e[2] <= DX_TOL
                                           and e[3] <= DE_TOL and e[4] <= DBIAS_TOL and same):
                    raise SystemExit(f"xent_steps: the wide K4-K6 {at} disagree with their plain versions")
                fns[f"{tree} K4"], fns[f"{tree} K5"], fns[f"{tree} K6"] = k4, k5, k6
            del dx_r, de_r, db_r, db64, clear, nll64, lse64
            if dtype == "bfloat16" and H != 1088:
                # this K5 on other splits: what WIDE_BLOCK_TILES models
                for S, per, w, tiles in wide_sweep_splits(N, V, rows, tile, clusters):
                    fns[f"wide K5 splits {S}"] = wide_calls(this, data, S, per)[0]
                    splits[f"{H}: K5 {S} splits"] = (S, per, w, tiles, S == plan["grid"][2])
                # this K4 on the splits of one to four waves: what WIDE_FWD_BLOCK_TILES models
                f_rows, f_tile = this.vb_xent_wide_geometry(1), this.vb_xent_wide_geometry(3)
                chosen = xe._wide_fwd_plan_of(this, N, V, H, sms)["grid"][1]
                for S, per, w, tiles in sweep_splits(N, V, f_rows, f_tile, sms, xe.WIDE_FWD_BLOCK_TILES):
                    fns[f"wide K4 splits {S}"] = wide_fwd_on(this, data, S, per)
                    splits[f"{H}: K4 {S} splits"] = (S, per, w, tiles, S == chosen)
            p = torch.empty((N, V), dtype=x.dtype, device=dev).normal_()
            fns["cuBLAS K4's product"] = lambda _: torch.matmul(x, emb.t())
            fns["cuBLAS K5's products"] = lambda _: (torch.matmul(x, emb.t()), torch.matmul(p, emb))
            fns["cuBLAS K6's products"] = lambda _: (torch.matmul(x, emb.t()), torch.matmul(p.t(), x))
            jobs, t = list(fns), {name: [] for name in fns}
            for r in range(ROUNDS):
                for name in (jobs if r % 2 == 0 else jobs[::-1]):
                    t[name].append(best_ms(fns[name]))
            for name, ms in t.items():
                extra = ""
                if "splits" in name:
                    kernel = name.split()[1]
                    S, per, w, tiles, chosen = splits[f"{H}: {kernel} {name.split()[-1]} splits"]
                    slots = f"{clusters} clusters" if kernel == "K5" else f"{sms} SMs"
                    extra = (f" ({per} tiles a split, {w} waves of {slots}, the busiest slot's modelled tiles "
                             f"{tiles}{'; the plan takes it' if chosen else ''})")
                print(f"{at}: {name}{extra}: {min(ms):.4f}-{max(ms):.4f} ms  [{card}]", flush=True)
            times[f"{dtype} {H}"] = t
            del data, x, emb, bias, lab, p, fns
            torch.cuda.empty_cache()
    # K4 alone at the widest clusters: held to the exact products (the plain version's fp32 sums drift)
    for H in WIDE_EXACT_WIDTHS:
        for dtype in WIDE_DTYPES:
            x, emb, bias, lab = inputs(torch, dev, H, dtype)[:4]
            N, V = x.shape[0], emb.shape[0]
            nll64, lse64 = fwd_exact(x, emb, bias, lab)
            nll_r, lse_r, _ = xe.mlm_xent_fwd_reference(x, emb, bias, lab)
            at = f"{dtype} at {H}"
            line = [f"the plain version nll {dist(nll_r, nll64):.3e}, lse {dist(lse_r, lse64):.3e}"]
            prefix = xe._WIDE_ENTRY[x.dtype]
            for tree in (t for t in libs if hasattr(libs[t], prefix + "fwd")):
                lib = libs[tree]
                fwd = (xe._wide_fwd_plan_of(lib, N, V, H, sms) if tree == "this"
                       else xe.fwd_plan(N, V, H, lib.vb_xent_wide_geometry(1), lib.vb_xent_wide_geometry(3), sms))
                nll, lse, _ = wide_fwd_on(lib, (x, emb, bias, lab), fwd["grid"][1], fwd["per"])(0)
                torch.cuda.synchronize()
                errors[f"{tree} K4 {at}"] = e = (dist(nll, nll64), dist(lse, lse64))
                line.append(f"{tree} K4 nll {e[0]:.3e}, lse {e[1]:.3e}")
                if tree == "this" and max(e) > XENT_TOL:
                    raise SystemExit(f"xent_steps: the wide K4 {at} misses the exact products")
            print(f"{at}, against the exact products (tol {XENT_TOL}): {'; '.join(line)}  [{card}]", flush=True)
            del x, emb, bias, lab, nll64, lse64, nll_r, lse_r
            torch.cuda.empty_cache()
    result = dict(card=card, errors=errors, info=info, ms=times, sass=sass, splits=splits)
    print(json.dumps(result), flush=True)
    return result


def main(argv=None):
    """Prints one line a check and a timing; returns the numbers."""
    import torch

    from visualbert_torch.ops import mlm_xent as xe
    from visualbert_torch.tools.attn_exp import best_ms
    from visualbert_torch.tools.main_path import card_line

    argv = list(argv or [])
    wide = bool(argv) and argv[0] == "--wide"
    if wide:
        argv = argv[1:]
    if len(argv) > 1:
        raise SystemExit(f"xent_steps: takes at most one argument (another checkout), got {argv}")
    if not torch.cuda.is_available():
        raise SystemExit("xent_steps: no CUDA device; the kernels run only on the card")
    card = card_line()
    if wide:
        return wide_main(argv[0] if argv else None, card)
    dev = torch.device("cuda")
    sms = xe.sm_count(dev)
    data = inputs(torch, dev)
    libs, seconds = build_all()
    builds = {"as built": _build.library(), **libs}
    N, V = data[0].shape[0], data[1].shape[0]
    print(f"xent_steps: N={N} V={V} H={H}; {len(BUILDS)} builds in {seconds:.1f} s  [{card}]", flush=True)

    built = builds["as built"]
    dx_fn, de_fn = calls(built, data, sms)
    dx, (de, db) = dx_fn(0), de_fn(0)
    nll, lse, am = fwd_call(built, data, sms)(0)
    nll_r, lse_r, _ = xe.mlm_xent_fwd_reference(*data[:4])
    errors = (rel(dx, xe.mlm_xent_dx_reference(*data)),) + tuple(
        rel(a, b) for a, b in zip((de, db), xe.mlm_xent_de_reference(*data)))
    e_fwd = max(float((nll - nll_r).abs().max()), float((lse - lse_r).abs().max()))
    torch.cuda.synchronize()
    print(f"as built against the plain versions: nll, lse {e_fwd:.3e} (tol {XENT_TOL}, absolute), dx {errors[0]:.3e} "
          f"(tol {DX_TOL}), dE {errors[1]:.3e} (tol {DE_TOL}), db {errors[2]:.3e} (tol {DBIAS_TOL})  [{card}]",
          flush=True)
    if not (e_fwd <= XENT_TOL and errors[0] <= DX_TOL and errors[1] <= DE_TOL and errors[2] <= DBIAS_TOL):
        raise SystemExit("xent_steps: the kernels as built disagree with their plain versions")
    for name in EXACT_FWD_BUILDS:
        same = all(torch.equal(a, b) for a, b in zip(fwd_call(builds[name], data, sms)(0), (nll, lse, am)))
        print(f"{name}: nll, lse and argmax equal K4's as built: {same}  [{card}]", flush=True)
        if name != "fwd split K" and not same:  # the same sums in the same order: the same bits
            raise SystemExit(f"xent_steps: {name} differs from K4 as built")
        if name == "fwd split K":
            got = fwd_call(builds[name], data, sms)(0)
            e = max(float((got[0] - nll_r).abs().max()), float((got[1] - lse_r).abs().max()))
            if e > XENT_TOL:
                raise SystemExit(f"xent_steps: {name} disagrees with the plain version ({e:.3e})")
    del dx, de, db, nll, lse, am

    sass = other_lib = None
    if argv:
        sass, other_lib = compare_sass(argv[0], card)
    # kernel -> {build: launch}: K4 in its builds, K5/K6 in theirs, all three as built
    fns = {"K4": {name: fwd_call(builds[name], data, sms) for name in ("as built", *FWD_BUILDS)},
           "K5": {}, "K6": {}}
    for name in ("as built", *BWD_BUILDS):
        fns["K5"][name], fns["K6"][name] = calls(builds[name], data, sms)
    if other_lib is not None:  # the other tree's K4 as its wrapper launched it, its K5 and K6 as built
        fns["K4"]["other K4"] = first_design_call(other_lib, data, sms)
        fns["K4"]["other K4, this plan"] = fwd_call(other_lib, data, sms)
        fns["K5"]["other K5"], fns["K6"]["other K6"] = calls(other_lib, data, sms)
        for name in ("other K4", "other K4, this plan", "other K5", "other K6"):
            builds[name] = other_lib
        # both trees' K4-K6 at width 1024, as this tree's wrappers launch them
        data_1024 = inputs(torch, dev, 1024)
        fns["at 1024"] = {}
        for tree, lib in (("this", built), ("other", other_lib)):
            fns["at 1024"][f"{tree} K4"] = fwd_call(lib, data_1024, sms)
            fns["at 1024"][f"{tree} K5"], fns["at 1024"][f"{tree} K6"] = calls(lib, data_1024, sms)
    # K4 as built on other splits, at both widths: what FWD_BLOCK_TILES models
    fns["K4 splits"], splits = {}, {}
    for width_data in (data, inputs(torch, dev, 1024)):
        sweep, facts = split_sweep(built, width_data, sms)
        fns["K4 splits"].update(sweep)
        splits.update(facts)
    info = {name: [[lib.vb_xent_info(k, w, H) for w in range(4)] for k in (0, 1, 2)] for name, lib in builds.items()}
    jobs = [(k, name) for k in fns for name in fns[k]]
    times = {k: {name: [] for name in fns[k]} for k in fns}
    for r in range(ROUNDS):
        for k, name in (jobs if r % 2 == 0 else jobs[::-1]):
            times[k][name].append(best_ms(fns[k][name]))
    for k in fns:
        for name, ms in times[k].items():
            if k == "K4 splits":
                S, per, w, tiles = splits[name]
                width = int(name.split(":")[0])
                chosen = xe.fwd_plan(N, V, width, built.vb_xent_geometry(1, width), built.vb_xent_geometry(3, width),
                                     sms)["grid"][1] == S
                print(f"{k} {name} of {per} tiles, {w} waves, the busiest SM's modelled tiles {tiles}"
                      f"{' (fwd_plan takes it)' if chosen else ''}: {min(ms):.4f}-{max(ms):.4f} ms  [{card}]",
                      flush=True)
                continue
            if k == "at 1024":
                print(f"{k} {name}: {min(ms):.4f}-{max(ms):.4f} ms  [{card}]", flush=True)
                continue
            print(f"{k} {name}: {min(ms):.4f}-{max(ms):.4f} ms; registers, local bytes, shared bytes, blocks an SM of "
                  f"K5, K6, K4: {info[name]}  [{card}]", flush=True)
    result = dict(card=card, errors=errors, fwd_error=e_fwd, info=info, ms=times, sass=sass, splits=splits)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    import sys

    main(sys.argv[1:])
