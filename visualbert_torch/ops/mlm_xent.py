"""Fused masked-LM softmax cross-entropy over the tied decoder (counterpart
of ``visualbert_tpu/ops/mlm_xent.py::mlm_xent``).

``mlm_xent(x [N, H], embedding [V, H], bias [V], labels [N])`` returns the
per-row ``nll`` [N] fp32 and the first-max ``argmax`` [N] int32 of the
logits ``x . embedding^T + bias``, with the JAX op's semantics: the logits
are products of compute-dtype operands accumulated in fp32, plus the fp32
bias; labels of -1 are computed as label 0 and the caller masks those rows;
in the backward ``dlog = softmax - onehot`` is rounded to the compute dtype
before each product, ``d embedding`` comes back in the embedding's compute
dtype and ``d bias`` in fp32. On the kernel path no [N, V] tensor reaches
device memory, forward or backward.

Kernels (``csrc/mlm_xent.cu``, design notes there):

* K4, :func:`mlm_xent_fwd`, replaces ``_fwd_kernel`` (nll, lse, argmax),
  on K5's tiling: a block of two warpgroups keeps 128 rows of x (64 at
  width 1024) as ``wgmma`` A fragments in registers, streams the embedding
  in 32-row tiles through a ring of ``cp.async`` copies, and keeps an online
  (max, sum of exp, label logit, first-max argmax) per row; the vocabulary
  is split across blocks (:func:`fwd_plan`) and a second pass merges the
  splits in order.
* K5, :func:`mlm_xent_dx`, replaces ``_dx_kernel``; K6,
  :func:`mlm_xent_de`, replaces ``_de_kernel`` (d embedding, d bias). Both
  are one Hopper kernel, bound by their two N x V x H products (288 GFLOP
  at the main path's N = 3072, V = 30522, H = 768): a block of two
  warpgroups keeps 64 rows (K5: of x; K6: of the embedding) in 128 B-swizzled
  shared memory and streams the other matrix in tiles that ``cp.async``
  brings a tile ahead; ``wgmma`` computes each tile's logits once (each
  warpgroup over half of H, partial sums exchanged in shared memory), then,
  from one shared bf16 dlog tile, each warpgroup's half of the result
  columns. At width 1024 a block owns
  512 of the columns (:func:`dx_plan`, :func:`de_plan`). K5 splits the
  vocabulary so that about four blocks per SM run (:func:`splits`): its
  blocks write fp32 partials of dx, which a second pass sums in split order.

The kernels take every dtype and width the JAX kernels take: bf16 and fp16
on the Hopper kernels, instantiated at widths 128, 256, 512, 768 and 1024
(``KERNEL_WIDTHS``), any other width up to 1024 zero-padded to the next of
them; bf16 and fp16 above 1024 on the wide form (``xent_wide_*`` in
``csrc/mlm_xent.cu``: K4 streams 128 x 128 tiles in 64-column panels by
TMA from a producer warp, its two warpgroups' products interleaving on
the tensor cores; K5/K6 run a thread-block cluster of one block a
512-column range
(:func:`wide_cluster`), which forms each tile's logits once by split K and
shares the rounded dlog through distributed shared memory) at any multiple
of 64 up to 8192 (``WIDE_MAX``), another width zero-padded to the next
multiple of 64 (:func:`kernel_width`, :func:`pad_width`: a zero column adds
nothing to a logit; the padded columns of dx and dE are dropped; the
padding copies E each call); fp32, and bf16 and fp16 above 8192 (upcast, an
fp32 copy of x and E each call: :func:`runs_on_f32`), at any
width on the tiled SIMT kernels of
``csrc/mlm_xent_f32.cu`` (128 x 256 tiles of logits, an 8 x 16 register
block a thread; K4 and K5 split the vocabulary, :func:`f32_plan`). Each
wrapper counts its launches in ``launches`` and, by form
(:func:`xent_form`), in ``forms``.

On CPU tensors the wrappers compute the plain versions
(:func:`mlm_xent_fwd_reference`, :func:`mlm_xent_dx_reference`,
:func:`mlm_xent_de_reference`, which materialise the logits); on CUDA
tensors they launch the kernels or raise.

Under a (data, model) mesh (``parallel/mesh.py``) the rows split over data
x model, as in JAX's ``shard_map`` (``ops/mlm_xent.py:312-350``): a data
rank holds its batch's rows already, and with ``mesh`` of model size m
each model rank runs K4-K6 on its ``N / m`` block of those (replicated)
rows; the table and the bias stay whole. nll and argmax are gathered over
the model group, dx likewise, and d embedding and d bias are summed there.
:func:`supports_mesh` says when the rows split; callers take the unfused
decoder otherwise.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from visualbert_torch.ops import _build
from visualbert_torch.ops._build import sm_count
from visualbert_torch.parallel.mesh import all_reduce, gather_slices

KERNEL_WIDTHS = (128, 256, 512, 768, 1024)  # the hidden widths K4-K6 are instantiated for (bf16, fp16)
WIDE_STEP = 64  # above KERNEL_WIDTHS[-1] the wide form takes the multiples of this (csrc/mlm_xent.cu)
WIDE_MAX = 8192  # ... up to this: a K5/K6 cluster of 16 blocks (the H100's most) of 512 columns
KERNEL_DTYPES = (torch.bfloat16, torch.float16, torch.float32)
_ENTRY = {torch.bfloat16: "vb_xent_", torch.float16: "vb_xent_f16_"}  # the entry points of csrc/mlm_xent.cu
_WIDE_ENTRY = {torch.bfloat16: "vb_xent_wide_", torch.float16: "vb_xent_f16_wide_"}  # ... of its wide form


def kernel_width(h: int) -> int:
    """The width at which the bf16 and fp16 kernels run rows of width h: up
    to 1024 the smallest instantiation that holds it, above it h rounded up
    to a multiple of WIDE_STEP (the wide form)."""
    if h > KERNEL_WIDTHS[-1]:
        return -(-h // WIDE_STEP) * WIDE_STEP
    return next(w for w in KERNEL_WIDTHS if h <= w)


def is_wide(h: int) -> bool:
    """Whether rows of width h are above the instantiated widths: bf16 and
    fp16 run them on the wide form up to WIDE_MAX."""
    return h > KERNEL_WIDTHS[-1]


def runs_on_f32(dtype, h: int) -> bool:
    """Whether rows of width h in ``dtype`` run on the fp32 kernels: fp32,
    and bf16 and fp16 above WIDE_MAX, wider than the wide form's largest
    cluster covers. Below it both half dtypes take the tensor cores: fp16's
    22-bit products keep db as near the exact products' as bf16's
    (csrc/mlm_xent.cu, the wide form's notes)."""
    return dtype == torch.float32 or h > WIDE_MAX


def pad_width(t: torch.Tensor, w: int) -> torch.Tensor:
    """``t`` [rows, h] with its columns zero-padded to w (``t`` itself at h = w)."""
    h = t.shape[-1]
    return t if h == w else torch.nn.functional.pad(t, (0, w - h))


def xent_form(dtype, h: int) -> str:
    """The kernel form K4-K6 run rows of width h in ``dtype`` on: "fp32" (the
    tiled SIMT kernels), "fp16 on fp32" or "bf16 on fp32" (above WIDE_MAX,
    upcast), "<dtype> H<instantiated width>" up to 1024, or "<dtype> wide
    H<padded width>" above it."""
    if dtype == torch.float32:
        return "fp32"
    name = "bf16" if dtype == torch.bfloat16 else "fp16"
    if runs_on_f32(dtype, h):
        return f"{name} on fp32"
    return f"{name} {'wide ' if is_wide(h) else ''}H{kernel_width(h)}"


def _logits(x, emb, bias):
    # compute-dtype products are exact in fp32, so this is the kernels' math
    return torch.matmul(x.float(), emb.float().t()) + bias.float()


def _dlog(x, emb, bias, labels, lse):
    """softmax - onehot, fp32 [N, V]."""
    p = torch.exp(_logits(x, emb, bias) - lse[:, None])
    rows = torch.arange(p.shape[0], device=p.device)
    p[rows, labels.long()] -= 1.0
    return p


def mlm_xent_fwd_reference(x, emb, bias, labels) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K4: (nll [N] fp32, lse [N] fp32, argmax [N] int32)."""
    logits = _logits(x, emb, bias)
    lse = torch.logsumexp(logits, dim=-1)
    nll = lse - logits.gather(1, labels.long()[:, None])[:, 0]
    return nll, lse, logits.argmax(dim=-1).to(torch.int32)


def mlm_xent_dx_reference(x, emb, bias, labels, lse, g) -> torch.Tensor:
    """Plain version of K5: dx [N, H] in x's dtype."""
    dlog = _dlog(x, emb, bias, labels, lse).to(x.dtype).float()
    return (torch.matmul(dlog, emb.float()) * g[:, None]).to(x.dtype)


def mlm_xent_de_reference(x, emb, bias, labels, lse, g) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K6: (d embedding [V, H] in emb's dtype, d bias [V] fp32)."""
    dlog = _dlog(x, emb, bias, labels, lse) * g[:, None]
    de = torch.matmul(dlog.to(x.dtype).float().t(), x.float()).to(emb.dtype)
    return de, dlog.sum(dim=0)


def _check_cuda_inputs(what, x, emb, bias, labels, *rows):
    lib = _build.library()
    N, H = x.shape
    V = emb.shape[0]
    if x.dtype not in KERNEL_DTYPES or emb.dtype != x.dtype:
        raise ValueError(f"{what}: the kernels take bf16, fp16 or fp32 x and an embedding of its dtype, got "
                         f"{x.dtype}, {emb.dtype}")
    if emb.shape != (V, H):
        raise ValueError(f"{what}: x and the embedding must have one hidden width, "
                         f"got x {tuple(x.shape)}, embedding {tuple(emb.shape)}")
    if bias.shape != (V,) or bias.dtype != torch.float32:
        raise ValueError(f"{what}: bias must be [{V}] float32")
    if labels.shape != (N,) or labels.dtype != torch.int32:
        raise ValueError(f"{what}: labels must be [{N}] int32")
    for r in rows:
        if r.shape != (N,) or r.dtype != torch.float32:
            raise ValueError(f"{what}: lse and g must be [{N}] float32")
    for t in (x, emb, bias, labels) + rows:
        if t.device != x.device:
            raise ValueError(f"{what}: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: tensors must be 16-byte aligned")
    return lib


# K4's fixed cost of a block (its x rows loaded, the ring filled), in tiles'
# time: the plan weighs more splits against it
FWD_BLOCK_TILES = 4


def splits(n_blocks: int, n_tiles: int, sms: int) -> Tuple[int, int]:
    """(splits, tiles per split) of n_tiles vocabulary tiles over n_blocks
    blocks a split: about four blocks per SM in all, no split empty."""
    target = 4 * sms
    per = -(-n_tiles // max(1, min(n_tiles, -(-target // n_blocks))))
    return -(-n_tiles // per), per


def fwd_plan(N: int, V: int, H: int, rows: int, tile: int, sms: int, block_tiles: int = FWD_BLOCK_TILES) -> dict:
    """K4's launch at N rows, V vocabulary rows and width H, for the
    kernel's tiling (``rows`` rows of x a block, ``tile`` vocabulary rows a
    tile: ``vb_xent_geometry`` 1, 3) on a card of ``sms`` SMs, one block an
    SM: the splits that give the busiest SM the least work (its waves of
    blocks times a block's tiles and ``block_tiles``, a block's fixed cost
    in tiles' time), the fewest on a tie.
    Returns the grid (row blocks, splits), the tiles a split (``per``; split
    s takes tiles [s per, s per + per)) and the shapes of the partials the
    kernel writes, [4, splits, N] fp32 and [splits, N] int32."""
    row_blocks, n_tiles = -(-N // rows), -(-V // tile)
    best = None
    for want in range(1, min(n_tiles, 8 * sms) + 1):
        per = -(-n_tiles // want)
        S = -(-n_tiles // per)  # no split empty
        cost = -(-row_blocks * S // sms) * (per + block_tiles)
        if best is None or cost < best[0]:
            best = (cost, S, per)
    _, S, per = best
    return dict(grid=(row_blocks, S), per=per, tiles=n_tiles, pf_shape=(4, S, N), pi_shape=(S, N))


def dx_plan(N: int, V: int, H: int, rows: int, tile: int, cols: int, sms: int) -> dict:
    """K5's launch at N rows, V vocabulary rows and width H, for the
    kernel's tiling (``rows`` rows of x a block, ``tile`` vocabulary rows a
    tile, ``cols`` columns a block, the last part shorter where H is no
    multiple of it: ``vb_xent_geometry`` 2, 4, 5) on a card of ``sms`` SMs:
    the grid (row blocks, column parts, splits), the tiles a split (``per``;
    split s takes tiles [s per, s per + per)) and the shape of the fp32
    partials the kernel writes, [splits, N, H]."""
    row_blocks, parts, n_tiles = -(-N // rows), -(-H // cols), -(-V // tile)
    S, per = splits(row_blocks * parts, n_tiles, sms)
    return dict(grid=(row_blocks, parts, S), per=per, tiles=n_tiles, part_shape=(S, N, H))


def de_plan(V: int, H: int, rows: int, cols: int) -> dict:
    """K6's grid (vocabulary blocks of ``rows``, column parts of ``cols``,
    the last shorter where H is no multiple of it): each block walks every
    row tile of x itself, so nothing is split."""
    return dict(grid=(-(-V // rows), -(-H // cols)))


# a wide K5 cluster's fixed cost (its resident panels copied, the ring
# filled, the first tile's logits), in tiles' time: the splits it picks are
# timed beside others by tools/xent_steps.py --wide ("wide K5 splits")
WIDE_BLOCK_TILES = 2


def wide_cluster(H: int, cols: int) -> Tuple[int, int]:
    """The wide K5/K6's cluster at width H (a multiple of 64) for blocks of
    at most ``cols`` result columns (``vb_xent_wide_geometry`` 5): (R, the
    64-column panels each block owns). R = cdiv(H, cols) blocks share the
    panels evenly, block r owning [r P, r P + P), the last the rest; as
    ``csrc/mlm_xent.cu::xent_wide_bwd_kernel`` works them out."""
    panels = H // 64
    R = -(-panels // (cols // 64))
    return R, -(-panels // R)


def wide_dx_plan(N: int, V: int, H: int, rows: int, tile: int, cols: int, clusters: int) -> dict:
    """The wide K5's launch at N rows, V vocabulary rows and width H, for its
    tiling (``rows`` resident x rows a cluster, ``tile`` vocabulary rows a
    tile, at most ``cols`` columns a block: ``vb_xent_wide_geometry`` 2, 4,
    5) when the card runs ``clusters`` clusters at once
    (``vb_xent_wide_info(0, 4, H)``): :func:`fwd_plan`'s splits over those
    cluster slots, WIDE_BLOCK_TILES a cluster's fixed cost. Returns the grid
    (row blocks, the cluster's R blocks, splits), the cluster's shape
    (1, R, 1), the panels a block owns, the tiles a split and the shape of
    the fp32 partials, [splits, N, H]."""
    R, panels = wide_cluster(H, cols)
    plan = fwd_plan(N, V, H, rows, tile, clusters, WIDE_BLOCK_TILES)
    row_blocks, S = plan["grid"]
    return dict(grid=(row_blocks, R, S), cluster=(1, R, 1), panels=panels, per=plan["per"], tiles=plan["tiles"],
                part_shape=(S, N, H))


def wide_de_plan(V: int, H: int, rows: int, cols: int) -> dict:
    """The wide K6's grid (vocabulary blocks of ``rows`` a cluster, the
    cluster's R blocks), the cluster's shape and the panels a block owns:
    each cluster walks every row tile of x, so nothing is split."""
    R, panels = wide_cluster(H, cols)
    return dict(grid=(-(-V // rows), R), cluster=(1, R, 1), panels=panels)


def f32_plan(N: int, V: int, rows: int, tile: int, slots: int) -> dict:
    """fp32 K4's and K5's launch (``csrc/mlm_xent_f32.cu``: ``rows`` x rows a
    block, ``tile`` vocabulary rows a tile, ``vb_xent_f32_geometry`` 0, 1) on
    ``slots`` resident blocks (SMs x blocks an SM): :func:`fwd_plan`'s
    splits with no fixed cost a block (a 128 x 256 fp32 tile over H dwarfs
    a block's set-up): at the main path on 132 slots (one block an SM) 11
    splits of 24 row blocks, two full waves. K5's fp32 partials are
    [splits, N, H] at width H. fp32 K6 runs cdiv(V, rows) blocks, each over
    every row tile of x."""
    return fwd_plan(N, V, 0, rows, tile, slots, block_tiles=0)


def bwd_products(dtype, h: int) -> int:
    """The N x V x h products K5 (or K6) runs at width h in ``dtype``: the
    logits and the result once each, plus, at 1024 (bf16, fp16: 512 columns
    a block), the logits again for the second column range. The wide form's
    cluster forms each tile's logits once over all its ranges, in bf16 and
    fp16."""
    if runs_on_f32(dtype, h):
        return 2
    w = kernel_width(h)
    if is_wide(w):
        return 2
    cols = w if w < KERNEL_WIDTHS[-1] else 512
    return -(-w // cols) + 1


def _device(x, what):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")
    return x.device.type == "cuda"


@functools.lru_cache(maxsize=None)
def _fwd_plan_of(lib, N: int, V: int, H: int, sms: int) -> dict:
    """K4's plan for a library's tiling: a pure function of the shape and
    the card, worked out once (the wrapper's host time counts beside K4's)."""
    return fwd_plan(N, V, H, lib.vb_xent_geometry(1, H), lib.vb_xent_geometry(3, H), sms)


def launch_fwd(lib, x, emb, bias, labels, sms):
    """Launch K4 on checked inputs: (the entry point's code, nll, lse,
    argmax)."""
    (N, H), V = x.shape, emb.shape[0]
    plan = _fwd_plan_of(lib, N, V, H, sms)
    pf = torch.empty(plan["pf_shape"], dtype=torch.float32, device=x.device)
    pi = torch.empty(plan["pi_shape"], dtype=torch.int32, device=x.device)
    nll = torch.empty(N, dtype=torch.float32, device=x.device)
    lse = torch.empty(N, dtype=torch.float32, device=x.device)
    am = torch.empty(N, dtype=torch.int32, device=x.device)
    code = getattr(lib, _ENTRY[x.dtype] + "fwd")(
        x.data_ptr(), emb.data_ptr(), bias.data_ptr(), labels.data_ptr(), N, V, H, plan["grid"][1], plan["per"],
        pf.data_ptr(), pi.data_ptr(), nll.data_ptr(), lse.data_ptr(), am.data_ptr(), _build.stream_ptr(x.device))
    return code, nll, lse, am


@functools.lru_cache(maxsize=None)
def _f32_plan_of(lib, kernel: int, N: int, V: int, sms: int) -> dict:
    """fp32 K4's (kernel 2) or K5's (kernel 0) plan on the card's block
    slots: its SMs times the kernel's resident blocks an SM."""
    slots = sms * max(1, lib.vb_xent_f32_info(kernel, 3, 1))
    return f32_plan(N, V, lib.vb_xent_f32_geometry(0), lib.vb_xent_f32_geometry(1), slots)


def launch_f32_fwd(lib, x, emb, bias, labels, sms):
    """Launch K4's fp32 kernel (``csrc/mlm_xent_f32.cu``) and its merge pass
    on checked inputs: (the entry point's code, nll, lse, argmax)."""
    (N, H), V = x.shape, emb.shape[0]
    plan = _f32_plan_of(lib, 2, N, V, sms)
    pf = torch.empty(plan["pf_shape"], dtype=torch.float32, device=x.device)
    pi = torch.empty(plan["pi_shape"], dtype=torch.int32, device=x.device)
    nll = torch.empty(N, dtype=torch.float32, device=x.device)
    lse = torch.empty(N, dtype=torch.float32, device=x.device)
    am = torch.empty(N, dtype=torch.int32, device=x.device)
    code = lib.vb_xent_f32_fwd(x.data_ptr(), emb.data_ptr(), bias.data_ptr(), labels.data_ptr(), N, V, H,
                               plan["grid"][1], plan["per"], pf.data_ptr(), pi.data_ptr(), nll.data_ptr(),
                               lse.data_ptr(), am.data_ptr(), _build.stream_ptr(x.device))
    return code, nll, lse, am


# the wide K4's fixed cost of a block (its ring filled, its last tile's
# statistics), in its tiles' time (128 vocabulary rows over the whole width)
WIDE_FWD_BLOCK_TILES = 1


@functools.lru_cache(maxsize=None)
def _wide_fwd_plan_of(lib, N: int, V: int, H: int, sms: int) -> dict:
    """The wide K4's plan: :func:`fwd_plan` on its tiling
    (``vb_xent_wide_geometry`` 1, 3), WIDE_FWD_BLOCK_TILES a block's fixed
    cost."""
    return fwd_plan(N, V, H, lib.vb_xent_wide_geometry(1), lib.vb_xent_wide_geometry(3), sms, WIDE_FWD_BLOCK_TILES)


def launch_wide_fwd(lib, x, emb, bias, labels, sms):
    """Launch the wide form's K4 and the merge pass on checked bf16 or fp16
    inputs of a width it takes: (the entry point's code, nll, lse,
    argmax)."""
    (N, H), V = x.shape, emb.shape[0]
    plan = _wide_fwd_plan_of(lib, N, V, H, sms)
    pf = torch.empty(plan["pf_shape"], dtype=torch.float32, device=x.device)
    pi = torch.empty(plan["pi_shape"], dtype=torch.int32, device=x.device)
    nll = torch.empty(N, dtype=torch.float32, device=x.device)
    lse = torch.empty(N, dtype=torch.float32, device=x.device)
    am = torch.empty(N, dtype=torch.int32, device=x.device)
    code = getattr(lib, _WIDE_ENTRY[x.dtype] + "fwd")(
        x.data_ptr(), emb.data_ptr(), bias.data_ptr(), labels.data_ptr(), N, V, H, plan["grid"][1], plan["per"],
        pf.data_ptr(), pi.data_ptr(), nll.data_ptr(), lse.data_ptr(), am.data_ptr(), _build.stream_ptr(x.device))
    return code, nll, lse, am


def _counted(fn, form: str) -> None:
    fn.launches += 1
    fn.forms[form] = fn.forms.get(form, 0) + 1


def mlm_xent_fwd(x, emb, bias, labels) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4 wrapper: (nll [N] fp32, lse [N] fp32, argmax [N] int32). Each form
    writes per-split partial statistics; its second pass merges them in
    vocabulary order. A bf16 or fp16 width between the instantiated ones,
    or above 1024 no multiple of 64, runs on x and E zero-padded to the
    next (a copy of E each call); above WIDE_MAX they run on the fp32
    kernels (an fp32 copy of x and E each call)."""
    what = "mlm xent forward (K4)"
    if not _device(x, what):
        return mlm_xent_fwd_reference(x, emb, bias, labels)
    lib = _check_cuda_inputs(what, x, emb, bias, labels)
    form = xent_form(x.dtype, x.shape[1])
    if runs_on_f32(x.dtype, x.shape[1]):
        code, nll, lse, am = launch_f32_fwd(lib, x.float(), emb.float(), bias, labels, sm_count(x.device))
    else:
        w = kernel_width(x.shape[1])
        launch = launch_wide_fwd if is_wide(w) else launch_fwd
        code, nll, lse, am = launch(lib, pad_width(x, w), pad_width(emb, w), bias, labels, sm_count(x.device))
    lib.check(code, what)
    _counted(mlm_xent_fwd, form)
    return nll, lse, am


mlm_xent_fwd.launches = 0
mlm_xent_fwd.forms = {}


def launch_dx(lib, x, emb, bias, labels, lse, g, sms):
    """Launch K5 on checked inputs: (the entry point's code, dx)."""
    (N, H), V = x.shape, emb.shape[0]
    plan = dx_plan(N, V, H, lib.vb_xent_geometry(2, H), lib.vb_xent_geometry(4, H), lib.vb_xent_geometry(5, H), sms)
    part = torch.empty(plan["part_shape"], dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    code = getattr(lib, _ENTRY[x.dtype] + "dx")(
        x.data_ptr(), emb.data_ptr(), bias.data_ptr(), labels.data_ptr(), lse.data_ptr(), g.data_ptr(), N, V, H,
        plan["grid"][2], plan["per"], part.data_ptr(), dx.data_ptr(), _build.stream_ptr(x.device))
    return code, dx


def launch_f32_dx(lib, x, emb, bias, labels, lse, g, sms):
    """Launch K5's fp32 kernel and its reduce pass on checked inputs: (the
    entry point's code, dx)."""
    (N, H), V = x.shape, emb.shape[0]
    plan = _f32_plan_of(lib, 0, N, V, sms)
    S = plan["grid"][1]
    part = torch.empty((S, N, H), dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    code = lib.vb_xent_f32_dx(x.data_ptr(), emb.data_ptr(), bias.data_ptr(), labels.data_ptr(), lse.data_ptr(),
                              g.data_ptr(), N, V, H, S, plan["per"], part.data_ptr(), dx.data_ptr(),
                              _build.stream_ptr(x.device))
    return code, dx


@functools.lru_cache(maxsize=None)
def wide_clusters(lib, kernel: int, H: int, dtype=torch.bfloat16) -> int:
    """The clusters of the wide K5 (kernel 0) or K6 (1) in ``dtype`` at width
    H that the card runs at once (``vb_xent_wide_info(kernel, 4, H)``, or
    ``vb_xent_f16_wide_info``); raises where none fits (a launch of such a
    cluster would fail on its own)."""
    n = getattr(lib, _WIDE_ENTRY[dtype] + "info")(kernel, 4, H)
    if n <= 0:
        raise RuntimeError(f"mlm xent: no cluster of the wide K{5 + kernel} at width {H} fits the card ({n})")
    return n


def launch_wide_dx(lib, x, emb, bias, labels, lse, g):
    """Launch the wide form's K5 (a cluster a row block and split) and its
    reduce pass on checked bf16 or fp16 inputs: (the entry point's code,
    dx)."""
    (N, H), V = x.shape, emb.shape[0]
    plan = wide_dx_plan(N, V, H, *(lib.vb_xent_wide_geometry(w) for w in (2, 4, 5)),
                        wide_clusters(lib, 0, H, x.dtype))
    part = torch.empty(plan["part_shape"], dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    code = getattr(lib, _WIDE_ENTRY[x.dtype] + "dx")(
        x.data_ptr(), emb.data_ptr(), bias.data_ptr(), labels.data_ptr(), lse.data_ptr(), g.data_ptr(), N, V, H,
        plan["grid"][2], plan["per"], part.data_ptr(), dx.data_ptr(), _build.stream_ptr(x.device))
    return code, dx


def mlm_xent_dx(x, emb, bias, labels, lse, g) -> torch.Tensor:
    """K5 wrapper: dx [N, H] in x's dtype. Each form writes fp32 partials of
    dx per vocabulary split; its second pass sums them in order. Widths are
    padded as :func:`mlm_xent_fwd`'s, and dx cut back."""
    what = "mlm xent dx (K5)"
    if not _device(x, what):
        return mlm_xent_dx_reference(x, emb, bias, labels, lse, g)
    lib = _check_cuda_inputs(what, x, emb, bias, labels, lse, g)
    H = x.shape[1]
    form = xent_form(x.dtype, H)
    if runs_on_f32(x.dtype, H):
        code, dx = launch_f32_dx(lib, x.float(), emb.float(), bias, labels, lse, g, sm_count(x.device))
        dx = dx.to(x.dtype)
    else:
        w = kernel_width(H)
        args = (lib, pad_width(x, w), pad_width(emb, w), bias, labels, lse, g)
        code, dx = launch_wide_dx(*args) if is_wide(w) else launch_dx(*args, sm_count(x.device))
        dx = dx if w == H else dx[:, :H].contiguous()
    lib.check(code, what)
    _counted(mlm_xent_dx, form)
    return dx


mlm_xent_dx.launches = 0
mlm_xent_dx.forms = {}


def launch_de(lib, x, emb, bias, labels, lse, g):
    """Launch K6 on checked inputs: (the entry point's code, d embedding, d bias)."""
    (N, H), V = x.shape, emb.shape[0]
    de = torch.empty_like(emb)
    db = torch.empty(V, dtype=torch.float32, device=x.device)
    code = getattr(lib, _ENTRY[x.dtype] + "de")(
        x.data_ptr(), emb.data_ptr(), bias.data_ptr(), labels.data_ptr(), lse.data_ptr(), g.data_ptr(), N, V, H,
        de.data_ptr(), db.data_ptr(), _build.stream_ptr(x.device))
    return code, de, db


def launch_f32_de(lib, x, emb, bias, labels, lse, g):
    """Launch K6's fp32 kernel on checked inputs: (the entry point's code, d
    embedding, d bias)."""
    (N, H), V = x.shape, emb.shape[0]
    de = torch.empty_like(emb)
    db = torch.empty(V, dtype=torch.float32, device=x.device)
    code = lib.vb_xent_f32_de(x.data_ptr(), emb.data_ptr(), bias.data_ptr(), labels.data_ptr(), lse.data_ptr(),
                              g.data_ptr(), N, V, H, de.data_ptr(), db.data_ptr(), _build.stream_ptr(x.device))
    return code, de, db


def launch_wide_de(lib, x, emb, bias, labels, lse, g):
    """Launch the wide form's K6 (a cluster a vocabulary block) on checked
    bf16 or fp16 inputs: (the entry point's code, d embedding, d bias)."""
    (N, H), V = x.shape, emb.shape[0]
    wide_clusters(lib, 1, H, x.dtype)
    de = torch.empty_like(emb)
    db = torch.empty(V, dtype=torch.float32, device=x.device)
    code = getattr(lib, _WIDE_ENTRY[x.dtype] + "de")(
        x.data_ptr(), emb.data_ptr(), bias.data_ptr(), labels.data_ptr(), lse.data_ptr(), g.data_ptr(), N, V, H,
        de.data_ptr(), db.data_ptr(), _build.stream_ptr(x.device))
    return code, de, db


def mlm_xent_de(x, emb, bias, labels, lse, g) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6 wrapper: (d embedding [V, H] in the embedding's dtype, d bias [V]
    fp32). Widths are padded as :func:`mlm_xent_fwd`'s, and dE cut back."""
    what = "mlm xent dE (K6)"
    if not _device(x, what):
        return mlm_xent_de_reference(x, emb, bias, labels, lse, g)
    lib = _check_cuda_inputs(what, x, emb, bias, labels, lse, g)
    H = x.shape[1]
    form = xent_form(x.dtype, H)
    if runs_on_f32(x.dtype, H):
        code, de, db = launch_f32_de(lib, x.float(), emb.float(), bias, labels, lse, g)
        de = de.to(emb.dtype)
    else:
        w = kernel_width(H)
        launch = launch_wide_de if is_wide(w) else launch_de
        code, de, db = launch(lib, pad_width(x, w), pad_width(emb, w), bias, labels, lse, g)
        de = de if w == H else de[:, :H].contiguous()
    lib.check(code, what)
    _counted(mlm_xent_de, form)
    return de, db


mlm_xent_de.launches = 0
mlm_xent_de.forms = {}


class _MlmXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, emb, bias, labels):
        nll, lse, am = mlm_xent_fwd(x, emb, bias, labels)
        ctx.save_for_backward(x, emb, bias, labels, lse)
        ctx.mark_non_differentiable(am)
        return nll, am

    @staticmethod
    def backward(ctx, dnll, _):
        x, emb, bias, labels, lse = ctx.saved_tensors
        g = dnll.float().contiguous()
        dx = de = db = None
        if ctx.needs_input_grad[0]:
            dx = mlm_xent_dx(x, emb, bias, labels, lse, g)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            de, db = mlm_xent_de(x, emb, bias, labels, lse, g)
        return dx, de, db, None


class _MlmXentRows(torch.autograd.Function):
    """The op on this model rank's block of the rows; nll and argmax (as
    fp32, exact below 2^24) gathered in one collective, dx gathered, d
    embedding and d bias summed over the model group."""

    @staticmethod
    def forward(ctx, x, emb, bias, labels, mesh):
        n = x.shape[0] // mesh.model_size
        rows = slice(mesh.model_index * n, (mesh.model_index + 1) * n)
        xl, ll = x[rows].contiguous(), labels[rows].contiguous()
        nll, lse, am = mlm_xent_fwd(xl, emb, bias, ll)
        both = gather_slices(torch.stack([nll, am.float()], dim=1), 0, mesh.model_index, mesh.model_size,
                             mesh.model_group)
        ctx.save_for_backward(xl, emb, bias, ll, lse)
        ctx.mesh, ctx.rows = mesh, rows
        am = both[:, 1].to(torch.int32)
        ctx.mark_non_differentiable(am)
        return both[:, 0].contiguous(), am

    @staticmethod
    def backward(ctx, dnll, _):
        xl, emb, bias, ll, lse = ctx.saved_tensors
        mesh = ctx.mesh
        g = dnll[ctx.rows].float().contiguous()
        dx = de = db = None
        if ctx.needs_input_grad[0]:
            dx = gather_slices(mlm_xent_dx(xl, emb, bias, ll, lse, g), 0, mesh.model_index, mesh.model_size,
                               mesh.model_group)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            de, db = mlm_xent_de(xl, emb, bias, ll, lse, g)
            all_reduce(de, mesh.model_group)
            all_reduce(db, mesh.model_group)
        return dx, de, db, None, None


def supports_mesh(n_rows: int, mesh) -> bool:
    """Whether :func:`mlm_xent` can take ``mesh``: this rank's ``n_rows``
    must split evenly over its model group (JAX's predicate, whose global
    rows split over data x model, on the rows a data rank holds)."""
    return mesh is None or mesh.model_size == 1 or n_rows % mesh.model_size == 0


def mlm_xent(x: torch.Tensor, embedding: torch.Tensor, bias: torch.Tensor,
             labels: torch.Tensor, mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row NLL and argmax of the tied-decoder softmax, fused.

    x: [N, H] transformed hidden states (bf16, fp16 or fp32 on the kernel path, any H);
    embedding: [V, H] tied word-embedding table, cast to x's dtype;
    bias: [V] decoder bias, used in fp32; labels: [N] int (-1 entries are
    computed as label 0 and masked by the caller).
    ``mesh``: this rank's (data, model) mesh, ``x`` its rows, replicated
    over the model group; the rows split there (:func:`supports_mesh`).
    Returns (nll [N] fp32, argmax [N] int32); gradients flow to x,
    embedding and bias."""
    if mesh is not None and mesh.model_size > 1:
        assert supports_mesh(x.shape[0], mesh), (x.shape[0], mesh.model_size)
        return _MlmXentRows.apply(x.contiguous(), embedding.to(x.dtype).contiguous(), bias.float().contiguous(),
                                  labels.clamp_min(0).to(torch.int32).contiguous(), mesh)
    return _MlmXent.apply(x.contiguous(), embedding.to(x.dtype).contiguous(), bias.float().contiguous(),
                          labels.clamp_min(0).to(torch.int32).contiguous())
