"""Residual add + LayerNorm, with and without dropout (counterpart of
``visualbert_tpu/ops/layer_norm.py``).

:func:`fused_add_layer_norm` is ``LayerNorm(x + res)`` and
:func:`fused_dropout_add_layer_norm` is ``LayerNorm(dropout(x) + res)``, the
epilogue of every transformer sublayer: fp32 statistics (the mean, then the
mean of squared deviations), fp32 ``scale``/``bias``, the result in
``x.dtype``; the backward recomputes ``x + res`` from the saved inputs and the
per-row ``mu``/``rstd``. Dropout scales the kept values by ``1 / (1 - rate)``
in fp32 before the add (not rounded to ``x.dtype``, unlike
``ops/dropout.py::fast_dropout``); its keep mask is K3's (element ``e`` of the
flattened ``[N, H]`` tensor keeps word ``e % 4`` of Philox at counter
``(e / 4, 0, 1)`` under key ``(seed, 0)``), so the plain versions here draw
the kernels' mask bit for bit.

The forward with dropout also returns the mask it drew, packed one bit an
element (:func:`pack_bits`: ``uint8 [N, ceil(H / 8)]``, bit ``k`` of byte
``j`` of a row for its element ``8 j + k``), and the backward takes those bits in place of the
seed: :class:`_DropoutAddLayerNorm` saves them (2.8 MB a call at the main
path's 29,184 x 768) where the JAX package regenerates the mask from the
seed. The function is the same, because the bits are.

Kernels (``csrc/layer_norm.cu``, design notes and bounds there):

* K7, :func:`add_layer_norm_fwd`, replaces ``_fwd_kernel`` (y, mu, rstd);
* K8, :func:`add_layer_norm_bwd`, replaces ``_bwd_kernel`` (dx, dscale, dbias);
* K9, :func:`dropout_add_layer_norm_fwd`, replaces ``_dfwd_kernel`` (and
  writes the keep bits);
* K10, :func:`dropout_add_layer_norm_bwd`, replaces ``_dbwd_kernel`` (dx,
  dres, dscale, dbias from K9's bits).

K8 and K10 are one Hopper kernel: each warp's rows arrive through a ring
of asynchronous row copies in shared memory, and the grid is as many blocks
as fit on the card at once (:func:`bwd_blocks`, from the kernel's occupancy
query ``vb_ln_info``), each writing one fp32 partial row of dscale and dbias
that a second pass sums in a fixed order.

The kernels take every width from 1 to ``vb_ln_geometry(3)`` (4096), each in
the form of its width (:func:`layer_norm_form`): a multiple of 8 up to 1024
on the design above ("warp, 16-byte"); another width up to 1024 a warp a
row with element loads ("warp, element"); wider rows a block of 4 warps a
row ("block, 16-byte" at a multiple of 8, else "block, element"). Only the
16-byte forms need 16-byte aligned tensors. Each wrapper counts its
launches in ``launches`` and, by form, in ``forms``. On CPU tensors the wrappers
compute the plain versions (the ``*_reference`` functions); on CUDA tensors
they launch the kernels or raise. :func:`reference_add_layer_norm` and
:func:`layer_norm_f32` are the unfused path's eager math.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from visualbert_torch.ops import _build
from visualbert_torch.ops.dropout import dropout_mask_reference, pack_keep, unpack_keep
from visualbert_torch.ops.philox import MASK32, keep_threshold

_DTYPE_CODES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}


def layer_norm_f32(x, scale, bias, eps: float = 1e-12):
    """``nn.LayerNorm(dtype=float32)`` on any input dtype: fp32 statistics
    and fp32 result (the embedding and MLM-transform norms; the caller casts)."""
    s = x.float()
    d = s - s.mean(-1, keepdim=True)
    var = (d * d).mean(-1, keepdim=True)
    return d * torch.rsqrt(var + eps) * scale.float() + bias.float()


def reference_add_layer_norm(x, res, scale, bias, eps: float = 1e-12):
    """``LayerNorm(x + res)`` with fp32 statistics, cast back to ``x.dtype``."""
    return layer_norm_f32(x.float() + res.float(), scale, bias, eps).to(x.dtype)


# ---- plain versions (2-D [N, H] inputs, fp32 scale and bias) ----


def keep_mask(shape, rate: float, seed: int, device) -> torch.Tensor:
    """The kernels' keep mask of ``shape`` (bool), K3's bits."""
    return dropout_mask_reference(shape, rate, seed, torch.int8, device).bool()


def pack_bits(keep: torch.Tensor) -> torch.Tensor:
    """A bool ``[N, H]`` mask as ``uint8 [N, ceil(H / 8)]``: bit ``k`` of
    byte ``j`` of a row is its element ``8 j + k``, the bits past H zero, the
    layout K9 writes (the dropout site's, ``ops/dropout.py::pack_keep``, row
    by row, each row padded to a whole byte)."""
    N, H = keep.shape
    pad = -H % 8
    if pad:
        keep = torch.nn.functional.pad(keep, (0, pad))
    return pack_keep(keep).reshape(N, (H + pad) // 8)


def unpack_bits(bits: torch.Tensor, H: Optional[int] = None) -> torch.Tensor:
    """:func:`pack_bits`'s inverse: ``uint8 [N, ceil(H / 8)]`` -> bool
    ``[N, H]`` (H the bytes' 8 bits each unless given)."""
    N, B = bits.shape
    H = 8 * B if H is None else H
    return unpack_keep(bits.reshape(-1), N * 8 * B).reshape(N, 8 * B)[:, :H]


def _keep_prob(rate: float) -> torch.Tensor:
    return torch.tensor(1.0 - rate, dtype=torch.float32)


def _dropped(x, rate: float, seed: int):
    """``where(keep, x / (1 - rate), 0)`` in fp32 and the keep mask."""
    keep = keep_mask(x.shape, rate, seed, x.device)
    return torch.where(keep, x.float() / _keep_prob(rate).to(x.device), 0.0), keep


def _fwd_plain(s, scale, bias, eps, dtype):
    mu = s.mean(-1, keepdim=True)
    d = s - mu
    rstd = torch.rsqrt((d * d).mean(-1, keepdim=True) + eps)
    y = d * rstd * scale.float() + bias.float()
    return y.to(dtype), mu[:, 0], rstd[:, 0]


def _bwd_plain(s, scale, mu, rstd, dy):
    """(ds fp32 [N, H], dscale, dbias) from the recomputed sum ``s``."""
    xhat = (s - mu[:, None]) * rstd[:, None]
    dy = dy.float()
    g = dy * scale.float()
    m1 = g.mean(-1, keepdim=True)
    m2 = (g * xhat).mean(-1, keepdim=True)
    ds = rstd[:, None] * (g - m1 - xhat * m2)
    return ds, (dy * xhat).sum(0), dy.sum(0)


def add_layer_norm_fwd_reference(x, res, scale, bias, eps: float = 1e-12):
    """Plain version of K7: (y [N, H] in x's dtype, mu [N], rstd [N] fp32)."""
    return _fwd_plain(x.float() + res.float(), scale, bias, eps, x.dtype)


def add_layer_norm_bwd_reference(x, res, scale, mu, rstd, dy):
    """Plain version of K8: (dx in x's dtype, dscale, dbias fp32); dx is the
    gradient of both ``x`` and ``res``."""
    ds, dscale, dbias = _bwd_plain(x.float() + res.float(), scale, mu, rstd, dy)
    return ds.to(x.dtype), dscale, dbias


def dropout_add_layer_norm_fwd_reference(x, res, scale, bias, rate: float, seed: int, eps: float = 1e-12):
    """Plain version of K9: (y, mu, rstd, bits) of ``LN(where(keep, x / (1 -
    rate), 0) + res)``, with the keep mask packed by :func:`pack_bits`."""
    xd, keep = _dropped(x, rate, seed)
    return _fwd_plain(xd + res.float(), scale, bias, eps, x.dtype) + (pack_bits(keep),)


def dropout_add_layer_norm_bwd_reference(x, res, scale, mu, rstd, dy, bits, rate: float):
    """Plain version of K10: (dx, dres, dscale, dbias) with ``dres = ds`` and
    ``dx = where(keep, ds / (1 - rate), 0)`` under the forward's mask, read
    from its packed ``bits``."""
    keep = unpack_bits(bits, x.shape[1])
    xd = torch.where(keep, x.float() / _keep_prob(rate).to(x.device), 0.0)
    ds, dscale, dbias = _bwd_plain(xd + res.float(), scale, mu, rstd, dy)
    dx = torch.where(keep, ds / _keep_prob(rate).to(x.device), 0.0)
    return dx.to(x.dtype), ds.to(res.dtype), dscale, dbias


# ---- kernel wrappers ----


def _on_cuda(x, what) -> bool:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")
    return x.device.type == "cuda"


def bits_width(H: int) -> int:
    """Bytes of a row of K9's keep bits: ceil(H / 8)."""
    return -(-H // 8)


def layer_norm_form(dtype, H: int, warp_width: int = 1024) -> str:
    """The kernel form K7-K10 run rows of width H in ``dtype`` on: "<dtype>
    warp, 16-byte" (H a multiple of 8 up to ``warp_width``, the widest row a
    warp owns: ``vb_ln_geometry(0)``), "<dtype> warp, element", "<dtype>
    block, 16-byte" or "<dtype> block, element"."""
    dt = {torch.bfloat16: "bf16", torch.float16: "fp16", torch.float32: "fp32"}[dtype]
    return f"{dt} {'warp' if H <= warp_width else 'block'}, {'element' if H % 8 else '16-byte'}"


def _check_cuda_inputs(what, x, res, scale, *others):
    """Raise on what the kernels do not take; returns the library. Rows
    that are a multiple of 8 wide run a 16-byte form, which needs 16-byte
    aligned tensors; the other widths' forms load element by element."""
    lib = _build.library()
    if x.dim() != 2:
        raise ValueError(f"{what}: the kernel takes [N, H] rows, got {tuple(x.shape)}")
    N, H = x.shape
    if x.dtype not in _DTYPE_CODES or res.dtype != x.dtype:
        raise ValueError(f"{what}: the kernel takes x and res of one dtype among bf16, fp16, fp32, "
                         f"got {x.dtype}, {res.dtype}")
    if not 1 <= H <= lib.vb_ln_geometry(3) or res.shape != x.shape:
        raise ValueError(f"{what}: the kernel takes [N, H] rows with H up to {lib.vb_ln_geometry(3)}, got x "
                         f"{tuple(x.shape)}, res {tuple(res.shape)}")
    if scale.shape != (H,) or scale.dtype != torch.float32:
        raise ValueError(f"{what}: scale and bias must be [{H}] float32")
    for t in (x, res, scale) + others:
        if t.device != x.device:
            raise ValueError(f"{what}: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")
        if H % 8 == 0 and t.data_ptr() % 16:
            raise ValueError(f"{what}: tensors must be 16-byte aligned (the 16-byte form of width {H})")
    return lib


def _check_fwd(what, x, res, scale, bias):
    lib = _check_cuda_inputs(what, x, res, scale, bias)
    if bias.shape != scale.shape or bias.dtype != torch.float32:
        raise ValueError(f"{what}: scale and bias must be [{x.shape[1]}] float32")
    return lib


def _check_bwd(what, x, res, scale, mu, rstd, dy, *bits):
    lib = _check_cuda_inputs(what, x, res, scale, mu, rstd, dy, *bits)
    N, H = x.shape
    if mu.shape != (N,) or rstd.shape != (N,) or mu.dtype != torch.float32 or rstd.dtype != torch.float32:
        raise ValueError(f"{what}: mu and rstd must be [{N}] float32")
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"{what}: dy must be [{N}, {H}] {x.dtype}")
    if bits and (bits[0].shape != (N, bits_width(H)) or bits[0].dtype != torch.uint8):
        raise ValueError(f"{what}: the keep bits must be [{N}, {bits_width(H)}] uint8, as the forward returns them")
    return lib


@functools.lru_cache(maxsize=None)
def _keep_args(rate: float):
    """(threshold, keep probability in fp32) of a dropout rate: a pure
    function of the rate, computed once (the wrappers' host time is of the
    order of K9's and K10's device time)."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} outside [0, 1)")
    return keep_threshold(rate), float(_keep_prob(rate))


def _dropout_args(rate: float, seed: int):
    """(seed, threshold, keep probability) as the entry points take them."""
    return (int(seed) & MASK32,) + _keep_args(float(rate))


@functools.lru_cache(maxsize=None)
def _bwd_geometry(lib, kernel: int, H: int, code: int):
    """(rows a block, blocks an SM) of K8 (kernel 8) or K10 at width H in
    dtype ``code``: a warp a row up to the widest row a warp owns, else a
    block a row; fixed for a library and a card, so queried once."""
    rows = lib.vb_ln_geometry(1) if H <= lib.vb_ln_geometry(0) else 1
    return rows, lib.vb_ln_info(kernel, 3, H, code)


def launch_fwd(lib, x, res, scale, bias, eps: float, dropout: bool, rate: float = 0.0, seed: int = 0):
    """Launch K7 (``dropout`` false) or K9 on checked inputs: (the entry
    point's code, y, mu, rstd, and K9's keep bits or None). K9 runs at rate
    0 too, keeping every element."""
    N, H = x.shape
    y = torch.empty_like(x)
    mu = torch.empty(N, dtype=torch.float32, device=x.device)
    rstd = torch.empty(N, dtype=torch.float32, device=x.device)
    bits = torch.empty((N, bits_width(H)), dtype=torch.uint8, device=x.device) if dropout else None
    code = lib.vb_ln_fwd(x.data_ptr(), res.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
                         mu.data_ptr(), rstd.data_ptr(), None if bits is None else bits.data_ptr(), N, H,
                         _DTYPE_CODES[x.dtype], float(eps), int(dropout), *_dropout_args(rate, seed),
                         _build.stream_ptr(x.device))
    return code, y, mu, rstd, bits


def bwd_blocks(N: int, rows: int, per_sm: int, sms: int) -> int:
    """The backward's grid: the blocks that fit on the card at once
    (``per_sm`` from the kernel's occupancy query, times the SMs), and no
    more than one for every ``rows`` rows (a block's warps)."""
    if per_sm < 1:
        raise RuntimeError(f"LayerNorm backward: the occupancy query answered {per_sm} blocks an SM")
    return max(1, min(per_sm * sms, -(-N // rows)))


def launch_bwd(lib, x, res, scale, mu, rstd, dy, bits, rate: float, sms: int, seed: int = 0):
    """Launch K10 (``bits`` from K9) or K8 (``bits`` None: no dropout, dx
    only) on checked inputs: (the entry point's code, dx, dres or None,
    dscale, dbias). ``seed`` is read only by a build of csrc/layer_norm.cu
    with -DVB_LN_REGEN_MASK (tools/ln_steps.py)."""
    N, H = x.shape
    dropout, code = bits is not None, _DTYPE_CODES[x.dtype]
    blocks = bwd_blocks(N, *_bwd_geometry(lib, 10 if dropout else 8, H, code), sms)
    dx = torch.empty_like(x)
    dres = torch.empty_like(res) if dropout else None
    part = torch.empty((blocks, 2, H), dtype=torch.float32, device=x.device)
    dscale = torch.empty(H, dtype=torch.float32, device=x.device)
    dbias = torch.empty(H, dtype=torch.float32, device=x.device)
    err = lib.vb_ln_bwd(x.data_ptr(), res.data_ptr(), scale.data_ptr(), mu.data_ptr(), rstd.data_ptr(),
                        dy.data_ptr(), None if bits is None else bits.data_ptr(), dx.data_ptr(),
                        None if dres is None else dres.data_ptr(), part.data_ptr(), dscale.data_ptr(),
                        dbias.data_ptr(), N, H, blocks, code, int(dropout), *_dropout_args(rate, seed),
                        _build.stream_ptr(x.device))
    return err, dx, dres, dscale, dbias


@functools.lru_cache(maxsize=None)
def _form(lib, dtype, H: int) -> str:
    return layer_norm_form(dtype, H, lib.vb_ln_geometry(0))


def _counted(fn, lib, x) -> None:
    fn.launches += 1
    form = _form(lib, x.dtype, x.shape[1])
    fn.forms[form] = fn.forms.get(form, 0) + 1


def add_layer_norm_fwd(x, res, scale, bias, eps: float = 1e-12) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K7 wrapper: (y [N, H] in x's dtype, mu [N], rstd [N] fp32)."""
    what = "add + LayerNorm forward (K7)"
    if not _on_cuda(x, what):
        return add_layer_norm_fwd_reference(x, res, scale, bias, eps)
    lib = _check_fwd(what, x, res, scale, bias)
    code, y, mu, rstd, _ = launch_fwd(lib, x, res, scale, bias, eps, False)
    lib.check(code, what)
    _counted(add_layer_norm_fwd, lib, x)
    return y, mu, rstd


add_layer_norm_fwd.launches = 0
add_layer_norm_fwd.forms = {}


def add_layer_norm_bwd(x, res, scale, mu, rstd, dy) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K8 wrapper: (dx, dscale, dbias); dx is the gradient of x and of res."""
    what = "add + LayerNorm backward (K8)"
    if not _on_cuda(x, what):
        return add_layer_norm_bwd_reference(x, res, scale, mu, rstd, dy)
    lib = _check_bwd(what, x, res, scale, mu, rstd, dy)
    code, dx, _, dscale, dbias = launch_bwd(lib, x, res, scale, mu, rstd, dy, None, 0.0, _build.sm_count(x.device))
    lib.check(code, what)
    _counted(add_layer_norm_bwd, lib, x)
    return dx, dscale, dbias


add_layer_norm_bwd.launches = 0
add_layer_norm_bwd.forms = {}


def dropout_add_layer_norm_fwd(x, res, scale, bias, rate: float, seed: int, eps: float = 1e-12):
    """K9 wrapper: (y, mu, rstd, keep bits [N, ceil(H / 8)] uint8) of
    ``LN(dropout(x) + res)``."""
    what = "dropout + add + LayerNorm forward (K9)"
    if not _on_cuda(x, what):
        return dropout_add_layer_norm_fwd_reference(x, res, scale, bias, rate, seed, eps)
    lib = _check_fwd(what, x, res, scale, bias)
    code, y, mu, rstd, bits = launch_fwd(lib, x, res, scale, bias, eps, True, rate, seed)
    lib.check(code, what)
    _counted(dropout_add_layer_norm_fwd, lib, x)
    return y, mu, rstd, bits


dropout_add_layer_norm_fwd.launches = 0
dropout_add_layer_norm_fwd.forms = {}


def dropout_add_layer_norm_bwd(x, res, scale, mu, rstd, dy, bits, rate: float):
    """K10 wrapper: (dx, dres, dscale, dbias) under the mask of K9's ``bits``."""
    what = "dropout + add + LayerNorm backward (K10)"
    if not _on_cuda(x, what):
        return dropout_add_layer_norm_bwd_reference(x, res, scale, mu, rstd, dy, bits, rate)
    lib = _check_bwd(what, x, res, scale, mu, rstd, dy, bits)
    code, *out = launch_bwd(lib, x, res, scale, mu, rstd, dy, bits, rate, _build.sm_count(x.device))
    lib.check(code, what)
    _counted(dropout_add_layer_norm_bwd, lib, x)
    return tuple(out)


dropout_add_layer_norm_bwd.launches = 0
dropout_add_layer_norm_bwd.forms = {}


# ---- autograd ----


class _AddLayerNorm(torch.autograd.Function):
    """K7 forward, K8 backward (JAX ``_fused_fwd``/``_fused_bwd``)."""

    @staticmethod
    def forward(ctx, x, res, scale, bias, eps):
        y, mu, rstd = add_layer_norm_fwd(x, res, scale, bias, eps)
        ctx.save_for_backward(x, res, scale, mu, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, res, scale, mu, rstd = ctx.saved_tensors
        dx, dscale, dbias = add_layer_norm_bwd(x, res, scale, mu, rstd, dy.contiguous())
        return dx, dx, dscale, dbias, None


class _DropoutAddLayerNorm(torch.autograd.Function):
    """K9 forward, K10 backward (JAX ``_dfused_fwd``/``_dfused_bwd``): the
    forward's keep bits are saved for the backward."""

    @staticmethod
    def forward(ctx, x, res, scale, bias, seed, rate, eps):
        y, mu, rstd, bits = dropout_add_layer_norm_fwd(x, res, scale, bias, rate, seed, eps)
        ctx.save_for_backward(x, res, scale, mu, rstd, bits)
        ctx.rate = rate
        return y

    @staticmethod
    def backward(ctx, dy):
        x, res, scale, mu, rstd, bits = ctx.saved_tensors
        dx, dres, dscale, dbias = dropout_add_layer_norm_bwd(x, res, scale, mu, rstd, dy.contiguous(), bits, ctx.rate)
        return dx, dres, dscale, dbias, None, None, None


def _rows(x, res, scale, bias):
    H = x.shape[-1]
    return (x.reshape(-1, H).contiguous(), res.to(x.dtype).reshape(-1, H).contiguous(),
            scale.float().contiguous(), bias.float().contiguous())


def fused_add_layer_norm(x, res, scale, bias, eps: float = 1e-12) -> torch.Tensor:
    """``LayerNorm(x + res)`` over the last axis (K7 forward, K8 backward);
    the result has ``x``'s shape and dtype."""
    return _AddLayerNorm.apply(*_rows(x, res, scale, bias), eps).view(x.shape)


def fused_dropout_add_layer_norm(x, res, scale, bias, seed: Optional[int], rate: float,
                                 eps: float = 1e-12) -> torch.Tensor:
    """``LayerNorm(dropout(x) + res)`` (K9 forward, K10 backward); ``seed`` is
    a Python int, one per call site and step."""
    if rate > 0.0 and seed is None:
        raise ValueError("fused_dropout_add_layer_norm: dropout needs a seed")
    return _DropoutAddLayerNorm.apply(*_rows(x, res, scale, bias), int(seed or 0), float(rate), eps).view(x.shape)
