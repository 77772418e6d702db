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

Kernels (``csrc/layer_norm.cu``, design notes and bounds there):

* K7, :func:`add_layer_norm_fwd`, replaces ``_fwd_kernel`` (y, mu, rstd);
* K8, :func:`add_layer_norm_bwd`, replaces ``_bwd_kernel`` (dx, dscale, dbias);
* K9, :func:`dropout_add_layer_norm_fwd`, replaces ``_dfwd_kernel``;
* K10, :func:`dropout_add_layer_norm_bwd`, replaces ``_dbwd_kernel`` (dx,
  dres, dscale, dbias).

On CPU tensors the wrappers compute the plain versions (the ``*_reference``
functions); on CUDA tensors they launch the kernels or raise.
:func:`reference_add_layer_norm` and :func:`layer_norm_f32` are the unfused
path's eager math.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from visualbert_torch.ops import _build
from visualbert_torch.ops.dropout import dropout_mask_reference
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
    """Plain version of K9: (y, mu, rstd) of ``LN(where(keep, x / (1 - rate), 0) + res)``."""
    xd, _ = _dropped(x, rate, seed)
    return _fwd_plain(xd + res.float(), scale, bias, eps, x.dtype)


def dropout_add_layer_norm_bwd_reference(x, res, scale, mu, rstd, dy, rate: float, seed: int):
    """Plain version of K10: (dx, dres, dscale, dbias) with ``dres = ds`` and
    ``dx = where(keep, ds / (1 - rate), 0)`` under the forward's mask."""
    xd, keep = _dropped(x, rate, seed)
    ds, dscale, dbias = _bwd_plain(xd + res.float(), scale, mu, rstd, dy)
    dx = torch.where(keep, ds / _keep_prob(rate).to(x.device), 0.0)
    return dx.to(x.dtype), ds.to(res.dtype), dscale, dbias


# ---- kernel wrappers ----


def _on_cuda(x, what) -> bool:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")
    return x.device.type == "cuda"


def _check_cuda_inputs(what, x, res, scale, *others):
    """Raise on what the kernels do not take; returns (library, dtype code)."""
    lib = _build.library()
    if x.dim() != 2:
        raise ValueError(f"{what}: the kernel takes [N, H] rows, got {tuple(x.shape)}")
    N, H = x.shape
    if x.dtype not in _DTYPE_CODES or res.dtype != x.dtype:
        raise ValueError(f"{what}: the kernel takes x and res of one dtype among bf16, fp16, fp32, "
                         f"got {x.dtype}, {res.dtype}")
    if H % 8 or H > lib.vb_ln_geometry(0) or res.shape != x.shape:
        raise ValueError(f"{what}: the kernel takes [N, H] rows with H a multiple of 8 up to "
                         f"{lib.vb_ln_geometry(0)}, got x {tuple(x.shape)}, res {tuple(res.shape)}")
    if scale.shape != (H,) or scale.dtype != torch.float32:
        raise ValueError(f"{what}: scale and bias must be [{H}] float32")
    for t in (x, res, scale) + others:
        if t.device != x.device:
            raise ValueError(f"{what}: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: tensors must be 16-byte aligned")
    return lib, _DTYPE_CODES[x.dtype]


def _dropout_args(rate: float, seed: int):
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} outside [0, 1)")
    return int(rate > 0.0), int(seed) & MASK32, keep_threshold(rate), float(_keep_prob(rate))


def _fwd(what, x, res, scale, bias, eps, rate, seed):
    lib, code = _check_cuda_inputs(what, x, res, scale, bias)
    if bias.shape != scale.shape or bias.dtype != torch.float32:
        raise ValueError(f"{what}: scale and bias must be [{x.shape[1]}] float32")
    N, H = x.shape
    y = torch.empty_like(x)
    mu = torch.empty(N, dtype=torch.float32, device=x.device)
    rstd = torch.empty(N, dtype=torch.float32, device=x.device)
    err = lib.vb_ln_fwd(x.data_ptr(), res.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
                        mu.data_ptr(), rstd.data_ptr(), N, H, code, float(eps), *_dropout_args(rate, seed),
                        _build.stream_ptr(x.device))
    lib.check(err, what)
    return y, mu, rstd


def _bwd(what, x, res, scale, mu, rstd, dy, rate, seed, with_dres):
    lib, code = _check_cuda_inputs(what, x, res, scale, mu, rstd, dy)
    N, H = x.shape
    if mu.shape != (N,) or rstd.shape != (N,) or mu.dtype != torch.float32 or rstd.dtype != torch.float32:
        raise ValueError(f"{what}: mu and rstd must be [{N}] float32")
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"{what}: dy must be [{N}, {H}] {x.dtype}")
    # as many blocks per SM as the kernel's launch bounds keep resident
    per_sm, rows = lib.vb_ln_geometry(2), lib.vb_ln_geometry(1)
    blocks = max(1, min(per_sm * torch.cuda.get_device_properties(x.device).multi_processor_count, -(-N // rows)))
    dx = torch.empty_like(x)
    dres = torch.empty_like(res) if with_dres else None
    part = torch.empty((blocks, 2, H), dtype=torch.float32, device=x.device)
    dscale = torch.empty(H, dtype=torch.float32, device=x.device)
    dbias = torch.empty(H, dtype=torch.float32, device=x.device)
    err = lib.vb_ln_bwd(x.data_ptr(), res.data_ptr(), scale.data_ptr(), mu.data_ptr(), rstd.data_ptr(),
                        dy.data_ptr(), dx.data_ptr(), None if dres is None else dres.data_ptr(), part.data_ptr(),
                        dscale.data_ptr(), dbias.data_ptr(), N, H, blocks, code, *_dropout_args(rate, seed),
                        _build.stream_ptr(x.device))
    lib.check(err, what)
    return dx, dres, dscale, dbias


def add_layer_norm_fwd(x, res, scale, bias, eps: float = 1e-12) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K7 wrapper: (y [N, H] in x's dtype, mu [N], rstd [N] fp32)."""
    what = "add + LayerNorm forward (K7)"
    if not _on_cuda(x, what):
        return add_layer_norm_fwd_reference(x, res, scale, bias, eps)
    out = _fwd(what, x, res, scale, bias, eps, 0.0, 0)
    add_layer_norm_fwd.launches += 1
    return out


add_layer_norm_fwd.launches = 0


def add_layer_norm_bwd(x, res, scale, mu, rstd, dy) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K8 wrapper: (dx, dscale, dbias); dx is the gradient of x and of res."""
    what = "add + LayerNorm backward (K8)"
    if not _on_cuda(x, what):
        return add_layer_norm_bwd_reference(x, res, scale, mu, rstd, dy)
    dx, _, dscale, dbias = _bwd(what, x, res, scale, mu, rstd, dy, 0.0, 0, with_dres=False)
    add_layer_norm_bwd.launches += 1
    return dx, dscale, dbias


add_layer_norm_bwd.launches = 0


def dropout_add_layer_norm_fwd(x, res, scale, bias, rate: float, seed: int,
                               eps: float = 1e-12) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K9 wrapper: (y, mu, rstd) of ``LN(dropout(x) + res)``."""
    what = "dropout + add + LayerNorm forward (K9)"
    if not _on_cuda(x, what):
        return dropout_add_layer_norm_fwd_reference(x, res, scale, bias, rate, seed, eps)
    out = _fwd(what, x, res, scale, bias, eps, rate, seed)
    dropout_add_layer_norm_fwd.launches += 1
    return out


dropout_add_layer_norm_fwd.launches = 0


def dropout_add_layer_norm_bwd(x, res, scale, mu, rstd, dy, rate: float, seed: int):
    """K10 wrapper: (dx, dres, dscale, dbias), the mask regenerated from ``seed``."""
    what = "dropout + add + LayerNorm backward (K10)"
    if not _on_cuda(x, what):
        return dropout_add_layer_norm_bwd_reference(x, res, scale, mu, rstd, dy, rate, seed)
    out = _bwd(what, x, res, scale, mu, rstd, dy, rate, seed, with_dres=True)
    dropout_add_layer_norm_bwd.launches += 1
    return out


dropout_add_layer_norm_bwd.launches = 0


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
    """K9 forward, K10 backward (JAX ``_dfused_fwd``/``_dfused_bwd``)."""

    @staticmethod
    def forward(ctx, x, res, scale, bias, seed, rate, eps):
        y, mu, rstd = dropout_add_layer_norm_fwd(x, res, scale, bias, rate, seed, eps)
        ctx.save_for_backward(x, res, scale, mu, rstd)
        ctx.args = (rate, seed)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, res, scale, mu, rstd = ctx.saved_tensors
        dx, dres, dscale, dbias = dropout_add_layer_norm_bwd(x, res, scale, mu, rstd, dy.contiguous(), *ctx.args)
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
