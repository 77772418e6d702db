"""Residual add + LayerNorm (counterpart of
``visualbert_tpu/ops/layer_norm.py::reference_add_layer_norm``).

The JAX package's fused LayerNorm kernels (K7-K10) are off in the configs
this port runs so far; they are listed in ROADMAP.md as still to port.
"""

from __future__ import annotations

import torch


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
