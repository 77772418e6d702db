"""Dropout from a seeded mask kernel (counterpart of
``visualbert_tpu/ops/dropout.py``; reference dropout sites:
pytorch_pretrained_bert/modeling.py:161,279,316).

:func:`dropout_mask` is the wrapper of kernel K3 (``csrc/dropout.cu``,
replacing ``visualbert_tpu/ops/dropout.py::_mask_kernel``): it writes the
keep mask of a shape straight from Philox4x32-10 keyed on the seed, as
int8 ``{0, 1}`` or as a ``{0, 1/(1-rate)}`` multiplier in a float dtype. On a
CPU tensor it computes :func:`dropout_mask_reference`, the bit-exact plain
version; on a CUDA tensor it launches the kernel or raises.

What bounds K3 on the H100 is the mask store (16.8 MB of int8 at
[96, 228, 768]); the kernel makes one Philox call per 4 elements and writes
them with one vector store.
"""

from __future__ import annotations

import torch

from visualbert_torch.ops import _build
from visualbert_torch.ops.philox import MASK32, keep_threshold, philox4x32_10

_DTYPE_CODES = {torch.int8: 0, torch.bfloat16: 1, torch.float16: 2, torch.float32: 3}


def _mask_values(keep: torch.Tensor, rate: float, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.int8:
        return keep.to(torch.int8)
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32).to(dtype)
    return torch.where(keep, scale, torch.zeros((), dtype=dtype)).to(dtype)


def dropout_mask_reference(shape, rate: float, seed: int, dtype=torch.int8, device="cpu") -> torch.Tensor:
    """Plain version of K3: the same Philox bits, in int64 tensor arithmetic."""
    n = 1
    for s in shape:
        n *= int(s)
    q = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    words = philox4x32_10(q & MASK32, q >> 32, 0, 1, int(seed) & MASK32, 0, device=device)
    bits = torch.stack(words, dim=-1).reshape(-1)[:n].reshape(tuple(shape))
    return _mask_values(bits >= keep_threshold(rate), rate, dtype)


def dropout_mask(shape, rate: float, seed: int, dtype=torch.int8, device="cpu") -> torch.Tensor:
    """Keep mask of ``shape``: int8 ``{0, 1}`` or ``{0, 1/(1-rate)}`` in
    ``dtype``. ``seed`` is a Python int (one per dropout site and step)."""
    device = torch.device(device)
    if device.type == "cpu":
        return dropout_mask_reference(shape, rate, seed, dtype, device)
    if device.type != "cuda":
        raise ValueError(f"dropout_mask: unsupported device {device}")
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"dropout_mask: unsupported dtype {dtype}")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout_mask: rate {rate} outside [0, 1)")
    lib = _build.library()
    out = torch.empty(tuple(shape), dtype=dtype, device=device)
    if out.data_ptr() % 16:
        raise ValueError("dropout_mask: output not 16-byte aligned")
    code = lib.vb_dropout_mask(
        out.data_ptr(), out.numel(), _DTYPE_CODES[dtype], int(seed) & MASK32,
        keep_threshold(rate), 1.0 / (1.0 - rate), _build.stream_ptr(device),
    )
    lib.check(code, "dropout mask kernel (K3)")
    dropout_mask.launches += 1
    return out


dropout_mask.launches = 0


def fast_dropout(x: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    """Dropout through the mask kernel, with nn.Dropout's gradient: the mask
    is a constant, so autograd multiplies the cotangent by the same
    ``mask * 1/(1-rate)`` (``visualbert_tpu/ops/dropout.py:148-161``). The
    rescale is rounded to ``x.dtype`` first, as the JAX package does."""
    if rate <= 0.0:
        return x
    mask = dropout_mask(x.shape, rate, seed, torch.int8, x.device)
    return x * (mask.to(x.dtype) * (1.0 / (1.0 - rate)))
