"""Dropout from seeded Philox bits (counterpart of
``visualbert_tpu/ops/dropout.py``; reference dropout sites:
pytorch_pretrained_bert/modeling.py:161,279,316).

Three kernels on one Philox body (``csrc/dropout.cu``, design notes and
bounds there). The keep bit of element ``e`` of the flattened tensor is word
``e % 4`` of Philox4x32-10 at counter ``(e / 4, 0, 1)`` under key ``(seed,
0)``, kept when at least :func:`~visualbert_torch.ops.philox.keep_threshold`
(K9's bits too):

* K3, :func:`dropout_mask`, replaces ``visualbert_tpu/ops/dropout.py::_mask_kernel``:
  the keep mask of a shape as int8 ``{0, 1}`` or as a ``{0, 1/(1-rate)}``
  multiplier in a float dtype;
* the site forward, :func:`dropout_fwd`: ``y = x * m`` with ``m = keep ? s :
  0`` and ``s = 1/(1-rate)`` rounded to ``x.dtype``, and the keep bits packed
  one an element (``uint8 [ceil(numel / 8)]``, bit ``k`` of byte ``j`` for
  element ``8 j + k``, the tail padded with zeros);
* the site backward, :func:`dropout_bwd`: ``dx = dy * m`` from those bits.

:func:`fast_dropout` is one site forward and, through :class:`_FastDropout`,
which saves only the bits, one site backward: the JAX package's mask kernel
plus the multiply XLA fuses after it, and ``nn.Dropout``'s gradient. Each
wrapper computes its plain version (``*_reference``: the eager composition
``x * (mask.to(x.dtype) * (1 / (1 - rate)))``, bit for bit) on a CPU
tensor, and on a CUDA tensor launches its kernel or raises. Each launch
works out its grid itself (one group of 16 elements a thread);
``vb_dropout_info`` reports a kernel's registers, spills and blocks an SM.
"""

from __future__ import annotations

import functools

import torch

from visualbert_torch.ops import _build
from visualbert_torch.ops.philox import MASK32, keep_threshold, philox4x32_10

_DTYPE_CODES = {torch.int8: 0, torch.bfloat16: 1, torch.float16: 2, torch.float32: 3}
SITE_DTYPES = (torch.bfloat16, torch.float16, torch.float32)  # what the site kernels take
ALIGNMENT = 16  # bytes: every kernel's tensors start on a 16-byte boundary
MASK, SITE_FWD, SITE_BWD = 0, 1, 2  # kernel numbers of vb_dropout_info


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


def pack_keep(keep: torch.Tensor) -> torch.Tensor:
    """A bool mask of any shape as ``uint8 [ceil(numel / 8)]``: bit ``k`` of
    byte ``j`` is element ``8 j + k`` of the flattened mask, the tail zero."""
    flat = keep.reshape(-1)
    pad = -flat.numel() % 8
    flat = torch.cat([flat, flat.new_zeros(pad)]) if pad else flat
    weights = torch.tensor([1 << k for k in range(8)], dtype=torch.int32, device=keep.device)
    return (flat.reshape(-1, 8).to(torch.int32) * weights).sum(-1).to(torch.uint8)


def unpack_keep(bits: torch.Tensor, n: int) -> torch.Tensor:
    """:func:`pack_keep`'s inverse: the first ``n`` elements, bool ``[n]``."""
    shifts = torch.arange(8, dtype=torch.int32, device=bits.device)
    return ((bits.to(torch.int32)[:, None] >> shifts) & 1).bool().reshape(-1)[:n]


def _multiplier(keep: torch.Tensor, rate: float, dtype: torch.dtype) -> torch.Tensor:
    """``{0, 1} * (1 / (1 - rate))`` in ``dtype``: the eager composition's m."""
    return keep.to(dtype) * (1.0 / (1.0 - rate))


def dropout_fwd_reference(x: torch.Tensor, rate: float, seed: int):
    """Plain version of the site forward: (``x * m`` in x's dtype, the keep
    bits), the eager composition of K3's int8 mask, a cast and two products."""
    keep = dropout_mask_reference(x.shape, rate, seed, torch.int8, x.device)
    return x * _multiplier(keep, rate, x.dtype), pack_keep(keep.bool())


def dropout_bwd_reference(dy: torch.Tensor, bits: torch.Tensor, rate: float) -> torch.Tensor:
    """Plain version of the site backward: ``dy * m`` under the forward's
    keep ``bits``, as autograd multiplies the eager composition's cotangent."""
    keep = unpack_keep(bits, dy.numel()).reshape(dy.shape)
    return dy * _multiplier(keep, rate, dy.dtype)


# ---- kernel wrappers ----


@functools.lru_cache(maxsize=None)
def _keep_args(rate: float):
    """(threshold, 1 / (1 - rate)) of a dropout rate, computed once."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} outside [0, 1)")
    return keep_threshold(rate), 1.0 / (1.0 - rate)


def _on_cuda(x: torch.Tensor, what: str) -> bool:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")
    return x.device.type == "cuda"


def _check_site(what: str, *tensors) -> None:
    x = tensors[0]
    if x.dtype not in SITE_DTYPES:
        raise ValueError(f"{what}: the kernel takes bf16, fp16 or fp32, got {x.dtype}")
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"{what}: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")
        if t.data_ptr() % ALIGNMENT:
            raise ValueError(f"{what}: tensors must be {ALIGNMENT}-byte aligned")


def launch_mask(lib, out: torch.Tensor, rate: float, seed: int) -> int:
    """Launch K3 into ``out`` (checked); returns the entry point's code."""
    code, n = _DTYPE_CODES[out.dtype], out.numel()
    return lib.vb_dropout_mask(out.data_ptr(), n, code, int(seed) & MASK32, *_keep_args(float(rate)),
                               _build.stream_ptr(out.device))


def launch_fwd(lib, x: torch.Tensor, y: torch.Tensor, bits: torch.Tensor, rate: float, seed: int) -> int:
    """Launch the site forward on checked tensors, as :func:`launch_mask`."""
    code, n = _DTYPE_CODES[x.dtype], x.numel()
    return lib.vb_dropout_fwd(x.data_ptr(), y.data_ptr(), bits.data_ptr(), n, code, int(seed) & MASK32,
                              *_keep_args(float(rate)), _build.stream_ptr(x.device))


def launch_bwd(lib, dy: torch.Tensor, bits: torch.Tensor, dx: torch.Tensor, rate: float, seed: int = 0) -> int:
    """Launch the site backward on checked tensors, as :func:`launch_mask`.
    ``seed`` is read only by a build of csrc/dropout.cu with
    -DVB_DROPOUT_REGEN_MASK (tools/dropout_steps.py)."""
    code, n = _DTYPE_CODES[dy.dtype], dy.numel()
    return lib.vb_dropout_bwd(dy.data_ptr(), bits.data_ptr(), dx.data_ptr(), n, code, int(seed) & MASK32,
                              *_keep_args(float(rate)), _build.stream_ptr(dy.device))


def dropout_mask(shape, rate: float, seed: int, dtype: torch.dtype, device) -> torch.Tensor:
    """K3 wrapper: the keep mask of ``shape``, int8 ``{0, 1}`` or ``{0,
    1/(1-rate)}`` in ``dtype``, on ``device`` (no default: the plain version
    runs only where the caller asks for the CPU). ``seed`` is a Python int
    (one per dropout site and step)."""
    what = "dropout mask kernel (K3)"
    device = torch.device(device)
    if device.type == "cpu":
        return dropout_mask_reference(shape, rate, seed, dtype, device)
    if device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {device}")
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"{what}: unsupported dtype {dtype}")
    _keep_args(float(rate))
    lib = _build.library()
    out = torch.empty(tuple(shape), dtype=dtype, device=device)
    if out.data_ptr() % ALIGNMENT:
        raise ValueError(f"{what}: output not {ALIGNMENT}-byte aligned")
    if out.numel() == 0:
        return out
    lib.check(launch_mask(lib, out, rate, seed), what)
    dropout_mask.launches += 1
    return out


dropout_mask.launches = 0


def dropout_fwd(x: torch.Tensor, rate: float, seed: int):
    """Site forward wrapper: (``x * m`` in x's dtype and shape, the keep bits
    ``uint8 [ceil(numel / 8)]``)."""
    what = "dropout site forward (K3 site)"
    if not _on_cuda(x, what):
        return dropout_fwd_reference(x, rate, seed)
    _keep_args(float(rate))
    lib = _build.library()
    _check_site(what, x)
    y = torch.empty_like(x)
    bits = torch.empty(-(-x.numel() // 8), dtype=torch.uint8, device=x.device)
    if x.numel() == 0:
        return y, bits
    lib.check(launch_fwd(lib, x, y, bits, rate, seed), what)
    dropout_fwd.launches += 1
    return y, bits


dropout_fwd.launches = 0


def dropout_bwd(dy: torch.Tensor, bits: torch.Tensor, rate: float) -> torch.Tensor:
    """Site backward wrapper: ``dy * m`` under the forward's keep ``bits``."""
    what = "dropout site backward (K3 site)"
    if not _on_cuda(dy, what):
        return dropout_bwd_reference(dy, bits, rate)
    _keep_args(float(rate))
    lib = _build.library()
    _check_site(what, dy, bits)
    if bits.dtype != torch.uint8 or bits.shape != (-(-dy.numel() // 8),):
        raise ValueError(f"{what}: the keep bits must be [{-(-dy.numel() // 8)}] uint8, as the forward returns them")
    dx = torch.empty_like(dy)
    if dy.numel() == 0:
        return dx
    lib.check(launch_bwd(lib, dy, bits, dx, rate), what)
    dropout_bwd.launches += 1
    return dx


dropout_bwd.launches = 0


class _FastDropout(torch.autograd.Function):
    """The site forward and backward; saves only the keep bits (one bit an
    element) and the rate."""

    @staticmethod
    def forward(ctx, x, rate, seed):
        y, bits = dropout_fwd(x, rate, seed)
        ctx.save_for_backward(bits)
        ctx.rate = rate
        return y

    @staticmethod
    def backward(ctx, dy):
        (bits,) = ctx.saved_tensors
        return dropout_bwd(dy.contiguous(), bits, ctx.rate), None, None


def fast_dropout(x: torch.Tensor, rate: float, seed: int, mesh=None) -> torch.Tensor:
    """Dropout on the mask kernel's bits with ``nn.Dropout``'s gradient
    (``visualbert_tpu/ops/dropout.py:148-161``): ``x * m``, the rescale
    rounded to ``x.dtype`` first as the JAX package does; ``seed`` is a
    Python int, one per site and step. Rate 0 returns ``x`` itself.
    ``mesh``: this rank's (data, model) mesh, ``x`` its rows; the seed is
    offset by the data index only (``Mesh.data_seed``, JAX ``:140``), so
    model peers, whose hidden states are replicated, draw one mask."""
    if rate <= 0.0:
        return x
    if mesh is not None:
        seed = mesh.data_seed(seed)
    return _FastDropout.apply(x.contiguous(), float(rate), int(seed))
