"""Philox4x32-10 in plain PyTorch: the bit-exact twin of ``csrc/philox.cuh``.

Integer tensors are int64 holding uint32 values; the 32x32 -> 64-bit
products are split into 16-bit limbs so no intermediate exceeds 2^49 and
nothing relies on signed overflow. The plain versions of the dropout and
attention kernels draw their masks from here, so a kernel and its plain
version can be compared with dropout on, mask for mask.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85

Word = Union[int, torch.Tensor]


def _mulhilo(m: int, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    a = (m & 0xFFFF) * x  # < 2^48
    b = (m >> 16) * x     # < 2^48
    lo = (a + ((b & 0xFFFF) << 16)) & MASK32
    hi = (b + (a >> 16)) >> 16
    return hi, lo


def philox4x32_10(c0: Word, c1: Word, c2: Word, c3: Word, k0: Word, k1: Word, device=None):
    """Four uint32 words (as int64 tensors) of Philox4x32-10 at counter
    (c0, c1, c2, c3) under key (k0, k1); arguments broadcast."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64, device=device) for c in (c0, c1, c2, c3))
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _W0) & MASK32
        k1 = (k1 + _W1) & MASK32
    return c0, c1, c2, c3


def keep_threshold(rate: float) -> int:
    """uint32 threshold: keep = bits >= threshold (the JAX package's rule)."""
    return min(int(rate * 2**32), 2**32 - 1)
