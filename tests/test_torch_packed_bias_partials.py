"""K2's QKV-bias gradient in bf16 and fp16 on the CPU: the wrapper
(``ops/flash_attention.py::launch_packed_x_bwd``) hands the kernels a
partials buffer of ``packed_bias_rows`` rows a batch row (one a 128-row
block of either pass at head dim 128, where several blocks share a (batch
row, head); one a batch row below) and sums its rows in one fixed reduction
(``sum_bias_partials``). Here a stand-in library writes, into that buffer,
the column sums of the plain backward's dqkv over each block's rows, as the
kernels' blocks do, and the wrapper's sum is held against the plain
version's bias gradient."""

import math

import numpy as np
import pytest
import torch

from visualbert_torch.ops import _build
from visualbert_torch.ops import flash_attention as fa

BLOCK_ROWS = 128  # the streamed passes' rows a block (csrc/flash_attention_packed.cu, SB_ROWS)


class BlockPartialsLib:
    """Stands in for the kernel library: ``vb_attn_packed_x_bias_rows`` as
    the source defines it, and a ``vb_attn_packed_x_bwd`` that writes the
    given dqkv [B, T, F] into its dqkv buffer and, into db_part [B, rows,
    F], the fp32 column sums of each row block of it (of BLOCK_ROWS rows at
    head dim 128, the whole batch row below)."""

    def __init__(self, dqkv):
        self.dqkv = dqkv
        self.calls = []

    def vb_attn_packed_x_bias_rows(self, dh, T):
        return math.ceil(T / BLOCK_ROWS) if dh == 128 else 1

    def vb_attn_packed_x_bwd(self, *args):
        self.calls.append(args)
        dqkv_ptr, db_ptr, B, T, dh = args[6], args[7], args[9], args[10], args[19]
        F = self.dqkv.shape[-1]
        rows = self.vb_attn_packed_x_bias_rows(dh, T)
        step = BLOCK_ROWS if dh == 128 else T
        parts = np.stack([self.dqkv.float()[:, r * step:(r + 1) * step].sum(dim=1).numpy() for r in range(rows)],
                         axis=1)
        assert parts.shape == (B, rows, F)
        ctypes_copy(dqkv_ptr, self.dqkv.contiguous())
        ctypes_copy(db_ptr, torch.tensor(np.ascontiguousarray(parts, dtype=np.float32)))
        return 0


def ctypes_copy(ptr, t):
    import ctypes

    ctypes.memmove(ptr, t.data_ptr(), t.numel() * t.element_size())


def plain_backward(B, T, H, D, dtype, rate, seed):
    rng = np.random.RandomState(T + D)
    F = 3 * H * D
    qkv = torch.tensor(rng.randn(B, T, F)).to(dtype)
    qb = torch.tensor(rng.randn(F) * 0.1).to(dtype)
    mask = np.ones((B, T), np.float32)
    mask[0, -3:] = 0
    key_bias = torch.tensor((1.0 - mask) * -10000.0)
    dout = torch.tensor(rng.randn(B, T, H * D)).to(dtype)
    out, stats = fa.packed_attention_fwd_reference(qkv, qb, key_bias, H, rate, seed)
    dqkv, dqb = fa.packed_attention_bwd_reference(qkv, qb, key_bias, dout, out, stats, H, rate, seed)
    return (qkv, qb, key_bias, dout, out, stats), dqkv, dqb


@pytest.mark.parametrize("T,rows", [(1, 1), (128, 1), (129, 2), (228, 2), (1000, 8)])
def test_the_streamed_form_writes_a_row_a_128_row_block(T, rows):
    assert fa.packed_bias_rows(BlockPartialsLib(None), 128, T) == rows
    for dp in (16, 32, 64):  # blocks that walk a whole batch row: no query
        assert fa.packed_bias_rows(None, dp, T) == 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("B,T,H,D,rate", [(2, 228, 2, 128, 0.0), (1, 300, 1, 128, 0.1), (3, 37, 2, 128, 0.0),
                                          (2, 130, 2, 64, 0.1), (2, 45, 3, 32, 0.0)])
def test_the_summed_block_partials_equal_the_plain_bias_gradient(monkeypatch, B, T, H, D, rate, dtype):
    """The wrapper's buffer holds B x packed_bias_rows rows of F = 3 H D;
    the gradient it returns, their sum rounded to the bias's dtype, is the
    plain version's (the same fp32 column sums of the same dqkv, taken in
    another order: within one ulp of the dtype), and the same bits on a
    second call."""
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    args, dqkv_r, dqb_r = plain_backward(B, T, H, D, dtype, rate, 5)
    lib = BlockPartialsLib(dqkv_r)
    code, dqkv, dqb = fa.launch_packed_x_bwd(lib, *args, H, rate, 5, 1, 1, 1.0 / math.sqrt(D))
    assert code == 0 and torch.equal(dqkv, dqkv_r) and dqb.dtype == dtype and dqb.shape == (3 * H * D,)
    eps = torch.finfo(dtype).eps
    torch.testing.assert_close(dqb.float(), dqb_r.float(), rtol=eps, atol=eps * float(dqb_r.float().abs().max()))
    _, _, again = fa.launch_packed_x_bwd(lib, *args, H, rate, 5, 1, 1, 1.0 / math.sqrt(D))
    assert torch.equal(again, dqb)
    (call, _) = lib.calls
    assert call[9:11] == (B, T) and call[19] == D
