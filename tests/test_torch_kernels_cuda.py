"""CUDA kernels of visualbert_torch against their plain versions, on the card.

This file imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_cuda.py

(``--noconftest``: the suite's conftest sets up JAX). Every test skips where
``torch.cuda.is_available()`` is false. Tolerances are for bf16 operands:
the kernels round unnormalised probabilities to bf16 before PV where the
plain version rounds normalised ones, and sum in another order, so outputs
agree to a few bf16 ulps (relative error of the max below 2e-2); the fp32
softmax statistics agree to 1e-4; the dropout masks agree exactly.
"""

import numpy as np
import pytest
import torch

from visualbert_torch.ops import flash_attention as fa
from visualbert_torch.ops.dropout import dropout_mask, dropout_mask_reference

pytestmark = pytest.mark.gpu

REL_TOL = 2e-2
STATS_ATOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def rel_err(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-6))


def attention_inputs(B, T, H, device, seed=0):
    rng = np.random.RandomState(seed)
    F = 3 * H * 64
    qkv = torch.tensor(rng.randn(B, T, F), dtype=torch.bfloat16, device=device)
    qb = torch.tensor(rng.randn(F) * 0.1, dtype=torch.bfloat16, device=device)
    mask = np.ones((B, T), np.float32)
    mask[0, T - T // 3:] = 0
    if B > 1:
        mask[1, -1:] = 0
    key_bias = torch.tensor((1.0 - mask) * -10000.0, device=device)
    dout = torch.tensor(rng.randn(B, T, H * 64), dtype=torch.bfloat16, device=device)
    return qkv, qb, key_bias, dout


@pytest.mark.parametrize("shape", [(96, 228, 768), (1001,), (3, 5, 7)])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, torch.float32])
def test_dropout_mask_matches_twin(cuda, shape, dtype):
    got = dropout_mask(shape, 0.1, 1234, dtype, cuda)
    want = dropout_mask_reference(shape, 0.1, 1234, dtype, cuda)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    keep = (got != 0).float().mean().item()
    n = got.numel()
    assert abs(keep - 0.9) <= 4 * np.sqrt(0.09 / n) + 1e-9


def test_dropout_mask_seeds(cuda):
    a = dropout_mask((96, 228, 768), 0.1, 7, torch.int8, cuda)
    b = dropout_mask((96, 228, 768), 0.1, 7, torch.int8, cuda)
    c = dropout_mask((96, 228, 768), 0.1, 8, torch.int8, cuda)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


@pytest.mark.parametrize("B,T,H", [(4, 228, 12), (2, 37, 3), (1, 64, 2), (2, 130, 4)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_attention_kernels_match_plain(cuda, B, T, H, rate):
    qkv, qb, key_bias, dout = attention_inputs(B, T, H, cuda)
    out, stats = fa.packed_attention_fwd(qkv, qb, key_bias, H, rate, 99)
    out_r, stats_r = fa.packed_attention_fwd_reference(qkv, qb, key_bias, H, rate, 99)
    torch.cuda.synchronize()
    assert rel_err(out, out_r) < REL_TOL
    assert float((stats - stats_r).abs().max()) < STATS_ATOL
    # the backward gets the same forward output and stats on both sides
    dqkv, dqb = fa.packed_attention_bwd(qkv, qb, key_bias, dout, out_r, stats_r, H, rate, 99)
    dqkv_r, dqb_r = fa.packed_attention_bwd_reference(qkv, qb, key_bias, dout, out_r, stats_r, H, rate, 99)
    torch.cuda.synchronize()
    assert rel_err(dqkv, dqkv_r) < REL_TOL
    assert rel_err(dqb, dqb_r) < REL_TOL


def test_attention_dropout_changes_output(cuda):
    qkv, qb, key_bias, _ = attention_inputs(2, 100, 2, cuda)
    o0, _ = fa.packed_attention_fwd(qkv, qb, key_bias, 2, 0.0, 5)
    o1, _ = fa.packed_attention_fwd(qkv, qb, key_bias, 2, 0.1, 5)
    o2, _ = fa.packed_attention_fwd(qkv, qb, key_bias, 2, 0.1, 5)
    o3, _ = fa.packed_attention_fwd(qkv, qb, key_bias, 2, 0.1, 6)
    assert torch.equal(o1, o2)
    assert not torch.equal(o0, o1)
    assert not torch.equal(o1, o3)


def test_autograd_through_kernels(cuda):
    qkv, qb, key_bias, dout = attention_inputs(2, 57, 2, cuda)
    x = qkv.clone().requires_grad_(True)
    b = qb.clone().requires_grad_(True)
    fa.flash_attention_packed(x, 2, key_bias, 0.1, 3, qkv_bias=b).backward(dout)
    xr = qkv.clone().requires_grad_(True)
    br = qb.clone().requires_grad_(True)
    fa.flash_attention_packed_reference(xr, 2, key_bias, 0.1, 3, qkv_bias=br).backward(dout)
    assert rel_err(x.grad, xr.grad) < REL_TOL
    assert rel_err(b.grad, br.grad) < REL_TOL


def test_f32_out_decoder_product(cuda):
    from visualbert_torch.models.heads import matmul_f32_out

    rng = np.random.RandomState(1)
    x = torch.tensor(rng.randn(2, 24, 768), dtype=torch.bfloat16, device=cuda, requires_grad=True)
    w = torch.tensor(rng.randn(1000, 768) * 0.02, dtype=torch.float32, device=cuda, requires_grad=True)
    g = torch.tensor(rng.randn(2, 24, 1000), dtype=torch.float32, device=cuda)
    out = matmul_f32_out(x, w)
    assert out.dtype == torch.float32
    out.backward(g)
    xr = x.detach().float().requires_grad_(True)
    wr = w.detach().to(torch.bfloat16).float().requires_grad_(True)
    ref = xr @ wr.t()
    ref.backward(g.to(torch.bfloat16).float())
    assert rel_err(out, ref) < 1e-5
    assert rel_err(x.grad, xr.grad) < REL_TOL
    assert rel_err(w.grad, wr.grad) < REL_TOL


def test_model_step_kernels_match_plain_with_dropout(cuda, monkeypatch):
    """Two layers at bert-base width, dropout on: the train step through the
    kernels and through their plain versions draws the same masks (the
    plain versions are bit-exact twins), so loss and gradients agree."""
    from visualbert_torch.config import VisualBertConfig
    from visualbert_torch.models.visualbert import VisualBertForTask
    from visualbert_torch.ops import dropout as dropout_ops
    from visualbert_torch.tools.synth import synth_batch
    from visualbert_torch.train.trainer import to_device

    cfg = VisualBertConfig.base(use_flash_attention=True, fast_dropout=True, num_hidden_layers=2)
    batch = to_device(synth_batch(4, seed=2), cuda)
    runs = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(fa, "packed_attention_fwd", fa.packed_attention_fwd_reference)
            monkeypatch.setattr(fa, "packed_attention_bwd", fa.packed_attention_bwd_reference)
            monkeypatch.setattr(dropout_ops, "dropout_mask", dropout_ops.dropout_mask_reference)
        model = VisualBertForTask(cfg, "pretraining").init_weights(torch.Generator().manual_seed(0)).to(cuda)
        out = model(batch, torch.Generator().manual_seed(7))
        out["loss"].backward()
        runs.append((float(out["loss"]), {k: p.grad.float() for k, p in model.named_parameters()}))
    (loss_k, grads_k), (loss_p, grads_p) = runs
    assert abs(loss_k - loss_p) <= 1e-2 * abs(loss_p)
    bad = {}
    for k in grads_p:
        if k.endswith("attention.self.key.bias"):
            # identically zero in exact arithmetic (a per-query constant
            # under the softmax); both sides are rounding noise
            assert float(grads_k[k].abs().max()) < 1e-5 and float(grads_p[k].abs().max()) < 1e-5
            continue
        err = rel_err(grads_k[k], grads_p[k])
        if not err < 5e-2:
            bad[k] = err
    assert not bad, bad
