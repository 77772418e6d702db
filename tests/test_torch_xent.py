"""The port's fused MLM cross-entropy (visualbert_torch/ops/mlm_xent.py) on
the CPU against the JAX package.

On CPU tensors the op runs its plain versions, the math of kernels K4-K6.
The forward is held against ``visualbert_tpu.ops.mlm_xent.mlm_xent``, whose
Pallas kernel runs in interpret mode here. The JAX op's custom VJP cannot be
differentiated (ROADMAP.md C1), so the backward is held against the JAX
backward kernels called directly (``_bwd_impl``, interpret mode) with the
``lse`` of ``_fwd_impl``. Tolerances: fp32 operands atol 1e-5 (the two sum
the same fp32 products in another order); bf16 operands as stated at the
test. The CUDA kernels are tested on the card (tests/test_torch_kernels_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualbert_tpu.ops import mlm_xent as jax_xent
from visualbert_torch.ops import mlm_xent as xe

ATOL = 1e-5


def inputs(seed, N, H, V, tie=False):
    """x, embedding, bias, labels (about 15 % -1) and a non-uniform g (0 on
    the -1 rows, as the model's masked mean gives)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(N, H).astype(np.float32)
    emb = (rng.randn(V, H) * 0.1).astype(np.float32)
    bias = (rng.randn(V) * 0.1).astype(np.float32)
    labels = rng.randint(0, V, N).astype(np.int32)
    labels[rng.rand(N) < 0.15] = -1
    labels[0] = -1
    if tie:
        # rows 3 and V-2 of the table are equal and far ahead of every
        # other logit of row 1: an exact tie, the lower index must win
        emb[3] = emb[V - 2] = x[1] * 0.5
        bias[3] = bias[V - 2] = 0.25
    g = np.where(labels >= 0, rng.uniform(0.5, 1.5, N), 0.0).astype(np.float32)
    return x, emb, bias, labels, g


@pytest.mark.parametrize("N,H,V,tie", [(37, 32, 300, True), (8, 64, 1283, False), (300, 48, 2601, True)])
def test_forward_matches_jax(N, H, V, tie):
    x, emb, bias, labels, _ = inputs(N, N, H, V, tie)
    nll_j, am_j = jax.jit(jax_xent.mlm_xent)(jnp.asarray(x), jnp.asarray(emb), jnp.asarray(bias),
                                              jnp.asarray(labels))
    nll, am = xe.mlm_xent(torch.tensor(x), torch.tensor(emb), torch.tensor(bias), torch.tensor(labels).long())
    assert nll.dtype == torch.float32 and am.dtype == torch.int32
    np.testing.assert_allclose(nll.numpy(), np.asarray(nll_j), atol=ATOL, rtol=ATOL)
    np.testing.assert_array_equal(am.numpy(), np.asarray(am_j))
    if tie:
        assert am[1] == 3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_matches_jax_bwd_kernels(dtype):
    """dx, d embedding and d bias of the plain versions of K5/K6 against the
    JAX backward kernels. bf16: dx and d embedding are bf16 on both sides
    and may round one ulp apart (rtol 8e-3 of the value, atol 1e-2 of the
    largest entry); d bias is fp32 (atol 1e-5)."""
    N, H, V = 48, 64, 640  # the JAX kernels take unpadded multiples of their blocks here
    x, emb, bias, labels, g = inputs(7, N, H, V)
    jd = jnp.dtype(dtype)
    xj, ej = jnp.asarray(x, jd), jnp.asarray(emb, jd)
    lab = jnp.asarray(np.maximum(labels, 0).reshape(N, 1))
    _, lse_j, _ = jax_xent._fwd_impl(xj, ej, jnp.asarray(bias).reshape(1, V), lab, nb=16, vbk=128)
    dx_j, de_j, db_j = jax_xent._bwd_impl(xj, ej, jnp.asarray(bias).reshape(1, V), lab, lse_j,
                                          jnp.asarray(g).reshape(N, 1), nb=16, vbk_dx=128, vbk_de=128)
    de_j = de_j.astype(jd)  # as the JAX op returns it (mlm_xent.py:306)

    td = getattr(torch, dtype)
    xt, et = torch.tensor(x).to(td), torch.tensor(emb).to(td)
    bt, lt = torch.tensor(bias), torch.tensor(np.maximum(labels, 0))
    lse = torch.tensor(np.asarray(lse_j)[:, 0])
    dx = xe.mlm_xent_dx(xt, et, bt, lt, lse, torch.tensor(g))
    de, db = xe.mlm_xent_de(xt, et, bt, lt, lse, torch.tensor(g))
    assert dx.dtype == td and de.dtype == td and db.dtype == torch.float32
    for got, want in ((dx, dx_j), (de, de_j)):
        got, want = got.float().numpy(), np.asarray(want, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)
        else:
            np.testing.assert_allclose(got, want, rtol=8e-3, atol=1e-2 * np.abs(want).max())
    np.testing.assert_allclose(db.numpy(), np.asarray(db_j)[0], atol=ATOL, rtol=ATOL)


def test_autograd_matches_the_plain_backward():
    """Gradients through ``mlm_xent`` (the autograd.Function, fp32) equal the
    plain K5/K6 with g = the cotangent of nll: dx, and d embedding through
    the cast into the parameter, d bias; the argmax has no gradient."""
    N, H, V = 40, 32, 500
    x, emb, bias, labels, g = inputs(3, N, H, V)
    xt = torch.tensor(x, requires_grad=True)
    et = torch.tensor(emb, requires_grad=True)
    bt = torch.tensor(bias, requires_grad=True)
    nll, am = xe.mlm_xent(xt, et, bt, torch.tensor(labels).long())
    assert not am.requires_grad
    (nll * torch.tensor(g)).sum().backward()
    lab = torch.tensor(np.maximum(labels, 0))
    _, lse, _ = xe.mlm_xent_fwd_reference(xt.detach(), et.detach(), bt.detach(), lab)
    de, db = xe.mlm_xent_de(xt.detach(), et.detach(), bt.detach(), lab, lse, torch.tensor(g))
    torch.testing.assert_close(xt.grad, xe.mlm_xent_dx(xt.detach(), et.detach(), bt.detach(), lab, lse,
                                                       torch.tensor(g)), rtol=0, atol=0)
    torch.testing.assert_close(et.grad, de, rtol=0, atol=0)
    torch.testing.assert_close(bt.grad, db, rtol=0, atol=0)
