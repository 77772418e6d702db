"""visualbert_torch.ops.layer_norm (K7-K10's plain versions, what the port
runs on CPU tensors) against ``visualbert_tpu.ops.layer_norm``, whose Pallas
kernels run in interpret mode here.

Tolerances: fp32 atol 1e-5 forward and 2e-4 / rtol 1e-3 for gradients, as
``tests/test_layer_norm.py`` holds the JAX kernel to its XLA reference. In
bf16 both sides compute the same fp32 values and round once to bf16, so y,
dx and dres may differ by one bf16 ulp where the fp32 values straddle a
rounding boundary (atol 1/64, one ulp at |v| < 4); dscale and dbias are fp32
sums and keep the fp32 bar. With dropout the JAX kernel draws other bits, so
the port at rate 0.1 is held to ``jax.vjp`` of the JAX reference applied to
``where(M, x / (1 - rate), 0)`` with the port's own mask ``M``, and the mask
is checked by its keep rate and its reproducibility.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualbert_tpu.ops.layer_norm import fused_add_layer_norm as jax_fused
from visualbert_tpu.ops.layer_norm import fused_dropout_add_layer_norm as jax_dfused
from visualbert_tpu.ops.layer_norm import reference_add_layer_norm as jax_reference
from visualbert_torch.ops import layer_norm as ln
from visualbert_torch.ops.dropout import dropout_mask_reference

FWD_ATOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 2e-4, 1e-3
BF16_ATOL = 1.0 / 64
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SHAPES = [(24, 64), (2, 8, 64), (13, 32)]  # 2-D, 3-D, N not a multiple of 8


def inputs(rng, shape, dtype):
    """x, res, dy in ``dtype`` (rounded once, so both sides see the same
    values) and fp32 scale, bias; numpy arrays and their torch twins."""
    jdt, tdt = DTYPES[dtype]
    H = shape[-1]
    arrs = [np.asarray(jnp.asarray(rng.randn(*shape), jdt).astype(jnp.float32)) for _ in range(3)]
    scale = (rng.rand(H) + 0.5).astype(np.float32)
    bias = (rng.randn(H) * 0.1).astype(np.float32)
    j = [jnp.asarray(a, jdt) for a in arrs] + [jnp.asarray(scale), jnp.asarray(bias)]
    t = [torch.tensor(a).to(tdt) for a in arrs] + [torch.tensor(scale), torch.tensor(bias)]
    return j, t


def close(got, want, dtype, grad=False):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if dtype == "bfloat16":
        np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=0)
    elif grad:
        np.testing.assert_allclose(got, want, atol=GRAD_ATOL, rtol=GRAD_RTOL)
    else:
        np.testing.assert_allclose(got, want, atol=FWD_ATOL, rtol=0)


def torch_vjp(fn, tensors, dy):
    leaves = [t.clone().requires_grad_(True) for t in tensors]
    y = fn(*leaves)
    y.backward(dy)
    return y, [t.grad for t in leaves]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_add_layer_norm_matches_jax(rng, shape, dtype):
    (jx, jr, jdy, js, jb), (tx, tr, tdy, ts, tb) = inputs(rng, shape, dtype)
    y_j, vjp = jax.vjp(lambda x, r, s, b: jax_fused(x, r, s, b), jx, jr, js, jb)
    grads_j = vjp(jdy)
    y_t, grads_t = torch_vjp(ln.fused_add_layer_norm, (tx, tr, ts, tb), tdy)
    assert y_t.shape == tx.shape and y_t.dtype == tx.dtype
    close(y_t, y_j, dtype)
    for name, g_t, g_j in zip(("dx", "dres", "dscale", "dbias"), grads_t, grads_j):
        close(g_t, g_j, dtype if name in ("dx", "dres") else "float32", grad=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_dropout_add_layer_norm_at_rate_0_matches_jax(rng, shape, dtype):
    (jx, jr, jdy, js, jb), (tx, tr, tdy, ts, tb) = inputs(rng, shape, dtype)
    seed = jnp.asarray([3], jnp.int32)
    y_j, vjp = jax.vjp(lambda x, r, s, b: jax_dfused(x, r, s, b, seed, 0.0), jx, jr, js, jb)
    grads_j = vjp(jdy)
    y_t, grads_t = torch_vjp(lambda x, r, s, b: ln.fused_dropout_add_layer_norm(x, r, s, b, 3, 0.0),
                             (tx, tr, ts, tb), tdy)
    close(y_t, y_j, dtype)
    for name, g_t, g_j in zip(("dx", "dres", "dscale", "dbias"), grads_t, grads_j):
        close(g_t, g_j, dtype if name in ("dx", "dres") else "float32", grad=True)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_dropout_add_layer_norm_matches_jax_on_the_ports_mask(rng, shape):
    rate, seed = 0.1, 1234
    (jx, jr, jdy, js, jb), (tx, tr, tdy, ts, tb) = inputs(rng, shape, "float32")
    keep = ln.keep_mask(tx.reshape(-1, shape[-1]).shape, rate, seed, "cpu").reshape(shape)
    m = jnp.asarray(keep.numpy())

    def f(x, r, s, b):
        return jax_reference(jnp.where(m, x / (1.0 - rate), 0.0), r, s, b)

    y_j, vjp = jax.vjp(f, jx, jr, js, jb)
    grads_j = vjp(jdy)
    y_t, grads_t = torch_vjp(lambda x, r, s, b: ln.fused_dropout_add_layer_norm(x, r, s, b, seed, rate),
                             (tx, tr, ts, tb), tdy)
    close(y_t, y_j, "float32")
    for g_t, g_j in zip(grads_t, grads_j):
        close(g_t, g_j, "float32", grad=True)
    # the backward regenerated the forward's mask: dx is zero exactly where it drops
    assert torch.equal(grads_t[0] == 0, ~keep)


def test_keep_mask_is_k3s_bits_and_reproducible():
    shape, rate = (96, 64), 0.1
    keep = ln.keep_mask(shape, rate, 11, "cpu")
    assert torch.equal(keep, dropout_mask_reference(shape, rate, 11, torch.int8).bool())
    assert torch.equal(keep, ln.keep_mask(shape, rate, 11, "cpu"))
    assert not torch.equal(keep, ln.keep_mask(shape, rate, 12, "cpu"))
    n = keep.numel()
    assert abs(keep.float().mean().item() - (1 - rate)) <= 4 * np.sqrt(rate * (1 - rate) / n)


def test_dropout_forward_and_backward_share_the_mask(rng):
    """The forward drops exactly the mask's zeros: y equals the plain add +
    LayerNorm of the masked, rescaled x; and dx is ds / (1 - rate) where
    kept, 0 elsewhere, with dres = ds."""
    rate, seed = 0.25, 5
    x, res, dy = (torch.tensor(rng.randn(40, 32), dtype=torch.float32) for _ in range(3))
    scale, bias = torch.rand(32) + 0.5, torch.randn(32) * 0.1
    keep = ln.keep_mask(x.shape, rate, seed, "cpu")
    y, mu, rstd, bits = ln.dropout_add_layer_norm_fwd(x, res, scale, bias, rate, seed)
    xd = torch.where(keep, x / torch.tensor(1 - rate), 0.0)
    torch.testing.assert_close(y, ln.reference_add_layer_norm(xd, res, scale, bias), atol=FWD_ATOL, rtol=0)
    dx, dres, _, _ = ln.dropout_add_layer_norm_bwd(x, res, scale, mu, rstd, dy, bits, rate)
    torch.testing.assert_close(dx, torch.where(keep, dres / torch.tensor(1 - rate), 0.0), atol=0, rtol=0)


@pytest.mark.parametrize("dropout", [False, True])
def test_autograd_functions_equal_their_plain_backward(rng, dropout):
    rate, seed = (0.1, 9) if dropout else (0.0, 0)
    x, res, dy = (torch.tensor(rng.randn(3, 7, 48), dtype=torch.float32) for _ in range(3))
    scale, bias = torch.rand(48) + 0.5, torch.randn(48) * 0.1
    if dropout:
        fn = lambda *t: ln.fused_dropout_add_layer_norm(*t, seed, rate)  # noqa: E731
    else:
        fn = ln.fused_add_layer_norm
    y, grads = torch_vjp(fn, (x, res, scale, bias), dy)
    x2, r2, dy2 = x.reshape(-1, 48), res.reshape(-1, 48), dy.reshape(-1, 48)
    if dropout:
        y_p, mu, rstd, bits = ln.dropout_add_layer_norm_fwd_reference(x2, r2, scale, bias, rate, seed)
        want = ln.dropout_add_layer_norm_bwd_reference(x2, r2, scale, mu, rstd, dy2, bits, rate)
    else:
        y_p, mu, rstd = ln.add_layer_norm_fwd_reference(x2, r2, scale, bias)
        dx, dscale, dbias = ln.add_layer_norm_bwd_reference(x2, r2, scale, mu, rstd, dy2)
        want = (dx, dx, dscale, dbias)
    assert torch.equal(y.detach().reshape(-1, 48), y_p)
    for g, w in zip(grads, want):
        assert torch.equal(g.reshape(w.shape), w)


def test_cpu_wrappers_run_the_plain_versions_and_count_nothing(rng):
    x, res, dy = (torch.tensor(rng.randn(8, 16), dtype=torch.float32) for _ in range(3))
    scale, bias = torch.ones(16), torch.zeros(16)
    wrappers = (ln.add_layer_norm_fwd, ln.add_layer_norm_bwd, ln.dropout_add_layer_norm_fwd,
                ln.dropout_add_layer_norm_bwd)
    before = [w.launches for w in wrappers]
    y, mu, rstd = ln.add_layer_norm_fwd(x, res, scale, bias)
    assert torch.equal(y, ln.add_layer_norm_fwd_reference(x, res, scale, bias)[0])
    ln.add_layer_norm_bwd(x, res, scale, mu, rstd, dy)
    _, _, _, bits = ln.dropout_add_layer_norm_fwd(x, res, scale, bias, 0.1, 3)
    ln.dropout_add_layer_norm_bwd(x, res, scale, mu, rstd, dy, bits, 0.1)
    assert [w.launches for w in wrappers] == before


# ---- K9's saved keep bits and K10 on them ----

BITS_SHAPES = [(24, 64), (13, 32), (37, 64), (5, 200), (3, 8), (1, 768), (1001, 256)]


def regenerating_bwd_reference(x, res, scale, mu, rstd, dy, rate, seed):
    """K10's plain version as it was before K9 saved its bits: the mask
    drawn again from the seed."""
    keep = ln.keep_mask(x.shape, rate, seed, x.device)
    kp = torch.tensor(1.0 - rate, dtype=torch.float32)
    xd = torch.where(keep, x.float() / kp, 0.0)
    ds, dscale, dbias = ln._bwd_plain(xd + res.float(), scale, mu, rstd, dy)
    dx = torch.where(keep, ds / kp, 0.0)
    return dx.to(x.dtype), ds.to(res.dtype), dscale, dbias


@pytest.mark.parametrize("shape", BITS_SHAPES, ids=str)
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_plain_k9_bits_are_the_keep_mask_packed(rng, shape, rate):
    """Byte j of a row holds elements 8 j .. 8 j + 7, element 8 j + k in bit
    k (numpy's little-endian packbits), for any H a multiple of 8."""
    x, res = (torch.tensor(rng.randn(*shape), dtype=torch.float32) for _ in range(2))
    scale, bias = torch.ones(shape[1]), torch.zeros(shape[1])
    *_, bits = ln.dropout_add_layer_norm_fwd_reference(x, res, scale, bias, rate, 21)
    keep = ln.keep_mask(shape, rate, 21, "cpu")
    assert bits.dtype == torch.uint8 and bits.shape == (shape[0], shape[1] // 8)
    assert np.array_equal(bits.numpy(), np.packbits(keep.numpy(), axis=-1, bitorder="little"))
    assert torch.equal(bits, ln.pack_bits(keep)) and torch.equal(ln.unpack_bits(bits), keep)


@pytest.mark.parametrize("shape", BITS_SHAPES, ids=str)
@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16], ids=str)
def test_plain_k10_on_the_saved_bits_equals_the_regenerating_one(rng, shape, rate, dtype):
    """Fed K9's bits, the plain K10 gives the regenerating version's dx,
    dres, dscale and dbias bit for bit."""
    x, res, dy = (torch.tensor(rng.randn(*shape), dtype=dtype) for _ in range(3))
    scale = torch.tensor(rng.rand(shape[1]) + 0.5, dtype=torch.float32)
    bias = torch.tensor(rng.randn(shape[1]) * 0.1, dtype=torch.float32)
    _, mu, rstd, bits = ln.dropout_add_layer_norm_fwd_reference(x, res, scale, bias, rate, 8)
    got = ln.dropout_add_layer_norm_bwd_reference(x, res, scale, mu, rstd, dy, bits, rate)
    want = regenerating_bwd_reference(x, res, scale, mu, rstd, dy, rate, 8)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_dropout_autograd_saves_the_bits_and_backs_through_them(rng):
    """_DropoutAddLayerNorm saves K9's bits (not the seed) and its backward
    is the plain backward on them."""
    rate, seed = 0.2, 31
    x, res, dy = (torch.tensor(rng.randn(4, 5, 40), dtype=torch.float32) for _ in range(3))
    scale, bias = torch.rand(40) + 0.5, torch.randn(40) * 0.1
    leaves = [t.clone().requires_grad_(True) for t in (x, res, scale, bias)]
    y = ln.fused_dropout_add_layer_norm(*leaves, seed, rate)
    node = y.grad_fn.next_functions[0][0]
    saved = node.saved_tensors
    keep = ln.keep_mask((20, 40), rate, seed, "cpu")
    assert len(saved) == 6 and saved[-1].dtype == torch.uint8 and torch.equal(saved[-1], ln.pack_bits(keep))
    y.backward(dy)
    x2, r2, dy2 = x.reshape(20, 40), res.reshape(20, 40), dy.reshape(20, 40)
    _, mu, rstd, bits = ln.dropout_add_layer_norm_fwd_reference(x2, r2, scale, bias, rate, seed)
    want = ln.dropout_add_layer_norm_bwd_reference(x2, r2, scale, mu, rstd, dy2, bits, rate)
    for t, w in zip(leaves, want):
        assert torch.equal(t.grad.reshape(w.shape), w)
    assert torch.equal(leaves[0].grad.reshape(20, 40) == 0, ~keep)


def _round_f32(value):
    """The float32 nearest to a Fraction (ties to even)."""
    from fractions import Fraction

    a = np.float32(float(value))
    cands = (np.nextafter(a, np.float32(-np.inf)), a, np.nextafter(a, np.float32(np.inf)))
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - value), int(np.float32(c).view(np.uint32)) & 1))


@pytest.mark.parametrize("rate", [0.1, 0.5, 0.25, 0.05, 0.9])
def test_k10s_division_is_the_ieee_quotient(rate):
    """csrc/layer_norm.cu::div_by divides by 1 - rate as q = x * r, then
    q + fma(-q, kp, x) * r with r = 1 / kp rounded (Markstein's
    correction): the correctly rounded quotient, as x / (1 - rate) in fp32,
    here emulated exactly for normal-range x."""
    from fractions import Fraction

    kp = float(ln._keep_prob(rate))
    r = _round_f32(1 / Fraction(kp))
    rng = np.random.RandomState(int(rate * 100))
    xs = np.concatenate([rng.randn(300), rng.randn(100) * 1e-20, rng.randn(100) * 1e20]).astype(np.float32)
    for x in xs:
        fx, fk, fr = Fraction(float(x)), Fraction(kp), Fraction(float(r))
        q = _round_f32(fx * fr)
        rem = _round_f32(-Fraction(float(q)) * fk + fx)
        got = _round_f32(Fraction(float(rem)) * fr + Fraction(float(q)))
        assert got == _round_f32(fx / fk) == np.float32(x) / np.float32(kp), x
