"""The port's dropout site (``visualbert_torch/ops/dropout.py``: the site
forward and backward on K3's Philox body, and ``fast_dropout`` through
``_FastDropout``) on the CPU.

The plain versions must equal, bit for bit, the eager composition that
``fast_dropout`` ran before the site kernels (K3's int8 mask, a cast, the
rescale and the product; copied below as ``eager_site``, the witness) and
its autograd gradient; the packed bits must be ``pack_bits`` of K3's plain
mask; autograd must save nothing but those bits. Against the JAX package's
``fast_dropout`` (Pallas in interpret mode, threefry bits, so another mask)
the kept values, the keep rate (within 4 sigma) and the gradient's zeros
are compared; a 2-layer pretraining step with fast_dropout on gives the
JAX model's loss and gradients once the JAX mask kernel's masks are
replaced by K3's. The launches are held to the entry points' signatures
with a recording library. The kernels themselves run on the card
(``tests/test_torch_kernels_cuda.py``).
"""

import ctypes
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualbert_tpu.ops.dropout import fast_dropout as jax_fast_dropout
from visualbert_torch.ops import _build
from visualbert_torch.ops import dropout as dr
from visualbert_torch.ops.layer_norm import pack_bits

SHAPES = [(6, 33, 64), (1001,), (3, 5, 7)]
RATES = [0.1, 0.25]
DTYPES = [torch.bfloat16, torch.float32]
INT_VIEW = {torch.bfloat16: torch.int16, torch.float16: torch.int16, torch.float32: torch.int32}


def eager_site(x, rate, seed):
    """``fast_dropout`` as the port ran it before the site kernels: K3's int8
    mask, then ``x * (mask.to(x.dtype) * (1 / (1 - rate)))`` under autograd."""
    mask = dr.dropout_mask_reference(x.shape, rate, seed, torch.int8, x.device)
    return x * (mask.to(x.dtype) * (1.0 / (1.0 - rate)))


def same_bits(a, b):
    """Equal in every bit (a -0 is not a +0; NaNs must match too)."""
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.view(INT_VIEW[a.dtype]),
                                                                     b.view(INT_VIEW[b.dtype]))


def inputs(shape, dtype, seed=0):
    rng = np.random.RandomState(seed)
    x = torch.tensor(rng.randn(*shape), dtype=torch.float32).to(dtype)
    dy = torch.tensor(rng.randn(*shape), dtype=torch.float32).to(dtype)
    return x, dy


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_site_equals_the_eager_composition(shape, rate, dtype):
    x, dy = inputs(shape, dtype)
    y, bits = dr.dropout_fwd_reference(x, rate, 17)
    leaf = x.clone().requires_grad_(True)
    want = eager_site(leaf, rate, 17)
    (dx_want,) = torch.autograd.grad(want, leaf, dy)
    assert same_bits(y, want.detach())
    assert same_bits(dr.dropout_bwd_reference(dy, bits, rate), dx_want)
    # and through fast_dropout's autograd
    leaf2 = x.clone().requires_grad_(True)
    got = dr.fast_dropout(leaf2, rate, 17)
    (dx_got,) = torch.autograd.grad(got, leaf2, dy)
    assert same_bits(got.detach(), want.detach()) and same_bits(dx_got, dx_want)


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bits_are_pack_bits_of_k3s_plain_mask(shape, rate):
    x, _ = inputs(shape, torch.float32)
    _, bits = dr.dropout_fwd_reference(x, rate, 23)
    keep = dr.dropout_mask_reference(shape, rate, 23, torch.int8).bool().reshape(-1)
    n = keep.numel()
    padded = torch.cat([keep, keep.new_zeros(-n % 8)])
    assert bits.dtype == torch.uint8 and bits.shape == (math.ceil(n / 8),)
    assert torch.equal(bits, pack_bits(padded.reshape(1, -1)).reshape(-1))
    assert torch.equal(dr.unpack_keep(bits, n), keep)
    if n % 8:  # the tail byte is padded with zeros
        assert int(bits[-1]) >> (n % 8) == 0


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_fast_dropout_saves_only_the_packed_bits(shape, dtype):
    x, dy = inputs(shape, dtype)
    x.requires_grad_(True)
    saved = []

    def pack(t):
        saved.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = dr.fast_dropout(x, 0.1, 5)
    assert len(saved) == 1
    (bits,) = saved
    assert bits.dtype == torch.uint8 and bits.shape == (math.ceil(x.numel() / 8),)
    (dx,) = torch.autograd.grad(y, x, dy)
    assert same_bits(dx, dr.dropout_bwd_reference(dy, bits, 0.1))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_a_nan_or_inf_at_a_dropped_position_stays_nan(dtype):
    shape, rate, seed = (6, 33, 64), 0.25, 9
    keep = dr.dropout_mask_reference(shape, rate, seed, torch.int8).bool()
    dropped = torch.nonzero(~keep.reshape(-1))[:2, 0]
    x, dy = inputs(shape, dtype)
    x.view(-1)[dropped[0]] = float("nan")
    x.view(-1)[dropped[1]] = float("inf")
    dy.view(-1)[dropped[0]] = float("nan")
    y, bits = dr.dropout_fwd(x, rate, seed)
    assert torch.isnan(y.view(-1)[dropped]).all()
    assert torch.isnan(dr.dropout_bwd(dy, bits, rate).view(-1)[dropped[0]])
    assert int(torch.isnan(y).sum()) == 2  # nothing else


def test_rate_zero_returns_x_itself():
    x = torch.randn(3, 5, 7, requires_grad=True)
    assert dr.fast_dropout(x, 0.0, 3) is x


def test_other_devices_are_refused():
    x = torch.empty(4, 8, device="meta")
    for call in (lambda: dr.dropout_fwd(x, 0.1, 1), lambda: dr.dropout_bwd(x, torch.empty(4, dtype=torch.uint8), 0.1)):
        with pytest.raises(ValueError, match="unsupported device"):
            call()


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_against_the_jax_fast_dropout(shape, dtype):
    """Both packages at rate 0.1 on the same x: the same value wherever both
    keep an element (the same rescale, rounded to the dtype, and the same
    product), keep rates within 4 sigma of 0.9, and in each package the
    gradient is zero exactly where the forward dropped."""
    rate = 0.1
    rng = np.random.RandomState(4)
    xn = rng.randn(*shape).astype(np.float32)
    xn[xn == 0] = 1.0
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    xj = jnp.asarray(xn).astype(jdt)
    yj = np.asarray(jax_fast_dropout(xj, rate, jnp.int32(5)).astype(jnp.float32))
    gj = np.asarray(jax.grad(lambda v: jax_fast_dropout(v, rate, jnp.int32(5)).astype(jnp.float32).sum())(xj)
                    .astype(jnp.float32))
    x = torch.tensor(xn).to(dtype).requires_grad_(True)
    y = dr.fast_dropout(x, rate, 5)
    (g,) = torch.autograd.grad(y.float().sum(), x)
    yt, gt = y.detach().float().numpy(), g.float().numpy()
    n = xn.size
    for kept in (yj != 0, yt != 0):
        assert abs(kept.mean() - (1 - rate)) <= 4 * math.sqrt(rate * (1 - rate) / n)
    both = (yj != 0) & (yt != 0)
    assert both.any()
    np.testing.assert_array_equal(yt[both], yj[both])
    np.testing.assert_array_equal(gt[both], gj[both])
    np.testing.assert_array_equal(gj == 0, yj == 0)
    np.testing.assert_array_equal(gt == 0, yt == 0)


SMALL = dict(vocab_size=97, hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
             max_position_embeddings=64, visual_embedding_dim=24, hidden_dropout_prob=0.1,
             attention_probs_dropout_prob=0.1, use_flash_attention=True, fast_dropout=True)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_two_layer_step_equals_the_eager_composition(monkeypatch, dtype):
    """A 2-layer pretraining step with fast_dropout at rate 0.1 on the CPU:
    the loss and every gradient through _FastDropout equal, bit for bit,
    those through the eager composition (the same masks, the same
    products), at each of the 5 sites (the embeddings, two a layer)."""
    from visualbert_torch.config import VisualBertConfig
    from visualbert_torch.models import encoder
    from visualbert_torch.models.visualbert import VisualBertForTask
    from visualbert_torch.tools.synth import synth_batch

    cfg = VisualBertConfig(**SMALL, dtype=dtype)
    batch = {k: torch.as_tensor(v) for k, v in synth_batch(3, tt=9, tv=5, dv=24, n_pred=3, vocab=97,
                                                           seed=1).items()}
    calls = []

    def counted(x, rate, seed):
        calls.append(seed)
        return eager_site(x, rate, seed)

    runs = []
    for site in (dr.fast_dropout, counted):
        monkeypatch.setattr(encoder, "fast_dropout", site)
        model = VisualBertForTask(cfg, "pretraining").init_weights(torch.Generator().manual_seed(0))
        out = model(batch, torch.Generator().manual_seed(7))
        out["loss"].backward()
        runs.append((out["loss"].detach(), {k: p.grad for k, p in model.named_parameters() if p.grad is not None}))
    (loss_a, grads_a), (loss_b, grads_b) = runs
    assert len(calls) == 1 + 2 * SMALL["num_hidden_layers"]
    assert torch.equal(loss_a, loss_b)
    assert grads_a.keys() == grads_b.keys() and len(grads_a) > 20
    assert all(torch.equal(grads_a[k], grads_b[k]) for k in grads_a)


@pytest.mark.parametrize("flash", [True, False])
def test_two_layer_step_with_fast_dropout_matches_jax(monkeypatch, rng, flash):
    """A 2-layer pretraining step in fp32 with fast_dropout at rate 0.1 at
    each of its 5 sites (attention-probability dropout 0), against the JAX
    model's step with its fast_dropout: the JAX mask kernel's bits come from
    threefry, so its dropout_mask is replaced, site by site in the order the
    sites run, by K3's plain mask at the seed the port drew there. The loss,
    the outputs and every parameter gradient must agree to
    tests/test_torch_model.py's tolerance, the one its dropout-off steps meet."""
    import visualbert_tpu.ops.dropout as jax_dropout
    from test_torch_model import ATOL, RTOL, make_batch, to_torch
    from visualbert_tpu.config import VisualBertConfig as JaxConfig
    from visualbert_tpu.models.visualbert import VisualBertForTask as JaxTask
    from visualbert_tpu.tools.export_torch import export_state_dict
    from visualbert_tpu.train.trainer import unbox
    from visualbert_torch.config import VisualBertConfig
    from visualbert_torch.models import encoder
    from visualbert_torch.models.visualbert import VisualBertForTask
    from visualbert_torch.tools.weights import load_state

    kw = dict(SMALL, attention_probs_dropout_prob=0.0, use_flash_attention=flash)
    jcfg = JaxConfig(**kw, dtype=jnp.float32, scan_layers=False)  # one trace a layer: one mask a site
    batch = make_batch(rng, alignment=True)
    batch["example_weight"] = np.array([1.0, 1.0, 0.0], np.float32)
    jm = JaxTask(jcfg, head_type="pretraining")
    params = unbox(jm.init(jax.random.PRNGKey(3), batch)["params"])

    sites = []

    def recorded(x, rate, seed):
        sites.append((tuple(x.shape), rate, seed))
        return dr.fast_dropout(x, rate, seed)

    monkeypatch.setattr(encoder, "fast_dropout", recorded)
    model = load_state(VisualBertForTask(VisualBertConfig(**kw, dtype=torch.float32), "pretraining"),
                       export_state_dict(params, jcfg))
    out_t = model(to_torch(batch), torch.Generator().manual_seed(7))
    out_t["loss"].backward()
    assert len(sites) == 1 + 2 * SMALL["num_hidden_layers"]
    assert all(rate == 0.1 for _, rate, _ in sites)

    masks = iter([jnp.asarray(dr.dropout_mask_reference(s, r, seed, torch.int8).numpy()) for s, r, seed in sites])
    drawn = []

    def k3_mask(shape, rate, seed, dtype=jnp.bfloat16, mesh=None):
        mask = next(masks)
        assert mask.shape == tuple(shape) and dtype == jnp.int8 and rate == 0.1
        drawn.append(shape)
        return mask

    monkeypatch.setattr(jax_dropout, "dropout_mask", k3_mask)
    jbatch = jax.tree.map(jnp.asarray, batch)

    def loss_fn(p):
        out = jm.apply({"params": p}, jbatch, deterministic=False, rngs={"dropout": jax.random.PRNGKey(9)})
        return out["loss"], out

    (_, out_j), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(params)
    assert [tuple(s) for s in drawn] == [s for s, _, _ in sites]
    for k in ("loss", "masked_lm_loss", "next_sentence_loss", "mlm_accuracy"):
        np.testing.assert_allclose(float(out_t[k].detach()), float(out_j[k]), atol=ATOL, rtol=RTOL, err_msg=k)
    np.testing.assert_allclose(out_t["logits"].detach().numpy(), out_j["logits"], atol=ATOL, rtol=RTOL)
    want = export_state_dict(grads_j, jcfg)
    names = dict(model.named_parameters())
    assert set(names) <= set(want)
    for name, p in names.items():
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), want[name], atol=ATOL, rtol=RTOL, err_msg=name)


CODES = {torch.int8: 0, torch.bfloat16: 1, torch.float16: 2, torch.float32: 3}


@pytest.mark.parametrize("n", [1, 17, 1001, 128 * 228 * 768])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32], ids=str)
@pytest.mark.parametrize("kernel", ["vb_dropout_mask", "vb_dropout_fwd", "vb_dropout_bwd"])
def test_each_dropout_launch_passes_its_signatures_arguments(monkeypatch, kernel, dtype, n):
    """The launches hand their entry point one value per declared argument
    (an int for every pointer and integer, a float for the rescale), n, the
    dtype code, the seed's low 32 bits, and the threshold and rescale of the
    rate; the grid is the entry point's own."""
    from test_torch_entry_points import DEFINED, RecordingLib

    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    rate = 0.1
    x = torch.empty(n, dtype=dtype) if n < 10**6 else torch.empty(1, dtype=dtype).expand(n)
    bits = torch.empty(-(-n // 8), dtype=torch.uint8)
    lib = RecordingLib()
    if kernel == "vb_dropout_mask":
        code = dr.launch_mask(lib, x, rate, 2**32 + 5)
    elif kernel == "vb_dropout_fwd":
        code = dr.launch_fwd(lib, x, x, bits, rate, 2**32 + 5)
    else:
        code = dr.launch_bwd(lib, x, bits, x, rate)
    assert code == 0
    ((name, values),) = lib.calls
    assert name == kernel and len(values) == len(_build._SIGNATURES[kernel])
    for value, argtype in zip(values, _build._SIGNATURES[kernel]):
        assert type(value) is (float if argtype is ctypes.c_float else int), (value, argtype)
    given = dict(zip(DEFINED[kernel][3], values))
    assert "blocks" not in given
    assert (given["n"], given["dtype"]) == (n, CODES[dtype])
    assert given["threshold"] == int(rate * 2**32) and given["scale"] == 1.0 / (1.0 - rate)
    if kernel != "vb_dropout_bwd":
        assert given["seed"] == 5
