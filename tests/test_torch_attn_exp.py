"""The attention experiment variants of the port (K15/K16) on the CPU against
the JAX scripts that define them.

``scripts/attn_exp.py`` and ``scripts/attn_hgrid.py`` are loaded as
modules, their module-level sizes (B, T, H, F) shrunk with monkeypatch, and
their Pallas kernels run in interpret mode; "base" is the production packed
kernel, as in the script. The port's wrappers, given CPU tensors, compute
their plain versions. The same numpy inputs go to both sides:

* fp32, dropout 0, every ``VARIANTS`` entry and hg 1, 2 and 4 (H = 4): out
  and stats at atol 2e-5 / rtol 1e-4 (the bar the JAX encoder meets against
  HF), dqkv and the summed bias gradient at the JAX attention tests' 3e-4 /
  1e-3;
* bf16, ``prescale``: the softmax statistics within 2e-5 of the JAX
  variant's and out and dqkv within 1e-3 of the largest value, where the
  port's base variant is off by more (the rounding of the scaled q shows
  and is reproduced); the bf16 bias gradient within two bf16 ulps.

With dropout on the two packages draw different bits (the TPU scripts salt
the seed by head group), so the port's masks are checked by themselves, in
fp32 where the numerics variants are K1/K2's function: every variant at
dropout 0.1 equals the port's K1/K2 plain version at the same seed (the
schedule variants exactly), the same seed repeats and another differs; and
in bf16 ``fdrop``'s gradient equals its formula (attn_exp.py:198-201)
written out here against the base plain version's probabilities and mask,
within 1e-3 of the largest value, where the base variant's is off by more.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from visualbert_tpu.ops import flash_attention as jfa
from visualbert_torch.ops import attention_exp as ae
from visualbert_torch.ops import flash_attention as fa

ATOL, RTOL = 2e-5, 1e-4
GRAD_ATOL, GRAD_RTOL = 3e-4, 1e-3
# bf16: the variant's rounding against its JAX or written-out counterpart,
# where the base variant is farther off (readings in brackets: variant, base)
STATS_BF16_ATOL = 2e-5   # prescale's statistics, absolute  [4.8e-7, 2.9e-3]
ROUNDING_TOL = 1e-3      # out, dqkv, as a share of the largest value  [0, 3.4e-3 to 5.7e-3]
BF16_ULPS = 2.0 ** -7    # the bf16 bias gradient: two bf16 ulps of the largest value
H, D = 4, 64
SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")


def load_script(name):
    spec = importlib.util.spec_from_file_location(f"{name}_script", os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scripts():
    return load_script("attn_exp"), load_script("attn_hgrid")


def shrink(monkeypatch, scripts, B, T):
    for mod in scripts:
        for name, value in (("B", B), ("T", T), ("H", H), ("F", 3 * H * D)):
            monkeypatch.setattr(mod, name, value)


def inputs(B, T, bf16=False, seed=0):
    rng = np.random.RandomState(seed)
    F = 3 * H * D
    qkv = rng.randn(B, T, F).astype(np.float32)
    qb = (rng.randn(F) * 0.1).astype(np.float32)
    dout = rng.randn(B, T, H * D).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    mask[0, -6:] = 0
    mask[-1, -1:] = 0
    key_bias = (1.0 - mask) * -10000.0
    if bf16:  # the same numbers rounded to bf16 on both sides
        qkv, qb, dout = (torch.tensor(x).to(torch.bfloat16).float().numpy() for x in (qkv, qb, dout))
    return qkv, qb, key_bias, dout


def run_jax(scripts, name, hg, qkv, qb, key_bias, dout, dtype=jnp.float32):
    """The JAX script's variant at dropout 0: out, stats, dqkv, summed db."""
    exp, hgrid = scripts
    x, b, do = (jnp.asarray(a).astype(dtype) for a in (qkv, qb, dout))
    kb = jnp.asarray(key_bias)
    seed = jnp.zeros((1,), jnp.int32)
    if hg is None and exp.VARIANTS[name] is None:  # the production kernel
        out, res = jfa._flash_packed_fwd(x, b, kb, 0.0, H, D, seed)
        dqkv, db, _, _ = jfa._flash_packed_bwd(0.0, H, D, res, do)
        stats = res[-1]
    else:
        with pltpu.force_tpu_interpret_mode():
            if hg is None:
                fwd, bwd = exp.make_variant(**exp.VARIANTS[name])(0.0)
                out, stats = fwd(x, b, kb, seed)
                dqkv, db = bwd(x, b, kb, seed, do, out, stats)
            else:
                fwd, bwd = hgrid.make_hgrid(hg)
                out, stats = fwd(x, b, kb, seed, 0.0)
                dqkv, db = bwd(x, b, kb, seed, do, out, stats, 0.0)
        db = jnp.sum(db, axis=(0, 1))
    return [np.asarray(a, np.float32) for a in (out, stats, dqkv, db)]


def port_fns(name, hg):
    """(forward, backward) of the port for a case, taking (..., rate, seed)."""
    if hg is None:
        kw = ae.VARIANTS[name] or {}
        return (lambda *a: ae.attn_exp_fwd(*a, **kw)), (lambda *a: ae.attn_exp_bwd(*a, **kw))
    return (lambda *a: ae.attn_hgrid_fwd(*a, hg=hg)), (lambda *a: ae.attn_hgrid_bwd(*a, hg=hg))


def run_port(name, hg, qkv, qb, key_bias, dout, rate=0.0, seed=0, dtype=torch.float32):
    fwd, bwd = port_fns(name, hg)
    x, b, do = (torch.tensor(a).to(dtype) for a in (qkv, qb, dout))
    kb = torch.tensor(key_bias)
    out, stats = fwd(x, b, kb, H, rate, seed)
    dqkv, db = bwd(x, b, kb, do, out, stats, H, rate, seed)
    return out, stats, dqkv, db


CASES = [(name, None) for name in ae.VARIANTS] + [("hgrid", hg) for hg in (1, 2, 4)]
IDS = list(ae.VARIANTS) + ["hg1", "hg2", "hg4"]


@pytest.mark.parametrize("name,hg", CASES, ids=IDS)
def test_variant_matches_jax_and_draws_k1s_mask(scripts, monkeypatch, name, hg):
    kw = (ae.VARIANTS[name] or {}) if hg is None else {}
    B, T = max(2, kw.get("bb", 1)), 21
    shrink(monkeypatch, scripts, B, T)
    qkv, qb, key_bias, dout = inputs(B, T)

    # dropout 0, fp32: the JAX script's variant
    want = run_jax(scripts, name, hg, qkv, qb, key_bias, dout)
    got = [t.numpy() for t in run_port(name, hg, qkv, qb, key_bias, dout)]
    assert got[1].shape == want[1].shape  # K16's statistic is [B, H/hg, hg, T]
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g, w, atol=GRAD_ATOL, rtol=GRAD_RTOL)

    # dropout 0.1: K1's mask, the same function in fp32 (exactly for the schedule variants)
    rate = 0.1
    x, b, do = (torch.tensor(a) for a in (qkv, qb, dout))
    kb = torch.tensor(key_bias)
    out1, stats1 = fa.packed_attention_fwd_reference(x, b, kb, H, rate, 9)
    k1k2 = [out1, stats1, *fa.packed_attention_bwd_reference(x, b, kb, do, out1, stats1, H, rate, 9)]
    run = run_port(name, hg, qkv, qb, key_bias, dout, rate, 9)
    if hg is not None:
        run = (run[0], run[1].reshape(B, H, T), *run[2:])
    for i, (g, w) in enumerate(zip(run, k1k2)):
        if not {"prescale", "nomax", "fdrop"} & set(kw):
            assert torch.equal(g, w)
        tol = (ATOL, RTOL) if i < 2 else (GRAD_ATOL, GRAD_RTOL)
        torch.testing.assert_close(g, w, atol=tol[0], rtol=tol[1])
    fwd, _ = port_fns(name, hg)
    assert torch.equal(fwd(x, b, kb, H, rate, 9)[0], run[0])
    assert not torch.equal(fwd(x, b, kb, H, rate, 10)[0], run[0])


def test_prescale_rounding_is_reproduced_in_bf16(scripts, monkeypatch):
    """bf16 inputs, dropout 0: the port's prescale against the JAX script's."""
    B, T = 2, 16
    shrink(monkeypatch, scripts, B, T)
    qkv, qb, key_bias, dout = inputs(B, T, bf16=True, seed=3)
    want = run_jax(scripts, "prescale", None, qkv, qb, key_bias, dout, dtype=jnp.bfloat16)
    got = [t.float().numpy() for t in run_port("prescale", None, qkv, qb, key_bias, dout, dtype=torch.bfloat16)]
    base = [t.float().numpy() for t in run_port("base", None, qkv, qb, key_bias, dout, dtype=torch.bfloat16)]
    assert np.abs(got[1] - want[1]).max() <= STATS_BF16_ATOL < np.abs(base[1] - want[1]).max()
    for i in (0, 2):
        limit = ROUNDING_TOL * np.abs(want[i]).max()
        assert np.abs(got[i] - want[i]).max() <= limit < np.abs(base[i] - want[i]).max()
    assert np.abs(got[3] - want[3]).max() <= BF16_ULPS * np.abs(want[3]).max()


def fdrop_dqkv(qkv, qb, key_bias, dout, out, stats, rate, seed):
    """dqkv by attn_exp.py:198-201 in bf16: ds = bf16(p_d) * dP - p * delta
    with p_d = keep * p / (1 - rate), from the probabilities and the mask of
    the base plain version, written out with einsum."""
    bf = torch.bfloat16
    B, T, F = qkv.shape
    x = (qkv + qb).view(B, T, H, 3, D).float()
    q, k, v = x.unbind(3)  # [B, T, H, D]
    do, o = dout.view(B, T, H, D).float(), out.view(B, T, H, D).float()
    t = torch.einsum("bihd,bjhd->bhij", q, k) * (np.log2(np.e) / np.sqrt(D)) + key_bias[:, None, None, :] * np.log2(np.e)
    p = torch.exp2(t - stats[..., None])
    keep = fa.attention_keep_reference(seed, B, H, T, rate)
    p_d = torch.where(keep, p / (1.0 - rate), 0.0).to(bf).float()
    dp = torch.einsum("bihd,bjhd->bhij", do, v)
    delta = torch.einsum("bihd,bihd->bhi", do, o)[..., None]
    ds = (p_d * dp - p * delta).to(bf).float()
    dq = torch.einsum("bhij,bjhd->bihd", ds, k) / np.sqrt(D)
    dk = torch.einsum("bhij,bihd->bjhd", ds, q) / np.sqrt(D)
    dv = torch.einsum("bhij,bihd->bjhd", p_d, do)
    return torch.stack([dq, dk, dv], dim=3).to(bf).reshape(B, T, F)


def test_fdrop_gradient_is_its_formula_in_bf16():
    B, T, rate, seed = 2, 21, 0.1, 4
    qkv, qb, key_bias, dout = inputs(B, T, seed=5)
    qkv, qb, dout = (torch.tensor(a).to(torch.bfloat16) for a in (qkv, qb, dout))
    key_bias = torch.tensor(key_bias)
    out, stats = ae.attn_exp_fwd(qkv, qb, key_bias, H, rate, seed)
    want = fdrop_dqkv(qkv, qb, key_bias, dout, out, stats, rate, seed)
    got, _ = ae.attn_exp_bwd(qkv, qb, key_bias, dout, out, stats, H, rate, seed, fdrop=True)
    base, _ = ae.attn_exp_bwd(qkv, qb, key_bias, dout, out, stats, H, rate, seed)
    limit = ROUNDING_TOL * want.float().abs().max()
    assert (got.float() - want.float()).abs().max() <= limit < (base.float() - want.float()).abs().max()


@pytest.mark.parametrize("kw,match", [(dict(bb=3), "bb=3"), (dict(group=0), "group"), (dict(hg=3), "hg=3")])
def test_variants_refuse_what_they_do_not_take(kw, match):
    qkv, qb, key_bias, dout = (torch.tensor(a) for a in inputs(4, 8))
    with pytest.raises(ValueError, match=match):
        if "hg" in kw:
            ae.attn_hgrid_fwd(qkv, qb, key_bias, H, 0.0, 0, **kw)
        else:
            ae.attn_exp_fwd(qkv, qb, key_bias, H, 0.0, 0, **kw)
    with pytest.raises(TypeError):
        ae.attn_exp_fwd(qkv, qb, key_bias, H, 0.0, 0, tscore=True)


@pytest.mark.parametrize("tool,args,match", [("attn_exp", [], "no CUDA device"), ("attn_hgrid", ["4"], "no CUDA device"),
                                             ("attn_exp", ["nope"], "unknown"), ("attn_hgrid", ["5"], "divide")])
def test_tools_refuse_to_run_without_a_card_or_on_bad_arguments(monkeypatch, tool, args, match):
    """The sweeps run on the card only: no fall-back to the CPU."""
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match=match):
        importlib.import_module(f"visualbert_torch.tools.{tool}").main(args)
