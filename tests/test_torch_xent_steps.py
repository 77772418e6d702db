"""``visualbert_torch/tools/xent_steps.py`` (K4's and K5/K6's design steps
left out in turn and timed), without a card: what runs here is the tool's
refusals and its switches in the source, each one the kernel library never
sets, the SASS parse it shares with ``tools/attn_ab.py``, which keys the
kernels both trees share (the bf16 K4, K5 and K6 at 768 and 1024, K5's
reduce pass, K4's merge pass; in the wide mode every kernel both trees
build but the wide K4, whatever the path each was built at), and the
splits its sweeps of K4, the wide K4 and the wide K5 time."""

import re

import pytest
import torch

from visualbert_torch.ops import _build
from visualbert_torch.ops import mlm_xent as xe
from visualbert_torch.tools import xent_steps


@pytest.mark.parametrize("args,match", [([], "no CUDA device"), (["a", "b"], "at most one argument"),
                                        (["--wide"], "no CUDA device"),
                                        (["--wide", "a", "b"], "at most one argument"),
                                        (["--h1024"], "no CUDA device"), (["--h1024", "a"], "no CUDA device"),
                                        (["--h1024", "a", "b"], "at most one argument")])
def test_the_tool_runs_only_on_the_card_and_takes_at_most_a_checkout(monkeypatch, args, match):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match=match):
        xent_steps.main(args)


@pytest.mark.parametrize("macro", sorted({d[2:] for defines in xent_steps.BUILDS.values() for d in defines}))
def test_each_left_out_step_is_a_switch_the_library_never_sets(macro):
    text = (_build.CSRC / "mlm_xent.cu").read_text()
    assert len(re.findall(rf"#ifndef {macro}\b", text)) == 1
    assert not any(macro in flag for flag in _build.ARCH_FLAGS + _build.NVCC_FLAGS)


def test_every_build_leaves_out_a_step_and_binds_the_entry_points_it_calls():
    assert all(defines for defines in xent_steps.BUILDS.values())
    assert len({tuple(sorted(d)) for d in xent_steps.BUILDS.values()}) == len(xent_steps.BUILDS)
    assert set(xent_steps.FNS) <= set(_build._SIGNATURES)
    assert xent_steps.BUILDS == {**xent_steps.FWD_BUILDS, **xent_steps.BWD_BUILDS, **xent_steps.H1024_BUILDS}
    # K4's switches are K4's alone, K5/K6's theirs, the 1024 form's its own: each build times one kernel's steps
    assert all(d.startswith("-DVB_XENT_FWD_") for ds in xent_steps.FWD_BUILDS.values() for d in ds)
    assert not any(d.startswith(("-DVB_XENT_FWD_", "-DVB_XENT_H1024_")) for ds in xent_steps.BWD_BUILDS.values()
                   for d in ds)
    assert all(d.startswith("-DVB_XENT_H1024_") for ds in xent_steps.H1024_BUILDS.values() for d in ds)
    assert set(xent_steps.EXACT_FWD_BUILDS) <= set(xent_steps.FWD_BUILDS)


@pytest.mark.parametrize("macro", sorted({d[2:] for d in sum(xent_steps.FWD_BUILDS.values(), [])}))
def test_k4s_switches_lie_inside_the_forward_kernel(macro):
    """A K4 switch may change K4's tiling or body only: K5/K6's source stays
    as it is (their SASS is compared against another tree)."""
    text = (_build.CSRC / "mlm_xent.cu").read_text()
    k4 = text[text.index("// ------------------------------------------------------------------ K4\n"):]
    k4 = k4[:k4.index("__global__ void xent_fwd_merge_kernel")]
    header = text[:text.index("// K5 and K6 are one")]
    assert text.count(macro) == k4.count(macro) + header.count(macro)


def test_the_1024_phase_stamps_each_find_their_line_once():
    """``--h1024``'s phase profile writes its clock64 stamps into a copy of
    the 1024 kernel at lines it finds by their text: each must be there,
    once, in the kernel's body, in the order of a tile."""
    text = (_build.CSRC / "mlm_xent.cu").read_text()
    body = text[text.index("xent_h1024_bwd_kernel(const __grid_constant__"):
                text.index("// The 1024 form's cluster launch")]
    at = [body.index(line) for _, line, _ in xent_steps.H1024_PHASES]
    assert all(body.count(line) == 1 for _, line, _ in xent_steps.H1024_PHASES)
    assert at == sorted(at) and body.count("  for (int t = t0; t < t1; ++t) {\n") == 1


def test_the_wide_backward_has_no_switch():
    """The wide K5/K6 are built one way only: no timing switch of the tool
    reaches them, so the kernel the tool times is the library's."""
    text = (_build.CSRC / "mlm_xent.cu").read_text()
    wide = text[text.index("// ------------------------------------------------------------ the wide form"):]
    assert not re.search(r"#if(n?def)?\b", wide) and "VB_XENT_WIDE_" not in text


def test_the_sass_parse_keys_the_shared_kernels_by_their_mangled_names():
    from visualbert_torch.tools.attn_ab import OTHER_FORMS, sass_of

    text = """
        Function : _ZN44_GLOBAL__N__x15xent_bwd_kernelILi768ELb0EEEvPK13__nv_bfloat16
        /*0000*/                   MOV R1, c[0x0][0x28] ;                  /* 0x00000a0000017a02 */
        /*0010*/                   BRA `(.L_x_7) ;                         /* 0x0000000000007947 */
        Function : _ZN44_GLOBAL__N__x15xent_fwd_kernelILi768EEEvPK13__nv_bfloat16
        /*0000*/                   EXIT ;                                  /* 0x000000000000794d */
        Function : _ZN44_GLOBAL__N__x21xent_h1024_bwd_kernelILb1E13__nv_bfloat16EEv14CUtensorMap_st
        /*0000*/                   EXIT ;                                  /* 0x000000000000794d */
        Function : _ZN44_GLOBAL__N__x15xent_bwd_kernelILi768ELb0E6__halfEEvPKT1_
        /*0000*/                   NOP ;                                   /* 0x0000000000007918 */
        Function : _ZN44_GLOBAL__N__x20xent_wide_fwd_kernelI13__nv_bfloat16EEvPKT_
        /*0000*/                   NOP ;                                   /* 0x0000000000007918 */
        Function : _ZN44_GLOBAL__N__x20xent_wide_bwd_kernelILb0E13__nv_bfloat16EEvPKT0_
        /*0000*/                   NOP ;                                   /* 0x0000000000007918 */
    """
    got = sass_of(text, xent_steps.SHARED_KERNELS, OTHER_FORMS)
    assert got == {"K5, 768": ["MOV R1, c[0x0][0x28]", "BRA `(.L0)"], "K4, 768": ["EXIT"], "K6, 1024": ["EXIT"]}
    # the bf16 forms up to 1024 only: no fp16 form, no wide form
    assert not any("wide" in key or "half" in key for key in xent_steps.SHARED_KERNELS.values())
    # the wide mode: every function of both builds by its name without the anonymous namespace's tag, which
    # differs between two paths; all are compared but the wide K4 (WIDE_TAKEN), the wide K5/K6 included
    here = text.replace("_GLOBAL__N__x", "_GLOBAL__N__f24a70b0_11_mlm_xent_cu_0bf669f9")
    there = text.replace("_GLOBAL__N__x", "_GLOBAL__N__cd4a2f04_11_mlm_xent_cu_0bf669f9").replace("NOP", "EXIT", 1)
    funcs = xent_steps.sass_functions(here)
    assert len(funcs) == 6 and all(name.startswith("_ZN44_GLOBAL__N_") and "f24a70b0" not in name for name in funcs)
    assert funcs == xent_steps.sass_functions(text.replace("_GLOBAL__N__x", "_GLOBAL__N_"))
    assert funcs["_ZN44_GLOBAL__N_15xent_bwd_kernelILi768ELb0EEEvPK13__nv_bfloat16"] == [
        "MOV R1, c[0x0][0x28]", "BRA `(.L0)"]
    got = xent_steps.compare_all_sass({"this": here, "other": there}, "card")
    assert got["only_here"] == got["only_there"] == [] and len(got["compared"]) == 5
    assert not any("xent_wide_fwd_kernel" in name for name in got["compared"])
    assert {name: same for name, (same, _, _) in got["compared"].items() if not same} == {
        "_ZN44_GLOBAL__N_15xent_bwd_kernelILi768ELb0E6__halfEEvPKT1_": False}
    assert got["compared"]["_ZN44_GLOBAL__N_20xent_wide_bwd_kernelILb0E13__nv_bfloat16EEvPKT0_"] == (True, 1, 1)


@pytest.mark.parametrize("H,rows", [(768, 128), (1024, 64)])
@pytest.mark.parametrize("V", [30522, 4099])
@pytest.mark.parametrize("sms", [132, 8])
def test_the_split_sweep_fills_one_to_four_waves_with_no_split_empty(H, rows, V, sms):
    """At N = 3072 (24 or 48 row blocks) each entry of the sweep fits in its
    own count of waves where one split of the row blocks does, and covers the
    vocabulary with no split empty; on 132 SMs at V = 30522 the sweep holds
    the splits fwd_plan takes."""
    N, tile = 3072, 32
    row_blocks, n_tiles = -(-N // rows), -(-V // tile)
    sweep = xent_steps.sweep_splits(N, V, rows, tile, sms)
    assert len(sweep) == 4
    for waves, (S, per, w, tiles) in enumerate(sweep, 1):
        assert (S - 1) * per < n_tiles <= S * per
        assert w == -(-row_blocks * S // sms)
        if row_blocks <= waves * sms:  # one split a row block fits in these waves
            assert w <= waves
        assert tiles == w * (per + xe.FWD_BLOCK_TILES)
    if sms == 132 and V == 30522:
        assert [w for _, _, w, _ in sweep] == [1, 2, 3, 4]
        assert xe.fwd_plan(N, V, H, rows, tile, sms)["grid"][1] in [S for S, *_ in sweep]


@pytest.mark.parametrize("H", [1088, 2048, 2560])
@pytest.mark.parametrize("V", [30522, 4099])
@pytest.mark.parametrize("N", [3072, 257])
def test_the_wide_k4_split_sweep_holds_the_plans_splits(N, V, H):
    """The wide K4's sweep (its 128 x 128 tiling, WIDE_FWD_BLOCK_TILES a
    block's fixed cost) fills one to four waves of 132 SMs with no split
    empty and holds the splits the wrapper's plan takes, the cheapest of
    them as fwd_plan models them."""
    rows, tile, sms = 128, 128, 132
    n_tiles = -(-V // tile)
    sweep = xent_steps.sweep_splits(N, V, rows, tile, sms, xe.WIDE_FWD_BLOCK_TILES)
    for S, per, w, tiles in sweep:
        assert (S - 1) * per < n_tiles <= S * per and tiles == w * (per + xe.WIDE_FWD_BLOCK_TILES)
    plan = xe.fwd_plan(N, V, H, rows, tile, sms, xe.WIDE_FWD_BLOCK_TILES)
    chosen = [e for e in sweep if e[0] == plan["grid"][1]]
    if N == 3072 and V == 30522:
        assert chosen and plan["grid"] == (24, 11)
    if chosen:
        assert chosen[0][3] == min(e[3] for e in sweep)


@pytest.mark.parametrize("H,clusters", [(2048, 30), (2560, 22), (4160, 9), (2048, 1)])
@pytest.mark.parametrize("V", [30522, 4099, 70])
def test_the_wide_split_sweep_holds_the_plans_splits_with_no_split_empty(H, clusters, V):
    """At N = 3072 (48 row blocks of 64) each split count of WIDE_SPLITS
    that the vocabulary allows appears once, covers the vocabulary with no
    split empty, and is modelled as wide_dx_plan models it (waves of the
    clusters at once times a split's tiles and WIDE_BLOCK_TILES); the
    splits the plan takes are among them and cost the least of them."""
    N, rows, tile = 3072, 64, 64
    row_blocks, n_tiles = -(-N // rows), -(-V // tile)
    sweep = xent_steps.wide_sweep_splits(N, V, rows, tile, clusters)
    assert len({S for S, *_ in sweep}) == len(sweep) >= min(2, n_tiles)
    for S, per, w, tiles in sweep:
        assert (S - 1) * per < n_tiles <= S * per
        assert w == -(-row_blocks * S // clusters) and tiles == w * (per + xe.WIDE_BLOCK_TILES)
    plan = xe.wide_dx_plan(N, V, H, rows, tile, 512, clusters)
    chosen = [e for e in sweep if e[0] == plan["grid"][2]]
    assert chosen and chosen[0][3] == min(e[3] for e in sweep)


def test_the_exact_yardsticks_agree_with_the_plain_versions_at_a_narrow_width():
    """fwd_exact's nll and lse and db_exact's db (the logits' products summed
    in fp64, what the wide forms are held to) agree with the plain versions
    where 64 products leave the fp32 sums no room to drift."""
    import numpy as np

    rng = np.random.RandomState(3)
    N, V, H = 24, 50, 64
    x = torch.tensor(rng.randn(N, H), dtype=torch.bfloat16)
    emb = torch.tensor(rng.randn(V, H) * 0.05, dtype=torch.bfloat16)
    bias = torch.tensor(rng.randn(V) * 0.1, dtype=torch.float32)
    labels = torch.tensor(rng.randint(0, V, N), dtype=torch.int32)
    g = torch.tensor(rng.uniform(0.5, 1.5, N), dtype=torch.float32)
    nll_r, lse_r, _ = xe.mlm_xent_fwd_reference(x, emb, bias, labels)
    nll64, lse64 = xent_steps.fwd_exact(x, emb, bias, labels)
    assert nll64.dtype == lse64.dtype == torch.float64 and nll64.shape == lse64.shape == (N,)
    torch.testing.assert_close(nll64, nll_r.double(), rtol=0, atol=1e-5)
    torch.testing.assert_close(lse64, lse_r.double(), rtol=0, atol=1e-5)
    _, db_r = xe.mlm_xent_de_reference(x, emb, bias, labels, lse_r, g)
    db64 = xent_steps.db_exact(x, emb, bias, labels, lse_r, g)
    assert db64.dtype == torch.float64
    assert float((db64 - db_r.double()).abs().max() / db_r.abs().max()) < 1e-6
