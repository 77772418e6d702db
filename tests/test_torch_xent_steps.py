"""``visualbert_torch/tools/xent_steps.py`` (K4's and K5/K6's design steps
left out in turn and timed), without a card: what runs here is the tool's
refusals and its switches in the source, each one the kernel library never
sets, the SASS parse it shares with ``tools/attn_ab.py``, which keys the
kernels both trees share (the bf16 K4, K5 and K6 at 768 and 1024, K5's
reduce pass, K4's merge pass; in the wide mode also the wide K4 and the
wide reduce pass, not the wide K5/K6), and the splits its sweeps of K4 and
of the wide K5 time."""

import re

import pytest
import torch

from visualbert_torch.ops import _build
from visualbert_torch.ops import mlm_xent as xe
from visualbert_torch.tools import xent_steps


@pytest.mark.parametrize("args,match", [([], "no CUDA device"), (["a", "b"], "at most one argument"),
                                        (["--wide"], "no CUDA device"),
                                        (["--wide", "a", "b"], "at most one argument")])
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
    assert xent_steps.BUILDS == {**xent_steps.FWD_BUILDS, **xent_steps.BWD_BUILDS}
    # K4's switches are K4's alone, K5/K6's theirs: each build times one kernel's steps
    assert all(d.startswith("-DVB_XENT_FWD_") for ds in xent_steps.FWD_BUILDS.values() for d in ds)
    assert not any(d.startswith("-DVB_XENT_FWD_") for ds in xent_steps.BWD_BUILDS.values() for d in ds)
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
        Function : _ZN44_GLOBAL__N__x15xent_bwd_kernelILi1024ELb1EEEvPK13__nv_bfloat16
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
    # the wide mode adds the wide K4 and the wide reduce pass, never the wide K5/K6 it changes
    got = sass_of(text, xent_steps.WIDE_SHARED_KERNELS, OTHER_FORMS)
    assert got == {"wide K4": ["NOP"]}
    assert not any("bwd" in key for key in xent_steps.WIDE_SHARED_KERNELS.values())


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
