"""``visualbert_torch/tools/ln_steps.py`` (K8/K10's design steps left out in
turn and timed; K7-K10's SASS and times against another checkout),
without a card: what runs here is the tool's refusals, its switches in the
source, each one the kernel library never sets, and the SASS keys of K7-K10's
48 vector-form instantiations and the reduce pass (the any-width forms'
kernels are keyed by none)."""

import re

import pytest
import torch

from visualbert_torch.ops import _build
from visualbert_torch.tools import ln_steps


@pytest.mark.parametrize("args,match", [([], "no CUDA device"), (["a", "b"], "at most one argument"),
                                        (["no/such/checkout"], "at most one argument")])
def test_the_tool_runs_only_on_the_card_and_takes_at_most_a_checkout(monkeypatch, args, match):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match=match):
        ln_steps.main(args)


@pytest.mark.parametrize("macro", sorted({d[2:].split("=")[0] for defines in ln_steps.BUILDS.values()
                                          for d in defines}))
def test_each_left_out_step_is_a_switch_the_library_never_sets(macro):
    text = (_build.CSRC / "layer_norm.cu").read_text()
    assert re.search(rf"#if(n?def| defined\()\s*\(?{macro}\b", text)
    assert not any(macro in flag for flag in _build.ARCH_FLAGS + _build.NVCC_FLAGS)


def test_every_build_differs_and_binds_the_entry_points_it_calls():
    assert all(defines for defines in ln_steps.BUILDS.values())
    assert len({tuple(sorted(d)) for d in ln_steps.BUILDS.values()}) == len(ln_steps.BUILDS)
    assert set(ln_steps.FNS) <= set(_build._SIGNATURES)
    assert set(ln_steps.SAME_GRID) <= set(ln_steps.BUILDS)
    # the first design's entry points: no bits pointer, otherwise this tree's order
    for fn in ("vb_ln_fwd", "vb_ln_bwd"):
        assert len(ln_steps.FIRST_DESIGN_SIGNATURES[fn]) == len(_build._SIGNATURES[fn]) - 1


def test_the_sass_parse_keys_k7_and_the_reduce_pass_by_their_mangled_names():
    from visualbert_torch.tools.attn_ab import sass_of

    text = """
        Function : _ZN40_GLOBAL__N__ab13ln_fwd_kernelI13__nv_bfloat16Li3ELb0EEEvNS_6LnArgsE
        /*0000*/                   MOV R1, c[0x0][0x28] ;                  /* 0x00000a0000017a02 */
        Function : _ZN40_GLOBAL__N__ab13ln_fwd_kernelI13__nv_bfloat16Li3ELb1EEEvNS_6LnArgsE
        /*0000*/                   EXIT ;                                  /* 0x000000000000794d */
        Function : _ZN40_GLOBAL__N__ab13ln_fwd_kernelIfLi4ELb0EEEvNS_6LnArgsE
        /*0000*/                   BRA `(.L_x_3) ;                         /* 0x0000000000007947 */
        Function : _ZN40_GLOBAL__N__ab20ln_bwd_reduce_kernelEPKfiiPfS2_
        /*0000*/                   NOP ;                                   /* 0x0000000000007918 */
        Function : _ZN40_GLOBAL__N__ab17ln_fwd_any_kernelI6__halfLb0ELb1ELi1EEEvNS_6LnArgsE
        /*0000*/                   EXIT ;                                  /* 0x000000000000794d */
        Function : _ZN40_GLOBAL__N__ab13ln_bwd_kernelI6__halfLi1ELb1EEEvNS_6LnArgsE
        /*0000*/                   RET ;                                   /* 0x000000000000794d */
    """
    got = sass_of(text, ln_steps.SHARED_KERNELS)
    assert got == {"K7 bf16 NC=3": ["MOV R1, c[0x0][0x28]"], "K9 bf16 NC=3": ["EXIT"], "K7 fp32 NC=4": ["BRA `(.L0)"],
                   "K8/K10 reduce": ["NOP"], "K10 fp16 NC=1": ["RET"]}
    assert len(ln_steps.SHARED_KERNELS) == 49
