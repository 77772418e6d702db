"""``visualbert_torch/tools/xent_steps.py`` (K5/K6's design steps left out in
turn and timed), without a card: what runs here is the tool's refusals and
its switches in the source, each one the kernel library never sets, and
the SASS parse it shares with ``tools/attn_ab.py``."""

import re

import pytest
import torch

from visualbert_torch.ops import _build
from visualbert_torch.tools import xent_steps


@pytest.mark.parametrize("args,match", [([], "no CUDA device"), (["a", "b"], "at most one argument")])
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


def test_the_sass_parse_keys_the_shared_kernels_by_their_mangled_names():
    from visualbert_torch.tools.attn_ab import sass_of

    text = """
        Function : _ZN44_GLOBAL__N__x15xent_fwd_kernelILi768EEEvPK13__nv_bfloat16
        /*0000*/                   MOV R1, c[0x0][0x28] ;                  /* 0x00000a0000017a02 */
        /*0010*/                   BRA `(.L_x_7) ;                         /* 0x0000000000007947 */
        Function : _ZN44_GLOBAL__N__x15xent_bwd_kernelILi768ELb0EEEvPK13__nv_bfloat16
        /*0000*/                   EXIT ;                                  /* 0x000000000000794d */
    """
    got = sass_of(text, xent_steps.SHARED_KERNELS)
    assert got == {"K4 forward, 768": ["MOV R1, c[0x0][0x28]", "BRA `(.L0)"]}
