"""``visualbert_torch/tools/attn_steps.py`` (K1/K2's design steps left out in
turn, and the Philox rate) and the head groups K1/K2 query once a shape,
without a card: what runs here is the tool's refusals, its switches in the
source, its count of Philox warp calls, and the memo of
``ops/flash_attention.py::packed_head_groups``."""

import math
import re

import pytest
import torch

from visualbert_torch.ops import _build
from visualbert_torch.ops import flash_attention as fa
from visualbert_torch.tools import attn_steps


@pytest.mark.parametrize("args,match", [([], "no CUDA device"), (["1"], "no arguments")])
def test_the_tool_runs_only_on_the_card_and_takes_no_arguments(monkeypatch, args, match):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match=match):
        attn_steps.main(args)


def text_with_headers(source):
    """A source under csrc and the text of every csrc header it includes."""
    text = (_build.CSRC / source).read_text()
    return text + "".join((_build.CSRC / h).read_text() for h in re.findall(r'#include "(\w+\.cuh)"', text))


@pytest.mark.parametrize("name", ["philox per row", "sync loads", "sp sync loads"])
def test_each_left_out_step_is_a_switch_the_library_never_sets(name):
    source, defines = attn_steps.BUILDS[name]
    text = text_with_headers(source)
    (macro,) = [d[2:] for d in defines]
    assert len(re.findall(rf"#ifdef {macro}\b", text)) == 1
    assert not any(macro in flag for flag in _build.ARCH_FLAGS + _build.NVCC_FLAGS)
    assert (_build.CSRC / attn_steps.BUILDS["philox rate"][0]).exists()


def warp_calls_of_the_kernels(T):
    """Warp iterations of a pass over one (b, h) pair that make a Philox
    call, as flash_attention_packed.cu's loops run: 64-row tiles of 4 warps
    (16 rows each, lanes g and g + 8), 8 column blocks of 8 a 64-column tile
    (lanes' columns 2 tq, 2 tq + 1); a lane calls where its column and its
    row pair lie below T, and a warp issues the call if any lane does."""
    Tp = -(-T // 64) * 64
    n = 0
    for r0 in range(0, Tp, 64):
        for warp in range(4):
            rows = [r0 + warp * 16 + g + e for g in range(8) for e in (0, 8)]
            row_ok = any((r & ~1) < T for r in rows)
            for c0 in range(0, Tp, 64):
                for nt in range(8):
                    col_ok = any(c0 + nt * 8 + 2 * tq < T for tq in range(4))
                    n += row_ok and col_ok
    return n


@pytest.mark.parametrize("T", [1, 37, 64, 130, 228, 272])
def test_philox_warp_calls_are_counted_as_the_kernels_make_them(T):
    assert warp_calls_of_the_kernels(T) == math.ceil(T / 16) * math.ceil(T / 8)
    rate = dict(cycles_per_warp_call=100.0, sm_ghz=1.5)
    want = 2 * 3 * 12 * warp_calls_of_the_kernels(T) / (132 * 4) * 100.0 / 1.5e6
    assert attn_steps.philox_alone_ms(rate, 3, T, 132, calls_per_iteration=2) == pytest.approx(want)


def test_packed_head_groups_query_the_occupancy_once_a_shape(monkeypatch):
    queries = []

    class Lib:
        def vb_attn_packed_info(self, which, what, T):
            queries.append((which, what, T))
            return 2

    class Props:
        multi_processor_count = 132

    monkeypatch.setattr(fa, "_head_groups", {})
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: Props)
    dev = torch.device("cuda", 0)
    assert fa.packed_head_groups(Lib(), 128, 12, 228, dev) == (6, 6, 6)
    assert fa.packed_head_groups(Lib(), 128, 12, 228, dev) == (6, 6, 6)
    assert queries == [(k, 3, 228) for k in range(3)]
    assert fa.packed_head_groups(Lib(), 96, 12, 228, dev) == (1, 1, 1)
    assert len(queries) == 6


@pytest.mark.parametrize("args,match", [(["/nonexistent"], "another checkout"), ([], "another checkout"),
                                        ([".", "."], "another checkout")])
def test_the_ab_tool_takes_one_checkout(args, match):
    from visualbert_torch.tools import attn_ab

    with pytest.raises(SystemExit, match=match):
        attn_ab.main(args)


def test_the_ab_tool_needs_a_card(monkeypatch):
    from visualbert_torch.tools import attn_ab

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        attn_ab.main([str(_build.CSRC.parent.parent)])


def test_the_ab_tool_reads_each_kernels_sass_apart():
    """Instructions keyed by kernel, addresses and encodings dropped, branch
    labels renumbered within each function (two builds number them apart)."""
    from visualbert_torch.tools import attn_ab

    text = """
        Function : _ZN9vb_hopper12_GLOBAL__N_114attn_dq_kernelINS0_12PackedLayoutEEEvPK
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x00000a00ff017b82 */
                                                                     /* 0x000fe40000000800 */
        /*0010*/              @P0 BRA `(.L_x_7) ;                  /* 0x0000000000000947 */
        /*0020*/                   BRA `(.L_x_9) ;                 /* 0x0000000000000947 */
        Function : _ZN12_GLOBAL__N_117packed_fwd_kernelEPK13__nv_bfloat16
        /*0000*/                   BRA `(.L_x_2) ;                 /* 0x0000000000000947 */
        Function : _Z5otherv
        /*0000*/                   EXIT ;                          /* 0x000000000000794d */
    """
    assert attn_ab.sass_of(text) == {"dQ pass": ["LDC R1, c[0x0][0x28]", "@P0 BRA `(.L0)", "BRA `(.L1)"],
                                     "forward": ["BRA `(.L0)"]}
