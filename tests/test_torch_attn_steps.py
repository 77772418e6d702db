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


@pytest.mark.parametrize("args", [["--only", "f32"], ["--only", "f32", "--only", "f32"],
                                  ["--only", "f32", "no-such-checkout"]])
def test_the_ab_tools_fp32_options_still_take_one_checkout(args):
    from visualbert_torch.tools import attn_ab

    with pytest.raises(SystemExit, match="another checkout"):
        attn_ab.main(args)
    with pytest.raises(SystemExit, match="another checkout"):
        attn_ab.main(args + [".", "."])


def test_the_ab_tools_fp32_part_needs_a_card(monkeypatch):
    from visualbert_torch.tools import attn_ab

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        attn_ab.main([str(_build.CSRC.parent.parent), "--only", "f32"])


@pytest.mark.parametrize("only", ["", "f32,nope", "--f32"])
def test_the_ab_tool_runs_only_its_own_parts(monkeypatch, only):
    """--only takes a comma-separated list of PARTS and nothing else; a
    checkout alone runs them all."""
    from visualbert_torch.tools import attn_ab

    root = str(_build.CSRC.parent.parent)
    with pytest.raises(SystemExit, match="--only takes some of"):
        attn_ab.main([root, "--only", only])
    assert attn_ab.parse([root]) == (root, attn_ab.PARTS)
    assert attn_ab.parse(["--only", "small_forwards,sass", root]) == (root, ("small_forwards", "sass"))


def test_the_ab_tool_builds_each_trees_fp32_source_alone(monkeypatch, tmp_path):
    """One nvcc a tree, started together, each on that tree's
    flash_attention_f32.cu with its own headers; every entry point the
    launches need is bound."""
    from visualbert_torch.tools import attn_ab

    cmds, bound = [], {}
    monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build, "_run_all", lambda c: (cmds.extend(c), [(x, 0, "") for x in c])[1])
    monkeypatch.setattr(attn_ab, "bind", lambda path, fns: bound.setdefault(str(path), fns))
    this, other = _build.CSRC.parent.parent, tmp_path / "parent"
    libs = attn_ab.build_f32({"this": this, "other": other})
    assert set(libs) == {"this", "other"} and len(cmds) == 2
    by_src = {c[c.index("-shared") + 1]: c for c in cmds}
    assert set(by_src) == {str(this / attn_ab.F32_SOURCE), str(other / attn_ab.F32_SOURCE)}
    for root, c in zip((this, other), (by_src[str(this / attn_ab.F32_SOURCE)], by_src[str(other / attn_ab.F32_SOURCE)])):
        assert c[c.index("-I") + 1] == str(root / attn_ab.SOURCE.parent)
    assert all(fns == attn_ab.F32_FNS for fns in bound.values()) and len(bound) == 2
    assert set(attn_ab.F32_FNS) <= set(_build._SIGNATURES)


def test_another_trees_fp32_backward_gets_a_row_of_bias_partials_a_batch_row(monkeypatch):
    """A build without ``vb_attn_f32_geometry`` (blocks that own whole
    pairs) is launched through WholePairs: the wrapper hands it one row of
    bias partials a batch row and sums those; this tree's build is used as
    it is."""
    import ctypes

    import numpy as np

    from visualbert_torch.ops import flash_attention as fa
    from visualbert_torch.tools import attn_ab

    class Old:
        def __init__(self, parts):
            self.parts = np.ascontiguousarray(parts, dtype=np.float32)

        def vb_attn_f32_bwd(self, *args):
            ctypes.memmove(args[7], self.parts.ctypes.data, self.parts.nbytes)
            return 0

    class New:
        def vb_attn_f32_geometry(self, which):
            return 64

    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    B, T, H, D = 2, 228, 2, 8
    parts = np.random.RandomState(0).randn(B, 1, 3 * H * D)
    old, new = attn_ab.F32Build("other", Old(parts)), attn_ab.F32Build("this", New())
    assert isinstance(old.lib, attn_ab.WholePairs) and isinstance(new.lib, New)
    assert fa.f32_bias_tiles(old.lib, T) == 1 and fa.f32_bias_tiles(new.lib, T) == 4
    qkv, out = torch.zeros((B, T, 3 * H * D)), torch.zeros((B, T, H * D))
    data = {"packed": (qkv, torch.zeros(3 * H * D), torch.zeros((B, T)), out), "H": H}
    dqkv, dqb = old.bwd("K1/K2", data, (out, torch.zeros((B, H, T))), 0.1, 3)
    np.testing.assert_allclose(dqb.numpy(), parts.sum(axis=(0, 1)), rtol=1e-5, atol=1e-5)


def test_the_ab_tool_reads_k1s_fp32_forward_apart():
    """K1/K11's fp32 forward, by its instantiations, and nothing of the
    other tiled kernels beside it (K13's forward, the backward)."""
    from visualbert_torch.tools import attn_ab

    text = """
        Function : _ZN12_GLOBAL__N_125attn_f32_tiled_fwd_kernelILi64EEEvPKfS2_S2_PfS3_iiiNS_6LayoutEjjfiif
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x00000a00ff017b82 */
        /*0010*/              @P0 BRA `(.L_x_4) ;                  /* 0x0000000000000947 */
        Function : _ZN12_GLOBAL__N_128attn_f32_tiled_sp_fwd_kernelILi64EEEvPKfS2_PfP13__nv_bfloat16iiiiNS_6LayoutE
        /*0000*/                   BRA `(.L_x_1) ;                 /* 0x0000000000000947 */
        Function : _ZN12_GLOBAL__N_124attn_f32_tiled_dq_kernelILi64ELb0EEEvPKfS2_S2_S2_S2_S2_PK13__nv_bfloat16
        /*0000*/                   EXIT ;                          /* 0x000000000000794d */
    """
    assert attn_ab.sass_of(text, attn_ab.F32_SASS) == {"K1/K11 fp32 forward at DP 64":
                                                       ["LDC R1, c[0x0][0x28]", "@P0 BRA `(.L0)"]}


@pytest.mark.parametrize("errors,ok", [
    (dict(out=9e-5, stats=9e-5, dqkv=9e-5, dqb=9e-5), True),
    (dict(out=9e-5, probs_ulps=1.0, dqkv=9e-5), True),
    (dict(out=2e-4, stats=0.0, dqkv=0.0), False),
    (dict(out=0.0, stats=2e-4, dqkv=0.0), False),
    (dict(out=0.0, probs_ulps=2.0, dqkv=0.0), False),
    (dict(out=0.0, stats=0.0, dqkv=0.0, dqb=2e-4), False),
])
def test_the_ab_tool_holds_the_fp32_kernels_to_chip_smokes_limits(errors, ok):
    from visualbert_torch.tools import attn_ab

    assert attn_ab.f32_within(errors) is ok


def test_the_ab_tool_binds_each_backwards_small_form_entry_points(monkeypatch, tmp_path):
    """Each tree's packed, heads-major and save-probs sources are built
    alone (and, for their machine code alone, the other sources that
    SASS_ONLY_SOURCES names), and the entry points that launch K1's, K2's,
    K11's, K12's and K14's other forms (their small-row forms here, the
    padded route in another tree) are bound with the library's
    signatures."""
    from visualbert_torch.tools import attn_ab

    cmds, bound = [], {}
    monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build, "_run_all", lambda c: (cmds.extend(c), [(x, 0, "") for x in c])[1])
    monkeypatch.setattr(attn_ab, "bind", lambda path, fns: bound.setdefault(str(path), fns))
    attn_ab.build({"this": _build.CSRC.parent.parent, "other": tmp_path / "parent"})
    assert len(cmds) == 2 * (2 + len(attn_ab.OTHER_SOURCES) + len(attn_ab.SASS_ONLY_SOURCES))
    assert sum(str(c[-3]).endswith("mlm_xent.cu") for c in cmds) == 2
    for fns in (attn_ab.PACKED_X_FNS, attn_ab.HM_X_FNS, attn_ab.SP_X_FNS):
        assert sum(set(fns) <= set(b) for b in bound.values()) == 2
        assert set(fns) <= set(_build._SIGNATURES)


def small_cpu_inputs(D, H=12):
    """A stand-in for attn_ab.f32_inputs on the CPU at B = 2, T = 37 (a
    row's last keys masked), in its "packed" form."""
    import numpy as np

    rng = np.random.RandomState(0)
    B, T, F = 2, 37, 3 * H * D
    qkv = torch.tensor(rng.randn(B, T, F), dtype=torch.float32)
    qb = torch.tensor(rng.randn(F) * 0.1, dtype=torch.float32)
    key_bias = torch.zeros(B, T)
    key_bias[0, -5:] = -10000.0
    return {"packed": (qkv, qb, key_bias, torch.tensor(rng.randn(B, T, H * D), dtype=torch.float32))}


@pytest.mark.parametrize("dp", ["unpadded", 64])
@pytest.mark.parametrize("dtype,D", [("bfloat16", 16), ("float16", 32)])
@pytest.mark.parametrize("pair", ["K2", "K12", "K14"])
def test_the_ab_tool_runs_each_backward_unpadded_and_padded_as_its_wrapper(monkeypatch, pair, dtype, D, dp):
    """small_forms_ab's calls without a card: each backward's inputs on the
    plain forward's outputs (K12 heads-major, K14 on K13's probabilities in
    their row layout), zero-padded to the head dim a tree runs (D here, 64
    in the other tree) at the unpadded D's scale and the gradients cut back,
    give the plain backward's outputs; the launches are stand-ins that run
    the plain versions on what they are given."""
    from visualbert_torch.tools import attn_ab

    monkeypatch.setattr(attn_ab, "f32_inputs", lambda D, H=12: small_cpu_inputs(D, H))
    monkeypatch.setattr(fa, "launch_packed_x_bwd", lambda lib, qkv, qb, kb, dout, out, stats, H, rate, seed, a, b,
                        scale: (0,) + fa.packed_attention_bwd_reference(qkv, qb, kb, dout, out, stats, H, rate, seed,
                                                                         scale=scale))
    monkeypatch.setattr(fa, "launch_hm_x_bwd", lambda lib, qkv, kb, dout, out, stats, rate, seed, a, b, scale: (
        0, fa.heads_major_attention_bwd_reference(qkv, kb, dout, out, stats, rate, seed, scale=scale)))
    monkeypatch.setattr(fa, "launch_sp_x_bwd", lambda lib, qkv, probs, ldp, dout, out, H, rate, seed, a, b, scale: (
        0, fa.packed_attention_sp_bwd_reference(qkv, probs, dout, out, H, rate, seed, scale=scale)))
    H, head_dim = 3, D if dp == "unpadded" else dp
    d, want = attn_ab.small_pair_inputs(pair, dtype, D, H, 0.1, 5)
    assert ("probs" in d) == (pair == "K14") and ("stats" in d) == (pair != "K14")
    code, got = attn_ab.small_pair_call(pair, None, d, H, 0.1, 5, D, head_dim, (1, 1))
    errors, ok = attn_ab.small_pair_errors(pair, got, want)
    assert code == 0 and ok and set(errors) == ({"dqkv", "dqb"} if pair == "K2" else {"dqkv"})
    assert got[0].shape == want[0].shape and got[0].dtype == getattr(torch, dtype)
    assert errors["dqkv"] <= 1e-6


def test_another_trees_d128_backward_gets_a_row_of_bias_partials_a_batch_row(monkeypatch):
    """K2 at head dim 128 of a build without ``vb_attn_packed_x_bias_rows``
    (its passes held a head's rows, a block a batch row) goes through
    BiasRows: the wrapper hands it one row of bias partials a batch row and
    sums those; a build with the entry point keeps its own rows."""
    import ctypes

    import numpy as np

    from visualbert_torch.ops import flash_attention as fa
    from visualbert_torch.tools import attn_ab

    class Old:
        def __init__(self, parts):
            self.parts = np.ascontiguousarray(parts, dtype=np.float32)

        def vb_attn_packed_x_bwd(self, *args):
            ctypes.memmove(args[7], self.parts.ctypes.data, self.parts.nbytes)
            return 0

    class New:
        def vb_attn_packed_x_bias_rows(self, dh, T):
            return -(-T // 128)

    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    B, T, H, D = 2, 228, 1, 128
    parts = np.random.RandomState(1).randn(B, 1, 3 * H * D)
    old, new = attn_ab.BiasRows(Old(parts)), attn_ab.BiasRows(New())
    assert fa.packed_bias_rows(old, D, T) == 1 and fa.packed_bias_rows(new, D, T) == 2
    qkv, qb = torch.zeros((B, T, 3 * H * D), dtype=torch.bfloat16), torch.zeros(3 * H * D, dtype=torch.bfloat16)
    out = torch.zeros((B, T, H * D), dtype=torch.bfloat16)
    code, dqkv, dqb = fa.launch_packed_x_bwd(old, qkv, qb, torch.zeros((B, T)), out, out, torch.zeros((B, H, T)), H,
                                             0.1, 3, 1, 1, 1.0 / 128 ** 0.5)
    assert code == 0 and dqb.dtype == torch.bfloat16
    np.testing.assert_allclose(dqb.float().numpy(), parts.sum(axis=(0, 1)), rtol=1e-2, atol=1e-2)
    assert attn_ab.STREAMED_SHAPES[0] == (128, 228) and max(T for _, T in attn_ab.STREAMED_SHAPES) <= 256
