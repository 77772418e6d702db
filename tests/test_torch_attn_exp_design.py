"""K15/K16's kernels (``csrc/flash_attention_exp.cu``) without a card: the
source is on K1/K2's Hopper blocks, the library binds its entry points, and
each ``VARIANTS`` entry and K16 head group launches the kernels with the
(batch rows, heads) a block, grid and bias-gradient partials worked out
here by hand from ``scripts/attn_exp.py``'s and ``scripts/attn_hgrid.py``'s
definitions. The kernels themselves run in ``tests/test_torch_kernels_cuda.py``
on the card."""

import ctypes
import re

import pytest
import torch

from visualbert_torch.ops import _build
from visualbert_torch.ops import attention_exp as ae
from visualbert_torch.ops import flash_attention as fa

H, D = 12, 64
# name: ((forward rows, heads), (backward rows, heads), numerics flags) at H = 12:
# make_variant's forward takes bb rows x every head, its backward bb rows x
# group heads (one with nostack); group defaults to 12, bb to 1
WANT = {
    "base": ((1, 12), (1, 12), ()),
    "prescale": ((1, 12), (1, 12), ("prescale",)),
    "g6": ((1, 12), (1, 6), ()),
    "g3": ((1, 12), (1, 3), ()),
    "nostack": ((1, 12), (1, 1), ()),
    "prescale_nostack": ((1, 12), (1, 1), ("prescale",)),
    "bb2": ((2, 12), (2, 12), ()),
    "bb4": ((4, 12), (4, 12), ()),
    "bb8": ((8, 12), (8, 12), ()),
    "bb2_g6": ((2, 12), (2, 6), ()),
    "fdrop": ((1, 12), (1, 12), ("fdrop",)),
    "nomax": ((1, 12), (1, 12), ("nomax",)),
    "fdrop_prescale": ((1, 12), (1, 12), ("fdrop", "prescale")),
}


def source():
    return (_build.CSRC / "flash_attention_exp.cu").read_text()


def test_the_source_is_built_on_the_hopper_blocks():
    text = source()
    assert '#include "hopper_attn.cuh"' in text and "attn_common.cuh" not in text
    assert not (_build.CSRC / "attn_common.cuh").exists()
    for block in ("issue_tile", "cp_commit", "product_ss", "product_rs", "keep_bits<false>", "keep_bits<true>"):
        assert block in text, block
    for first_design in ("mma16816", "load_a<", "load_b_rows", "load_b_cols", "mma.sync"):
        assert first_design not in text, first_design
    head = "".join(text.splitlines(keepends=True)[:4])  # the TPU kernels it replaces, by file and line
    assert "scripts/attn_exp.py::make_variant" in head and "scripts/attn_hgrid.py::make_hgrid" in head


def test_the_library_binds_the_experiment_entry_points():
    i = ctypes.c_int
    assert _build._SIGNATURES["vb_attn_exp_info"] == [i, i, i, i, i]
    assert _build.restype("vb_attn_exp_info") is i
    for name, n_args in (("vb_attn_exp_smem_bytes", 1), ("vb_attn_exp_fwd", 17), ("vb_attn_exp_bwd", 21)):
        assert len(_build._SIGNATURES[name]) == n_args
    names = list(_build._SIGNATURES)
    assert names.index("vb_attn_exp_info") == names.index("vb_attn_exp_smem_bytes") + 1


def test_every_variant_has_a_worked_schedule():
    assert set(WANT) == set(ae.VARIANTS)


def parameters(name):
    """The parameter names of C entry point ``name`` of the source, in order."""
    (params,) = re.findall(r'extern "C"[^(]*\b' + name + r"\s*\(([^)]*)\)", source())
    return [re.findall(r"(\w+)\s*$", p.strip())[0] for p in params.split(",")]


class RecordingLib:
    """Records each entry point's call with its arguments by parameter
    name and answers 0 (success)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            names = parameters(name)
            assert len(args) == len(names) == len(_build._SIGNATURES[name])
            self.calls.append((name, dict(zip(names, args))))
            return 0

        return call

    def check(self, code, what):
        assert code == 0


def inputs(B, T=37):
    F = 3 * H * D
    qkv = torch.zeros((B, T, F), dtype=torch.bfloat16)
    return qkv, torch.zeros(F, dtype=torch.bfloat16), torch.zeros((B, T)), torch.zeros((B, T, H * D),
                                                                                      dtype=torch.bfloat16)


@pytest.fixture
def lib(monkeypatch):
    """The wrappers launch on CPU tensors into a recording library."""
    rec = RecordingLib()
    monkeypatch.setattr(fa, "_on_cuda", lambda what, x: True)
    monkeypatch.setattr(fa, "_check_packed", lambda *a, **k: rec)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    return rec


CASES = [(name, B) for name in WANT for B in (96, 128)]


@pytest.mark.parametrize("name,B", CASES)
def test_each_variant_launches_its_schedule(lib, name, B):
    (fr, fh), (br, bh), flags = WANT[name]
    kw = ae.VARIANTS[name] or {}
    assert ae.schedules(B, H, **kw) == {"forward": (fr, fh), "backward": (br, bh)}
    qkv, qb, key_bias, dout = inputs(B)
    out, stats = ae.attn_exp_fwd(qkv, qb, key_bias, H, 0.1, 3, **kw)
    ae.attn_exp_bwd(qkv, qb, key_bias, dout, out, stats, H, 0.1, 3, **kw)
    (f_name, f), (b_name, b) = lib.calls
    assert (f_name, b_name) == ("vb_attn_exp_fwd", "vb_attn_exp_bwd")
    assert (f["B"], f["T"], f["H"], f["rows"], f["heads"]) == (B, 37, H, fr, fh)
    assert (b["B"], b["T"], b["H"], b["rows"], b["heads"]) == (B, 37, H, br, bh)
    assert (f["prescale"], f["nomax"]) == (int("prescale" in flags), int("nomax" in flags))
    assert (b["prescale"], b["fdrop"]) == (int("prescale" in flags), int("fdrop" in flags))
    # the grid: every (batch row, head) pair in exactly one block
    gx, gy = ae.grid(B, H, br, bh)
    assert (gx, gy) == (B // br, -(-H // bh))
    pairs = sorted((x * br + i, y * bh + j) for x in range(gx) for y in range(gy) for i in range(br)
                   for j in range(bh) if y * bh + j < H)
    assert pairs == [(b_, h) for b_ in range(B) for h in range(H)]


@pytest.mark.parametrize("name,B,grid", [("base", 128, (128, 1)), ("g3", 128, (128, 4)), ("nostack", 128, (128, 12)),
                                         ("bb8", 128, (16, 1)), ("bb2_g6", 96, (48, 2)), ("bb4", 96, (24, 1))])
def test_backward_grids_and_partials(monkeypatch, name, B, grid):
    """The backward grid of a few variants worked out by hand, and the
    bias-gradient partials: one fp32 row a block row."""
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    rows, heads = ae.schedules(B, H, **(ae.VARIANTS[name] or {}))["backward"]
    assert ae.grid(B, H, rows, heads) == grid
    qkv, qb, key_bias, dout = inputs(B, T=5)
    stats = torch.zeros((B, H, 5))
    code, dqkv, db_part = ae.launch_exp_bwd(RecordingLib(), qkv, qb, key_bias, dout, dout, stats, H, 0.1, 3, rows,
                                            heads)
    assert code == 0 and dqkv.shape == qkv.shape
    assert db_part.shape == (grid[0], 3 * H * D) and db_part.dtype == torch.float32


@pytest.mark.parametrize("hg", [1, 2, 3, 4, 6, 12])
def test_each_head_group_launches_one_batch_row_a_block(lib, hg):
    B = 4
    assert ae.schedules(B, H, hg=hg) == {"forward": (1, hg), "backward": (1, hg)}
    assert ae.grid(B, H, 1, hg) == (B, H // hg)
    qkv, qb, key_bias, dout = inputs(B)
    out, stats = ae.attn_hgrid_fwd(qkv, qb, key_bias, H, 0.1, 3, hg)
    assert stats.shape == (B, H // hg, hg, 37)
    ae.attn_hgrid_bwd(qkv, qb, key_bias, dout, out, stats, H, 0.1, 3, hg)
    (_, f), (_, b) = lib.calls
    for call in (f, b):
        assert (call["rows"], call["heads"], call["prescale"]) == (1, hg, 0)
    assert (f["nomax"], b["fdrop"]) == (0, 0)


def test_prescale_backward_names_its_largest_t(lib):
    T = ae.PRESCALE_MAX_T + 1
    qkv, qb, key_bias, dout = inputs(1, T)
    stats = torch.zeros((1, H, T))
    with pytest.raises(ValueError, match=f"T up to {ae.PRESCALE_MAX_T}, got T={T}"):
        ae.attn_exp_bwd(qkv, qb, key_bias, dout, dout, stats, H, 0.1, 3, prescale=True)
    assert lib.calls == []
    ae.attn_exp_bwd(qkv, qb, key_bias, dout, dout, stats, H, 0.1, 3)  # the other variants take it
    ae.attn_exp_fwd(qkv, qb, key_bias, H, 0.1, 3, prescale=True)     # and prescale's forward
    assert [n for n, _ in lib.calls] == ["vb_attn_exp_bwd", "vb_attn_exp_fwd"]
