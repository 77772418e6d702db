"""The Python side of K13/K14 (``ops/flash_attention.py``, kernels in
``csrc/flash_attention_sp.cu``) without a card: the row stride of the saved
probabilities, the layout check and copy of K14's wrapper, the head groups
both query once a shape, and the plain path on a padded-stride view."""

import numpy as np
import pytest
import torch

from visualbert_torch.ops import _build
from visualbert_torch.ops import flash_attention as fa


@pytest.mark.parametrize("T,ldp", [(1, 8), (7, 8), (8, 8), (37, 40), (228, 232), (272, 272), (704, 704)])
def test_probs_rows_are_padded_to_16_bytes(T, ldp):
    assert fa.probs_row_stride(T) == ldp


def k13_buffer(B, H, T, ldp=None):
    """A [B, H, T, T] view of a [B, H, T, ldp] bf16 buffer, as K13 returns."""
    ldp = fa.probs_row_stride(T) if ldp is None else ldp
    return torch.zeros((B, H, T, ldp), dtype=torch.bfloat16)[..., :T]


@pytest.mark.parametrize("T", [1, 37, 228, 272])
def test_k14_reads_k13s_layout_in_place(T):
    assert fa.probs_layout(k13_buffer(2, 3, T), 2, 3, T) == fa.probs_row_stride(T)
    # a wider stride that is a multiple of 8 is read in place too
    assert fa.probs_layout(k13_buffer(2, 3, T, ldp=fa.probs_row_stride(T) + 8), 2, 3, T) == fa.probs_row_stride(T) + 8


@pytest.mark.parametrize("T,in_place", [(37, False), (228, False), (1, False), (272, True), (64, True)])
def test_contiguous_probs_are_read_in_place_only_at_t_a_multiple_of_8(T, in_place):
    flat = torch.zeros((2, 3, T, T), dtype=torch.bfloat16)
    assert fa.probs_layout(flat, 2, 3, T) == (T if in_place else None)


@pytest.mark.parametrize("what", ["shape", "dtype", "transposed", "stride not a multiple of 8", "misaligned"])
def test_the_layout_check_refuses_what_k14_cannot_read(what):
    B, H, T = 2, 3, 37
    probs = {
        "shape": lambda: torch.zeros((B, H, T, T + 1), dtype=torch.bfloat16),
        "dtype": lambda: torch.zeros((B, H, T, T)),
        "transposed": lambda: torch.zeros((B, H, T, T), dtype=torch.bfloat16).transpose(-1, -2),
        "stride not a multiple of 8": lambda: k13_buffer(B, H, T, ldp=T + 5),
        "misaligned": lambda: torch.zeros((B, H, T, 48), dtype=torch.bfloat16)[..., 1:T + 1],
    }[what]()
    with pytest.raises(ValueError, match="probs"):
        fa.probs_layout(probs, B, H, T)


def test_padded_copy_holds_the_same_probabilities():
    rng = np.random.RandomState(0)
    flat = torch.tensor(rng.rand(2, 3, 37, 37), dtype=torch.bfloat16)
    pad = fa.padded_probs(flat)
    assert pad.shape == flat.shape and pad.stride(2) == 40
    assert torch.equal(pad, flat)
    assert fa.probs_layout(pad, 2, 3, 37) == 40


def test_the_plain_backward_takes_the_padded_view():
    """On the CPU K14's wrapper runs the plain version, which reads a
    padded-stride view as it reads a contiguous tensor."""
    B, T, H, D = 2, 21, 2, 16
    rng = np.random.RandomState(1)
    qkv = torch.tensor(rng.randn(B, T, 3 * H * D).astype(np.float32))
    key_bias = torch.zeros((B, T))
    dout = torch.tensor(rng.randn(B, T, H * D).astype(np.float32))
    out, probs = fa.packed_attention_sp_fwd(qkv, key_bias, H, 0.1, 3)
    pad = fa.padded_probs(probs)
    want = fa.packed_attention_sp_bwd(qkv, probs, dout, out, H, 0.1, 3)
    assert torch.equal(fa.packed_attention_sp_bwd(qkv, pad, dout, out, H, 0.1, 3), want)


class OccupancyLib:
    """The occupancy queries of the kernel library, answering `per_sm`."""

    def __init__(self, per_sm):
        self.per_sm, self.queries = per_sm, []

    def vb_attn_packed_info(self, which, what, T):
        self.queries.append(("packed", which, what, T))
        return self.per_sm

    def vb_attn_sp_info(self, which, what, T):
        self.queries.append(("sp", which, what, T))
        return self.per_sm

    def vb_attn_hm_info(self, which, what, T):
        self.queries.append(("hm", which, what, T))
        return self.per_sm


@pytest.fixture
def card(monkeypatch):
    class Props:
        multi_processor_count = 132

    monkeypatch.setattr(fa, "_head_groups", {})
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: Props)
    return torch.device("cuda", 0)


@pytest.mark.parametrize("B,per_sm,hg", [(128, 2, 6), (96, 2, 1), (64, 2, 3), (2, 1, 1), (128, 1, 12)])
def test_sp_head_groups_follow_the_wave_model(card, B, per_sm, hg):
    lib = OccupancyLib(per_sm)
    assert fa.sp_head_groups(lib, B, 12, 228, card) == (hg, hg, hg)
    assert fa.sp_head_groups(lib, B, 12, 228, card) == (hg, hg, hg)
    assert lib.queries == [("sp", k, 3, 228) for k in range(3)]


def test_sp_and_packed_head_groups_are_kept_apart(card):
    lib = OccupancyLib(2)
    fa.sp_head_groups(lib, 128, 12, 272, card)
    fa.packed_head_groups(lib, 128, 12, 272, card)
    assert [q[0] for q in lib.queries] == ["sp"] * 3 + ["packed"] * 3


@pytest.mark.parametrize("B,per_sm,hg", [(128, 2, 6), (64, 2, 3), (128, 1, 12)])
def test_hm_head_groups_follow_the_wave_model_apart_from_the_others(card, B, per_sm, hg):
    """K11/K12 (csrc/flash_attention.cu) pick their head groups as K1/K2 do,
    from their own occupancy query, memoised apart from K1/K2's and K13/K14's."""
    lib = OccupancyLib(per_sm)
    assert fa.hm_head_groups(lib, B, 12, 228, card) == (hg, hg, hg)
    fa.packed_head_groups(lib, B, 12, 228, card)
    assert fa.hm_head_groups(lib, B, 12, 228, card) == (hg, hg, hg)
    assert lib.queries == [("hm", k, 3, 228) for k in range(3)] + [("packed", k, 3, 228) for k in range(3)]
    with pytest.raises(RuntimeError, match="K11/K12 forward: no block fits"):
        fa.hm_head_groups(OccupancyLib(0), B, 12, 704, card)


def test_no_block_fitting_an_sm_raises(card):
    with pytest.raises(RuntimeError, match="K13/K14 forward: no block fits"):
        fa.sp_head_groups(OccupancyLib(0), 128, 12, 228, card)


def test_the_library_binds_the_sp_entry_points():
    for name, n_args in (("vb_attn_sp_info", 3), ("vb_attn_sp_fwd", 14), ("vb_attn_sp_bwd", 18)):
        assert len(_build._SIGNATURES[name]) == n_args
    text = (_build.CSRC / "flash_attention_sp.cu").read_text()
    assert '#include "hopper_attn.cuh"' in text and "attn_common.cuh" not in text
