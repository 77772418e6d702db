"""The fp32 attention backward's QKV-bias gradient on the CPU: the wrapper
(``ops/flash_attention.py::launch_f32_bwd``) hands the kernels a partials
buffer of one row a (batch row, tile of the library's
``vb_attn_f32_geometry(0)`` rows) and sums its rows in one fixed reduction;
here a stand-in library writes known partials into that buffer and the sum
is held against numpy's sum of the same partials."""

import ctypes

import numpy as np
import pytest
import torch

from visualbert_torch.ops import _build
from visualbert_torch.ops import flash_attention as fa


class PartialsLib:
    """Stands in for the kernel library: backward tiles of ``rows`` rows, and
    a ``vb_attn_f32_bwd`` that writes ``partials`` (B x tiles x F floats)
    into the db_part buffer it is given."""

    def __init__(self, partials=np.zeros(0), rows=64):
        self.partials = np.ascontiguousarray(partials, dtype=np.float32)
        self.rows = rows
        self.calls = []

    def vb_attn_f32_geometry(self, which):
        return self.rows if which == 0 else -1

    def vb_attn_f32_bwd(self, *args):
        self.calls.append(args)
        db_part = args[7]
        ctypes.memmove(db_part, self.partials.ctypes.data, self.partials.nbytes)
        return 0


@pytest.mark.parametrize("T,tiles", [(1, 1), (63, 1), (64, 1), (65, 2), (228, 4), (1000, 16)])
def test_bias_tiles_are_the_64_row_tiles_of_t(T, tiles):
    assert fa.f32_bias_tiles(PartialsLib(), T) == tiles


@pytest.mark.parametrize("B,tiles,F", [(1, 1, 48), (2, 4, 2304), (128, 4, 96), (3, 16, 7)])
def test_the_partials_sum_to_numpys_sum(B, tiles, F):
    """Over the B x tiles rows, within fp32 rounding of numpy's float64 sum;
    the same on a second call, bit for bit."""
    parts = np.random.RandomState(B * tiles + F).randn(B, tiles, F).astype(np.float32)
    got = fa.sum_bias_partials(torch.tensor(parts))
    want = parts.astype(np.float64).reshape(-1, F).sum(axis=0)
    assert got.shape == (F,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(parts).sum(axis=(0, 1)).max())
    assert torch.equal(got, fa.sum_bias_partials(torch.tensor(parts)))


def launch(lib, B, T, H, D):
    """launch_f32_bwd on zero CPU inputs: (code, dqkv, dqb), the call's
    arguments."""
    F = 3 * H * D
    qkv, out = torch.zeros((B, T, F)), torch.zeros((B, T, H * D))
    code, dqkv, dqb = fa.launch_f32_bwd(lib, qkv, torch.zeros(F), torch.zeros((B, T)), out, out,
                                        torch.zeros((B, H, T)), H, 0.1, 3)
    (args,) = lib.calls
    return code, dqkv, dqb, args


@pytest.mark.parametrize("B,T,H,D", [(2, 37, 2, 8), (3, 228, 2, 16), (1, 130, 1, 100), (2, 1, 3, 4)])
def test_launch_f32_bwd_sums_the_partials_of_every_tile(monkeypatch, B, T, H, D):
    """The wrapper's buffer holds B x ceil(T / 64) rows of F = 3 H D, and the
    bias gradient it returns is their sum."""
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    F = 3 * H * D
    parts = np.random.RandomState(T).randn(B, -(-T // 64), F)
    code, dqkv, dqb, args = launch(PartialsLib(parts), B, T, H, D)
    assert code == 0 and dqkv.shape == (B, T, F) and args[9:13] == (B, T, H, D)
    np.testing.assert_allclose(dqb.numpy(), parts.reshape(-1, F).sum(axis=0), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("rows,tiles", [(32, 8), (64, 4), (1 << 30, 1)])
def test_the_wrapper_sizes_the_partials_by_the_librarys_tile_rows(monkeypatch, rows, tiles):
    """At T = 228, a library whose backward tiles ``rows`` rows fills B x
    ceil(228 / rows) rows of partials (one a batch row where a block owns a
    whole pair), and the wrapper sums exactly those."""
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    B, T, H, D = 2, 228, 2, 8
    parts = np.random.RandomState(rows % 97).randn(B, tiles, 3 * H * D)
    lib = PartialsLib(parts, rows)
    assert fa.f32_bias_tiles(lib, T) == tiles
    _, _, dqb, _ = launch(lib, B, T, H, D)
    np.testing.assert_allclose(dqb.numpy(), parts.sum(axis=(0, 1)), rtol=1e-5, atol=1e-4)
