"""The launch plans of K4-K6's fp32 form (``csrc/mlm_xent_f32.cu``) and
wide form (``csrc/mlm_xent.cu``'s ``xent_wide_*``, bf16 and fp16 above
width 1024), without a card.

``ops/mlm_xent.py::f32_plan``, ``::fwd_plan``, ``::dx_plan`` and
``::de_plan`` choose the grids and the vocabulary splits in plain Python
from the kernels' tiling and the SM count; a slip there shows on the card
only as a row, vocabulary tile or column left out or done twice. Here the
plans are walked as the kernels walk them, at the main path's N = 3072, V =
30522 and ragged shapes, at widths 768 (fp32) and 1088, 2048 and 2560 (the
wide form), on a card of 132 SMs (an H100) and of 8: every (row block,
vocabulary tile) and every (row block, column range, vocabulary tile) is
covered exactly once, each split's tiles come after the previous split's
(the merge and reduce passes add the splits in ascending order), no split
is empty, and the grids have the expected sizes. The tiling is the one
``vb_xent_f32_geometry`` and ``vb_xent_wide_geometry`` report on the card
(``tests/test_torch_kernels_cuda.py`` checks it there).
"""

import re

import pytest
import torch

from visualbert_torch.ops import _build
from visualbert_torch.ops import mlm_xent as xe
from visualbert_torch.tools import xent_f32_steps

F32_ROWS, F32_TILE = 128, 256  # vb_xent_f32_geometry 0, 1
# vb_xent_wide_geometry: width step, K4 rows / block, K5/K6 resident rows, K4 tile, K5/K6 tile, columns a block
WIDE = (64, 128, 64, 64, 64, 512)
SMS = (132, 8)
VS = (30522, 4099, 70)


def covered_once(ranges, total):
    """The half-open ranges cover [0, total) with no gap and no overlap."""
    ranges = sorted(r for r in ranges if r[0] < r[1])
    return ranges[0][0] == 0 and ranges[-1][1] == total and all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


def split_tiles(S, per, n_tiles):
    """The vocabulary tiles of each split, in split order."""
    return [range(s * per, min(n_tiles, s * per + per)) for s in range(S)]


def assert_splits(S, per, n_tiles):
    tiles = split_tiles(S, per, n_tiles)
    assert all(len(t) > 0 for t in tiles), "a split without a vocabulary tile"
    flat = [t for split in tiles for t in split]
    assert flat == list(range(n_tiles)), "the splits, in order, are not the tiles in ascending order"


@pytest.mark.parametrize("sms", (264, 132, 16))
@pytest.mark.parametrize("V", VS)
@pytest.mark.parametrize("N", [3072, 1536, 257, 1])
def test_f32_plan_covers_every_row_block_and_tile_once(N, V, sms):
    """fp32 K4 and K5: block (x, s) takes rows [128 x, 128 x + 128) and the
    tiles of split s; every (row block, tile) once, and the partials have
    the shapes the kernels write."""
    plan = xe.f32_plan(N, V, F32_ROWS, F32_TILE, sms)
    row_blocks, S = plan["grid"]
    n_tiles = -(-V // F32_TILE)
    assert plan["tiles"] == n_tiles
    assert covered_once([(x * F32_ROWS, min(N, x * F32_ROWS + F32_ROWS)) for x in range(row_blocks)], N)
    assert (row_blocks - 1) * F32_ROWS < N  # no block without a row
    assert_splits(S, plan["per"], n_tiles)
    visits = [(x, t) for x in range(row_blocks) for split in split_tiles(S, plan["per"], n_tiles) for t in split]
    assert len(visits) == len(set(visits)) == row_blocks * n_tiles
    assert plan["pf_shape"] == (4, S, N) and plan["pi_shape"] == (S, N)


@pytest.mark.parametrize("H", [1, 7, 100, 200, 768, 1088, 2048, 2500])
@pytest.mark.parametrize("V", VS)
def test_f32_products_and_k6_cover_every_column_and_row_once(H, V):
    """The second products walk H in column chunks of F32_TILE (the last one
    ragged) and K6's cdiv(V, 128) blocks take every vocabulary row once."""
    assert covered_once([(c0, min(H, c0 + F32_TILE)) for c0 in range(0, H, F32_TILE)], H)
    blocks = -(-V // F32_ROWS)
    assert covered_once([(b * F32_ROWS, min(V, b * F32_ROWS + F32_ROWS)) for b in range(blocks)], V)


@pytest.mark.parametrize("slots,grid,per", [(132, (24, 11), 11), (264, (24, 11), 11), (16, (24, 2), 60)])
def test_f32_plan_at_the_main_path(slots, grid, per):
    """At N = 3072, V = 30522 on an H100 (132 SMs, one block an SM) the 24
    row blocks take 11 splits of 11 tiles: 264 blocks, two full waves."""
    plan = xe.f32_plan(3072, 30522, F32_ROWS, F32_TILE, slots)
    assert plan["grid"] == grid and plan["per"] == per
    if slots >= 132:
        assert grid[0] * grid[1] % slots == 0


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("V", VS)
@pytest.mark.parametrize("H", [1088, 2048, 2560])
@pytest.mark.parametrize("N", [3072, 257, 1])
def test_wide_fwd_plan_covers_every_row_block_and_tile_once(N, H, V, sms):
    rows, tile = WIDE[1], WIDE[3]
    plan = xe.fwd_plan(N, V, H, rows, tile, sms)
    row_blocks, S = plan["grid"]
    n_tiles = -(-V // tile)
    assert covered_once([(x * rows, min(N, x * rows + rows)) for x in range(row_blocks)], N)
    assert_splits(S, plan["per"], n_tiles)
    visits = [(x, t) for x in range(row_blocks) for split in split_tiles(S, plan["per"], n_tiles) for t in split]
    assert len(visits) == len(set(visits)) == row_blocks * n_tiles
    assert plan["pf_shape"] == (4, S, N) and plan["pi_shape"] == (S, N)


def part_panels(H, y, wg=None):
    """The 64-column panels column part y (a warpgroup wg of it) owns."""
    cols = WIDE[5]
    per_wg = cols // 64 // 2
    first = y * cols // 64 + (0 if wg is None else wg * per_wg)
    n = cols // 64 if wg is None else per_wg
    return [p for p in range(first, first + n) if p < H // 64]


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("V", VS)
@pytest.mark.parametrize("H", [1088, 1152, 2048, 2560])
@pytest.mark.parametrize("N", [3072, 257, 37, 1])
def test_wide_dx_plan_covers_every_row_tile_and_column_once(N, H, V, sms):
    """K5's block (x, y, z): rows [64 x, +64), the 512 columns of part y
    (its two warpgroups 256 each; the last part shorter) and the tiles of
    split z: every (row block, column panel, tile) once; no part is
    empty."""
    rows, tile, cols = WIDE[2], WIDE[4], WIDE[5]
    plan = xe.dx_plan(N, V, H, rows, tile, cols, sms)
    row_blocks, parts, S = plan["grid"]
    n_tiles = -(-V // tile)
    assert parts == -(-H // cols) and all(part_panels(H, y) for y in range(parts))
    panels = [p for y in range(parts) for wg in (0, 1) for p in part_panels(H, y, wg)]
    assert sorted(panels) == list(range(H // 64))
    assert_splits(S, plan["per"], n_tiles)
    visits = {(x, y, t) for x in range(row_blocks) for y in range(parts)
              for split in split_tiles(S, plan["per"], n_tiles) for t in split}
    assert len(visits) == row_blocks * parts * n_tiles
    assert covered_once([(x * rows, min(N, x * rows + rows)) for x in range(row_blocks)], N)
    assert plan["part_shape"] == (S, N, H)


@pytest.mark.parametrize("V", VS)
@pytest.mark.parametrize("H", [1088, 2048, 2560])
def test_wide_de_plan_covers_every_vocabulary_row_and_column_once(H, V):
    rows, cols = WIDE[2], WIDE[5]
    blocks, parts = xe.de_plan(V, H, rows, cols)["grid"]
    assert covered_once([(x * rows, min(V, x * rows + rows)) for x in range(blocks)], V)
    assert sorted(p for y in range(parts) for p in part_panels(H, y)) == list(range(H // 64))


@pytest.mark.parametrize("H,dx_grid,de_grid", [(2048, (48, 4, 3), (477, 4)), (2560, (48, 5, 3), (477, 5)),
                                                (1088, (48, 3, 4), (477, 3))])
def test_wide_grids_at_the_main_path(H, dx_grid, de_grid):
    """At N = 3072, V = 30522 on an H100: K4 24 row blocks of 128 x 11
    splits of 44 tiles; K5 48 row blocks x the column parts x the splits
    for about four blocks an SM; K6 477 vocabulary blocks x the parts."""
    fwd = xe.fwd_plan(3072, 30522, H, WIDE[1], WIDE[3], 132)
    assert fwd["grid"] == (24, 11) and fwd["per"] == 44
    assert xe.dx_plan(3072, 30522, H, WIDE[2], WIDE[4], WIDE[5], 132)["grid"] == dx_grid
    assert xe.de_plan(30522, H, WIDE[2], WIDE[5])["grid"] == de_grid


def test_every_width_above_1024_meets_the_wide_forms_smallest():
    """The wrapper hands the wide form multiples of 64 from the narrowest
    it takes (csrc/mlm_xent.cu's WIDE_MIN, 17 panels: its rings count on
    more panels than stages); every width above 1024 goes there."""
    src = (_build.CSRC / "mlm_xent.cu").read_text()
    wide_min = int(re.search(r"constexpr int WIDE_MIN = (\d+);", src).group(1))
    stages = max(int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
                 for name in ("WF_STAGES", "WB_STAGES"))
    assert wide_min // 64 > stages
    for h in range(1025, 4097):
        w = xe.kernel_width(h)
        assert xe.is_wide(h) and w % WIDE[0] == 0 and w >= wide_min and w - WIDE[0] < h <= w
    assert not xe.is_wide(1024) and xe.kernel_width(1024) == 1024


@pytest.mark.parametrize("dtype,H,products", [(torch.float32, 768, 2), (torch.float32, 2048, 2),
                                               (torch.bfloat16, 768, 2), (torch.bfloat16, 1024, 3),
                                               (torch.bfloat16, 2048, 5), (torch.bfloat16, 2560, 6),
                                               (torch.bfloat16, 1100, 4), (torch.float16, 1100, 2)])
def test_the_backward_forms_recompute_the_logits_once_a_column_range(dtype, H, products):
    """K5's and K6's N x V x H products: fp32 (and fp16 above 1024, which
    runs on the fp32 kernels) and the forms up to 768 (a block owns every
    column) two; 1024 and the bf16 wide form recompute the logits for every
    further 512-column range (at 2048: 5, 2.5x the 2 of the two
    products)."""
    assert xe.bwd_products(dtype, H) == products
    assert xe.runs_on_f32(dtype, H) == (dtype == torch.float32 or (dtype == torch.float16 and H > 1024))


def test_the_sources_name_the_tiling_the_plans_assume():
    """The constants in the sources that the plans here assume."""
    f32 = (_build.CSRC / "mlm_xent_f32.cu").read_text()
    assert re.search(rf"#define VB_F32_NTH {2 * F32_ROWS}\b", f32) and "constexpr int BM = NTH / 2;" in f32
    assert re.search(rf"constexpr int BN = {F32_TILE};", f32)
    wide = (_build.CSRC / "mlm_xent.cu").read_text()
    for name, value in (("WF_ROWS", WIDE[1]), ("WF_TILE", WIDE[3]), ("WB_TILE", WIDE[4]), ("WB_COLS", WIDE[5])):
        assert re.search(rf"constexpr int {name} = {value};", wide), name


@pytest.mark.parametrize("args,match", [([], "no CUDA device"), (["a"], "takes no arguments")])
def test_the_f32_steps_tool_runs_only_on_the_card(monkeypatch, args, match):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match=match):
        xent_f32_steps.main(args)


@pytest.mark.parametrize("macro", sorted({d[2:].split("=")[0] for ds in xent_f32_steps.BUILDS.values() for d in ds}))
def test_each_f32_design_switch_is_one_the_library_never_sets(macro):
    """tools/xent_f32_steps.py's builds change one choice of
    csrc/mlm_xent_f32.cu each, through a switch with a default in the
    source that the library's build never passes."""
    text = (_build.CSRC / "mlm_xent_f32.cu").read_text()
    assert len(re.findall(rf"#ifndef {macro}\b", text)) == 1
    assert not any(macro in flag for flag in _build.ARCH_FLAGS + _build.NVCC_FLAGS)
    assert len({tuple(ds) for ds in xent_f32_steps.BUILDS.values()}) == len(xent_f32_steps.BUILDS)
