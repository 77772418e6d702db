"""The grids of the MLM cross-entropy kernels (K4, K5, K6), without a card.

``ops/mlm_xent.py::fwd_plan``, ``::dx_plan`` and ``::de_plan`` choose the
grids and K4's and K5's vocabulary splits in plain Python from the kernels'
tiling and the card's SM count; a slip there shows on the card only as a row
or vocabulary tile left out or done twice, or a partials buffer of the wrong
size. Here the plans are walked as the kernels walk them
(``csrc/mlm_xent.cu::xent_fwd_kernel``, ``::xent_bwd_kernel``) at both
widths, for the main path's vocabulary and two ragged ones, on a card of 132
SMs (an H100) and of 8: every row, vocabulary tile and result column is
covered exactly once, no split is empty, and the partials have the shape the
kernel writes. The tiling is the one ``vb_xent_geometry`` reports on the card
(``tests/test_torch_kernels_cuda.py`` checks it there).
"""

import pytest

from visualbert_torch.ops import mlm_xent as xe

# width -> (rows of a block, streamed rows of a tile, result columns of a block)
TILING = {768: (64, 32, 768), 1024: (64, 16, 512)}
# K4: width -> (x rows of a block, vocabulary rows of a tile)
FWD_TILING = {768: (128, 32), 1024: (64, 32)}
SMS = (132, 8)


def covered_once(ranges, total):
    """The half-open ranges cover [0, total) with no gap and no overlap."""
    ranges = sorted(r for r in ranges if r[0] < r[1])
    return ranges[0][0] == 0 and ranges[-1][1] == total and all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("V", [30522, 4099, 70])
@pytest.mark.parametrize("H", sorted(FWD_TILING))
@pytest.mark.parametrize("N", [3072, 257, 65, 37, 1])
def test_fwd_plan_covers_every_row_block_and_tile_once(N, H, V, sms):
    """Block (x, y) takes rows [x rows, x rows + rows) and the vocabulary
    tiles [y per, y per + per); it writes its split's partials of those rows."""
    rows, tile = FWD_TILING[H]
    plan = xe.fwd_plan(N, V, H, rows, tile, sms)
    row_blocks, S = plan["grid"]
    per, n_tiles = plan["per"], -(-V // tile)
    assert covered_once([(x * rows, min(N, x * rows + rows)) for x in range(row_blocks)], N)
    assert (row_blocks - 1) * rows < N  # no block without a row
    assert plan["tiles"] == n_tiles
    splits = [(y * per, min(n_tiles, y * per + per)) for y in range(S)]
    assert all(a < b for a, b in splits), "a split without a vocabulary tile"
    assert covered_once(splits, n_tiles)
    assert covered_once([(t * tile, min(V, t * tile + tile)) for t in range(n_tiles)], V)
    assert plan["pf_shape"] == (4, S, N) and plan["pi_shape"] == (S, N)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("V", [30522, 4099, 70])
@pytest.mark.parametrize("H", sorted(FWD_TILING))
@pytest.mark.parametrize("N", [3072, 257, 1])
def test_fwd_plan_takes_the_least_busy_splits(N, H, V, sms):
    """What holds whatever a block's fixed cost (FWD_BLOCK_TILES, a modelled
    number that ``tools/xent_steps.py``'s split sweep times on the card): no
    split is empty, and the busiest SM runs no more waves of blocks (one
    block an SM) than under splits for about four blocks an SM
    (:func:`splits`, K4's first plan)."""
    rows, tile = FWD_TILING[H]
    plan = xe.fwd_plan(N, V, H, rows, tile, sms)
    row_blocks, S = plan["grid"]
    n_tiles = -(-V // tile)
    assert (S - 1) * plan["per"] < n_tiles <= S * plan["per"]
    S_old, _ = xe.splits(row_blocks, n_tiles, sms)
    assert -(-row_blocks * S // sms) <= -(-row_blocks * S_old // sms)


@pytest.mark.parametrize("H,grid,per", [(768, (24, 11), 87), (1024, (48, 11), 87)])
def test_fwd_plan_fills_the_card_at_the_main_path(H, grid, per):
    """At N = 3072, V = 30522 on 132 SMs the row blocks (24 of 128 rows at
    768, 48 of 64 at 1024) take 11 splits of 87 tiles: 264 and 528 blocks,
    two and four full waves."""
    rows, tile = FWD_TILING[H]
    plan = xe.fwd_plan(3072, 30522, H, rows, tile, 132)
    assert plan["grid"] == grid and plan["per"] == per
    assert grid[0] * grid[1] % 132 == 0


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("V", [30522, 4099, 70])
@pytest.mark.parametrize("H", sorted(TILING))
@pytest.mark.parametrize("N", [3072, 257, 37, 1])
def test_dx_plan_covers_every_row_tile_and_column_once(N, H, V, sms):
    rows, tile, cols = TILING[H]
    plan = xe.dx_plan(N, V, H, rows, tile, cols, sms)
    row_blocks, parts, S = plan["grid"]
    per = plan["per"]
    assert covered_once([(x * rows, min(N, x * rows + rows)) for x in range(row_blocks)], N)
    assert (row_blocks - 1) * rows < N  # no block without a row
    assert covered_once([(y * cols, y * cols + cols) for y in range(parts)], H)
    n_tiles = -(-V // tile)
    assert plan["tiles"] == n_tiles
    splits = [(z * per, min(n_tiles, z * per + per)) for z in range(S)]
    assert all(a < b for a, b in splits), "a split without a vocabulary tile"
    assert covered_once(splits, n_tiles)
    assert covered_once([(t * tile, min(V, t * tile + tile)) for t in range(n_tiles)], V)
    # block (x, y, z) writes part[z, rows of x, columns of y]: [S, N, H] in all
    assert plan["part_shape"] == (S, N, H)


@pytest.mark.parametrize("V", [30522, 4099, 70])
@pytest.mark.parametrize("H", sorted(TILING))
def test_de_plan_covers_every_vocabulary_row_and_column_once(H, V):
    rows, _, cols = TILING[H]
    blocks, parts = xe.de_plan(V, H, rows, cols)["grid"]
    assert covered_once([(x * rows, min(V, x * rows + rows)) for x in range(blocks)], V)
    assert (blocks - 1) * rows < V
    assert covered_once([(y * cols, y * cols + cols) for y in range(parts)], H)


@pytest.mark.parametrize("sms", SMS)
def test_dx_plan_fills_the_card_at_the_main_path(sms):
    """About four blocks per SM: at N = 3072, V = 30522, width 768 the 48 row
    blocks take 11 splits on 132 SMs (528 blocks, four full waves)."""
    rows, tile, cols = TILING[768]
    plan = xe.dx_plan(3072, 30522, 768, rows, tile, cols, sms)
    blocks = plan["grid"][0] * plan["grid"][1] * plan["grid"][2]
    assert 4 * sms <= blocks < 4 * sms + plan["grid"][0] * plan["grid"][1]
    if sms == 132:
        assert plan["grid"] == (48, 1, 11) and plan["per"] == 87


def test_splits_never_leave_a_split_empty():
    for n_blocks in (1, 2, 7, 48, 96, 600):
        for n_tiles in (1, 2, 3, 5, 954, 1908):
            for sms in SMS:
                S, per = xe.splits(n_blocks, n_tiles, sms)
                assert 1 <= S <= n_tiles and (S - 1) * per < n_tiles <= S * per
