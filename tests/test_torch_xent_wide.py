"""The launch plans of K4-K6's fp32 form (``csrc/mlm_xent_f32.cu``) and
wide form (``csrc/mlm_xent.cu``'s ``xent_wide_*``, bf16 and fp16 above
width 1024), without a card.

``ops/mlm_xent.py::f32_plan``, ``::fwd_plan``, ``::wide_cluster``,
``::wide_dx_plan`` and ``::wide_de_plan`` choose the grids, the wide
K5/K6's thread-block clusters and the vocabulary splits in plain Python
from the kernels' tiling and the SM or cluster count; a slip there shows
on the card only as a row, vocabulary tile or column left out or done
twice. Here the plans (and the wide K4's ring of TMA stages, step by
step) are walked as the kernels walk them, at the main
path's N = 3072, V = 30522 and ragged shapes, at widths 768 (fp32) and
1088 to 4160 (the wide form), on a card of 132 SMs (an H100) and of 8, and
for 30, 8 and 1 clusters at once: every (row block, vocabulary tile) and
every (row block, column panel, vocabulary tile) is covered exactly once,
a cluster's blocks share a row block and a split and own the width's
panels between them, each split's tiles come after the previous split's
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
# vb_xent_wide_geometry: width step, K4 rows / block, K5/K6 resident rows, K4 tile, K5/K6 tile, columns a
# block at most, blocks a cluster at most
WIDE = (64, 128, 64, 128, 64, 512, 16)
WF_STAGES = 6  # the wide K4's ring stages
SMS = (132, 8)
CLUSTERS = (30, 8, 1)  # K5/K6 clusters a card runs at once (an H100 at 2048: 30)
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
    """The wide K4's plan (xe._wide_fwd_plan_of's: WIDE_FWD_BLOCK_TILES a
    block's fixed cost): every (row block, tile) once, the splits in
    order, none empty."""
    rows, tile = WIDE[1], WIDE[3]
    plan = xe.fwd_plan(N, V, H, rows, tile, sms, xe.WIDE_FWD_BLOCK_TILES)
    row_blocks, S = plan["grid"]
    n_tiles = -(-V // tile)
    assert covered_once([(x * rows, min(N, x * rows + rows)) for x in range(row_blocks)], N)
    assert_splits(S, plan["per"], n_tiles)
    visits = [(x, t) for x in range(row_blocks) for split in split_tiles(S, plan["per"], n_tiles) for t in split]
    assert len(visits) == len(set(visits)) == row_blocks * n_tiles
    assert plan["pf_shape"] == (4, S, N) and plan["pi_shape"] == (S, N)


def walk_wide_fwd_ring(nsteps, stages=WF_STAGES, producer_first=True):
    """The wide K4's ring (csrc/mlm_xent.cu::xent_wide_fwd_kernel): the
    producer warp issues step q into stage q % stages once that stage's
    empty mbarrier has completed the phase of step q - stages (parity (q /
    stages - 1) & 1); the consumers wait for the full mbarrier's phase of
    step q (parity (q / stages) & 1), take it and release the stage (every
    consumer warp arrives). The two sides alternate, the producer running ahead as
    far as the ring lets it (``producer_first``) or one step at a time.
    Returns the (issued, consumed) order of the steps; asserts that nothing
    waits forever, that a stage is filled only after its last step was
    released, and that every wait finds its own phase or the one before it
    (a parity two phases stale would be read as the wrong one)."""
    full, empty = [0] * stages, [0] * stages  # completed phases of each stage's mbarriers
    issued, consumed = [], []

    def ready(bars, b, phase):
        assert bars[b] in (phase, phase + 1), f"stage {b}: phase {bars[b]}, waited for {phase}"
        return bars[b] == phase + 1

    while len(consumed) < nsteps:
        moved = False
        while len(issued) < nsteps:
            q = len(issued)
            b = q % stages
            if q >= stages and not ready(empty, b, q // stages - 1):
                break
            full[b] += 1
            issued.append(q)
            moved = True
            if not producer_first:
                break
        q = len(consumed)
        if ready(full, q % stages, q // stages):
            consumed.append(q)
            empty[q % stages] += 1
            moved = True
        assert moved, f"no side can move at step {q}"
    return issued, consumed


@pytest.mark.parametrize("producer_first", [True, False])
@pytest.mark.parametrize("V", VS)
@pytest.mark.parametrize("H", [1088, 1152, 2048, 2560, 4160, 8192])
@pytest.mark.parametrize("N", [3072, 257, 1])
def test_the_wide_fwd_ring_takes_every_panel_of_every_tile_once_in_order(N, H, V, producer_first):
    """Each block of the plan walks its split's tiles panel by panel: every
    step issued once and in order before it is used, every stage refilled
    only after its last step was released, the products added in (tile,
    panel) order with each tile's statistics once after its last panel, at
    even and odd step counts (17 panels a tile at 1088)."""
    rows, tile = WIDE[1], WIDE[3]
    plan = xe.fwd_plan(N, V, H, rows, tile, 132, xe.WIDE_FWD_BLOCK_TILES)
    NP = H // 64
    for tiles in split_tiles(plan["grid"][1], plan["per"], plan["tiles"]):
        nsteps = len(tiles) * NP
        issued, consumed = walk_wide_fwd_ring(nsteps, producer_first=producer_first)
        assert issued == consumed == list(range(nsteps))
        order = [(tiles[q // NP], q % NP) for q in consumed]
        assert order == [(t, p) for t in tiles for p in range(NP)]
        assert [t for t, p in order if p == NP - 1] == list(tiles)


def block_panels(H, r, wg=None):
    """The 64-column panels block r of a wide K5/K6 cluster owns (its
    warpgroup wg's: accumulator j holds panel 2 j + wg of the block's), as
    csrc/mlm_xent.cu::xent_wide_bwd_kernel works them out."""
    R, per = xe.wide_cluster(H, WIDE[5])
    first = r * per
    own = [first + k for k in range(per) if first + k < H // 64]
    return own if wg is None else [own[k] for k in range(wg, len(own), 2)]


@pytest.mark.parametrize("H", list(range(1088, 8193, 64)))
def test_a_wide_cluster_owns_every_panel_once_within_the_cards_limits(H):
    """R = cdiv(H, 512) blocks, each at most 8 panels (its four m64n64
    accumulators a warpgroup), none without a panel, the two warpgroups
    every other panel; at most 8 blocks (the portable cluster) up to 8 x 512
    = 4096 columns and 16 (the H100's largest) up to 8192."""
    R, per = xe.wide_cluster(H, WIDE[5])
    assert R == -(-H // WIDE[5]) and per <= WIDE[5] // 64
    assert R <= (8 if H <= 8 * WIDE[5] else WIDE[6])
    assert all(block_panels(H, r) for r in range(R))
    assert sorted(p for r in range(R) for wg in (0, 1) for p in block_panels(H, r, wg)) == list(range(H // 64))
    assert all(len(block_panels(H, r, wg)) <= 4 for r in range(R) for wg in (0, 1))


def block_rows(R, r):
    """The rows of a streamed tile's logits that block r of a cluster of R
    sums and turns into dlog, [lo, hi), and the stride of the partials it
    receives from each block (rows a block's slots), as
    csrc/mlm_xent.cu::xent_wide_bwd_kernel works them out."""
    rows = WIDE[2]
    return r * rows // R, (r + 1) * rows // R, -(-rows // R)


def row_owner(R, i):
    """The block of a cluster of R that sums row i: where the kernel sends
    row i's partials."""
    return ((i + 1) * R - 1) // WIDE[2]


@pytest.mark.parametrize("R", range(xe.wide_cluster(1088, WIDE[5])[0], WIDE[6] + 1))
def test_a_wide_cluster_sums_every_row_once_at_every_cluster_size(R):
    """Every row of a tile has one block that sums it, the one its partials
    go to; each block sums at least 4 rows and at most its slots' stride (no
    count negative or zero, the mbarriers' byte counts whole), the rows a
    thread takes (a warp of 8 every eighth, WB_MAXK each) cover each block's,
    and the R blocks' slots fit the partials' buffer (WB_ROWS + the largest
    cluster rows of 64)."""
    rows = WIDE[2]
    shares = [block_rows(R, r) for r in range(R)]
    assert [i for lo, hi, _ in shares for i in range(lo, hi)] == list(range(rows))
    assert all(4 <= hi - lo <= per for lo, hi, per in shares)
    assert all(shares[row_owner(R, i)][0] <= i < shares[row_owner(R, i)][1] for i in range(rows))
    # the bytes each block's mbarriers expect a tile: every block's partials of its rows, the others' dlog rows
    sent = [0] * R
    for i in range(rows):
        sent[row_owner(R, i)] += R * 64 * 4
    assert sent == [R * (hi - lo) * 64 * 4 for lo, hi, _ in shares]
    assert sum(rows - (hi - lo) for lo, hi, _ in shares) == (R - 1) * rows
    min_r = xe.wide_cluster(1088, WIDE[5])[0]
    maxk = (-(-rows // min_r) + 7) // 8
    assert all(hi - lo <= 8 * maxk for lo, hi, _ in shares)
    # a receiving block's slot of row i from block src: src per + (i - lo)
    slots = [src * per + i - lo for lo, hi, per in shares for src in range(R) for i in range(lo, hi)]
    assert max(slots) < R * shares[0][2] <= rows + WIDE[6]


@pytest.mark.parametrize("clusters", CLUSTERS)
@pytest.mark.parametrize("V", VS)
@pytest.mark.parametrize("H", [1088, 1152, 2048, 2560, 4160])
@pytest.mark.parametrize("N", [3072, 257, 37, 1])
def test_wide_dx_plan_covers_every_row_tile_and_column_once(N, H, V, clusters):
    """K5's cluster (x, z): rows [64 x, +64) and the tiles of split z, its R
    blocks (the grid's y, the cluster's whole) the panels of
    block_panels: every (row block, column panel, tile) once; the blocks of
    a cluster share its row block and split (the cluster spans y alone)."""
    rows, tile, cols = WIDE[2], WIDE[4], WIDE[5]
    plan = xe.wide_dx_plan(N, V, H, rows, tile, cols, clusters)
    row_blocks, R, S = plan["grid"]
    n_tiles = -(-V // tile)
    assert plan["cluster"] == (1, R, 1) and (R, plan["panels"]) == xe.wide_cluster(H, cols)
    assert_splits(S, plan["per"], n_tiles)
    visits = [(x, p, t) for x in range(row_blocks) for r in range(R) for p in block_panels(H, r)
              for split in split_tiles(S, plan["per"], n_tiles) for t in split]
    assert len(visits) == len(set(visits)) == row_blocks * (H // 64) * n_tiles
    assert covered_once([(x * rows, min(N, x * rows + rows)) for x in range(row_blocks)], N)
    assert plan["part_shape"] == (S, N, H)


@pytest.mark.parametrize("V", VS)
@pytest.mark.parametrize("H", [1088, 2048, 2560, 4160])
def test_wide_de_plan_covers_every_vocabulary_row_and_column_once(H, V):
    rows, cols = WIDE[2], WIDE[5]
    plan = xe.wide_de_plan(V, H, rows, cols)
    blocks, R = plan["grid"]
    assert plan["cluster"] == (1, R, 1) and (R, plan["panels"]) == xe.wide_cluster(H, cols)
    assert covered_once([(x * rows, min(V, x * rows + rows)) for x in range(blocks)], V)
    assert sorted(p for r in range(R) for p in block_panels(H, r)) == list(range(H // 64))


@pytest.mark.parametrize("H,clusters,dx_grid,de_grid", [(2048, 30, (48, 4, 5), (477, 4)),
                                                        (2560, 22, (48, 5, 5), (477, 5)),
                                                        (1088, 39, (48, 3, 4), (477, 3)),
                                                        (4160, 9, (48, 9, 3), (477, 9))])
def test_wide_grids_at_the_main_path(H, clusters, dx_grid, de_grid):
    """At N = 3072, V = 30522 on an H100: K4 24 row blocks of 128 x 11
    splits of 22 tiles of 128 vocabulary rows, 264 blocks, two full waves
    of 132; K5 48 row blocks x a cluster of cdiv(H,
    512) blocks x the splits that give the card's clusters (30 at once at
    2048, 22 at 2560, 39 at 1088, 9 at 4160) the fewest tiles; K6 477
    vocabulary blocks x the cluster."""
    fwd = xe.fwd_plan(3072, 30522, H, WIDE[1], WIDE[3], 132, xe.WIDE_FWD_BLOCK_TILES)
    assert fwd["grid"] == (24, 11) and fwd["per"] == 22
    assert xe.wide_dx_plan(3072, 30522, H, WIDE[2], WIDE[4], WIDE[5], clusters)["grid"] == dx_grid
    assert xe.wide_de_plan(30522, H, WIDE[2], WIDE[5])["grid"] == de_grid


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
    # up to a cluster of 16 blocks of 512 columns; wider bf16 and fp16 rows run on the fp32 kernels
    assert xe.WIDE_MAX == WIDE[5] * WIDE[6]
    for dtype, name in ((torch.bfloat16, "bf16"), (torch.float16, "fp16")):
        assert not xe.runs_on_f32(dtype, xe.WIDE_MAX) and xe.runs_on_f32(dtype, xe.WIDE_MAX + 1)
        assert xe.xent_form(dtype, xe.WIDE_MAX + 1) == f"{name} on fp32"
        assert xe.xent_form(dtype, xe.WIDE_MAX) == f"{name} wide H{xe.WIDE_MAX}"


@pytest.mark.parametrize("dtype,name", [(torch.bfloat16, "bf16"), (torch.float16, "fp16")], ids=str)
def test_fp16_and_bf16_run_every_width_from_1025_to_8192_on_the_wide_form(dtype, name):
    """Both half dtypes take the wide form at every width above 1024 up to
    WIDE_MAX (fp16 no longer on the fp32 kernels), at the next multiple of
    64, with two N x V x H products in K5 and in K6; fp16 and bf16 above
    WIDE_MAX and fp32 at every width run on the fp32 kernels."""
    for h in range(1025, xe.WIDE_MAX + 1):
        assert not xe.runs_on_f32(dtype, h) and xe.xent_form(dtype, h) == f"{name} wide H{xe.kernel_width(h)}"
        assert xe.bwd_products(dtype, h) == 2
    for h in (xe.WIDE_MAX + 1, xe.WIDE_MAX + 64, 12288):
        assert xe.runs_on_f32(dtype, h) and xe.xent_form(dtype, h) == f"{name} on fp32"
    assert all(xe.runs_on_f32(torch.float32, h) for h in (64, 1024, 1088, 8192, 8193))


@pytest.mark.parametrize("dtype,H,products", [(torch.float32, 768, 2), (torch.float32, 2048, 2),
                                               (torch.bfloat16, 768, 2), (torch.bfloat16, 1024, 3),
                                               (torch.bfloat16, 2048, 2), (torch.bfloat16, 2560, 2),
                                               (torch.bfloat16, 1100, 2), (torch.float16, 1100, 2),
                                               (torch.bfloat16, 4160, 2), (torch.bfloat16, 8256, 2),
                                               (torch.float16, 1024, 3), (torch.float16, 2048, 2),
                                               (torch.float16, 8256, 2)])
def test_the_backward_forms_recompute_the_logits_once_a_column_range(dtype, H, products):
    """K5's and K6's N x V x H products: fp32 (and bf16 and fp16 above 8192,
    which run on the fp32 kernels) and the forms up to 768 (a block owns
    every column) two; 1024 recomputes the logits for its second 512-column
    range (3); the wide form's cluster forms them once over all its ranges
    in bf16 and fp16 (2, at every width it takes)."""
    assert xe.bwd_products(dtype, H) == products
    assert xe.runs_on_f32(dtype, H) == (dtype == torch.float32 or H > xe.WIDE_MAX)


def test_the_sources_name_the_tiling_the_plans_assume():
    """The constants in the sources that the plans here assume."""
    f32 = (_build.CSRC / "mlm_xent_f32.cu").read_text()
    assert re.search(rf"#define VB_F32_NTH {2 * F32_ROWS}\b", f32) and "constexpr int BM = NTH / 2;" in f32
    assert re.search(rf"constexpr int BN = {F32_TILE};", f32)
    wide = (_build.CSRC / "mlm_xent.cu").read_text()
    for name, value in (("WF_ROWS", WIDE[1]), ("WB_ROWS", WIDE[2]), ("WF_TILE", WIDE[3]), ("WB_TILE", WIDE[4]),
                        ("WB_COLS", WIDE[5]), ("WB_MAX_CLUSTER", WIDE[6]), ("WF_STAGES", WF_STAGES)):
        assert re.search(rf"constexpr int {name} = {value};", wide), name
    # the wide K4's grid and ring, as the plan and walk_wide_fwd_ring take them
    assert "xent_wide_fwd_kernel<ET><<<dim3(cdiv(N, WF_ROWS), S), WF_THREADS, WF_SMEM, st>>>(" in wide
    assert "if (q >= WF_STAGES) mbar_wait(empty0 + 8 * b, (q / WF_STAGES - 1) & 1);" in wide
    assert "mbar_wait(full0 + 8 * b, (q / WF_STAGES) & 1);" in wide
    assert "mbar_init_count(empty0 + 8 * b, NTHREADS / 32);" in wide and "if (lane == 0) mbar_arrive(" in wide
    # the cluster's split of the width, as wide_cluster plans it, and of a tile's rows, as block_rows does
    assert "NP = hid / 64, CP = cdiv(NP, R), p0 = rank * CP" in wide
    assert "int wide_cluster(int hid) { return cdiv(hid / 64, WB_CP); }" in wide
    assert "per = cdiv(WB_ROWS, R), rlo = rank * WB_ROWS / R, rhi = (rank + 1) * WB_ROWS / R;" in wide
    assert "owner = ((i + 1) * R - 1) / WB_ROWS;" in wide and "slot = rank * per + i - owner * WB_ROWS / R;" in wide
    assert "d_bytes = (WB_ROWS - (rhi - rlo)) * 128, p_bytes = R * (rhi - rlo) * 64 * 4;" in wide
    assert "constexpr int WB_P_BYTES = (WB_ROWS + WB_MAX_CLUSTER) * WB_TILE * 4;" in wide


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
