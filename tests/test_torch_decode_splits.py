"""The work plan that the decode kernels B4, B5 and B6 share
(``ops/quant_decode_cuda.py``): the blocks a launch takes from shapes alone
(``plan_grid``, ``paged_plan_grid``), the plan the kernels make on the
device from the lanes' live lengths (its twin ``work_plan``, which mirrors
``csrc/quant_decode.cuh::Plan``'s arithmetic); the row groups a launch
takes past the rows one block serves (``row_groups``); the head dims and
groups the launchers take (``check_rows``); and the scratch those blocks
write their partials and group counters into (``scratch_ptrs``). All run
on the host, so they are checked here without a card."""

import itertools
import os
import re

import numpy as np
import pytest
import torch

from ring_flash_attn_tpu_torch.ops import (paged_decode_cuda,
                                           paged_quant_decode_cuda)
from ring_flash_attn_tpu_torch.ops import quant_decode_cuda as qd
from ring_flash_attn_tpu_torch.ops.quant_decode_cuda import (
    CHUNK, HEAD_DIMS, MAX_ROWS, MIN_CHUNKS, ROW_TILE, TARGET_BLOCKS,
    TILE_CLUSTER, TILE_CLUSTERS, TILE_MIN_CHUNKS, check_rows, lane_chunks,
    pages_a_chunk, paged_plan_grid, plan_counters, plan_grid, row_groups,
    scratch_ptrs, tile_chunks, tile_max_chunks, tile_plan, work_plan)

D = 128  # the head dim of the scratch tests below

# (groups, chunks of the longest possible lane): one lane to a full batch,
# lanes shorter than MIN_CHUNKS chunks, counts that are not multiples of
# MIN_CHUNKS, and groups that fill the card alone
PLANS = [(1, 1), (1, 3), (1, 5), (1, 512), (8, 7), (8, 512), (24, 128),
         (32, 64), (64, 64), (64, 1), (100, 333), (528, 64), (1000, 4096)]


@pytest.mark.parametrize("groups,max_chunks", PLANS)
def test_plan_grid_never_needs_a_second_wave(groups, max_chunks):
    """One block an SM at most, but where the groups alone outnumber the
    SMs: then a block a group, each whole (the plan cuts a group only
    within TARGET_BLOCKS blocks, ``test_plan_workspace_bound_holds``), so
    a launch takes a second wave only as one a group would."""
    assert TARGET_BLOCKS == 132
    assert 1 <= plan_grid(groups, max_chunks) <= max(groups, TARGET_BLOCKS)


@pytest.mark.parametrize("groups,max_chunks", PLANS)
def test_plan_grid_gives_every_group_a_block_where_the_card_allows(
        groups, max_chunks):
    """The device's plan gives each live group at least a block of its own
    (a group never waits for another's, and a block holds one piece at
    most), so the grid holds one a group, past the card's SMs too."""
    assert plan_grid(groups, max_chunks) >= groups


@pytest.mark.parametrize("groups,max_chunks", PLANS)
def test_plan_grid_gives_each_block_min_chunks(groups, max_chunks):
    """Beyond one block a group, a block more only for each MIN_CHUNKS
    chunks the lanes could hold: a lane too short for that is not cut."""
    n = plan_grid(groups, max_chunks)
    assert n <= max(groups, -(-groups * max_chunks // MIN_CHUNKS))
    if max_chunks < MIN_CHUNKS:
        assert n == groups


def test_plan_grid_refuses_more_than_the_plan_counts():
    """The device's plan counts chunks in 32 bits: the launcher refuses a
    shape whose chunks could reach 2^30."""
    plan_grid(2**13, 2**16)
    with pytest.raises(ValueError, match="more than the decode plan"):
        plan_grid(2**14, 2**16)


def test_paged_plan_grid_is_the_grid_of_the_table_shape():
    """B5 and B6 size the grid from a lane of npages pages of page_size
    tokens (64-token chunks that never span a page): at the serving
    table's shape (8 lanes of 8 kv heads, 16 pages of 256) and at the
    engine's 4 lanes every SM; 16-token pages count a chunk a page; a
    table of one short page, a block a group."""
    assert CHUNK == 64
    assert paged_plan_grid(8, 8, 16, 256) == TARGET_BLOCKS
    assert paged_plan_grid(4, 8, 16, 256) == TARGET_BLOCKS
    assert paged_plan_grid(2, 8, 256, 16) == plan_grid(16, 256)
    assert paged_plan_grid(3, 8, 64, 100) == plan_grid(24, 128)
    assert paged_plan_grid(2, 4, 1, 16) == 8


@pytest.mark.parametrize("rows,d", [(128, 64), (240, 128), (355, 64),
                                    (355, 256)])
def test_paged_plan_grid_counts_row_groups(rows, d):
    """Row tiles are groups of the plan: B * Hkv * nrg of them share the
    card's blocks in clusters of TILE_CLUSTER, one cluster a tile at least
    (nrg = 1, 2, 3 and 6: a tile of 128 rows at head dims 64 and 128, of 64
    at 256)."""
    nrg = row_groups(rows, d)[0]
    assert nrg == -(-rows // ROW_TILE[d])
    n = paged_plan_grid(4, 1, 32, 256, nrg, tiles=True)
    assert n == plan_grid(4 * nrg, 32 * 4, tiles=True)
    cs = TILE_CLUSTER
    assert n % cs == 0
    assert 4 * nrg <= n // cs <= max(4 * nrg, TILE_CLUSTERS)


def test_plan_constants_mirror_the_kernels():
    """MIN_CHUNKS, TARGET_BLOCKS and CHUNK are the kernels' own
    (csrc/quant_decode.cuh)."""
    src = open(os.path.join(os.path.dirname(qd.__file__), os.pardir, "csrc",
                            "quant_decode.cuh")).read()
    assert re.search(r"constexpr int MIN_CHUNKS = (\d+);", src).group(1) \
        == str(MIN_CHUNKS)
    assert re.search(r"constexpr int TARGET_BLOCKS = (\d+);",
                     src).group(1) == str(TARGET_BLOCKS)
    assert re.search(r"constexpr int C = (\d+);", src).group(1) == str(CHUNK)
    assert re.search(r"constexpr int TILE_CLUSTER = (\d+);",
                     src).group(1) == str(TILE_CLUSTER)
    assert re.search(r"constexpr int TILE_CLUSTERS = (\d+);",
                     src).group(1) == str(TILE_CLUSTERS)
    assert re.search(r"constexpr int TILE_MIN_CHUNKS = (\d+);",
                     src).group(1) == str(TILE_MIN_CHUNKS)


# work_plan's cases: (name, lane lengths, page size (None: B4's contiguous
# cache of S tokens a lane), kv heads, row groups a kv head, the table's
# pages a lane or B4's S, head dim, bytes a cached value): the decode
# sub-table's ragged lanes at Llama-3.2-1B's and Gemma-7B's kv heads, the
# engine's 4 lanes, the same tokens in equal lanes, B4's caches
# (generate's prompt and tail, the sub-table's), dead lanes at either end
# and between, one-token lanes, 16-token pages, row groups (StarCoder's
# 240 rows, Falcon-7B's 355), the serving table's shape and more groups
# than the card has SMs
_RNG = np.random.default_rng(21)
PLAN_CASES = [
    ("ragged D64", [0, 1, 3000, 8192], 256, 8, 1, 32, 64, 2),
    ("ragged D256", [0, 1, 3000, 8192], 256, 16, 1, 32, 256, 2),
    ("engine", [3016, 1216, 2616, 316], 256, 8, 1, 16, 64, 2),
    ("engine D256", [3016, 1216, 2616, 316], 256, 16, 1, 16, 256, 2),
    ("equal lanes", [2798, 2798, 2798, 2799], 256, 8, 1, 32, 64, 2),
    ("equal chunks", [2760, 2800, 2780, 2790], 256, 16, 1, 32, 256, 2),
    ("B4 prompt", [32768], None, 8, 1, 32768, 64, 1),
    ("B4 tail", [32], None, 8, 1, 32, 64, 1),
    ("B4 one token", [1, 1], None, 16, 1, 32, 256, 1),
    ("B4 sub-table", [8000, 8000], None, 8, 1, 8192, 64, 1),
    ("B4 D256", [8000, 8000], None, 16, 1, 8192, 256, 1),
    ("B4 length 0", [0, 0], None, 8, 1, 64, 128, 1),
    ("all dead", [0, 0, 0], 256, 8, 1, 4, 128, 2),
    ("one token lanes", [1, 1, 1, 1], 16, 8, 1, 4, 128, 2),
    ("dead ends", [0, 4096, 0, 17, 0], 16, 8, 1, 256, 128, 1),
    ("one long lane", [0] * 7 + [32768], 256, 8, 1, 128, 128, 2),
    ("StarCoder 240 rows", [0, 1, 3000, 8192], 128, 1, 2, 64, 128, 2),
    ("Falcon 355 rows", [0, 1, 3000, 8192], 256, 1, 3, 32, 64, 1),
    ("table shape", [0, 1, 255, 256, 257, 1000, 4095, 4096], 256, 8, 1, 16,
     128, 2),
    ("64 lanes", [int(x) for x in _RNG.integers(0, 4096, 64)], 256, 8, 1,
     16, 128, 2),
]
_IDS = [c[0] for c in PLAN_CASES]


def _plan_of(case):
    """(chunks a lane, groups a lane, grid, used, runs) of a case: the grid
    from shapes as the launchers size it, the plan as the kernel makes it."""
    _, lens, page, hkv, nrg, width, d, eb = case
    chunks = [lane_chunks(n, page) for n in lens]
    if page is None:
        grid = plan_grid(len(lens) * hkv * nrg, lane_chunks(width))
    else:
        grid = paged_plan_grid(len(lens), hkv, width, page, nrg)
    used, runs = work_plan(chunks, hkv * nrg, grid)
    return chunks, hkv * nrg, grid, used, runs


def _pieces_by_group(runs):
    out = {}
    for p, run in enumerate(runs):
        for piece in run:
            out.setdefault(piece["group"], []).append((p, piece))
    return out


@pytest.mark.parametrize("case", PLAN_CASES, ids=_IDS)
def test_plan_covers_every_live_chunk_once(case):
    """Every live chunk of every group lies in exactly one piece of one
    block, a dead lane's groups in none (the kernel clears those rows)."""
    chunks, gl, grid, used, runs = _plan_of(case)
    seen = []
    for run in runs:
        for piece in run:
            assert piece["chunks"] >= 1
            seen += [(piece["group"], piece["first"] + k)
                     for k in range(piece["chunks"])]
    want = [(b * gl + x, j) for b, n in enumerate(chunks) for x in range(gl)
            for j in range(n)]
    assert sorted(seen) == want
    assert len(runs) == grid and all(not run for run in runs[used:])


@pytest.mark.parametrize("case", PLAN_CASES, ids=_IDS)
def test_plan_pieces_of_a_group_are_in_order(case):
    """A group cut across blocks lies in consecutive blocks, piece k
    holding the chunks after piece k - 1's; its pieces take their blocks'
    slots from first_slot, in block order, and each names the same count,
    the counter's target, so the last block merges them in piece order
    whichever finishes first. A whole group is one piece."""
    _, _, _, _, runs = _plan_of(case)
    for group, pieces in _pieces_by_group(runs).items():
        blocks = [p for p, _ in pieces]
        assert blocks == list(range(blocks[0], blocks[0] + len(blocks)))
        at = 0
        for p, piece in pieces:
            assert piece["first"] == at
            at += piece["chunks"]
        if len(pieces) == 1:
            assert pieces[0][1]["whole"]
            continue
        for k, (p, piece) in enumerate(pieces):
            assert not piece["whole"]
            assert piece["slot"] == p
            assert piece["first_slot"] == blocks[0]
            assert piece["slot"] == piece["first_slot"] + k
            assert piece["pieces"] == len(pieces)


@pytest.mark.parametrize("case", PLAN_CASES, ids=_IDS)
def test_plan_workspace_bound_holds(case):
    """The slots of all partials are distinct and below min(grid,
    TARGET_BLOCKS), the workspace ``scratch_ptrs`` lays out from shapes
    alone: a group is cut only within the first wave, and has at most as
    many pieces (``merge_fits`` is held for them); one block never writes
    a partial."""
    chunks, gl, grid, _, runs = _plan_of(case)
    cap = min(grid, TARGET_BLOCKS)
    slots = [piece["slot"] for run in runs for piece in run
             if not piece["whole"]]
    assert len(slots) == len(set(slots))
    assert all(0 <= s < cap for s in slots)
    assert all(piece["pieces"] <= cap for run in runs for piece in run
               if not piece["whole"])
    if grid == 1:
        assert not slots


@pytest.mark.parametrize("case", PLAN_CASES, ids=_IDS)
def test_plan_depends_only_on_what_the_kernel_reads(case):
    """The kernel reads the lanes' live chunks (from seq_lens or B4's
    length), the groups a lane and its grid; lengths that give the same
    chunks give the same plan, every call, and
    the grid is the launcher's, from shapes (Python ints: no read of
    seq_lens, no host sync)."""
    _, lens, page, hkv, nrg, width, d, eb = case
    chunks, gl, grid, used, runs = _plan_of(case)
    assert type(grid) is int and isinstance(used, int)
    # each live lane one token shorter, where that keeps its chunks
    other = [n - 1 if n > 1 and lane_chunks(n - 1, page) == c else n
             for n, c in zip(lens, chunks)]
    again = work_plan([lane_chunks(n, page) for n in other], gl, grid)
    assert again == (used, runs) == work_plan(chunks, gl, grid)


@pytest.mark.parametrize("case", PLAN_CASES, ids=_IDS)
def test_plan_balances_the_runs(case):
    """The busiest block holds the least load, in chunks, that any cut of
    each group into whole blocks of near-equal runs fits in the blocks
    the plan may take (one a live group, up to min(grid, TARGET_BLOCKS))
    at a load of at least MIN_CHUNKS (or the longest lane's chunks), so no
    SM idles while a long lane streams; a live group always has a block."""
    chunks, gl, grid, used, runs = _plan_of(case)
    live = [n for n in chunks if n]
    if not live:
        assert used == 0
        return
    cap = max(len(live) * gl, min(grid, TARGET_BLOCKS))
    load = max(p["chunks"] for run in runs for p in run)
    assert len(live) * gl <= used <= cap
    floor = min(MIN_CHUNKS, max(live))
    assert load >= floor
    if load > floor:  # one chunk less a block would take too many blocks
        assert gl * sum(-(-n // (load - 1)) for n in live) > cap


@pytest.mark.parametrize("case", PLAN_CASES, ids=_IDS)
def test_plan_holds_one_piece_a_block(case):
    """A block holds one piece at most (one meeting of its warps, one
    merge), the used blocks first; a group's pieces differ by one chunk at
    most, and a group is whole exactly when it is one piece."""
    chunks, _, _, used, runs = _plan_of(case)
    assert all(len(run) == 1 for run in runs[:used])
    assert all(not run for run in runs[used:])
    for pieces in _pieces_by_group(runs).values():
        sizes = [piece["chunks"] for _, piece in pieces]
        assert max(sizes) - min(sizes) <= 1
        assert all(piece["whole"] == (len(pieces) == 1)
                   for _, piece in pieces)


def _equal(case):
    live = {lane_chunks(n, case[2]) for n in case[1] if n}
    return len(live) == 1


@pytest.mark.parametrize("case", [c for c in PLAN_CASES if _equal(c)],
                         ids=[c[0] for c in PLAN_CASES if _equal(c)])
def test_plan_equal_lanes_never_cross_a_group(case):
    """Where every live lane holds the same chunks (B4 always), every live
    group takes the same number of blocks, so the used blocks are a
    multiple of the live groups, one piece of one group a block."""
    chunks, gl, grid, used, runs = _plan_of(case)
    glive = sum(1 for n in chunks if n) * gl
    if used >= glive:
        assert used % glive == 0
        assert all(len(run) == 1 for run in runs[:used])


@pytest.mark.parametrize("n", [1, 2, 3, 5, 7, 125, 128, 511, 512])
@pytest.mark.parametrize("lanes,gl", [(1, 8), (2, 8), (2, 16), (1, 23),
                                      (4, 32), (200, 1)])
def test_plan_closed_form_of_equal_lanes_is_the_search(lanes, gl, n):
    """B4's lanes all hold n chunks, and its kernel takes the plan in
    closed form (quant_decode.cuh::plan_piece with Lanes::EQUAL): s =
    ceil(n / L) blocks a group, L = max(the search's lower bound,
    ceil(n / floor(U / G))). It is the search's plan."""
    g = lanes * gl
    grid = plan_grid(g, n)
    u = max(g, min(grid, TARGET_BLOCKS))
    most = u // g
    load = max(min(MIN_CHUNKS, n), -(-g * n // u), -(-n // most))
    s = -(-n // load)
    used, runs = work_plan([n] * lanes, gl, grid)
    assert used == g * s
    for p in range(used):
        (piece,) = runs[p]
        assert piece["group"] == p // s
        assert piece["first"] == (p % s) * n // s
        assert piece.get("pieces", 1) == s


def test_partials_hold_one_row_per_split():
    """The workspace holds one (acc, (m, l)) partial per slot (a block's,
    up to TARGET_BLOCKS: ``work_plan``) and row, fp32, and one int32
    counter per group, zero when allocated."""
    qd._WORKSPACES.clear()
    scratch_ptrs(6, 9, 4, D, "cpu", 101)
    part, counters = qd._WORKSPACES[("cpu", 101)]
    assert part.dtype == torch.float32 and counters.dtype == torch.int32
    assert part.numel() == 9 * 4 * (D + 2)
    assert counters.numel() == 6 and torch.all(counters == 0)


def test_workspace_is_kept_per_stream_and_grows_on_demand():
    """A second launch of the same or a smaller shape on a stream reuses
    its workspace (no allocation); a larger one grows it; another stream
    has its own, so two streams never share counters."""
    qd._WORKSPACES.clear()
    acc, ml, cnt = scratch_ptrs(8, 66, 4, D, "cpu", 7)
    assert scratch_ptrs(8, 66, 4, D, "cpu", 7) == (acc, ml, cnt)
    assert scratch_ptrs(2, 9, 4, D, "cpu", 7)[0] == acc
    other, _, cnt_other = scratch_ptrs(8, 66, 4, D, "cpu", 8)
    assert other != acc and cnt_other != cnt
    scratch_ptrs(64, 9, 16, D, "cpu", 7)
    part, counters = qd._WORKSPACES[("cpu", 7)]
    # grown, never shrunk: the earlier shape fits what is kept now
    assert part.numel() == 66 * 4 * (D + 2)
    scratch_ptrs(300, 300, 16, D, "cpu", 7)  # slots stop at TARGET_BLOCKS
    part, counters = qd._WORKSPACES[("cpu", 7)]
    assert part.numel() == TARGET_BLOCKS * 16 * (D + 2)
    assert counters.numel() == 300 and torch.all(counters == 0)
    assert len(qd._WORKSPACES) == 2


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("groups,grid,rows", [(8, 66, 4), (4, 16, 16),
                                              (1, 3, 8), (200, 200, 4)])
def test_scratch_ptrs_lay_the_partials_out(groups, grid, rows, d):
    """The kernels' pointers: part_acc (slots, rows, D) at the workspace's
    start, part_ml (slots, rows, 2) right after it, slots = min(grid,
    TARGET_BLOCKS), and the counters, laid out by the call's head dim D."""
    qd._WORKSPACES.clear()
    acc, ml, cnt = scratch_ptrs(groups, grid, rows, d, "cpu", 11)
    part, counters = qd._WORKSPACES[("cpu", 11)]
    slots = min(grid, TARGET_BLOCKS)
    assert acc == part.data_ptr() and cnt == counters.data_ptr()
    assert ml == acc + 4 * slots * rows * d
    assert part.numel() == slots * rows * (d + 2)


def test_scratch_ptrs_are_null_with_one_split():
    """With one block it writes every (out, lse) itself: no workspace."""
    qd._WORKSPACES.clear()
    assert scratch_ptrs(8, 1, 4, D, "cpu", 5) == (None, None, None)
    assert not qd._WORKSPACES


def test_b5_wrapper_takes_the_shared_plan():
    """B5's and B6's launchers import the grid and the scratch B4 uses (no
    plan of their own)."""
    assert paged_decode_cuda.paged_plan_grid is paged_plan_grid
    assert paged_decode_cuda.scratch_ptrs is scratch_ptrs
    assert paged_quant_decode_cuda.paged_plan_grid is paged_plan_grid
    assert paged_quant_decode_cuda.scratch_ptrs is scratch_ptrs


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("hq,hkv,tq", [(32, 8, 1), (32, 8, 5), (8, 1, 1),
                                       (8, 1, 5), (48, 1, 1), (48, 1, 5),
                                       (71, 1, 1), (71, 1, 5), (16, 16, 1)])
def test_row_groups_cover_every_row(hq, hkv, tq, d):
    """A launch at R = (Hq / Hkv) * Tq rows a kv head takes a group of the
    plan per row group: one group of R rows up to MAX_ROWS[D] (16; 8 at
    256, csrc/quant_decode.cuh::max_rows), else the row-tile loop's
    ceil(R / ROW_TILE[D]) tiles (128 rows; 64 at 256, row_tile) whose
    partials hold that many rows, the last tile the rest. Every row falls
    in exactly one group."""
    rows = (hq // hkv) * tq
    nrg, per = row_groups(rows, d)
    assert MAX_ROWS[d] == (8 if d == 256 else 16)
    assert ROW_TILE[d] == (64 if d == 256 else 128)
    if rows <= MAX_ROWS[d]:
        assert (nrg, per) == (1, rows)
    else:
        assert per == ROW_TILE[d] and (nrg - 1) * per < rows <= nrg * per
    starts = [g * per for g in range(nrg)]
    sizes = [min(per, rows - r0) for r0 in starts]
    assert sum(sizes) == rows and min(sizes) >= 1
    check_rows(hq, hkv, tq, d)  # every whole group is taken


def test_check_rows_refuses_a_partial_group_and_other_head_dims():
    """Hq must be a multiple of Hkv; a head dim with no build (96) raises
    the plain head_dim error, naming what the kernels take."""
    with pytest.raises(ValueError, match="multiple of Hkv"):
        check_rows(12, 8, 1, 128)
    with pytest.raises(ValueError, match="must be one of"):
        check_rows(8, 8, 1, 96)


# the row tile's edges: R rows a kv head just past the small-row loop's, at
# and beside one and two warpgroups' 64 rows, and Falcon-7B's 355
TILE_ROWS = [17, 63, 64, 65, 128, 129, 355]


def _check_tile_plan(chunks, gl, grid):
    """The row-tile loop's plan (``tile_plan``) as its kernel takes it:
    every live chunk of every group once; a used cluster's blocks hold
    consecutive runs of one piece, in rank order, the first ones a chunk
    more; a group's clusters consecutive, in order, whole exactly when
    alone, else with distinct partial slots below the workspace's
    min(grid, TARGET_BLOCKS) and the counters a rank of their group. Returns
    the used blocks and the plan's runs."""
    cs = TILE_CLUSTER
    used, runs = tile_plan(chunks, gl, grid)
    assert used % cs == 0 and grid % cs == 0 and len(runs) == grid
    assert all(len(run) == 1 for run in runs[:used])
    assert all(not run for run in runs[used:])
    seen = sorted((piece["group"], piece["first"] + k) for run in runs
                  for piece in run for k in range(piece["chunks"]))
    assert seen == [(b * gl + x, j) for b, n in enumerate(chunks)
                    for x in range(gl) for j in range(n)]
    clusters = {}
    for p in range(used):
        (piece,) = runs[p]
        assert (piece["cluster"], piece["rank"]) == divmod(p, cs)
        assert piece["counter"] == piece["group"] * cs + piece["rank"]
        assert piece["counter"] < plan_counters(len(chunks) * gl, True)
        clusters.setdefault(piece["cluster"], []).append(piece)
    groups = {}
    for c, pieces in sorted(clusters.items()):
        assert len({piece["group"] for piece in pieces}) == 1
        sizes = [piece["chunks"] for piece in pieces]
        assert sizes == sorted(sizes, reverse=True)
        assert sizes[0] - sizes[-1] <= 1 and sizes[0] >= 1
        assert [piece["first"] for piece in pieces] == list(
            itertools.accumulate([pieces[0]["first"]] + sizes[:-1]))
        groups.setdefault(pieces[0]["group"], []).append(
            (c, pieces[0]["first"], sum(sizes), pieces[0]))
    cap = min(grid, TARGET_BLOCKS)
    slots = []
    for g, cl in groups.items():
        assert [c for c, _, _, _ in cl] == list(range(cl[0][0],
                                                      cl[0][0] + len(cl)))
        assert [first for _, first, _, _ in cl] == list(
            itertools.accumulate([0] + [n for _, _, n, _ in cl[:-1]]))
        for k, (c, _, _, piece) in enumerate(cl):
            assert piece["whole"] == (len(cl) == 1)
            if not piece["whole"]:
                assert piece["slot"] == c and piece["first_slot"] == cl[0][0]
                assert piece["pieces"] == len(cl)
                slots.append(c)
    assert len(slots) == len(set(slots)) and all(0 <= x < cap for x in slots)
    return used, runs


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("rows", TILE_ROWS)
def test_plan_of_row_tiles(rows, d):
    """Past MAX_ROWS[D] rows a kv head a group of the plan is a (lane, kv
    head, row tile): ceil(R / ROW_TILE[D]) groups a kv head, so a kv head
    of up to ROW_TILE[D] rows is one group and each chunk is read once a
    tile. On the decode sub-table's lanes in pages of 16 (a dead lane, one
    token, ragged and long lanes; a chunk four pages) at 2 kv heads: the
    row-tile loop's plan in clusters (``_check_tile_plan``), and the
    partials' slots within the workspace that ``scratch_ptrs`` lays out
    for ROW_TILE[D] rows a slot, with TILE_CLUSTER counters a group."""
    nrg, per = row_groups(rows, d)
    if rows <= MAX_ROWS[d]:
        pytest.fail(f"{rows} rows at {d} are not past the small-row loop")
    assert per == ROW_TILE[d] and nrg == -(-rows // ROW_TILE[d])
    assert (nrg == 1) == (rows <= ROW_TILE[d])
    lens, hkv, page, pps = [0, 1, 3000, 8192], 2, 16, 512
    chunks = [tile_chunks(n, page) for n in lens]
    assert chunks == [0, 1, 47, 128]
    grid = paged_plan_grid(len(lens), hkv, pps, page, nrg, tiles=True)
    _check_tile_plan(chunks, hkv * nrg, grid)
    cap = min(grid, TARGET_BLOCKS)
    qd._WORKSPACES.clear()
    acc, ml, _ = scratch_ptrs(plan_counters(len(lens) * hkv * nrg, True),
                              grid, per, d, "cpu", 3)
    part, counters = qd._WORKSPACES[("cpu", 3)]
    assert ml == acc + 4 * cap * per * d
    assert part.numel() == cap * per * (d + 2)
    assert counters.numel() == len(lens) * hkv * nrg * TILE_CLUSTER


# the row-tile loop's launches: (name, lane lengths, page size (None: B4's
# contiguous cache of S tokens a lane), kv heads, rows a kv head, the
# table's pages a lane or B4's S, head dim): StarCoder's engine lanes (48
# rows, pages of 16) and its k = 4 verify (192), the Llama-3-8B k = 8
# verify (32 rows, 8 kv heads), generate's StarCoder prompt and tail, the
# decode sub-table's 240 and 355 rows, one-token and dead lanes, pages of
# 32 and 48 (two pages a chunk; a page a chunk), and more groups than the
# card's clusters
TILE_PLAN_CASES = [
    ("engine 48 rows", [3016, 1216, 2616, 316], 16, 1, 48, 512, 128),
    ("k=4 verify 192 rows", [3016, 1216, 2616, 316], 16, 1, 192, 512, 128),
    ("k=8 verify 32 rows", [3016, 1216, 2616, 316], 16, 8, 32, 512, 128),
    ("generate prompt", [8192], None, 1, 48, 8192, 128),
    ("generate tail", [32], None, 1, 48, 32, 128),
    ("240 rows", [0, 1, 3000, 8192], 128, 1, 240, 64, 128),
    ("355 rows", [0, 1, 3000, 8192], 256, 1, 355, 32, 64),
    ("one token lanes", [1, 1, 1], 16, 2, 20, 4, 256),
    ("dead lanes", [0, 0, 5000, 0], 32, 1, 65, 256, 64),
    ("pages of 48", [100, 4000], 48, 1, 129, 100, 128),
    ("64 lanes", [int(x) for x in _RNG.integers(0, 4096, 64)], 16, 8, 20,
     256, 64),
]


@pytest.mark.parametrize("case", TILE_PLAN_CASES,
                         ids=[c[0] for c in TILE_PLAN_CASES])
def test_tile_plan_holds_every_chunk_in_clusters(case):
    """The row-tile loop's plan at the launches that take it, from the
    launchers' grid (whole clusters, one a group at least): every live
    chunk once, in clusters (``_check_tile_plan``); a cluster's load at
    least min(TILE_CLUSTER * TILE_MIN_CHUNKS, the longest lane) and the
    least that fits the card's clusters; the lanes' chunks as the kernel
    counts them (a chunk is 64 positions over pages of 16 or 32)."""
    _, lens, page, hkv, rows, width, d = case
    nrg, _ = row_groups(rows, d)
    gl = hkv * nrg
    chunks = [tile_chunks(n, page) for n in lens]
    if page is None:
        most = tile_chunks(width)
        grid = plan_grid(len(lens) * gl, most, tiles=True)
    else:
        most = tile_max_chunks(width, page)
        grid = paged_plan_grid(len(lens), hkv, width, page, nrg, tiles=True)
    assert all(c <= most for c in chunks)
    cs = TILE_CLUSTER
    live = [n for n in chunks if n]
    used, runs = _check_tile_plan(chunks, gl, grid)
    assert len(live) * gl * cs <= used <= max(len(live) * gl * cs, grid)
    cap = max(len(live) * gl, min(grid // cs, TILE_CLUSTERS))
    clusters = {}
    for run in runs[:used]:
        clusters.setdefault(run[0]["cluster"], 0)
        clusters[run[0]["cluster"]] += run[0]["chunks"]
    load = max(clusters.values())
    floor = min(cs * TILE_MIN_CHUNKS, max(live))
    assert load >= floor
    if load > floor:
        assert gl * sum(-(-n // (load - 1)) for n in live) > cap


@pytest.mark.parametrize("groups,max_chunks", PLANS)
def test_tile_plan_grid_takes_whole_clusters(groups, max_chunks):
    """The row-tile loop's grid: whole clusters of TILE_CLUSTER blocks, a
    cluster a group at least, beyond that one a TILE_CLUSTER *
    TILE_MIN_CHUNKS chunks of the lanes, and no more than the card's
    TILE_CLUSTERS where the groups alone do not outnumber them (more would
    wait for a second wave)."""
    n = plan_grid(groups, max_chunks, tiles=True)
    assert n % TILE_CLUSTER == 0
    clusters = n // TILE_CLUSTER
    assert groups <= clusters <= max(groups, TILE_CLUSTERS)
    assert clusters <= max(groups, -(-groups * max_chunks // (
        TILE_CLUSTER * TILE_MIN_CHUNKS)))


def test_pages_a_chunk_span_small_pages():
    """The row-tile loop's chunk is 64 positions of the lane over whole
    pages where pages of 2 to 32 tokens divide 64, else the loop above's
    chunk (never past a page): its chunks a lane follow."""
    assert [pages_a_chunk(p) for p in (1, 2, 16, 32, 48, 64, 100, 256,
                                       None)] == [1, 32, 4, 2, 1, 1, 1, 1, 1]
    assert tile_chunks(3016, 16) == 48 and tile_chunks(0, 16) == 0
    assert tile_chunks(65, 32) == 2 and tile_chunks(64, 32) == 1
    for n, page in ((3000, 128), (100, 48), (8192, None), (1, 1), (0, 48)):
        assert tile_chunks(n, page) == lane_chunks(n, page)
