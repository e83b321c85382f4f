"""The split plan that the decode kernels B4, B5 and B6 share
(``ops/quant_decode_cuda.py::num_splits``, ``paged_num_splits``): how many
blocks take one (batch, kv head) group's tokens; the row groups a launch
takes past the rows one block serves (``row_groups``); the head dims and
groups the launchers take (``check_rows``); and the scratch those blocks
write their partials and group counters into (``scratch_ptrs``). All run
on the host from shapes alone, so they are checked here without a
card."""

import pytest
import torch

from ring_flash_attn_tpu_torch.ops import (paged_decode_cuda,
                                           paged_quant_decode_cuda)
from ring_flash_attn_tpu_torch.ops import quant_decode_cuda as qd
from ring_flash_attn_tpu_torch.ops.quant_decode_cuda import (
    CHUNK, HEAD_DIMS, MAX_ROWS, MIN_CHUNKS, TARGET_BLOCKS, check_rows,
    num_splits, paged_num_splits, row_groups, scratch_ptrs)

D = 128  # the head dim of the scratch tests below

# (groups, chunks of the longest possible lane): one lane to a full batch,
# lanes shorter than MIN_CHUNKS chunks, counts that are not multiples of
# MIN_CHUNKS, and groups that fill the card alone
PLANS = [(1, 1), (1, 3), (1, 5), (1, 512), (8, 7), (8, 512), (24, 128),
         (32, 64), (64, 64), (64, 1), (100, 333), (528, 64), (1000, 4096)]


@pytest.mark.parametrize("groups,max_chunks", PLANS)
def test_num_splits_fills_the_card_where_the_chunks_allow(groups,
                                                          max_chunks):
    """One block an SM (a block runs several pipelines side by side): as
    many splits as fill the SMs without a second wave, unless the chunks
    run out first."""
    n = num_splits(groups, max_chunks)
    assert n >= 1
    assert n == 1 or n * groups <= TARGET_BLOCKS  # never a second wave
    if max_chunks // MIN_CHUNKS >= TARGET_BLOCKS // groups:
        # one split more would not fit in one wave
        assert n == 1 or (n + 1) * groups > TARGET_BLOCKS
    else:
        assert n == max(1, max_chunks // MIN_CHUNKS)


@pytest.mark.parametrize("groups,max_chunks", PLANS)
def test_num_splits_never_needs_a_second_wave(groups, max_chunks):
    """The decode kernels hold one block an SM: a plan of more blocks than
    TARGET_BLOCKS would run a second, mostly idle wave."""
    assert TARGET_BLOCKS == 132
    n = num_splits(groups, max_chunks)
    assert n * groups <= max(TARGET_BLOCKS, groups)


@pytest.mark.parametrize("groups,max_chunks", PLANS)
def test_num_splits_gives_each_split_min_chunks(groups, max_chunks):
    n = num_splits(groups, max_chunks)
    share = -(-max_chunks // n)  # chunks a block takes of the longest lane
    assert share >= min(MIN_CHUNKS, max_chunks)
    if max_chunks < 2 * MIN_CHUNKS:
        assert n == 1


@pytest.mark.parametrize("groups", [TARGET_BLOCKS, TARGET_BLOCKS + 1, 4096])
def test_num_splits_is_one_when_the_groups_fill_the_card(groups):
    assert num_splits(groups, 10**6) == 1


def test_paged_num_splits_is_the_plan_of_the_table_shape():
    """B5 and B6 split a lane of npages pages of page_size tokens
    (64-token chunks that never span a page): at the serving table's
    shape (8 lanes, 16 pages of 256) 2 splits, 128 blocks; at the engine's
    4 lanes 4 splits, 128 blocks; 16-token pages count a chunk a page."""
    assert CHUNK == 64
    assert paged_num_splits(8, 8, 16, 256) == 2
    assert paged_num_splits(4, 8, 16, 256) == 4
    assert paged_num_splits(1, 8, 128, 256) == num_splits(8, 512) == 16
    assert paged_num_splits(2, 8, 256, 16) == num_splits(16, 256)
    assert paged_num_splits(3, 8, 64, 100) == num_splits(24, 128)


def test_paged_num_splits_depends_on_shapes_only():
    """The plan is a function of the cache's and the table's shapes alone
    (Python ints: no read of seq_lens, so no host sync) and gives the same
    int every call; a table twice as wide never gives fewer splits."""
    shapes = [(b, p, ps) for b in (1, 4, 8) for p in (1, 16, 128)
              for ps in (16, 256)]
    first = [paged_num_splits(b, 8, p, ps) for b, p, ps in shapes]
    again = [paged_num_splits(b, 8, p, ps) for b, p, ps in shapes]
    assert first == again and all(type(n) is int for n in first)
    for b, p, ps in shapes:
        assert paged_num_splits(b, 8, 2 * p, ps) >= paged_num_splits(
            b, 8, p, ps)


def test_partials_hold_one_row_per_split():
    """The workspace holds one (acc, (m, l)) partial per group, split and
    row, fp32, and one int32 counter per group, zero when allocated."""
    qd._WORKSPACES.clear()
    scratch_ptrs(6, 9, 4, D, "cpu", 101)
    part, counters = qd._WORKSPACES[("cpu", 101)]
    assert part.dtype == torch.float32 and counters.dtype == torch.int32
    assert part.numel() == 6 * 9 * 4 * (D + 2)
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
    assert part.numel() == 64 * 9 * 16 * (D + 2)
    assert counters.numel() == 64 and torch.all(counters == 0)
    assert len(qd._WORKSPACES) == 2


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("groups,nsplit,rows", [(8, 66, 4), (4, 16, 16),
                                                (1, 3, 8)])
def test_scratch_ptrs_lay_the_partials_out(groups, nsplit, rows, d):
    """The kernels' pointers: part_acc (groups, nsplit, rows, D) at the
    workspace's start, part_ml (groups, nsplit, rows, 2) right after it,
    and the counters, laid out by the call's head dim D."""
    qd._WORKSPACES.clear()
    acc, ml, cnt = scratch_ptrs(groups, nsplit, rows, d, "cpu", 11)
    part, counters = qd._WORKSPACES[("cpu", 11)]
    assert acc == part.data_ptr() and cnt == counters.data_ptr()
    assert ml == acc + 4 * groups * nsplit * rows * d
    assert part.numel() == groups * nsplit * rows * (d + 2)


def test_scratch_ptrs_are_null_with_one_split():
    """With one split a block writes (out, lse) itself: no workspace."""
    qd._WORKSPACES.clear()
    assert scratch_ptrs(8, 1, 4, D, "cpu", 5) == (None, None, None)
    assert not qd._WORKSPACES


def test_b5_wrapper_takes_the_shared_plan():
    """B5's and B6's launchers import the plan and the scratch B4 uses (no
    plan of their own)."""
    assert paged_decode_cuda.paged_num_splits is paged_num_splits
    assert paged_decode_cuda.scratch_ptrs is scratch_ptrs
    assert paged_quant_decode_cuda.paged_num_splits is paged_num_splits
    assert paged_quant_decode_cuda.scratch_ptrs is scratch_ptrs


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("hq,hkv,tq", [(32, 8, 1), (32, 8, 5), (8, 1, 1),
                                       (8, 1, 5), (48, 1, 1), (48, 1, 5),
                                       (71, 1, 1), (71, 1, 5), (16, 16, 1)])
def test_row_groups_cover_every_row(hq, hkv, tq, d):
    """A launch at R = (Hq / Hkv) * Tq rows a kv head takes one block row
    per row group: one group of R rows up to MAX_ROWS[D] (16; 8 at 256,
    csrc/quant_decode.cuh::max_rows), else ceil(R / MAX_ROWS[D]) groups of
    MAX_ROWS[D] rows whose partials hold that many rows, the last group
    the rest. Every row falls in exactly one group."""
    rows = (hq // hkv) * tq
    nrg, per = row_groups(rows, d)
    assert MAX_ROWS[d] == (8 if d == 256 else 16)
    if rows <= MAX_ROWS[d]:
        assert (nrg, per) == (1, rows)
    else:
        assert per == MAX_ROWS[d] and (nrg - 1) * per < rows <= nrg * per
    starts = [g * per for g in range(nrg)]
    sizes = [min(per, rows - r0) for r0 in starts]
    assert sum(sizes) == rows and min(sizes) >= 1
    check_rows(hq, hkv, tq, d)  # every whole group is taken


@pytest.mark.parametrize("nrg", [1, 2, 15, 45])
def test_paged_num_splits_counts_row_groups(nrg):
    """Row groups are groups of the plan: B * Hkv * nrg of them share the
    card's blocks, never a second wave."""
    n = paged_num_splits(4, 1, 32, 256, nrg)
    assert n == num_splits(4 * nrg, 32 * 4)
    assert n * 4 * nrg <= max(TARGET_BLOCKS, 4 * nrg)


def test_check_rows_refuses_a_partial_group_and_other_head_dims():
    """Hq must be a multiple of Hkv; a head dim with no build (96) raises
    the plain head_dim error, naming what the kernels take."""
    with pytest.raises(ValueError, match="multiple of Hkv"):
        check_rows(12, 8, 1, 128)
    with pytest.raises(ValueError, match="must be one of"):
        check_rows(8, 8, 1, 96)
