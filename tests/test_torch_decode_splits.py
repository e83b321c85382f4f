"""The split plan that the decode kernels B4, B5 and B6 share
(``ops/quant_decode_cuda.py::num_splits``, ``paged_num_splits``): how many
blocks take one (batch, kv head) group's tokens. It runs on the host from
shapes alone, so it is checked here without a card."""

import pytest
import torch

from ring_flash_attn_tpu_torch.ops import paged_decode_cuda
from ring_flash_attn_tpu_torch.ops.quant_decode_cuda import (
    CHUNK, HEAD_DIM, MIN_CHUNKS, TARGET_BLOCKS, num_splits, paged_num_splits,
    partials)

# (groups, chunks of the longest possible lane): one lane to a full batch,
# lanes shorter than MIN_CHUNKS chunks, counts that are not multiples of
# MIN_CHUNKS, and groups that fill the card alone
PLANS = [(1, 1), (1, 3), (1, 5), (1, 512), (8, 7), (8, 512), (24, 128),
         (32, 64), (64, 64), (64, 1), (100, 333), (528, 64), (1000, 4096)]


@pytest.mark.parametrize("groups,max_chunks", PLANS)
def test_num_splits_fills_the_card_where_the_chunks_allow(groups,
                                                          max_chunks):
    n = num_splits(groups, max_chunks)
    assert n >= 1
    if max_chunks // MIN_CHUNKS * groups >= TARGET_BLOCKS:
        assert n * groups >= TARGET_BLOCKS
    # no more blocks than the target needs: one split fewer would not do
    assert n == 1 or (n - 1) * groups < TARGET_BLOCKS


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
    shape (8 lanes, 16 pages of 256) 9 splits, 576 blocks; at the engine's
    4 lanes 16 splits, 512 blocks; 16-token pages count a chunk a page."""
    assert CHUNK == 64
    assert paged_num_splits(8, 8, 16, 256) == 9
    assert paged_num_splits(4, 8, 16, 256) == 16
    assert paged_num_splits(1, 8, 128, 256) == num_splits(8, 512)
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
    acc, ml = partials(6, 9, 4, "cpu")
    assert acc.shape == (6, 9, 4, HEAD_DIM) and acc.dtype == torch.float32
    assert ml.shape == (6, 9, 4, 2) and ml.dtype == torch.float32


def test_b5_wrapper_takes_the_shared_plan():
    """B5's launcher imports the plan B6 uses (no plan of its own)."""
    assert paged_decode_cuda.paged_num_splits is paged_num_splits
    assert paged_decode_cuda.partials is partials
