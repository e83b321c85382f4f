"""Sequence-sharding layout transforms (global <-> per-rank local).

The port of ``ring_flash_attn_tpu/parallel/layouts.py`` for the layouts the
ported schedules use:

- contiguous: rank r holds tokens [r*L, (r+1)*L)  (ring, fused ring, llama3)
- zigzag: split into 2W chunks; rank r holds chunks [r, 2W-1-r]

All operate on the sequence axis ``axis`` of a global tensor and return
either the shard for one rank or the full resharded tensor ordered by rank.
``zigzag_position_ids`` gives the layout's true global token positions,
which rotary embeddings need. The stripe layout comes with its schedule.
"""

import numpy as np
import torch


def _chunks(x, n, axis):
    if x.shape[axis] % n:
        raise ValueError(f"axis {axis} of {tuple(x.shape)} does not split "
                         f"into {n} equal chunks")
    return torch.chunk(x, n, dim=axis)


def extract_local_contiguous(x, rank, world, axis=1):
    return _chunks(x, world, axis)[rank]


def extract_local_zigzag(x, rank, world, axis=1):
    c = _chunks(x, 2 * world, axis)
    return torch.cat([c[rank], c[2 * world - 1 - rank]], dim=axis)


def all_local_zigzag(x, world, axis=1):
    """Global -> concatenation over ranks of the zigzag shards."""
    return torch.cat(
        [extract_local_zigzag(x, r, world, axis) for r in range(world)],
        dim=axis,
    )


def restore_zigzag(x, world, axis=1):
    """Inverse of all_local_zigzag (rank-ordered shards -> global order)."""
    c = _chunks(x, 2 * world, axis)  # per rank: [chunk r, 2W-1-r]
    ordered = [None] * (2 * world)
    for r in range(world):
        ordered[r] = c[2 * r]
        ordered[2 * world - 1 - r] = c[2 * r + 1]
    return torch.cat(ordered, dim=axis)


def zigzag_position_ids(rank, world, local_len):
    """Global positions of rank r's zigzag tokens (chunk r ++ chunk 2W-1-r),
    a numpy int32 array."""
    half = local_len // 2
    a = np.arange(half) + rank * half
    b = np.arange(half) + (2 * world - 1 - rank) * half
    return np.concatenate([a, b]).astype(np.int32)
