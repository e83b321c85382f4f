"""Packed (varlen) sequences: cu_seqlens to segment ids and positions.

The port of ``ring_flash_attn_tpu/ops/varlen.py``, the port's own copy in
torch and numpy. The reference threads flash-attn's ``cu_seqlens`` through
every varlen schedule; the kernels here take segment ids and per-token
positions instead (``MaskArgs.q_segids``/``q_pos``), and these helpers
convert. ``cu_seqlens`` may be a list, a numpy array or a tensor; the
results are int32 tensors on ``device`` (the q tensor's, at the call
sites), computed on that device without a host sync when a tensor is
given. The ``extract_local_*`` layout helpers work on numpy arrays or
tensors alike.
"""

import numpy as np
import torch


def as_cu_seqlens(cu_seqlens, device=None):
    """cu_seqlens (a list, numpy array or tensor) as an int32 tensor on
    ``device``."""
    if isinstance(cu_seqlens, torch.Tensor):
        return cu_seqlens.to(device=device, dtype=torch.int32)
    return torch.as_tensor(np.asarray(cu_seqlens, np.int32), device=device)


def cu_seqlens_to_segids(cu_seqlens, total, device=None):
    """Segment index of each of ``total`` packed tokens; cu_seqlens (N+1,)
    ascending with cu_seqlens[-1] == total."""
    cu = as_cu_seqlens(cu_seqlens, device)
    t = torch.arange(total, dtype=torch.int32, device=cu.device)
    return (torch.searchsorted(cu, t, right=True) - 1).to(torch.int32)


def cu_seqlens_to_positions(cu_seqlens, total, device=None):
    """Position of each packed token within its own sequence."""
    cu = as_cu_seqlens(cu_seqlens, device)
    seg = cu_seqlens_to_segids(cu, total)
    t = torch.arange(total, dtype=torch.int32, device=cu.device)
    return (t - cu[seg.long()]).to(torch.int32)


def ring_varlen_info(cu_seqlens_local, total_local, rank, device=None):
    """(segids, positions) for the ring-varlen layout: every sequence is
    split into W contiguous parts and rank r packs part r of every
    sequence, so the local cu_seqlens (global // W) are the same on every
    rank, and rank r's part of sequence i covers positions [r l_i,
    (r + 1) l_i)."""
    cu = as_cu_seqlens(cu_seqlens_local, device)
    seg = cu_seqlens_to_segids(cu, total_local)
    s = seg.long()
    lens = cu[s + 1] - cu[s]
    local = torch.arange(total_local, dtype=torch.int32,
                         device=cu.device) - cu[s]
    return seg, (rank * lens + local).to(torch.int32)


def zigzag_varlen_info(cu_seqlens_local, total_local, rank, world,
                       device=None):
    """(segids, positions) for the grouped zigzag-varlen layout: every
    sequence splits into 2W chunks and rank r packs chunk r of every
    sequence, then chunk 2W - 1 - r of every sequence. cu_seqlens_local
    are the per-half cu_seqlens (global // 2W)."""
    half = total_local // 2
    cu = as_cu_seqlens(cu_seqlens_local, device)
    seg = cu_seqlens_to_segids(cu, half)
    s = seg.long()
    lens = cu[s + 1] - cu[s]
    off = torch.arange(half, dtype=torch.int32, device=cu.device) - cu[s]
    front = rank * lens + off
    back = (2 * world - 1 - rank) * lens + off
    return (torch.cat([seg, seg]),
            torch.cat([front, back]).to(torch.int32))


def _take(x, idx, axis):
    if isinstance(x, torch.Tensor):
        return x.index_select(axis, torch.as_tensor(idx, device=x.device))
    return np.take(x, idx, axis=axis)


def _cat(parts, axis):
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts, dim=axis)
    return np.concatenate(parts, axis=axis)


def extract_local_ring_varlen(x, cu_seqlens, rank, world, axis=0):
    """Part ``rank`` of every sequence of x along ``axis``, packed."""
    cu = np.asarray(cu_seqlens)
    parts = []
    for i in range(len(cu) - 1):
        li = (cu[i + 1] - cu[i]) // world
        start = cu[i] + rank * li
        parts.append(_take(x, np.arange(start, start + li), axis))
    return _cat(parts, axis)


def extract_local_zigzag_varlen(x, cu_seqlens, rank, world, axis=0):
    """The grouped zigzag layout: chunk ``rank`` of every sequence, then
    chunk 2W - 1 - rank of every sequence."""
    cu = np.asarray(cu_seqlens)
    front, back = [], []
    for i in range(len(cu) - 1):
        ci = (cu[i + 1] - cu[i]) // (2 * world)
        j = 2 * world - 1 - rank
        front.append(_take(x, np.arange(cu[i] + rank * ci,
                                        cu[i] + (rank + 1) * ci), axis))
        back.append(_take(x, np.arange(cu[i] + j * ci,
                                       cu[i] + (j + 1) * ci), axis))
    return _cat(front + back, axis)


def local_chunk_info(segids_sorted):
    """(local_off, lens) of each token from SORTED segment ids: local_off
    is the token's index within its run, lens the run's length. Under the
    ring and zigzag varlen layouts rank r's positions are ``r * lens +
    local_off``, so a ring step derives the resident kv's positions from
    its source rank instead of receiving them."""
    seg = torch.as_tensor(segids_sorted).to(torch.int32).contiguous()
    idx = torch.arange(seg.shape[0], dtype=torch.int32, device=seg.device)
    start = torch.searchsorted(seg, seg, right=False).to(torch.int32)
    end = torch.searchsorted(seg, seg, right=True).to(torch.int32)
    return idx - start, end - start
