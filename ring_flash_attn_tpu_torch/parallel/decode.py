"""Sequence-sharded long-context decode with a quantized KV cache.

The port of ``ring_flash_attn_tpu/parallel/decode.py``. The quantized KV
cache is sharded contiguously along the sequence over the process group;
each decode step computes a partial attention against the local shard and
the partials are LSE-combined across the group with three all-reduces of
O(Hq * D) values: the cache never moves. Functions are per-process;
``group=None`` with no initialised process group is one process, where
every collective is the identity.
"""

import torch

from ..ops.mask import NEG_INF
from ..ops.quant import QuantizedKV, quant_decode_attention, update_cache
from .mesh import all_reduce, ring_rank


def merge_across_axis(out, lse, group=None):
    """Combine per-shard normalized partials (out, lse) over the group.

    Stable cross-shard softmax combine: m = max(lse), w = exp(lse - m),
    out = sum(w * out) / sum(w). Dead shards (lse = NEG_INF) get w = 0; a
    row dead on every shard gives out = 0, lse = NEG_INF."""
    m = all_reduce(lse, "max", group)
    m = m.clamp(min=NEG_INF / 2)  # all-dead row guard
    w = torch.exp(lse - m)
    num = all_reduce(w[..., None] * out, "sum", group)
    den = all_reduce(w, "sum", group)
    den_safe = torch.where(den == 0.0, torch.ones_like(den), den)
    merged = num / den_safe[..., None]
    lse_m = torch.where(den == 0.0, torch.full_like(den, NEG_INF),
                        m + torch.log(den_safe))
    return merged, lse_m


def sharded_quant_decode(q, cache: QuantizedKV, total_length, scale,
                         group=None, softcap=None):
    """Per-process decode step.

    q (B, Hq, Tq, D) replicated new-token queries; cache = this rank's
    contiguous shard of the sequence. total_length: valid tokens globally
    (a Python int). Returns merged (out in q.dtype, lse f32), replicated.
    """
    rank = ring_rank(group)
    s_shard = cache.k_q.shape[2]
    start = rank * s_shard
    local_len = min(max(int(total_length) - start, 0), s_shard)
    out, lse = quant_decode_attention(
        q, cache, local_len, scale, pos_offset=start, softcap=softcap)
    out, lse = merge_across_axis(out, lse, group)
    return out.to(q.dtype), lse


def sharded_cache_update(cache: QuantizedKV, k_new, v_new, index,
                         group=None):
    """Insert new tokens at global position ``index`` (a Python int) into
    the sharded cache, in place.

    Each rank owns positions [rank * s_shard, (rank + 1) * s_shard). The
    rank that owns ``index`` writes at the local position, clamped so that
    the update fits; every other rank writes nothing."""
    rank = ring_rank(group)
    s_shard = cache.k_q.shape[2]
    start = rank * s_shard
    index = int(index)
    if start <= index < start + s_shard:
        update_cache(cache, k_new, v_new, index - start)
    return cache
