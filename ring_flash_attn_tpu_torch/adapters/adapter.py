"""Model-integration adapter: the port of
``ring_flash_attn_tpu/adapters/adapter.py`` (reference
adapters/hf_adapter.py).

The reference makes an HF causal LM ring-capable by patching transformers'
flash-attention entry points and feeding per-batch sharding metadata
through a module-global DATA_PARAMS dict. The port, like the reference,
runs one process per rank; DATA_PARAMS keeps the JAX package's contents
(the packed batch's *global* segment labels), and each rank takes its
slice by its rank in the group.

- ``update_ring_flash_attn_params(cu_seqlens, group)``: per batch, before
  the model's forward; stores each token's global segment label.
- ``use_ring_attn(bool)``: the runtime switch (reference RING_ATTN_SWITCH).
- ``current_ring_params()``: the current batch's labels, to pass as
  ``global_segids``.
- ``ring_attention_forward(q, k, v, ...)``: the attention override, per
  rank on (B, S_local, H, D), llama3 all-gather context parallelism
  underneath (``parallel/llama3.py`` with ``q_segids``; kernels B1 and B2
  or B3a/B3b on the card).
- ``substitute_hf_flash_attn()``: registers the override in torch
  transformers' ``AttentionInterface`` and routes the llama, mistral and
  gemma attention modules to it.

Causal-only with a packed batch of size 1, as the reference. The model
runs on every rank of the group with the rank's contiguous shard of the
tokens and their global ``position_ids`` (each token's position within its
document). ``transformers`` is imported only by
``substitute_hf_flash_attn``.
"""

import importlib

import numpy as np
import torch

from ..api import flash_attn_func
from ..parallel.llama3 import llama3_attention
from ..parallel.mesh import ring_rank

# Per-batch sharding metadata, set by update_ring_flash_attn_params: the
# reference's module-global of the same name (hf_adapter.py:32).
DATA_PARAMS = {}
_RING_ATTN_SWITCH = True
_HF_SUBSTITUTED = False
HF_ATTENTION = "ring_flash_attn"  # its name in AttentionInterface


def use_ring_attn(enable):
    """Runtime toggle (reference hf_adapter.py:65-67)."""
    global _RING_ATTN_SWITCH
    _RING_ATTN_SWITCH = enable


def update_ring_flash_attn_params(cu_seqlens, group=None):
    """Recompute sharding metadata for this batch (reference :42-62).

    cu_seqlens: the GLOBAL packed cu_seqlens (host ints). Stores each
    token's global segment label (its sequence's global start), which
    every rank slices by its rank in ``group`` (None: the default group)."""
    cu = np.asarray(cu_seqlens, np.int64)
    total = int(cu[-1])
    seg = np.searchsorted(cu, np.arange(total), side="right") - 1
    DATA_PARAMS.update({
        "global_segids": torch.as_tensor(cu[seg], dtype=torch.int32),
        "total": total,
        "group": group,
    })


def current_ring_params():
    """The current batch's metadata: {"global_segids": (S,) int32}, for
    ``ring_attention_forward(global_segids=...)``."""
    return {"global_segids": DATA_PARAMS["global_segids"]}


def segment_labels(l, rank, position_ids=None, global_segids=None,
                   device=None):
    """The global segment labels (S_local,) int32 of rank ``rank``'s ``l``
    contiguous tokens: from ``position_ids`` (packed documents restart
    their positions, so a token's label is its global index minus its
    position), else from ``global_segids`` or DATA_PARAMS' labels."""
    if position_ids is not None:
        pos = position_ids.reshape(-1).to(device=device, dtype=torch.int64)
        if pos.numel() != l:
            raise ValueError(f"position_ids hold {pos.numel()} tokens, the "
                             f"shard {l}")
        idx = rank * l + torch.arange(l, device=device)
        return (idx - pos).to(torch.int32)
    if global_segids is None:
        global_segids = DATA_PARAMS["global_segids"]
    return torch.as_tensor(global_segids)[rank * l:(rank + 1) * l].to(
        device=device, dtype=torch.int32)


def ring_attention_forward(q, k, v, causal=True, softmax_scale=None,
                           heads_k_stride=None, group=None,
                           position_ids=None, softcap=0.0,
                           alibi_slopes=None, global_segids=None,
                           window_left=None):
    """Attention override: (B, S_local, H, D) in and out on every rank of
    ``group`` (None: DATA_PARAMS' group, else the default group), packed
    batch_size == 1 when ring is on (the reference enforces the same,
    hf_adapter.py:145-147).

    Segment labels, in preference order (``segment_labels``): 1.
    ``position_ids``, each token's position within its document, what the
    HF route passes; 2. ``global_segids``, the (S,) labels of
    ``current_ring_params()``; 3. DATA_PARAMS' labels from the last
    ``update_ring_flash_attn_params``. With ring off, or none of the
    three, it is single-device ``flash_attn_func``. ``window_left``: a
    sliding window on the token index (mistral's ``sliding_window - 1``)."""
    if not _RING_ATTN_SWITCH or (
            position_ids is None and global_segids is None
            and "global_segids" not in DATA_PARAMS):
        return flash_attn_func(q, k, v, softmax_scale=softmax_scale,
                               causal=causal, softcap=softcap,
                               alibi_slopes=alibi_slopes,
                               window_size=(-1, -1) if window_left is None
                               else (window_left, 0))
    if not causal:
        raise ValueError("the ring adapter is causal-only (reference "
                         ":138-144)")
    if q.shape[0] != 1:
        raise ValueError("the ring adapter needs a packed batch of size 1 "
                         f"(reference :145-147), got {q.shape[0]}")
    if group is None:
        group = DATA_PARAMS.get("group")
    seg = segment_labels(q.shape[1], ring_rank(group), position_ids,
                         global_segids, q.device)
    scale = softmax_scale if softmax_scale is not None else q.shape[-1]**-0.5
    out, _ = llama3_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), seg,
        scale=scale, causal=True,
        heads_k_stride=heads_k_stride or DATA_PARAMS.get("heads_k_stride"),
        group=group, softcap=float(softcap) if softcap else None,
        alibi_slopes=alibi_slopes, window_left=window_left)
    return out.transpose(1, 2)


def _hf_attention(module, query, key, value, attention_mask, dropout=0.0,
                  scaling=None, position_ids=None, sliding_window=None,
                  softcap=None, **kwargs):
    """The override in transformers' AttentionInterface: q (B, H, S, D),
    k and v (B, Hkv, S, D) -> (out (B, S, H, D), None). The mask is causal
    on the packed documents that ``position_ids`` delimit;
    ``attention_mask`` (padding) is not read."""
    del attention_mask, kwargs
    if dropout:
        raise NotImplementedError("the ring adapter runs attention without "
                                  "dropout")
    out = ring_attention_forward(
        query.transpose(1, 2), key.transpose(1, 2), value.transpose(1, 2),
        causal=True, softmax_scale=scaling, position_ids=position_ids,
        softcap=softcap or 0.0,
        window_left=None if sliding_window is None else sliding_window - 1)
    return out, None


def _routed_forward(orig):
    """The attention module's forward, run with the config's attention
    implementation set to the override for the call while ring is on
    (not on a decode step over a filled KV cache, nor when attention
    weights are asked for: the original forward runs those)."""

    def forward(self, *args, **kwargs):
        cache = kwargs.get("past_key_values")
        if (not _RING_ATTN_SWITCH or kwargs.get("output_attentions")
                or (cache is not None
                    and cache.get_seq_length(self.layer_idx) > 0)):
            return orig(self, *args, **kwargs)
        cfg = self.config
        saved = cfg._attn_implementation_internal
        cfg._attn_implementation_internal = HF_ATTENTION
        try:
            return orig(self, *args, **kwargs)
        finally:
            cfg._attn_implementation_internal = saved

    return forward


def substitute_hf_flash_attn(process_group=None, heads_k_stride=1):
    """Make torch transformers' causal LMs ring-capable (the reference
    patches ``_flash_attention_forward`` and ALL_ATTENTION_FUNCTIONS,
    hf_adapter.py:361-393).

    Registers the override as ``"ring_flash_attn"`` in transformers'
    ``AttentionInterface`` and routes every available decoder family with
    the llama attention structure (llama, mistral, gemma) to it. Call once
    at startup (later calls only update the group and heads_k_stride);
    then per batch call the model on each rank with its shard of the
    tokens and their global ``position_ids`` (or call
    ``update_ring_flash_attn_params``). Returns ``ring_attention_forward``
    for custom stacks."""
    global _HF_SUBSTITUTED
    DATA_PARAMS["group"] = process_group
    DATA_PARAMS["heads_k_stride"] = heads_k_stride
    if _HF_SUBSTITUTED:
        return ring_attention_forward
    from transformers import AttentionInterface

    AttentionInterface.register(HF_ATTENTION, _hf_attention)
    for family in ("llama", "mistral", "gemma"):
        try:
            mod = importlib.import_module(
                f"transformers.models.{family}.modeling_{family}")
        except ImportError:
            continue
        cls = getattr(mod, f"{family.capitalize()}Attention")
        cls.forward = _routed_forward(cls.forward)
    _HF_SUBSTITUTED = True
    return ring_attention_forward
