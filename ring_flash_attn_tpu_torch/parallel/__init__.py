from . import layouts
from .decode import (
    merge_across_axis,
    sharded_cache_update,
    sharded_quant_decode,
)
from .fused_ring import fused_ring_attention, fused_ring_bwd_supported
from .llama3 import llama3_attention
from .layouts import (
    extract_local_contiguous,
    extract_local_stripe,
    extract_local_zigzag,
    stripe_position_ids,
    zigzag_position_ids,
)
from .mesh import (
    all_to_all,
    psum_exact,
    reduce_scatter,
    ring_rank,
    ring_rotate,
    ring_rotate_start,
    ring_size,
)
from .ring import ring_attention
from .ring_varlen import ring_attention_varlen
from .stripe import stripe_attention
from .ulysses import ulysses_attention, usp_attention
from .zigzag import zigzag_ring_attention
from .zigzag_varlen import zigzag_ring_attention_varlen

__all__ = [
    "layouts",
    "merge_across_axis",
    "sharded_cache_update",
    "sharded_quant_decode",
    "fused_ring_attention",
    "fused_ring_bwd_supported",
    "llama3_attention",
    "extract_local_contiguous",
    "extract_local_stripe",
    "extract_local_zigzag",
    "stripe_position_ids",
    "zigzag_position_ids",
    "all_to_all",
    "psum_exact",
    "reduce_scatter",
    "ring_rank",
    "ring_rotate",
    "ring_rotate_start",
    "ring_size",
    "ring_attention",
    "ring_attention_varlen",
    "stripe_attention",
    "ulysses_attention",
    "usp_attention",
    "zigzag_ring_attention",
    "zigzag_ring_attention_varlen",
]
