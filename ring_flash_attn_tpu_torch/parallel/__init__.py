from . import layouts
from .decode import (
    merge_across_axis,
    sharded_cache_update,
    sharded_quant_decode,
)
from .fused_ring import fused_ring_attention, fused_ring_bwd_supported
from .llama3 import llama3_attention
from .mesh import (
    psum_exact,
    ring_rank,
    ring_rotate,
    ring_rotate_start,
    ring_size,
)
from .ring import ring_attention
from .zigzag import zigzag_ring_attention

__all__ = [
    "layouts",
    "merge_across_axis",
    "sharded_cache_update",
    "sharded_quant_decode",
    "fused_ring_attention",
    "fused_ring_bwd_supported",
    "llama3_attention",
    "psum_exact",
    "ring_rank",
    "ring_rotate",
    "ring_rotate_start",
    "ring_size",
    "ring_attention",
    "zigzag_ring_attention",
]
