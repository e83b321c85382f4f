from .decode import (
    merge_across_axis,
    sharded_cache_update,
    sharded_quant_decode,
)
from .llama3 import llama3_attention
from .mesh import psum_exact, ring_rank, ring_rotate, ring_size

__all__ = [
    "merge_across_axis",
    "sharded_cache_update",
    "sharded_quant_decode",
    "llama3_attention",
    "psum_exact",
    "ring_rank",
    "ring_rotate",
    "ring_size",
]
