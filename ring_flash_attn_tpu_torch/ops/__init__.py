from .mask import NEG_INF, MaskArgs
from .flash import block_bwd, block_fwd, compute_delta, flash_attention
from .paged import (
    PagedKVCache,
    copy_pages,
    paged_append,
    paged_decode_attention,
    paged_gather_dense,
    paged_init,
    paged_prefill,
)

__all__ = [
    "NEG_INF",
    "MaskArgs",
    "block_bwd",
    "block_fwd",
    "compute_delta",
    "flash_attention",
    "PagedKVCache",
    "copy_pages",
    "paged_append",
    "paged_decode_attention",
    "paged_gather_dense",
    "paged_init",
    "paged_prefill",
]
