from .registry import (
    RingAttentionLayer,
    get_attention,
    list_attention,
    register_attention,
)
from .adapter import (
    DATA_PARAMS,
    current_ring_params,
    ring_attention_forward,
    substitute_hf_flash_attn,
    update_ring_flash_attn_params,
    use_ring_attn,
)

__all__ = [
    "DATA_PARAMS",
    "RingAttentionLayer",
    "get_attention",
    "list_attention",
    "register_attention",
    "current_ring_params",
    "ring_attention_forward",
    "substitute_hf_flash_attn",
    "update_ring_flash_attn_params",
    "use_ring_attn",
]
