from .registry import (
    RingAttentionLayer,
    get_attention,
    list_attention,
    register_attention,
)

__all__ = [
    "RingAttentionLayer",
    "get_attention",
    "list_attention",
    "register_attention",
]
