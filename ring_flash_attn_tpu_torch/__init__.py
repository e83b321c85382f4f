"""ring-flash-attention on PyTorch and CUDA for the NVIDIA H100.

The port of the JAX/Pallas package ``ring_flash_attn_tpu``, slice by slice.
Ported so far: the serving path (the paged-KV continuous-batching
``ServingEngine`` over the llama-style flagship model), single-device
training (``loss_fn``, ``train_step``, the differentiable
``flash_attention`` and the flash-attn-style ``api`` functions) and
long-context inference on a quantized KV cache (``models.generate`` over a
``torch.distributed`` process group, or one process on one card) and
context-parallel attention and training over a process group (the ring,
zigzag, fused-ring, stripe, Ulysses and USP schedules of ``parallel``, the
``api`` functions of the ring, zigzag and stripe schedules, the attention
registry of ``adapters`` and ``train_step`` with a sequence group and a
Ulysses group) and packed (varlen) sequences (``flash_attn_varlen_func``,
``ring_flash_attn_varlen_func``, ``zigzag_ring_flash_attn_varlen_func``,
``llama3_flash_attn_varlen_func``), softcap and ALiBi on all of them, with
nine kernels written by hand in CUDA C++ for
``sm_90a`` (``csrc/``): the flash forward (B1), bf16 paged decode (B5), the fused
flash backward (B2), the split backward (B3a dq, B3b dk/dv), decode over
an int8/fp8 cache, contiguous (B4) or paged (B6), and the fused ring's
forward and backward steps (B7, B8). CUDA tensors go to the kernels,
CPU tensors to their plain PyTorch versions. The package imports neither
JAX nor the JAX package.
"""

__version__ = "0.1.0"

from .adapters import (  # noqa: F401
    RingAttentionLayer,
    get_attention,
    list_attention,
    register_attention,
)
from .api import (  # noqa: F401
    flash_attn_func,
    flash_attn_kvpacked_func,
    flash_attn_qkvpacked_func,
    flash_attn_varlen_func,
    flash_attn_varlen_kvpacked_func,
    flash_attn_varlen_qkvpacked_func,
    llama3_flash_attn_prepare_cu_seqlens,
    llama3_flash_attn_varlen_func,
    llama3_flash_attn_varlen_kvpacked_func,
    llama3_flash_attn_varlen_qkvpacked_func,
    ring_flash_attn_func,
    ring_flash_attn_kvpacked_func,
    ring_flash_attn_qkvpacked_func,
    ring_flash_attn_varlen_func,
    ring_flash_attn_varlen_kvpacked_func,
    ring_flash_attn_varlen_qkvpacked_func,
    stripe_flash_attn_func,
    stripe_flash_attn_kvpacked_func,
    stripe_flash_attn_qkvpacked_func,
    zigzag_ring_flash_attn_func,
    zigzag_ring_flash_attn_kvpacked_func,
    zigzag_ring_flash_attn_qkvpacked_func,
    zigzag_ring_flash_attn_varlen_func,
    zigzag_ring_flash_attn_varlen_kvpacked_func,
    zigzag_ring_flash_attn_varlen_qkvpacked_func,
)
from .config import resolve_device  # noqa: F401
from .models import (  # noqa: F401
    ModelConfig,
    SamplingParams,
    ServingEngine,
    Transformer,
    generate,
    init_params,
    loss_fn,
    params_from_jax,
    prepare_zigzag_batch,
    train_step,
)
from .ops import MaskArgs, block_bwd, block_fwd, flash_attention  # noqa: F401
from .parallel import (  # noqa: F401
    fused_ring_attention,
    ring_attention,
    ring_attention_varlen,
    stripe_attention,
    ulysses_attention,
    usp_attention,
    zigzag_ring_attention,
    zigzag_ring_attention_varlen,
)

__all__ = [
    "resolve_device",
    "ModelConfig",
    "SamplingParams",
    "ServingEngine",
    "Transformer",
    "generate",
    "init_params",
    "loss_fn",
    "params_from_jax",
    "prepare_zigzag_batch",
    "train_step",
    "MaskArgs",
    "block_bwd",
    "block_fwd",
    "flash_attention",
    "flash_attn_func",
    "flash_attn_kvpacked_func",
    "flash_attn_qkvpacked_func",
    "flash_attn_varlen_func",
    "flash_attn_varlen_kvpacked_func",
    "flash_attn_varlen_qkvpacked_func",
    "llama3_flash_attn_prepare_cu_seqlens",
    "llama3_flash_attn_varlen_func",
    "llama3_flash_attn_varlen_kvpacked_func",
    "llama3_flash_attn_varlen_qkvpacked_func",
    "ring_flash_attn_func",
    "ring_flash_attn_kvpacked_func",
    "ring_flash_attn_qkvpacked_func",
    "ring_flash_attn_varlen_func",
    "ring_flash_attn_varlen_kvpacked_func",
    "ring_flash_attn_varlen_qkvpacked_func",
    "stripe_flash_attn_func",
    "stripe_flash_attn_kvpacked_func",
    "stripe_flash_attn_qkvpacked_func",
    "zigzag_ring_flash_attn_func",
    "zigzag_ring_flash_attn_kvpacked_func",
    "zigzag_ring_flash_attn_qkvpacked_func",
    "zigzag_ring_flash_attn_varlen_func",
    "zigzag_ring_flash_attn_varlen_kvpacked_func",
    "zigzag_ring_flash_attn_varlen_qkvpacked_func",
    "RingAttentionLayer",
    "get_attention",
    "list_attention",
    "register_attention",
    "fused_ring_attention",
    "ring_attention",
    "ring_attention_varlen",
    "stripe_attention",
    "ulysses_attention",
    "usp_attention",
    "zigzag_ring_attention",
    "zigzag_ring_attention_varlen",
]
