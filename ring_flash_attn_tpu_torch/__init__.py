"""ring-flash-attention on PyTorch and CUDA for the NVIDIA H100.

The port of the JAX/Pallas package ``ring_flash_attn_tpu``, slice by slice.
Ported so far: the serving path (the paged-KV continuous-batching
``ServingEngine`` over the llama-style flagship model), single-device
training (``loss_fn``, ``train_step``, the differentiable
``flash_attention`` and the flash-attn-style ``api`` functions) and
long-context inference on a quantized KV cache (``models.generate`` over a
``torch.distributed`` process group, or one process on one card), with
seven kernels written by hand in CUDA C++ for ``sm_90a`` (``csrc/``): the
flash forward (B1), bf16 paged decode (B5), the fused flash backward (B2),
the split backward (B3a dq, B3b dk/dv) and decode over an int8/fp8 cache,
contiguous (B4) or paged (B6). CUDA tensors go to the kernels,
CPU tensors to their plain PyTorch versions. The package imports neither
JAX nor the JAX package.
"""

__version__ = "0.1.0"

from .api import (  # noqa: F401
    flash_attn_func,
    flash_attn_kvpacked_func,
    flash_attn_qkvpacked_func,
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
    train_step,
)
from .ops import MaskArgs, block_bwd, block_fwd, flash_attention  # noqa: F401

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
    "train_step",
    "MaskArgs",
    "block_bwd",
    "block_fwd",
    "flash_attention",
    "flash_attn_func",
    "flash_attn_kvpacked_func",
    "flash_attn_qkvpacked_func",
]
