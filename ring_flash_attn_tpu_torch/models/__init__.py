from .transformer import (
    ModelConfig,
    Transformer,
    init_params,
    loss_fn,
    params_from_jax,
    prepare_zigzag_batch,
    train_step,
)
from .generate import decode_step, generate, prefill
from .serve import SamplingParams, ServingEngine

__all__ = [
    "ModelConfig",
    "Transformer",
    "init_params",
    "loss_fn",
    "params_from_jax",
    "prepare_zigzag_batch",
    "train_step",
    "SamplingParams",
    "ServingEngine",
    "decode_step",
    "generate",
    "prefill",
]
