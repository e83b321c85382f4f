from .transformer import (
    ModelConfig,
    Transformer,
    init_params,
    loss_fn,
    param_specs,
    params_from_jax,
    prepare_zigzag_batch,
    shard_params,
    train_step,
)
from .moe import MoELayer, init_moe_layer, moe_mlp
from .generate import decode_step, generate, prefill
from .serve import SamplingParams, ServingEngine

__all__ = [
    "ModelConfig",
    "Transformer",
    "init_params",
    "loss_fn",
    "param_specs",
    "params_from_jax",
    "prepare_zigzag_batch",
    "shard_params",
    "train_step",
    "MoELayer",
    "init_moe_layer",
    "moe_mlp",
    "SamplingParams",
    "ServingEngine",
    "decode_step",
    "generate",
    "prefill",
]
