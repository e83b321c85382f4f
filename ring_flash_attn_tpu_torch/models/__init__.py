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
from .pipeline import (
    forward_pp,
    loss_fn_pp,
    pipeline_specs,
    stack_layers,
    train_step_pp,
)

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
    "forward_pp",
    "loss_fn_pp",
    "pipeline_specs",
    "stack_layers",
    "train_step_pp",
]
