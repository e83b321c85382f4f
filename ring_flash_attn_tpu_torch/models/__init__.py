from .transformer import (
    ModelConfig,
    Transformer,
    init_params,
    loss_fn,
    params_from_jax,
    train_step,
)
from .serve import SamplingParams, ServingEngine

__all__ = [
    "ModelConfig",
    "Transformer",
    "init_params",
    "loss_fn",
    "params_from_jax",
    "train_step",
    "SamplingParams",
    "ServingEngine",
]
