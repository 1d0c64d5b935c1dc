"""ray_tpu_torch.models — the port's model zoo (training half of Llama)."""

from ray_tpu_torch.models.llama import (
    Llama,
    LlamaConfig,
    adamw,
    entry,
    forward,
    init_params,
    make_train_step,
    next_token_loss,
    param_count,
    params_from_jax,
)

__all__ = [
    "Llama",
    "LlamaConfig",
    "adamw",
    "entry",
    "forward",
    "init_params",
    "make_train_step",
    "next_token_loss",
    "param_count",
    "params_from_jax",
]
