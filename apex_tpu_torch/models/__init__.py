"""The GPT model, its loss, its decoding loop and conversion of JAX
weights and training state."""

from apex_tpu_torch.models.convert import (
    fused_adam_state_from_jax,
    gpt_params_from_jax,
    scaler_state_from_jax,
)
from apex_tpu_torch.models.generate import generate, sample_next_token
from apex_tpu_torch.models.gpt import (
    Embedding,
    GPTModel,
    gpt2_small_config,
    gpt_loss_fn,
)

__all__ = [
    "Embedding", "GPTModel", "fused_adam_state_from_jax", "generate",
    "gpt2_small_config", "gpt_loss_fn", "gpt_params_from_jax",
    "sample_next_token", "scaler_state_from_jax",
]
