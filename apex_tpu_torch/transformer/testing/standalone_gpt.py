"""The config half of the standalone GPT (counterpart of
``gpt_config_from_args`` in apex_tpu/transformer/testing/standalone_gpt.py).
``run_gpt`` needs the pipeline schedules and waits for them."""

import dataclasses

from apex_tpu_torch.transformer.config import TransformerConfig
from apex_tpu_torch.transformer.testing.arguments import (
    transformer_config_from_args,
)

__all__ = ["gpt_config_from_args"]


def gpt_config_from_args(args) -> TransformerConfig:
    """``transformer_config_from_args`` with dropout off, as the reference
    tests run (and the standalone BERT with them)."""
    return dataclasses.replace(transformer_config_from_args(args),
                               hidden_dropout=0.0, attention_dropout=0.0)
