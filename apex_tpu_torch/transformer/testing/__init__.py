"""Megatron-style testing harness: the argument system, the global args,
and the standalone BERT and pipelined GPT pre-training entry points
(``standalone_bert``, ``standalone_gpt``)."""

from apex_tpu_torch.transformer.testing.arguments import (
    parse_args,
    transformer_config_from_args,
    validate_args,
)
from apex_tpu_torch.transformer.testing.global_vars import get_args, set_args

__all__ = ["get_args", "parse_args", "set_args",
           "transformer_config_from_args", "validate_args"]
