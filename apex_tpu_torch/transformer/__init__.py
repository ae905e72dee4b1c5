"""The Megatron-style transformer stack."""

from apex_tpu_torch.transformer.config import TransformerConfig
from apex_tpu_torch.transformer.enums import (
    AttnMaskType,
    AttnType,
    LayerType,
    ModelType,
)
from apex_tpu_torch.transformer.layer import (
    CoreAttention,
    KVCache,
    Norm,
    ParallelAttention,
    ParallelMLP,
    ParallelTransformer,
    ParallelTransformerLayer,
    ShardAwareDropout,
    seed_dropout,
)

__all__ = [
    "AttnMaskType", "AttnType", "CoreAttention", "KVCache", "LayerType",
    "ModelType", "Norm", "ParallelAttention", "ParallelMLP",
    "ParallelTransformer", "ParallelTransformerLayer", "ShardAwareDropout",
    "TransformerConfig", "seed_dropout",
]
