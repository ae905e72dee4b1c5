"""Optimizers: fused Adam on the hand-written Adam kernel."""

from apex_tpu_torch.optimizers._fused_kernels import adam_flat
from apex_tpu_torch.optimizers.fused_adam import (
    AdamTransform,
    FusedAdam,
    FusedAdamState,
    fused_adam,
)

__all__ = ["AdamTransform", "FusedAdam", "FusedAdamState", "adam_flat",
           "fused_adam"]
