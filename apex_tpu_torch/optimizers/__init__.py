"""Optimizers: fused Adam on the hand-written Adam kernel, ZeRO-2 Adam
at a data-parallel world of one, which clips with the hand-written
sum-of-squares kernel, and fused momentum SGD (plain torch)."""

from apex_tpu_torch.optimizers._fused_kernels import (
    adam_flat,
    l2norm_flat,
    sumsq_flat,
)
from apex_tpu_torch.optimizers.distributed_fused_adam import (
    DistributedFusedAdam,
    DistributedFusedAdamState,
    distributed_fused_adam,
)
from apex_tpu_torch.optimizers.fused_adam import (
    AdamTransform,
    FusedAdam,
    FusedAdamState,
    fused_adam,
)
from apex_tpu_torch.optimizers.fused_sgd import (
    FusedSGD,
    FusedSGDState,
    SGDTransform,
    fused_sgd,
)

__all__ = ["AdamTransform", "DistributedFusedAdam",
           "DistributedFusedAdamState", "FusedAdam", "FusedAdamState",
           "FusedSGD", "FusedSGDState", "SGDTransform", "adam_flat",
           "distributed_fused_adam", "fused_adam", "fused_sgd", "l2norm_flat",
           "sumsq_flat"]
