"""Optimizers: fused Adam on the hand-written Adam kernel, and ZeRO-2
Adam at a data-parallel world of one, which clips with the hand-written
sum-of-squares kernel."""

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

__all__ = ["AdamTransform", "DistributedFusedAdam",
           "DistributedFusedAdamState", "FusedAdam", "FusedAdamState",
           "adam_flat", "distributed_fused_adam", "fused_adam", "l2norm_flat",
           "sumsq_flat"]
