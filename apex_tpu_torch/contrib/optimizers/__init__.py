"""``apex.contrib.optimizers`` import surface (counterpart of
apex_tpu/contrib/optimizers/__init__.py; the reference's ZeRO optimizers
and the deprecated contrib copies of FusedAdam, FusedLAMB, FusedSGD and
FP16_Optimizer). The implementations are the port's ``optimizers`` and
``fp16_utils``."""

from apex_tpu_torch.fp16_utils import FP16_Optimizer
from apex_tpu_torch.optimizers import (
    DistributedFusedAdam,
    DistributedFusedLAMB,
    FusedAdam,
    FusedLAMB,
    FusedSGD,
    distributed_fused_adam,
    distributed_fused_lamb,
)

__all__ = [
    "DistributedFusedAdam",
    "DistributedFusedLAMB",
    "distributed_fused_adam",
    "distributed_fused_lamb",
    "FusedAdam",
    "FusedLAMB",
    "FusedSGD",
    "FP16_Optimizer",
]
