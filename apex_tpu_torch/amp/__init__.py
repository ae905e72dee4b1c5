"""Loss scaling for mixed-precision training."""

from apex_tpu_torch.amp.grad_scaler import GradScaler
from apex_tpu_torch.amp.scaler import LossScaler, LossScalerState

__all__ = ["GradScaler", "LossScaler", "LossScalerState"]
