"""Automatic mixed precision (counterpart of apex_tpu/amp): the opt
levels O0-O3 and ``initialize`` (``policy``), O1's cast lists and engine
(``cast_lists``, ``cast_engine``), loss scaling (``scaler``,
``grad_scaler``) and ``AmpOptimizer`` (``optimizer``). FP8 is not
ported yet."""

from apex_tpu_torch.amp.cast_engine import (
    cast_ops,
    disable_casts,
    float_function,
    half_function,
    promote_function,
    register_float_function,
    register_half_function,
    register_promote_function,
)
from apex_tpu_torch.amp.grad_scaler import GradScaler
from apex_tpu_torch.amp.optimizer import (
    AmpOptimizer,
    AmpOptimizerState,
    master_params,
)
from apex_tpu_torch.amp.policy import O0, O1, O2, O3, Policy, initialize, \
    opt_levels
from apex_tpu_torch.amp.scaler import (
    LossScaler,
    LossScalerState,
    scale_loss,
    unscale_grads,
)

__all__ = [
    "disable_casts", "AmpOptimizer", "AmpOptimizerState", "master_params",
    "cast_ops", "half_function", "float_function", "promote_function",
    "register_half_function", "register_float_function",
    "register_promote_function", "Policy", "O0", "O1", "O2", "O3",
    "opt_levels", "initialize", "LossScaler", "LossScalerState",
    "scale_loss", "unscale_grads", "GradScaler",
]
