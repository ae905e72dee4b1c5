"""Automatic mixed precision (counterpart of apex_tpu/amp): the opt
levels O0-O3 and ``initialize`` (``policy``), O1's cast lists and engine
(``cast_lists``, ``cast_engine``), loss scaling (``scaler``,
``grad_scaler``), ``AmpOptimizer`` (``optimizer``) and FP8 delayed
scaling (``fp8``)."""

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
from apex_tpu_torch.amp.fp8 import (
    Fp8TensorState,
    fp8_dense,
    init_fp8_state,
    update_fp8_state,
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
    "Fp8TensorState", "fp8_dense", "init_fp8_state", "update_fp8_state",
    "cast_ops", "half_function", "float_function", "promote_function",
    "register_half_function", "register_float_function",
    "register_promote_function", "Policy", "O0", "O1", "O2", "O3",
    "opt_levels", "initialize", "LossScaler", "LossScalerState",
    "scale_loss", "unscale_grads", "GradScaler",
]
