"""The legacy manual mixed-precision API (counterpart of
apex_tpu/fp16_utils; ref apex/fp16_utils): conversion helpers over
dicts of named tensors or modules, the static and dynamic loss scalers,
and ``FP16_Optimizer``, a thin layer over ``amp.AmpOptimizer``."""

from apex_tpu_torch.fp16_utils.fp16_optimizer import FP16_Optimizer
from apex_tpu_torch.fp16_utils.fp16util import (
    BN_convert_float,
    convert_network,
    master_params_to_model_params,
    model_grads_to_master_grads,
    network_to_half,
    prep_param_lists,
    to_python_float,
    tofp16,
)
from apex_tpu_torch.fp16_utils.loss_scaler import DynamicLossScaler, \
    LossScaler

__all__ = ["BN_convert_float", "convert_network",
           "master_params_to_model_params", "model_grads_to_master_grads",
           "network_to_half", "prep_param_lists", "to_python_float",
           "tofp16", "DynamicLossScaler", "LossScaler", "FP16_Optimizer"]
