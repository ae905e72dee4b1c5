"""Model-conversion helpers (counterpart of
apex_tpu/fp16_utils/fp16util.py; ref fp16_utils/fp16util.py). Each takes
a dict of named tensors (and returns a new one) or a module (cast in
place); norm tensors are found by name, as amp's keep-fp32 rule finds
them."""

from typing import Any, Dict, Tuple

import torch

from apex_tpu_torch.amp.policy import cast_named, default_keep_fp32_predicate
from apex_tpu_torch.utils.pytree import tree_cast

__all__ = ["BN_convert_float", "convert_network",
           "master_params_to_model_params", "model_grads_to_master_grads",
           "network_to_half", "prep_param_lists", "to_python_float",
           "tofp16"]


def tofp16(params):
    """Every floating tensor to fp16."""
    return cast_named(params, lambda name, t: torch.float16)


def BN_convert_float(params):
    """Norm tensors back to fp32 (BN stays fp32 for stability)."""
    return cast_named(params, lambda name, t: torch.float32
                      if default_keep_fp32_predicate(name) else None)


def network_to_half(params):
    """fp16 everywhere but the norms."""
    return BN_convert_float(tofp16(params))


def convert_network(params, dtype):
    """``network_to_half`` with any dtype (amp O2's cast)."""
    return cast_named(params, lambda name, t: torch.float32
                      if default_keep_fp32_predicate(name) else dtype)


def prep_param_lists(params: Dict[str, torch.Tensor]
                     ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """(the model's tensors, an fp32 master copy of them)."""
    return params, {n: p.detach().float().clone() for n, p in params.items()}


def master_params_to_model_params(model_params: Dict[str, torch.Tensor],
                                  master_params: Dict[str, torch.Tensor]):
    """The masters' values in the model's dtypes, as a new dict."""
    return {n: master_params[n].to(p.dtype) for n, p in model_params.items()}


def model_grads_to_master_grads(model_grads):
    """Model (half) gradients as fp32 master gradients."""
    return tree_cast(model_grads, torch.float32)


def to_python_float(t) -> float:
    """A one-element tensor (or number) as a Python float."""
    return float(torch.as_tensor(t).reshape(()))
