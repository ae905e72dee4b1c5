"""Training-loop utilities (counterpart of apex_tpu/transformer/utils.py)."""

from typing import Any

import torch

from apex_tpu_torch.utils.pytree import tree_leaves

__all__ = ["calc_params_l2_norm"]


def calc_params_l2_norm(params: Any) -> torch.Tensor:
    """Global L2 norm of a tensor collection at tensor-parallel size 1,
    summed in fp32 leaf by leaf in the JAX leaf order; a 0-d tensor on the
    leaves' device."""
    total = 0.0
    for p in tree_leaves(params):
        total = total + p.float().square().sum()
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))
