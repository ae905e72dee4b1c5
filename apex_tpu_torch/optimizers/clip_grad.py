"""Global-norm gradient clipping (counterpart of
apex_tpu/optimizers/clip_grad.py; ref apex.contrib.clip_grad).

Functional, as in JAX: it returns new gradients and the norm. The 2-norm
comes from ``ops.multi_tensor.multi_tensor_l2norm``, so on CUDA tensors
each leaf's sum of squares is kernel #9; the inf- and p-norms are plain
torch. The coefficient ``min(max_norm / (norm + 1e-6), 1)`` is fp32 and
each gradient is scaled in fp32 and cast back to its dtype.
"""

from typing import Any, Tuple

import torch

from apex_tpu_torch.ops.multi_tensor import multi_tensor_l2norm
from apex_tpu_torch.utils.pytree import tree_leaves, tree_map

__all__ = ["clip_grad_norm"]


def clip_grad_norm(grads: Any, max_norm: float, norm_type: float = 2.0
                   ) -> Tuple[Any, torch.Tensor]:
    """(grads clipped to the global ``max_norm``, the total norm)."""
    if norm_type == 2.0:
        total = multi_tensor_l2norm(grads)
    elif norm_type == float("inf"):
        total = torch.stack([x.float().abs().max()
                             for x in tree_leaves(grads)]).max()
    else:
        acc = sum(x.float().abs().pow(norm_type).sum()
                  for x in tree_leaves(grads))
        total = acc ** (1.0 / norm_type)
    coef = torch.clamp_max(max_norm / (total + 1e-6), 1.0)
    clipped = tree_map(lambda g: (g.float() * coef).to(g.dtype), grads)
    return clipped, total
