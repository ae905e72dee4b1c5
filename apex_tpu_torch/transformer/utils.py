"""Training-loop utilities (counterpart of apex_tpu/transformer/utils.py)."""

from typing import Any, Callable, Optional

import torch

from apex_tpu_torch.parallel import parallel_state as ps
from apex_tpu_torch.utils.pytree import leaf_order, tree_leaves

__all__ = ["calc_params_l2_norm"]


def calc_params_l2_norm(params: Any,
                        tp_duplicate_predicate: Optional[
                            Callable[[str], bool]] = None,
                        group=None) -> torch.Tensor:
    """Global L2 norm of a tensor collection, summed in fp32 leaf by leaf
    in the JAX leaf order; a 0-d tensor on the leaves' device.

    With ``group`` (the tensor-parallel group) the ranks' partial sums are
    all-reduced over it, and ``tp_duplicate_predicate(path)`` marks the
    tp-replicated tensors (norms, the position table, row-parallel
    biases), counted on tp rank 0 only (the reference's
    ``tensor_model_parallel`` attribute check). ``path`` is a dict key
    with ``/`` for ``.``, as the JAX function joins a tree path; the
    predicate needs ``params`` to be a dict."""
    counted_here = group is None or torch.distributed.get_rank(group) == 0
    if group is not None and tp_duplicate_predicate is not None:
        if not isinstance(params, dict):
            raise TypeError("a tp_duplicate_predicate needs a dict of "
                            "tensors by name")
        items = [(n, params[n]) for n in leaf_order(params)]
    else:
        items = [(None, p) for p in tree_leaves(params)]
    total = 0.0
    for name, p in items:
        sq = p.float().square().sum()
        if name is not None and not counted_here and \
                tp_duplicate_predicate(name.replace(".", "/")):
            sq = torch.zeros_like(sq)
        total = total + sq
    total = torch.as_tensor(total, dtype=torch.float32)
    if group is not None:
        total = ps.all_reduce(total, group)
    return torch.sqrt(total)
