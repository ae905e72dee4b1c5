"""Tensor-collection helpers (counterpart of apex_tpu/utils/pytree.py).

A collection is a tensor, or a list, tuple or dict of collections; its
leaves are taken in the JAX leaf order. A dict's keys may be dotted paths
(``dict(model.named_parameters())``): they sort by their components, as
the nested dicts they stand for would (``layer_10`` before ``layer_2``).
"""

from typing import Any, List

import torch

__all__ = ["leaf_order", "tree_any_non_finite", "tree_leaves"]


def leaf_order(names):
    """Dict keys in the JAX leaf order: sorted by their dotted path."""
    return sorted(names, key=lambda n: tuple(str(n).split(".")))


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of ``tree`` in the JAX leaf order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in leaf_order(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in tree_leaves(x)]
    raise TypeError(f"not a tensor collection: {type(tree).__name__}")


def tree_any_non_finite(tree: Any) -> torch.Tensor:
    """0-d bool tensor: does any floating leaf hold a NaN or an Inf? It
    stays on the leaves' device (no host sync); False for no leaves."""
    leaves = [t for t in tree_leaves(tree) if t.is_floating_point()]
    if not leaves:
        return torch.tensor(False)
    finite = torch.stack([torch.isfinite(t).all() for t in leaves])
    return finite.logical_not().any()
