"""Tensor-collection helpers (counterpart of apex_tpu/utils/pytree.py).

A collection is a tensor, or a list, tuple or dict of collections; its
leaves are taken in the JAX leaf order. A dict's keys may be dotted paths
(``dict(model.named_parameters())``): they sort by their components, as
the nested dicts they stand for would (``layer_10`` before ``layer_2``).
"""

from typing import Any, List

import torch

__all__ = ["leaf_order", "map_floats", "tree_any_non_finite", "tree_cast",
           "tree_leaves", "tree_map"]


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


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """``tree`` with ``fn(leaf, *leaves of rest)`` at every tensor leaf;
    the other trees share its structure (dict keys, sequence lengths)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        if isinstance(tree, list):
            return out
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    raise TypeError(f"not a tensor collection: {type(tree).__name__}")


def tree_cast(tree: Any, dtype) -> Any:
    """Every floating leaf of ``tree`` cast to ``dtype`` (None: unchanged);
    integer and bool leaves pass through."""
    if dtype is None:
        return tree
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    tree)


def map_floats(fn, tree: Any) -> Any:
    """``tree`` (any nesting of dicts, lists and tuples, named tuples
    included) with ``fn`` applied to every floating tensor; other
    tensors and non-tensor values (ints, strings, None) pass through."""
    if isinstance(tree, torch.Tensor):
        return fn(tree) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: map_floats(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_floats(fn, v) for v in tree]
    if isinstance(tree, tuple):
        out = [map_floats(fn, v) for v in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return tree
