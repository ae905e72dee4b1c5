"""Tensor-collection helpers (counterpart of apex_tpu/utils/pytree.py).

A collection is a tensor, or a list, tuple or dict of collections; its
leaves are taken in the JAX leaf order. A dict's keys may be dotted paths
(``dict(model.named_parameters())``): they sort by their components, as
the nested dicts they stand for would (``layer_10`` before ``layer_2``).
The state classes (dataclasses and named tuples of tensors) are nodes
too: :func:`tree_leaves_with_path` names their fields as JAX names a
registered dataclass's (``.field``).
"""

import dataclasses
from typing import Any, Iterator, List, Tuple

import torch

__all__ = ["keystr", "leaf_order", "map_floats", "map_tensors",
           "state_fields", "tree_any_non_finite", "tree_cast", "tree_copy_",
           "tree_leaves", "tree_leaves_with_path", "tree_map"]


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


def state_fields(node):
    """(name, value) pairs of a state class (a dataclass or a named
    tuple), in declared order, else None."""
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name))
                for f in dataclasses.fields(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    return None


def map_tensors(fn, tree: Any) -> Any:
    """``tree`` with ``fn`` at every tensor, its structure kept: dicts,
    lists, tuples, named tuples and dataclasses (their fields in declared
    order, a dict's items in insertion order); other values pass
    through."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    fields = state_fields(tree)
    if fields is not None:
        out = {k: map_tensors(fn, v) for k, v in fields}
        if isinstance(tree, tuple):
            return type(tree)(**out)
        return dataclasses.replace(tree, **out)
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [map_tensors(fn, v) for v in tree]
        return out if isinstance(tree, list) else tuple(out)
    return tree


def keystr(path) -> str:
    """A leaf path written as ``jax.tree_util.keystr`` writes it: a dict
    key as ``['key']``, a sequence index as ``[i]`` and a field (given as
    a one-tuple ``(name,)``) as ``.name``."""
    out = []
    for k in path:
        if isinstance(k, tuple):
            out.append(f".{k[0]}")
        elif isinstance(k, str):
            out.append(f"[{k!r}]")
        else:
            out.append(f"[{k}]")
    return "".join(out)


def tree_leaves_with_path(tree: Any, path=()
                          ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(keystr path, tensor) pairs in the JAX leaf order. A dotted dict
    key stands for the nested dicts of its components; a dataclass or
    named tuple's fields come in their declared order, as ``.name``;
    None is an empty subtree."""
    if isinstance(tree, torch.Tensor):
        yield keystr(path), tree
        return
    if tree is None:
        return
    fields = state_fields(tree)
    if fields is not None:
        for name, v in fields:
            yield from tree_leaves_with_path(v, path + ((name,),))
    elif isinstance(tree, dict):
        for k in leaf_order(tree):
            yield from tree_leaves_with_path(
                tree[k], path + tuple(str(k).split(".")))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from tree_leaves_with_path(x, path + (i,))
    else:
        raise TypeError(f"not a tensor collection: {type(tree).__name__}")


@torch.no_grad()
def tree_copy_(dst: Any, src: Any) -> Any:
    """Copy every leaf of ``src`` into the tensor at the same path of
    ``dst`` (``copy_``, so a model's own ``Parameter`` keeps training the
    restored values); returns ``dst``. The paths, shapes and dtypes must
    agree."""
    want = dict(tree_leaves_with_path(src))
    have = list(tree_leaves_with_path(dst))
    if [p for p, _ in have] != list(want):
        raise ValueError("tree_copy_: the two trees differ in structure")
    for path, t in have:
        s = want[path]
        if t.shape != s.shape or t.dtype != s.dtype:
            raise ValueError(
                f"tree_copy_: {path} is {tuple(s.shape)} {s.dtype}, the "
                f"live tensor {tuple(t.shape)} {t.dtype}")
        if s is not t:
            t.copy_(s)
    return dst
