"""Flat buffers of a parameter collection and the ``multi_tensor_*``
functional ops (counterpart of apex_tpu/ops/multi_tensor.py).

A collection is a dict from dotted names (``"transformer.layer_0.mlp..."``,
the port's ``named_parameters()`` names, which are the JAX tree's paths
joined with dots) to tensors. Its flat order is the JAX leaf order: dict
keys sorted at every level, so ``layer_10`` comes before ``layer_2``.
With the same padding to a multiple of :data:`CHUNK_SIZE`, the port's flat
buffers (the Adam moments of ``fused_adam(fuse="flat")``) are element for
element interchangeable with the JAX package's.
"""

import dataclasses
from typing import Any, Dict, Mapping, Tuple

import torch

from apex_tpu_torch.utils.pytree import (
    leaf_order,
    tree_any_non_finite,
    tree_leaves,
    tree_map,
)

__all__ = ["CHUNK_SIZE", "FlatSpec", "flatten_pytree", "leaf_order",
           "multi_tensor_applier", "multi_tensor_axpby",
           "multi_tensor_l2norm", "multi_tensor_scale", "unflatten_pytree"]

# the reference's multi_tensor_applier chunk (and the JAX package's)
CHUNK_SIZE = 2048 * 32


@dataclasses.dataclass(frozen=True)
class FlatSpec:
    """Names, shapes, dtypes and offsets of a flattened collection."""

    names: Tuple[str, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    offsets: Tuple[int, ...]  # start of each leaf in the flat buffer
    total: int  # unpadded element count
    padded_total: int  # total rounded up to a multiple of the chunk


def flatten_pytree(tree: Mapping[str, torch.Tensor], dtype=None):
    """One zero-padded 1-D buffer of every leaf in leaf order, and its
    :class:`FlatSpec`. The buffer's length is a multiple of
    :data:`CHUNK_SIZE` (at least one chunk); ``dtype`` defaults to the
    first leaf's."""
    names = tuple(leaf_order(tree))
    leaves = [tree[n] for n in names]
    sizes = [t.numel() for t in leaves]
    offsets, total = [], 0
    for n in sizes:
        offsets.append(total)
        total += n
    padded = max(CHUNK_SIZE, -(-total // CHUNK_SIZE) * CHUNK_SIZE)
    out_dtype = dtype or (leaves[0].dtype if leaves else torch.float32)
    device = leaves[0].device if leaves else None
    pad = torch.zeros(padded - total, dtype=out_dtype, device=device)
    flat = torch.cat([t.reshape(-1).to(out_dtype) for t in leaves] + [pad])
    spec = FlatSpec(names, tuple(tuple(t.shape) for t in leaves),
                    tuple(t.dtype for t in leaves), tuple(offsets), total,
                    padded)
    return flat, spec


def unflatten_pytree(flat: torch.Tensor, spec: FlatSpec
                     ) -> Dict[str, torch.Tensor]:
    """The leaves of ``flat`` by name, shaped and typed as ``spec``
    records them. Leaves that keep the buffer's dtype are views of it."""
    out = {}
    for name, shape, dtype, off in zip(spec.names, spec.shapes, spec.dtypes,
                                       spec.offsets):
        n = 1
        for s in shape:
            n *= s
        leaf = flat[off:off + n].reshape(shape)
        out[name] = leaf.to(dtype)
    return out


# -- multi_tensor_* functional ops (ref: csrc/amp_C_frontend.cpp) ----------

def multi_tensor_scale(tree: Any, scale) -> Tuple[Any, torch.Tensor]:
    """(tree * scale, overflow flag of ``tree``): the scale is cast to each
    leaf's dtype first, as the JAX function casts it."""
    out = tree_map(lambda x: x * torch.as_tensor(scale, dtype=x.dtype,
                                                 device=x.device), tree)
    return out, tree_any_non_finite(tree)


def multi_tensor_axpby(a, b, x_tree: Any, y_tree: Any
                       ) -> Tuple[Any, torch.Tensor]:
    """(a * x + b * y leaf by leaf, overflow flag of x or y)."""
    def axpby(x, y):
        def c(v):
            return torch.as_tensor(v, dtype=x.dtype, device=x.device)
        return c(a) * x + c(b) * y

    out = tree_map(axpby, x_tree, y_tree)
    return out, tree_any_non_finite(x_tree) | tree_any_non_finite(y_tree)


def _leaf_sumsq(x: torch.Tensor) -> torch.Tensor:
    """A leaf's fp32 sum of squares: kernel #9 on a CUDA tensor."""
    if x.is_cuda:
        from apex_tpu_torch.optimizers._fused_kernels import sumsq_flat
        return sumsq_flat(x.reshape(-1))
    return x.float().square().sum()


def multi_tensor_l2norm(tree: Any, per_tensor: bool = False):
    """The global L2 norm over every leaf (0-d fp32), and with
    ``per_tensor`` each leaf's norm too (1-d fp32, leaf order)."""
    leaves = tree_leaves(tree)
    if not leaves:
        z = torch.zeros((), dtype=torch.float32)
        return (z, torch.zeros(0, dtype=torch.float32)) if per_tensor else z
    sq = torch.stack([_leaf_sumsq(x) for x in leaves])
    total = torch.sqrt(sq.sum())
    if per_tensor:
        return total, torch.sqrt(sq)
    return total


def multi_tensor_applier(op, noop_flag, tensor_lists, *args):
    """The reference's call convention: ``op(noop_flag, tensor_lists,
    *args)``, which returns the new lists and flag; nothing is written in
    place."""
    return op(noop_flag, tensor_lists, *args)
