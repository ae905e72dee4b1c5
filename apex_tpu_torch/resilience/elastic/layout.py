"""How a live state lies across the ranks, and the global tree it stands
for (the port's counterpart of the ``NamedSharding`` a JAX array
carries).

A JAX state leaf is one global array whatever the mesh; a port rank
holds only its part. A checkpoint at world > 1 records every leaf as its
GLOBAL array, so that a step saved at dp 4 restores at dp 2 and its
per-leaf crc32 is the one the JAX package takes over the same array
(``apex_tpu/resilience/elastic/reshard.py`` checks it over the global
array's C-order bytes). Each leaf has one of four splits:

- ``None`` (replicated): every rank holds the whole leaf (the scaler,
  the sentinel, the optimizer's step, the parameters at tp = 1);
- ``("tp", dim)``: a tp-sharded parameter (``partition_dim``, set by
  ``parallel.layers``), or a fused Adam moment of one, is the tp ranks'
  shards concatenated along ``dim``;
- ``("zero",)``: a ZeRO flat buffer (``DistributedFusedAdamState``'s
  master, moments, or the int16 remainders), the dp ranks' shards
  concatenated in dp order, one row per tp rank at tp > 1 (shape ``(tp,
  padded_total)``); only these may change length across a change of dp
  (``reshard``);
- ``("ef",)``: an error-feedback residual, each rank's own: the ranks'
  residuals in rank order, a 1-D one concatenated (``(devices * n,)``,
  the JAX state's dp-sharded global) and any other stacked
  (``(devices, *local)``); its own shape at a world of one. Advisory
  state, which a restore on another layout resets to zero where it
  cannot re-pad it.

:class:`StateLayout` derives the splits from a live state tree and this
process's ``parallel_state`` (dp x tp over the layout's ranks; pp and
cp > 1 are refused), and moves between the two forms:
:meth:`~StateLayout.gather` assembles the global tree on the layout's
first rank (one ``gather`` a split leaf; a replicated leaf is that
rank's own copy), and :meth:`~StateLayout.local_part` cuts this rank's
part out of a global leaf. At a world of one both are the identity on a
host copy, and the checkpoint is the one a world of one always wrote.
"""

from typing import Any, List, Optional

import torch
import torch.distributed as dist

from apex_tpu_torch.parallel import parallel_state as ps
from apex_tpu_torch.utils.pytree import (
    map_tensors,
    state_fields,
    tree_leaves_with_path,
)

__all__ = ["EF", "StateLayout", "ZERO"]

ZERO = ("zero",)
EF = ("ef",)


def _leaf_splits(tree: Any, tp: int) -> List[Any]:
    """One split a leaf of ``tree``, in ``tree_leaves_with_path`` order
    (module docstring), from the state classes and the parameters'
    ``tensor_model_parallel`` marks."""
    from apex_tpu_torch.optimizers.distributed_fused_adam import (
        DistributedFusedAdamState,
    )

    def tp_split(t):
        if tp > 1 and getattr(t, "tensor_model_parallel", False):
            return ("tp", int(getattr(t, "partition_dim", 0)))
        return None

    by_name = {}  # parameter name -> its split, for the moments' dicts

    def collect(node):
        if isinstance(node, dict):
            for k, v in node.items():
                if isinstance(v, torch.Tensor):
                    if tp_split(v) is not None:
                        by_name[k] = tp_split(v)
                else:
                    collect(v)
        elif state_fields(node) is not None:
            for _, v in state_fields(node):
                collect(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                collect(v)

    marks = {}

    def mark(t, split):
        marks[id(t)] = split

    def walk(node, name=None, ef=False):
        if isinstance(node, torch.Tensor):
            if ef:
                mark(node, EF if node.dim() else None)
            else:
                own = tp_split(node)
                mark(node, own if own is not None else by_name.get(name))
        elif isinstance(node, DistributedFusedAdamState):
            for field in ("master_shard", "exp_avg", "exp_avg_sq"):
                mark(getattr(node, field), ZERO)
            mark(node.step, None)
            walk(node.ef_residual, ef=True)
        elif state_fields(node) is not None:
            for field, v in state_fields(node):
                walk(v, ef=ef or field == "ef_residual")
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, name=k, ef=ef or k == "ef_residual")
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v, ef=ef)

    collect(tree)
    walk(tree)
    return [marks[id(t)] for _, t in tree_leaves_with_path(tree)]


def _host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t`` that shares no storage with it."""
    t = t.detach()
    return t.clone() if t.device.type == "cpu" else t.cpu()


class StateLayout:
    """The layout of a live state tree over this process's
    ``parallel_state`` (module docstring)."""

    def __init__(self, tree: Any):
        if ps.get_pipeline_model_parallel_world_size() > 1 or \
                ps.get_context_parallel_world_size() > 1:
            raise ValueError(
                "a checkpoint's global layout covers dp x tp: pp and cp "
                "above 1 are not laid out (save at pp = cp = 1)")
        self.tp = ps.get_tensor_model_parallel_world_size()
        self.dp = ps.get_data_parallel_world_size()
        self.devices = ps.get_model_world_size()
        self.group = ps.get_model_world_group()
        # this rank's place: r = d * tp + t (parallel_state's order)
        self.rank = (ps.get_data_parallel_rank() * self.tp
                     + ps.get_tensor_model_parallel_rank())
        flat = list(tree_leaves_with_path(tree))
        self.paths = [p for p, _ in flat]
        self.splits = _leaf_splits(tree, self.tp)
        self.local_shapes = [tuple(t.shape) for _, t in flat]

    @property
    def multi_rank(self) -> bool:
        return self.devices > 1

    @property
    def is_writer(self) -> bool:
        """Is this rank the one that writes (and fingerprints) the global
        tree: the layout's first rank?"""
        return self.rank == 0

    def global_shape(self, i: int) -> tuple:
        """Leaf ``i``'s global shape."""
        shape, split = list(self.local_shapes[i]), self.splits[i]
        if split is None:
            return tuple(shape)
        if split[0] == "tp":
            shape[split[1]] *= self.tp
            return tuple(shape)
        if split == ZERO:
            n = shape[0] * self.dp
            return (self.tp, n) if self.tp > 1 else (n,)
        if not self.multi_rank:
            return tuple(shape)
        if len(shape) == 1:
            return (self.devices * shape[0],)
        return (self.devices,) + tuple(shape)

    def spec(self, i: int) -> Optional[list]:
        """Leaf ``i``'s partition in the JAX manifest's form: one entry a
        dim, each None, an axis name or a list of them (null for a
        replicated leaf, as JAX writes a leaf without a named
        sharding)."""
        split = self.splits[i]
        if split is None:
            return None
        if split[0] == "tp":
            out = [None] * len(self.local_shapes[i])
            out[split[1]] = "tp"
            return out
        if split == ZERO:
            return ["tp", "dp"] if self.tp > 1 else ["dp"]
        if not self.multi_rank:
            return None
        ranks = ["dp", "tp"] if self.tp > 1 else "dp"
        if len(self.local_shapes[i]) == 1:
            return [ranks]
        return [ranks] + [None] * len(self.local_shapes[i])

    # -- local <-> global ----------------------------------------------------

    def _gather(self, t: torch.Tensor) -> Optional[List[torch.Tensor]]:
        """Every layout rank's ``t`` (one shape on all), on the host of
        the first rank in rank order; None on the others."""
        if not self.multi_rank:
            return [_host(t)]
        src = t.detach().contiguous()
        if dist.get_backend(self.group) == "gloo":
            src = src.cpu()
        first = dist.get_global_rank(self.group, 0)
        parts = ([torch.empty_like(src) for _ in range(self.devices)]
                 if self.is_writer else None)
        dist.gather(src, parts, dst=first, group=self.group)
        return None if parts is None else [p.cpu() for p in parts]

    def _assemble(self, split, parts: List[torch.Tensor]) -> torch.Tensor:
        if split[0] == "tp":
            return torch.cat(parts[:self.tp], dim=split[1])
        if split == ZERO:
            rows = [torch.cat([parts[d * self.tp + t]
                               for d in range(self.dp)])
                    for t in range(self.tp)]
            return torch.stack(rows) if self.tp > 1 else rows[0]
        if not self.multi_rank:
            return parts[0]
        return torch.cat(parts) if parts[0].dim() == 1 else \
            torch.stack(parts)

    def gather(self, tree: Any) -> Any:
        """The global tree (``tree``'s structure, host tensors) on the
        first rank, None on the others. Collective over the layout's
        ranks: every rank calls it with its own part."""
        flat = [t for _, t in tree_leaves_with_path(tree)]
        if [tuple(t.shape) for t in flat] != self.local_shapes:
            raise ValueError("the tree is not the one this layout was "
                             "taken from")
        out = []
        for t, split in zip(flat, self.splits):
            if split is None:
                out.append(_host(t) if self.is_writer else None)
                continue
            parts = self._gather(t)
            out.append(None if parts is None
                       else self._assemble(split, parts))
        if not self.is_writer:
            return None
        by_id = {id(t): g for t, g in zip(flat, out)}
        return map_tensors(lambda t: by_id[id(t)], tree)

    def local_part(self, i: int, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of leaf ``i``'s global array ``full`` (already
        regrouped to this layout's global shape)."""
        split = self.splits[i]
        if split is None or not self.multi_rank:
            return full
        t, d = self.rank % self.tp, self.rank // self.tp
        if split[0] == "tp":
            return full.chunk(self.tp, dim=split[1])[t]
        if split == ZERO:
            row = full[t] if self.tp > 1 else full
            return row.chunk(self.dp)[d]
        if len(self.local_shapes[i]) == 1:
            return full.chunk(self.devices)[self.rank]
        return full[self.rank]

    def broadcast_object(self, obj: Any) -> Any:
        """The first rank's ``obj`` on every layout rank."""
        if not self.multi_rank:
            return obj
        return ps.broadcast_object(obj, self.group)
