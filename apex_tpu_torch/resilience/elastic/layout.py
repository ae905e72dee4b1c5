"""How a live state lies across the ranks, and the global tree it stands
for (the port's counterpart of the ``NamedSharding`` a JAX array
carries).

A JAX state leaf is one global array whatever the mesh; a port rank
holds only its part. A checkpoint at world > 1 records every leaf as its
GLOBAL array, so that a step saved at dp 4 restores at dp 2 and its
per-leaf crc32 is the one the JAX package takes over the same array
(``apex_tpu/resilience/elastic/reshard.py`` checks it over the global
array's C-order bytes). The layout's ranks are ``parallel_state``'s, ``r
= ((d * pp + p) * cp + c) * tp + t`` (JAX's ``reshape(dp, pp, cp,
tp)``). Each leaf has one of five splits:

- ``None`` (replicated): every rank holds the whole leaf (the scaler,
  the sentinel, the optimizer's step, the parameters at tp = 1, and
  every parameter over cp, as JAX replicates them there);
- ``("tp", dim)``: a tp-sharded parameter (``partition_dim``, set by
  ``parallel.layers``), or a fused Adam moment of one, is the tp ranks'
  shards concatenated along ``dim`` (replicated over pp: the pipelined
  GPT's embedding and head live on every stage, as in JAX);
- ``("pp", inner)``: a pipeline stage's leaf (marked by
  :func:`mark_pipeline_stage`, or the moment of one) is the pp ranks'
  leaves stacked on a new leading axis, JAX's ``pp``-sharded stacked
  ``stages`` tree; ``inner`` is the leaf's own split within a stage,
  None or ``("tp", dim)``;
- ``("zero",)``: a ZeRO flat buffer (``DistributedFusedAdamState``'s
  master, moments, or the int16 remainders), the dp ranks' shards
  concatenated in dp order (JAX's ``P("dp")``: replicated over cp), one
  row per tp rank at tp > 1 and one block of rows per pp rank at pp >
  1 (shape ``([pp,] [tp,] padded_total)``); only these may change length
  across a change of dp (``reshard``);
- ``("ef",)``: an error-feedback residual, each rank's own: the ranks'
  residuals in rank order, a 1-D one concatenated (``(devices * n,)``,
  the JAX state's dp-sharded global) and any other stacked
  (``(devices, *local)``); its own shape at a world of one. Advisory
  state, which a restore on another layout resets to zero where it
  cannot re-pad it.

:class:`StateLayout` derives the splits from a live state tree and this
process's ``parallel_state`` (dp x pp x cp x tp over the layout's ranks)
and moves between the two forms: :meth:`~StateLayout.gather` assembles
the global tree on the layout's first rank (one ``gather`` a split leaf;
a replicated leaf is that rank's own copy), and
:meth:`~StateLayout.local_part` cuts this rank's part out of a global
leaf. At a world of one both are the identity on a host copy, and the
checkpoint is the one a world of one always wrote.
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

__all__ = ["EF", "StateLayout", "ZERO", "mark_pipeline_stage"]

ZERO = ("zero",)
EF = ("ef",)

#: the attribute that marks a pipeline stage's tensor
PIPELINE_STAGE = "pipeline_stage"


def mark_pipeline_stage(tensors) -> None:
    """Marks ``tensors`` (an iterable) as a pipeline stage's own: at pp >
    1 a checkpoint stacks the pp ranks' copies of each on a new leading
    axis (module docstring)."""
    for t in tensors:
        setattr(t, PIPELINE_STAGE, True)


def _leaf_splits(tree: Any, tp: int, pp: int = 1) -> List[Any]:
    """One split a leaf of ``tree``, in ``tree_leaves_with_path`` order
    (module docstring), from the state classes and the parameters'
    ``tensor_model_parallel`` marks."""
    from apex_tpu_torch.optimizers.distributed_fused_adam import (
        DistributedFusedAdamState,
    )

    def tp_split(t):
        inner = None
        if tp > 1 and getattr(t, "tensor_model_parallel", False):
            inner = ("tp", int(getattr(t, "partition_dim", 0)))
        if pp > 1 and getattr(t, PIPELINE_STAGE, False):
            return ("pp", inner)
        return inner

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
        self.tp = ps.get_tensor_model_parallel_world_size()
        self.pp = ps.get_pipeline_model_parallel_world_size()
        self.cp = ps.get_context_parallel_world_size()
        self.dp = ps.get_data_parallel_world_size()
        self.devices = ps.get_model_world_size()
        self.group = ps.get_model_world_group()
        # this rank's place: r = ((d * pp + p) * cp + c) * tp + t
        # (parallel_state's order)
        self.coords = (ps.get_data_parallel_rank(),
                       ps.get_pipeline_model_parallel_rank(),
                       ps.get_context_parallel_rank(),
                       ps.get_tensor_model_parallel_rank())
        self.rank = self._rank(*self.coords)
        flat = list(tree_leaves_with_path(tree))
        self.paths = [p for p, _ in flat]
        self.splits = _leaf_splits(tree, self.tp, self.pp)
        self.local_shapes = [tuple(t.shape) for _, t in flat]

    def _rank(self, d: int, p: int, c: int, t: int) -> int:
        return ((d * self.pp + p) * self.cp + c) * self.tp + t

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
        if split[0] == "pp":
            inner = list(shape)
            if split[1] is not None:
                inner[split[1][1]] *= self.tp
            return (self.pp,) + tuple(inner)
        if split[0] == "tp":
            shape[split[1]] *= self.tp
            return tuple(shape)
        if split == ZERO:
            return self._zero_rows() + (shape[0] * self.dp,)
        if not self.multi_rank:
            return tuple(shape)
        if len(shape) == 1:
            return (self.devices * shape[0],)
        return (self.devices,) + tuple(shape)

    def _zero_rows(self) -> tuple:
        """The leading dims of a ZeRO buffer's global shape: one block a
        pp rank, one row a tp rank."""
        return ((self.pp,) if self.pp > 1 else ()) + \
            ((self.tp,) if self.tp > 1 else ())

    def spec(self, i: int) -> Optional[list]:
        """Leaf ``i``'s partition in the JAX manifest's form: one entry a
        dim, each None, an axis name or a list of them (null for a
        replicated leaf, as JAX writes a leaf without a named
        sharding)."""
        split = self.splits[i]
        if split is None:
            return None
        if split[0] == "pp":
            out = [None] * len(self.local_shapes[i])
            if split[1] is not None:
                out[split[1][1]] = "tp"
            return ["pp"] + out
        if split[0] == "tp":
            out = [None] * len(self.local_shapes[i])
            out[split[1]] = "tp"
            return out
        if split == ZERO:
            return (["pp"] if self.pp > 1 else []) + \
                (["tp"] if self.tp > 1 else []) + ["dp"]
        if not self.multi_rank:
            return None
        ranks = ["dp"] + [a for a, n in (("pp", self.pp), ("cp", self.cp),
                                         ("tp", self.tp)) if n > 1]
        if len(ranks) == 1:
            ranks = "dp"
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
        if split[0] == "pp":
            stages = []
            for p in range(self.pp):
                own = [parts[self._rank(0, p, 0, t)] for t in range(self.tp)]
                stages.append(own[0] if split[1] is None
                              else torch.cat(own, dim=split[1][1]))
            return torch.stack(stages)
        if split[0] == "tp":
            return torch.cat(parts[:self.tp], dim=split[1])
        if split == ZERO:
            blocks = []
            for p in range(self.pp):
                rows = [torch.cat([parts[self._rank(d, p, 0, t)]
                                   for d in range(self.dp)])
                        for t in range(self.tp)]
                blocks.append(torch.stack(rows) if self.tp > 1 else rows[0])
            return torch.stack(blocks) if self.pp > 1 else blocks[0]
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
        d, p, _, t = self.coords
        if split[0] == "pp":
            full, split = full[p], split[1]
            if split is None:
                return full
        if split[0] == "tp":
            return full.chunk(self.tp, dim=split[1])[t]
        if split == ZERO:
            row = full[p] if self.pp > 1 else full
            row = row[t] if self.tp > 1 else row
            return row.chunk(self.dp)[d]
        if len(self.local_shapes[i]) == 1:
            return full.chunk(self.devices)[self.rank]
        return full[self.rank]

    def broadcast_object(self, obj: Any) -> Any:
        """The first rank's ``obj`` on every layout rank."""
        if not self.multi_rank:
            return obj
        return ps.broadcast_object(obj, self.group)
