"""The port's "emitted module": what one recorded step really did
(counterpart of apex_tpu/analysis/hlo/parser.py).

The JAX package parses the optimized HLO that XLA emitted for a step.
Eager torch compiles nothing, so the port's source for "what the step
really did", as against what the program asked for (the ledger), is the
recorder of ``analysis/passes.py``, and this module turns what it saw
into the records the HLO passes read. The mapping:

- **collectives**: every ``c10d`` op the step dispatched (a
  ``TorchDispatchMode`` sees each collective that reaches the transport,
  whichever code issued it: ``c10d.allreduce_``, ``_allgather_base_``,
  ``allgather_``, ``_reduce_scatter_base_``, ``reduce_scatter_``,
  ``alltoall_base_``, ``send``, ``recv_``, ``broadcast_``), with its
  process group's ranks (``ProcessGroup.unbox`` of the op's argument,
  then ``get_process_group_ranks``: the one group this rank sees, where
  HLO prints every group), its peer for point-to-point (as a
  ``source_target_pairs`` edge of global ranks), its tensors' elements
  and dtype, and its site (``passes.op_site``) in place of HLO's
  ``metadata`` provenance. An op issued inside ``parallel_state``'s
  helpers (the ledger-instrumented ones) is ``via_helper``;
- **entry parameters**: the step's state tensors (the leaves of its
  arguments: parameters, optimizer, scaler and sentinel state, the
  batch), with shape, dtype, bytes and storage pointer before and after
  the step, in place of HLO's entry parameters and their shardings (an
  eager tensor carries none: ``sharding_audit.py`` compares the ranks'
  values instead);
- **entry outputs**: the leaves of what the step returns;
- **input_output_alias**: an output that lives in an argument's storage
  (storage reuse, the port's realized donation);
- **memory**: the allocator's watermarks around the step on the card
  (``monitor/xray/hbm/live.py``), in place of ``memory_analysis()``;
- **staged**: gloo's staging copies (``parallel_state
  .staged_through_host``: a collective of CUDA tensors copied through
  pinned host memory). They stage a collective and are not one: they are
  kept apart, never among the collectives.

Byte conventions match the ledger's: a collective's payload is its input
(for all-gather the local shard, for reduce-scatter the whole input).
Element counts are the cross-checking currency, as in the JAX package.
"""

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "COLLECTIVE_KINDS",
    "KIND_CLASS",
    "HloShape",
    "HloOperand",
    "HloCollective",
    "HloParam",
    "HloModule",
    "collective_from_dispatch",
    "state_leaves",
    "storage_ptr",
    "tensor_digest",
]

#: the c10d ops the recorder keeps, each with its op class in the JAX
#: package's opcode names (``send``'s class is collective-permute; its
#: receiving half ``recv_`` is kept but is no payload of its own, as
#: HLO's ``-done`` halves)
KIND_CLASS = {
    "allreduce_": "all-reduce",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute",
    "recv_": "collective-permute",
    "broadcast_": "broadcast",
}
COLLECTIVE_KINDS = tuple(KIND_CLASS)

#: the kind as the timeline names a transport's range (``gloo:all_reduce``
#: -> ``allreduce``): the join key of ``monitor.xray.timeline``
_FAMILY = {
    "allreduce_": "allreduce", "allgather_": "allgather",
    "_allgather_base_": "allgather", "reduce_scatter_": "reducescatter",
    "_reduce_scatter_base_": "reducescatter", "alltoall_": "alltoall",
    "alltoall_base_": "alltoall", "send": "send", "recv_": "recv",
    "broadcast_": "broadcast",
}

_DTYPE_BYTES = {
    "bool": 1, "uint8": 1, "int8": 1, "float8_e4m3fn": 1, "float8_e5m2": 1,
    "int16": 2, "float16": 2, "bfloat16": 2, "int32": 4, "float32": 4,
    "int64": 8, "float64": 8, "complex64": 8, "complex128": 16,
}


@dataclasses.dataclass(frozen=True)
class HloShape:
    dtype: str
    dims: Tuple[int, ...]

    @property
    def elements(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n

    @property
    def nbytes(self) -> int:
        return self.elements * _DTYPE_BYTES.get(self.dtype, 4)

    def __str__(self) -> str:
        return f"{self.dtype}[{','.join(str(d) for d in self.dims)}]"


def _shape(t) -> HloShape:
    return HloShape(str(t.dtype).replace("torch.", ""), tuple(t.shape))


@dataclasses.dataclass(frozen=True)
class HloOperand:
    shape: HloShape

    @property
    def elements(self) -> int:
        return self.shape.elements

    @property
    def nbytes(self) -> int:
        return self.shape.nbytes


@dataclasses.dataclass(frozen=True)
class HloCollective:
    """One dispatched c10d op of the step.

    ``replica_groups`` holds the one group this rank saw (its global
    ranks); a point-to-point op prints ``source_target_pairs`` instead:
    ``((this rank, peer),)`` for ``send``, ``((peer, this rank),)`` for
    ``recv_``. ``line`` is the op's position in dispatch order;
    ``source_file``/``source_line`` its site."""

    kind: str  # one of COLLECTIVE_KINDS
    name: str  # c10d.allreduce_#3
    computation: str
    result: HloShape
    operands: Tuple[HloOperand, ...]
    replica_groups: Tuple[Tuple[int, ...], ...]
    op_name: str
    source_file: str
    source_line: int
    line: int
    source_target_pairs: Tuple[Tuple[int, int], ...] = ()
    backend: str = ""
    via_helper: bool = False  # issued inside parallel_state's helpers

    @property
    def op_class(self) -> str:
        return KIND_CLASS[self.kind]

    @property
    def family(self) -> str:
        return _FAMILY[self.kind]

    @property
    def group_size(self) -> int:
        return len(self.replica_groups[0]) if self.replica_groups else 0

    @property
    def elements(self) -> int:
        return sum(op.elements for op in self.operands)

    @property
    def nbytes(self) -> int:
        return sum(op.nbytes for op in self.operands)

    @property
    def site(self) -> str:
        return (f"{self.source_file}:{self.source_line}" if self.source_file
                else "<unknown>")


@dataclasses.dataclass(frozen=True)
class HloParam:
    """One state tensor of the step (an argument leaf), or one output.

    ``label`` is its path (``state.opt.exp_avg['...']``, ``m``), ``root``
    the component it books to (the state's field name, or the
    argument's); ``ptr_before``/``ptr_after`` its storage before and
    after the step (None after: the path is gone); ``digest_*`` a cheap
    fingerprint of its values, taken only above the recorder's floor."""

    index: int
    name: str
    shape: HloShape
    label: str
    argnum: int = 0
    root: str = ""
    ptr_before: Optional[int] = None
    ptr_after: Optional[int] = None
    digest_before: Optional[Tuple[float, float]] = None
    digest_after: Optional[Tuple[float, float]] = None

    @property
    def nbytes(self) -> int:
        return self.shape.nbytes

    @property
    def rebound(self) -> bool:
        """Did the step move this state to another storage?"""
        return self.ptr_after != self.ptr_before

    @property
    def updated(self) -> bool:
        """Did the step change this state (its storage or its values)?"""
        return self.rebound or self.digest_after != self.digest_before


@dataclasses.dataclass
class HloModule:
    """What one recorded step did: what the HLO passes read."""

    name: str
    collectives: List[HloCollective]
    entry_params: List[HloParam]
    entry_root_shapes: List[HloShape]
    input_output_alias: Dict[int, int]  # param index -> output index
    entry_name: str = "step"
    entry_outputs: List[HloParam] = dataclasses.field(default_factory=list)
    #: gloo's staging copies: (aten op, bytes), not collectives
    staged: List[Tuple[str, int]] = dataclasses.field(default_factory=list)
    #: {"before": watermarks, "after": watermarks} on the card, else None
    memory: Optional[Dict[str, Any]] = None

    def collectives_in_entry(self) -> List[HloCollective]:
        return [c for c in self.collectives if c.computation == self.entry_name]


def _process_group(args):
    import torch

    for a in args:
        if isinstance(a, torch._C.ScriptObject) and "ProcessGroup" in str(
                a._type()):
            return torch._C._distributed_c10d.ProcessGroup.unbox(a)
    return None


def _tensors(x) -> list:
    import torch

    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for item in x for t in _tensors(item)]
    return []


def collective_from_dispatch(func, args, site: str, index: int,
                             via_helper: bool) -> Optional[HloCollective]:
    """The :class:`HloCollective` of one dispatched c10d op (None for an
    op the recorder does not keep, such as ``barrier``)."""
    import torch.distributed as dist

    kind = str(func.overloadpacket.__name__)
    if func.namespace != "c10d" or kind not in KIND_CLASS:
        return None
    pg = _process_group(args)
    ranks = tuple(dist.get_process_group_ranks(pg)) if pg is not None else ()
    backend = dist.get_backend(pg) if pg is not None else ""
    # the payload: the input (an all-gather's local shard, a
    # reduce-scatter's whole input); an in-place op's tensors
    if kind in ("_allgather_base_", "_reduce_scatter_base_", "alltoall_base_"):
        payload = _tensors(args[1])
    elif kind in ("allgather_", "reduce_scatter_", "alltoall_"):
        payload = _tensors(args[1])
    else:
        payload = _tensors(args[0])
    result = _tensors(args[0])
    pairs: Tuple[Tuple[int, int], ...] = ()
    if kind in ("send", "recv_") and ranks:
        me = dist.get_rank()
        peer = ranks[int(args[2])]
        pairs = ((me, peer),) if kind == "send" else ((peer, me),)
    path, _, line = site.rpartition(":")
    return HloCollective(
        kind=kind, name=f"c10d.{kind}#{index}", computation="step",
        result=_shape(result[0]) if result else HloShape("float32", ()),
        operands=tuple(HloOperand(_shape(t)) for t in payload),
        replica_groups=(ranks,) if ranks and not pairs else (),
        op_name=str(func),
        source_file=path if line.isdigit() else "",
        source_line=int(line) if line.isdigit() else 0,
        line=index, source_target_pairs=pairs, backend=backend,
        via_helper=via_helper,
    )


def _fields(obj) -> Optional[List[Tuple[str, Any]]]:
    """(name, value) of a dataclass's or NamedTuple's fields, else None."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [(f.name, getattr(obj, f.name))
                for f in dataclasses.fields(obj)]
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return list(zip(obj._fields, obj))
    return None


def state_leaves(args: Sequence[Any], names: Optional[Sequence[str]] = None
                 ) -> List[Tuple[int, str, str, Any]]:
    """``(argnum, label, root, tensor)`` of every tensor leaf of ``args``,
    in order: dicts by key, lists and tuples by index, dataclasses and
    NamedTuples by field. The label is the leaf's path from its
    argument's name (``state.opt.exp_avg['w']``); the root the field of
    a state object at the top (``params``, ``opt``), else the
    argument's name."""
    import torch

    out: List[Tuple[int, str, str, Any]] = []

    def walk(argnum, x, label, root):
        if isinstance(x, torch.Tensor):
            out.append((argnum, label, root, x))
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(argnum, v, f"{label}[{k!r}]", root)
        elif _fields(x) is not None:
            for k, v in _fields(x):
                walk(argnum, v, f"{label}.{k}", root)
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(argnum, v, f"{label}[{i}]", root)

    for i, arg in enumerate(args):
        name = names[i] if names and i < len(names) else f"arg{i}"
        fields = _fields(arg)
        if fields is not None:
            for k, v in fields:
                walk(i, v, f"{name}.{k}", k)
        else:
            walk(i, arg, name, name)
    return out


def tensor_digest(t) -> Tuple[float, float]:
    """A cheap fingerprint of ``t``'s values: its fp32 sum and sum of
    squares (equal tensors give equal sums on one kind of device; one
    host read each, taken outside the step)."""
    x = t.detach().float()
    return (float(x.sum()), float((x * x).sum()))


def storage_ptr(t) -> int:
    return t.untyped_storage().data_ptr()
