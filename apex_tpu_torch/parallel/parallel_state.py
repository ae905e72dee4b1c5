"""Process groups of the parallel axes (counterpart of
apex_tpu/parallel/parallel_state.py).

The JAX package lays every device on one mesh with the axes
``("dp", "pp", "cp", "tp")``, outermost to innermost. Here each process
is one rank of a ``torch.distributed`` world, and the axes are process
groups over the same layout: rank ``r = ((d * pp + p) * cp + c) * tp +
t``, so port rank ``r`` holds what JAX device ``r`` holds on the CPU mesh
(``np.asarray(devices).reshape(dp, pp, cp, tp)``). Pipeline and context
parallelism (pp, cp > 1) are not ported yet and raise.

The backend is the caller's (``transformer.testing.commons
.initialize_distributed``): NCCL moves CUDA tensors as they are; gloo
moves CUDA tensors through host memory (:func:`staged_through_host`).
Every collective of the port goes through this module's helpers
(:func:`all_reduce`, :func:`all_gather`, :func:`reduce_scatter`,
:func:`broadcast`), which return their input unchanged where there is no
process group. A group of size one still runs its collective, so a world
of one under NCCL runs the NCCL calls it would run at scale.

Without ``initialize_model_parallel`` (or without a process group) every
getter answers for a world of one, as the JAX package's do with no mesh.
"""

import dataclasses
from typing import Callable, Optional

import torch
import torch.distributed as dist

__all__ = [
    "AXIS_ORDER", "all_gather", "all_reduce", "broadcast",
    "destroy_model_parallel", "get_data_parallel_group",
    "get_data_parallel_rank", "get_data_parallel_world_size",
    "get_group", "get_model_parallel_world_size",
    "get_pipeline_model_parallel_world_size",
    "get_context_parallel_world_size", "get_tensor_model_parallel_group",
    "get_tensor_model_parallel_rank",
    "get_tensor_model_parallel_world_size", "group_size",
    "initialize_model_parallel", "model_parallel_is_initialized",
    "STAGED", "reduce_scatter", "staged_through_host",
]

DATA_AXIS, PIPELINE_AXIS, CONTEXT_AXIS, TENSOR_AXIS = "dp", "pp", "cp", "tp"
AXIS_ORDER = (DATA_AXIS, PIPELINE_AXIS, CONTEXT_AXIS, TENSOR_AXIS)

# one-call collectives into a preallocated output, by the name this
# torch has for them (both names take (output, input, ..., group=))
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


@dataclasses.dataclass(frozen=True)
class _Axes:
    tp: int
    dp: int
    tp_rank: int
    dp_rank: int
    tp_group: object
    dp_group: object


_AXES: Optional[_Axes] = None


def initialize_model_parallel(tensor_model_parallel_size: int = 1,
                              pipeline_model_parallel_size: int = 1,
                              context_parallel_size: int = 1) -> None:
    """Builds the tp and dp groups of the initialized world (ref:
    parallel_state.py:100). Data-parallel size is what remains after tp,
    as in JAX. Every rank builds every group, in the same order, as
    ``torch.distributed.new_group`` requires. Without a process group the
    world is one process."""
    global _AXES
    if pipeline_model_parallel_size != 1 or context_parallel_size != 1:
        raise NotImplementedError(
            "pipeline and context parallelism are not ported yet "
            f"(pp={pipeline_model_parallel_size}, "
            f"cp={context_parallel_size})")
    tp = tensor_model_parallel_size
    if not dist.is_initialized():
        if tp != 1:
            raise RuntimeError(
                f"tensor_model_parallel_size={tp} needs a torch.distributed "
                "world of at least that many processes "
                "(transformer.testing.commons.initialize_distributed)")
        _AXES = None
        return
    destroy_model_parallel()
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % tp:
        raise RuntimeError(f"world size ({world}) is not divisible by tp "
                           f"({tp}) x pp (1) x cp (1)")
    dp = world // tp
    tp_group = dp_group = None
    for d in range(dp):  # rank = d * tp + t
        g = dist.new_group([d * tp + t for t in range(tp)])
        if rank // tp == d:
            tp_group = g
    for t in range(tp):
        g = dist.new_group([d * tp + t for d in range(dp)])
        if rank % tp == t:
            dp_group = g
    _AXES = _Axes(tp=tp, dp=dp, tp_rank=rank % tp, dp_rank=rank // tp,
                  tp_group=tp_group, dp_group=dp_group)


def model_parallel_is_initialized() -> bool:
    return _AXES is not None


def destroy_model_parallel() -> None:
    """Destroys the groups (ref: parallel_state.py:761); the default
    group stays, for its owner to destroy."""
    global _AXES
    axes, _AXES = _AXES, None
    if axes is not None and dist.is_initialized():
        for g in {id(axes.tp_group): axes.tp_group,
                  id(axes.dp_group): axes.dp_group}.values():
            dist.destroy_process_group(g)


def get_tensor_model_parallel_world_size() -> int:
    return 1 if _AXES is None else _AXES.tp


def get_tensor_model_parallel_rank() -> int:
    return 0 if _AXES is None else _AXES.tp_rank


def get_tensor_model_parallel_group():
    return None if _AXES is None else _AXES.tp_group


def get_data_parallel_world_size() -> int:
    return 1 if _AXES is None else _AXES.dp


def get_data_parallel_rank() -> int:
    return 0 if _AXES is None else _AXES.dp_rank


def get_data_parallel_group():
    return None if _AXES is None else _AXES.dp_group


def get_pipeline_model_parallel_world_size() -> int:
    return 1


def get_context_parallel_world_size() -> int:
    return 1


def get_model_parallel_world_size() -> int:
    return get_tensor_model_parallel_world_size() * \
        get_pipeline_model_parallel_world_size()


def get_group(axis: str):
    """The process group of a mesh axis name: ``"tp"`` or ``"dp"``; None
    for the size-one ``"pp"`` and ``"cp"`` (no collective)."""
    if axis == TENSOR_AXIS:
        return get_tensor_model_parallel_group()
    if axis == DATA_AXIS:
        return get_data_parallel_group()
    if axis in (PIPELINE_AXIS, CONTEXT_AXIS):
        return None
    raise ValueError(f"unknown mesh axis {axis!r}; expected one of "
                     f"{AXIS_ORDER}")


def group_size(group) -> int:
    """Ranks in ``group``; 1 for None (no process group)."""
    return 1 if group is None else dist.get_world_size(group)


# -- collectives -----------------------------------------------------------

# what staged_through_host has moved in this process: the collectives it
# staged and the bytes it copied between the card and the host (both
# directions); a run reads them to size gloo's transport
STAGED = {"collectives": 0, "bytes": 0}


def staged_through_host(group, collective: Callable, out: torch.Tensor,
                        *inputs: torch.Tensor) -> torch.Tensor:
    """Runs ``collective(out, *inputs)`` on the group's transport and
    returns ``out``; a collective given no ``inputs`` works in place on
    ``out``. NCCL and gloo on host tensors run it as it is. Gloo with CUDA
    tensors (``ProcessGroupGloo`` has CUDA variants of only all_reduce and
    broadcast, and those copy through the host too) is staged through
    host memory here: each input (and an in-place ``out``) is copied into
    a pinned host buffer, the collective runs on the host buffers, and the
    result is copied back into ``out`` on the card. The collective is the
    same one, only its buffers live on the host; no collective becomes a
    computation on one rank."""
    if out.is_cuda and dist.get_backend(group) == "gloo":
        def host(t, read):
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            return h.copy_(t) if read else h

        host_out = host(out, read=not inputs)
        collective(host_out, *(host(t, True) for t in inputs))
        STAGED["collectives"] += 1
        STAGED["bytes"] += (out.nbytes * (1 if inputs else 2)
                            + sum(t.nbytes for t in inputs))
        return out.copy_(host_out)
    collective(out, *inputs)
    return out


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """Elementwise sum (or ``op="max"``) of ``x`` over ``group``, as a new
    tensor; ``x`` itself when there is no group."""
    if group is None:
        return x
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    return staged_through_host(
        group, lambda o: dist.all_reduce(o, op=red, group=group),
        x.contiguous().clone())


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order."""
    if group is None:
        return x
    n = group_size(group)
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0],) + tuple(xt.shape[1:]))
    staged_through_host(group, lambda o, i: _ALL_GATHER(o, i, group=group),
                        out, xt)
    return out.movedim(0, dim)


def reduce_scatter(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This rank's slice along ``dim`` of the sum of the ranks' ``x``
    (``dim`` must divide by the group's size)."""
    if group is None:
        return x
    n = group_size(group)
    xt = x.movedim(dim, 0).contiguous()
    if xt.shape[0] % n:
        raise ValueError(f"dim {dim} ({xt.shape[0]}) does not divide by "
                         f"the group's {n} ranks")
    out = xt.new_empty((xt.shape[0] // n,) + tuple(xt.shape[1:]))
    staged_through_host(
        group, lambda o, i: _REDUCE_SCATTER(o, i, group=group), out, xt)
    return out.movedim(0, dim)


def broadcast(x: torch.Tensor, group, src_index: int = 0) -> torch.Tensor:
    """``x`` of the group's ``src_index``-th rank on every rank, written
    into ``x`` (which is returned)."""
    if group is None:
        return x
    src = dist.get_global_rank(group, src_index)
    return staged_through_host(
        group, lambda o: dist.broadcast(o, src=src, group=group), x)
