"""Process groups of the parallel axes (counterpart of
apex_tpu/parallel/parallel_state.py).

The JAX package lays every device on one mesh with the axes
``("dp", "pp", "cp", "tp")``, outermost to innermost. Here each process
is one rank of a ``torch.distributed`` world, and the axes are process
groups over the same layout: rank ``r = ((d * pp + p) * cp + c) * tp +
t``, so port rank ``r`` holds what JAX device ``r`` holds on the CPU mesh
(``np.asarray(devices).reshape(dp, pp, cp, tp)``). The cp group holds
the ranks that share a sequence, each with its chunk of it
(``parallel.ring_attention``).

Pipeline stages talk point to point (:func:`p2p`, which the schedules of
``parallel.pipeline`` drive): sends are posted and waited for later,
receives block, and each message carries a tag, so two streams between
the same pair of ranks (activations one way, gradients the other, and
both on the ring of the interleaved schedule) never cross. Gloo honours
tags; NCCL ignores them and matches a pair's messages in the order they
were posted. So at pp = 2, where both streams of the interleaved
schedule share one pair of ranks, each pp group has a twin over the same
ranks, and a message under a tag above 0 (the gradients) takes the
twin: the two streams then run on two groups, whose messages no backend
mixes.

The backend is the caller's (``transformer.testing.commons
.initialize_distributed``): NCCL moves CUDA tensors as they are; gloo
moves CUDA tensors through host memory (:func:`staged_through_host`).
Every collective of the port goes through this module's helpers
(:func:`all_reduce`, :func:`all_gather`, :func:`reduce_scatter`,
:func:`broadcast`, :func:`all_to_all`), which return their input
unchanged where there is no process group; all but the broadcast (and
each send of :func:`p2p`) record themselves in the collective-traffic
ledger (``monitor.xray.ledger``) when one is active. A group of size one
still runs its collective, so a world of one under NCCL runs the NCCL
calls it would run at scale.

Without ``initialize_model_parallel`` (or without a process group) every
getter answers for a world of one, as the JAX package's do with no mesh.

A world makes each group it needs once: ``initialize_model_parallel``
takes the group of a set of ranks from a cache of the world's groups,
and ``destroy_model_parallel`` forgets the layout but leaves its groups
to the next one (every rank asks for the same groups in the same order,
so the cache hits on every rank alike); they go down with the world's
default group. A world that lays out many layouts in turn (the tests'
spawned worlds run dozens, the elastic path 4 -> 2 -> 4 ranks) so opens
a handful of gloo contexts, not hundreds: every ``new_group`` is a
full-mesh TCP rendezvous of its ranks, and under a loaded host one of
hundreds of them failing ("Gloo connectFullMesh failed ... Connection
closed by peer") took down a test's whole world.
"""

import dataclasses
from typing import Callable, Optional

import torch
import torch.distributed as dist

__all__ = [
    "AXIS_ORDER", "PendingCollective", "all_gather", "all_gather_async",
    "all_gather_object", "all_reduce",
    "all_to_all",
    "amax_reduction", "broadcast", "broadcast_object",
    "get_amax_reduction_axes",
    "destroy_model_parallel", "get_context_parallel_group",
    "get_context_parallel_rank", "get_data_parallel_group",
    "get_data_parallel_rank", "get_data_parallel_world_size",
    "get_group", "get_model_parallel_world_size", "get_model_world_group",
    "get_model_world_size", "groups_made", "participates",
    "get_pipeline_model_parallel_group", "get_pipeline_model_parallel_rank",
    "get_pipeline_model_parallel_split_rank",
    "get_pipeline_model_parallel_world_size",
    "get_virtual_pipeline_model_parallel_rank",
    "get_virtual_pipeline_model_parallel_world_size",
    "get_context_parallel_world_size", "get_tensor_model_parallel_group",
    "get_tensor_model_parallel_rank",
    "get_tensor_model_parallel_world_size", "group_size",
    "initialize_model_parallel", "is_pipeline_first_stage",
    "is_pipeline_last_stage", "model_parallel_is_initialized", "p2p",
    "set_virtual_pipeline_model_parallel_rank", "STAGED", "reduce_scatter",
    "staged_through_host", "wait_sends",
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
    pp: int = 1
    pp_rank: int = 0
    pp_group: object = None  # None at pp = 1: no collective
    # at pp = 2: the groups that messages under tags 1, 2, ... take
    pp_streams: tuple = ()
    cp: int = 1
    cp_rank: int = 0
    cp_group: object = None  # None at cp = 1: no collective
    devices: int = 1
    world_group: object = None  # the sub-world's ranks; None: the world


_AXES: Optional[_Axes] = None
# the world's groups by their ranks (and the world they belong to), and
# how many this process has made (:func:`groups_made`)
_GROUPS: dict = {}
_GROUPS_MADE = 0
# True on a rank outside the leading ``devices`` ranks the layout was
# built over: it sits out every collective of the layout
_SITTING_OUT = False
# the JAX module's host-side pipeline settings, kept without a world too
_VIRTUAL_PIPELINE_WORLD_SIZE: Optional[int] = None
_VIRTUAL_PIPELINE_RANK: Optional[int] = None
_PIPELINE_SPLIT_RANK: Optional[int] = None


def _layout(dp: int, pp: int, cp: int, tp: int):
    """The ranks of each tp, dp, pp and cp group, in rank order:
    ``r = ((d * pp + p) * cp + c) * tp + t``, the order of JAX's
    ``reshape(dp, pp, cp, tp)``."""
    def rank(d, p, c, t):
        return ((d * pp + p) * cp + c) * tp + t

    grid = [(d, p, c) for d in range(dp) for p in range(pp)
            for c in range(cp)]
    tp_groups = [[rank(d, p, c, t) for t in range(tp)] for d, p, c in grid]
    dp_groups = [[rank(d, p, c, t) for d in range(dp)]
                 for p in range(pp) for c in range(cp) for t in range(tp)]
    pp_groups = [[rank(d, p, c, t) for p in range(pp)]
                 for d in range(dp) for c in range(cp) for t in range(tp)]
    cp_groups = [[rank(d, p, c, t) for c in range(cp)]
                 for d in range(dp) for p in range(pp) for t in range(tp)]
    return tp_groups, dp_groups, pp_groups, cp_groups


def initialize_model_parallel(
        tensor_model_parallel_size: int = 1,
        pipeline_model_parallel_size: int = 1,
        virtual_pipeline_model_parallel_size: Optional[int] = None,
        pipeline_model_parallel_split_rank: Optional[int] = None,
        context_parallel_size: int = 1,
        devices: Optional[int] = None) -> None:
    """Builds the tp, dp, (at pp > 1) pp and (at cp > 1) cp groups of the
    initialized world (ref: parallel_state.py:100). Data-parallel size is
    what remains after tp x pp x cp, as in JAX. Every rank builds every
    group, in the same order, as ``torch.distributed.new_group``
    requires. Without a process group the world is one process. The
    virtual pipeline size and the split rank are kept for their getters,
    as in JAX.

    ``devices`` (a count ``n``; JAX's sub-mesh ``devices=``) lays the
    groups over the world's leading ``n`` ranks only: one spawned world
    of 4 then runs a layout of 2, as JAX's 8-device process runs a
    4-device mesh. The ranks past ``n``
    still call every ``new_group`` (torch requires it), then sit out:
    :func:`participates` is False there, every getter answers for a
    world of one, and no collective of the layout waits on them.
    :func:`get_model_world_group` is the group of the ``n`` ranks."""
    global _AXES, _VIRTUAL_PIPELINE_WORLD_SIZE, _VIRTUAL_PIPELINE_RANK
    global _PIPELINE_SPLIT_RANK, _SITTING_OUT
    tp, pp = tensor_model_parallel_size, pipeline_model_parallel_size
    cp = context_parallel_size
    if not dist.is_initialized() and tp * pp * cp != 1:
        raise RuntimeError(
            f"tensor ({tp}) x pipeline ({pp}) x context ({cp}) parallel "
            "size needs a torch.distributed world of at least that many "
            "processes (transformer.testing.commons.initialize_distributed)")
    destroy_model_parallel()
    if dist.is_initialized():
        full, rank = dist.get_world_size(), dist.get_rank()
        world = _device_count(devices, full)
        if world % (tp * pp * cp):
            raise RuntimeError(f"world size ({world}) is not divisible by tp "
                               f"({tp}) x pp ({pp}) x cp ({cp})")
        dp = world // (tp * pp * cp)
        mine = {}
        streams = ()
        for axis, groups in zip(("tp", "dp", "pp", "cp"),
                                _layout(dp, pp, cp, tp)):
            if (axis == "pp" and pp == 1) or (axis == "cp" and cp == 1):
                continue
            for ranks in groups:
                g = _group(ranks)
                # the gradient stream's twin, where both streams of the
                # interleaved schedule share one pair (module docstring)
                twin = (_group(ranks, stream=1),) if axis == "pp" and \
                    pp == 2 else ()
                if rank in ranks:
                    mine[axis] = g
                    if twin:
                        streams = twin
        world_group = _group(list(range(world))) if world < full else None
        _SITTING_OUT = rank >= world
        if not _SITTING_OUT:
            _AXES = _Axes(tp=tp, dp=dp, tp_rank=rank % tp,
                          dp_rank=rank // (tp * pp * cp),
                          tp_group=mine["tp"], dp_group=mine["dp"], pp=pp,
                          pp_rank=rank // (tp * cp) % pp,
                          pp_group=mine.get("pp"), pp_streams=streams,
                          cp=cp,
                          cp_rank=rank // tp % cp, cp_group=mine.get("cp"),
                          devices=world, world_group=world_group)
    _VIRTUAL_PIPELINE_WORLD_SIZE = virtual_pipeline_model_parallel_size
    _VIRTUAL_PIPELINE_RANK = (0 if virtual_pipeline_model_parallel_size
                              else None)
    _PIPELINE_SPLIT_RANK = pipeline_model_parallel_split_rank


def _group(ranks, stream: int = 0):
    """The world's process group of ``ranks``, made on first use (every
    rank of the world calls this for every group, in the same order, as
    ``torch.distributed.new_group`` requires of the making call).
    ``stream`` > 0 gives another group over the same ranks (the pp
    group's twins, :func:`p2p`)."""
    global _GROUPS_MADE
    world = dist.group.WORLD
    if _GROUPS.get("world") is not world:
        _GROUPS.clear()
        _GROUPS["world"] = world
    key = tuple(ranks) if stream == 0 else ("stream", stream) + tuple(ranks)
    if key not in _GROUPS:
        _GROUPS[key] = dist.new_group(list(ranks))
        _GROUPS_MADE += 1
    return _GROUPS[key]


def groups_made() -> int:
    """How many process groups this process has made
    (``torch.distributed.new_group`` calls of ``parallel_state``)."""
    return _GROUPS_MADE


def _device_count(devices: Optional[int], world: int) -> int:
    """The layout's rank count: ``devices``, the whole world when None."""
    if devices is None:
        return world
    if not 1 <= devices <= world:
        raise ValueError(f"devices={devices}: the world has {world} rank(s)")
    return devices


def model_parallel_is_initialized() -> bool:
    return _AXES is not None


def participates() -> bool:
    """Does this rank take part in the layout? False only on a rank past
    the ``devices`` that :func:`initialize_model_parallel` was given."""
    return not _SITTING_OUT


def get_model_world_size() -> int:
    """The ranks of the layout (the world, or its leading ``devices``)."""
    return 1 if _AXES is None else _AXES.devices


def get_model_world_group():
    """The group of the layout's ranks: ``torch.distributed``'s world
    when the layout spans it, None without a layout or a world."""
    if _AXES is None or not dist.is_initialized():
        return None
    return (_AXES.world_group if _AXES.world_group is not None
            else dist.group.WORLD)


def destroy_model_parallel() -> None:
    """Forgets the layout (ref: parallel_state.py:761), after every send
    in flight is waited for. Its groups stay with the world, for the next
    layout (module docstring); they and the default group go down when
    the default group's owner destroys it."""
    global _AXES, _VIRTUAL_PIPELINE_WORLD_SIZE, _VIRTUAL_PIPELINE_RANK
    global _PIPELINE_SPLIT_RANK, _SITTING_OUT
    axes, _AXES = _AXES, None
    _SITTING_OUT = False
    _VIRTUAL_PIPELINE_WORLD_SIZE = _VIRTUAL_PIPELINE_RANK = None
    _PIPELINE_SPLIT_RANK = None
    if axes is not None and dist.is_initialized():
        wait_sends()  # no layout ends under a message in flight


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
    return 1 if _AXES is None else _AXES.pp


def get_pipeline_model_parallel_rank() -> int:
    return 0 if _AXES is None else _AXES.pp_rank


def get_pipeline_model_parallel_group():
    """The pp group; None at pp = 1 (no collective)."""
    return None if _AXES is None else _AXES.pp_group


def get_virtual_pipeline_model_parallel_world_size() -> Optional[int]:
    return _VIRTUAL_PIPELINE_WORLD_SIZE


def get_virtual_pipeline_model_parallel_rank() -> Optional[int]:
    return _VIRTUAL_PIPELINE_RANK


def set_virtual_pipeline_model_parallel_rank(rank: int) -> None:
    global _VIRTUAL_PIPELINE_RANK
    _VIRTUAL_PIPELINE_RANK = rank


def get_pipeline_model_parallel_split_rank() -> Optional[int]:
    return _PIPELINE_SPLIT_RANK


def is_pipeline_first_stage(ignore_virtual: bool = False) -> bool:
    """(ref: parallel_state.py:649) Under virtual pp, only model chunk 0
    of pp rank 0."""
    if (not ignore_virtual and _VIRTUAL_PIPELINE_WORLD_SIZE is not None
            and _VIRTUAL_PIPELINE_RANK != 0):
        return False
    return get_pipeline_model_parallel_rank() == 0


def is_pipeline_last_stage(ignore_virtual: bool = False) -> bool:
    """(ref: parallel_state.py:660) Under virtual pp, only the last model
    chunk of the last pp rank."""
    if (not ignore_virtual and _VIRTUAL_PIPELINE_WORLD_SIZE is not None
            and _VIRTUAL_PIPELINE_RANK != _VIRTUAL_PIPELINE_WORLD_SIZE - 1):
        return False
    return (get_pipeline_model_parallel_rank()
            == get_pipeline_model_parallel_world_size() - 1)


def get_context_parallel_world_size() -> int:
    return 1 if _AXES is None else _AXES.cp


def get_context_parallel_rank() -> int:
    return 0 if _AXES is None else _AXES.cp_rank


def get_context_parallel_group():
    """The cp group; None at cp = 1 (no collective)."""
    return None if _AXES is None else _AXES.cp_group


def get_model_parallel_world_size() -> int:
    return get_tensor_model_parallel_world_size() * \
        get_pipeline_model_parallel_world_size()


def get_amax_reduction_axes() -> tuple:
    """The axes of the FP8 amax-reduction group (ref parallel_state.py:
    280-292): the tp and dp ranks of a pipeline stage, every rank that
    holds a shard of the same activations, and cp for the same reason as
    dp."""
    return (DATA_AXIS, CONTEXT_AXIS, TENSOR_AXIS)


def amax_reduction(local_amax: torch.Tensor) -> torch.Tensor:
    """The max of a local |x| max over every amax axis whose group has
    more than one rank (the delayed-scaling statistic FP8 recipes
    synchronize); ``local_amax`` itself without such a group."""
    out = local_amax
    for axis in get_amax_reduction_axes():
        group = get_group(axis)
        if group_size(group) > 1:
            out = all_reduce(out, group, op="max")
    return out


def get_group(axis: str):
    """The process group of a mesh axis name: ``"tp"``, ``"dp"``, ``"pp"``
    or ``"cp"``; None for ``"pp"`` at pp = 1 and ``"cp"`` at cp = 1 (no
    collective)."""
    if axis == TENSOR_AXIS:
        return get_tensor_model_parallel_group()
    if axis == DATA_AXIS:
        return get_data_parallel_group()
    if axis == PIPELINE_AXIS:
        return get_pipeline_model_parallel_group()
    if axis == CONTEXT_AXIS:
        return get_context_parallel_group()
    raise ValueError(f"unknown mesh axis {axis!r}; expected one of "
                     f"{AXIS_ORDER}")


def group_size(group) -> int:
    """Ranks in ``group``; 1 for None (no process group)."""
    return 1 if group is None else dist.get_world_size(group)


# -- collectives -----------------------------------------------------------

# what staged_through_host and p2p have moved in this process: the
# collectives staged and the bytes they copied between the card and the
# host (both directions), and likewise the point-to-point sends and
# receives; a run reads them to size gloo's transport
STAGED = {"collectives": 0, "bytes": 0, "p2p": 0, "p2p_bytes": 0}


class PendingCollective:
    """A collective in flight (:func:`staged_through_host` with
    ``async_op``): :meth:`wait` waits on its c10d work, copies a staged
    result back to the card, and returns ``out``."""

    def __init__(self, work, out: torch.Tensor, host_out=None,
                 host_in=()):
        # the staged buffers live until the collective has ended
        self._work, self._out = work, out
        self._host_out, self._host_in = host_out, host_in

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            self._work.wait()
            self._work = None
        if self._host_out is not None:
            self._out.copy_(self._host_out)
            self._host_out, self._host_in = None, ()
        return self._out


def staged_through_host(group, collective: Callable, out: torch.Tensor,
                        *inputs: torch.Tensor, async_op: bool = False):
    """Runs ``collective(out, *inputs)`` on the group's transport and
    returns ``out``; a collective given no ``inputs`` works in place on
    ``out``. NCCL and gloo on host tensors run it as it is. Gloo with CUDA
    tensors (``ProcessGroupGloo`` has CUDA variants of only all_reduce and
    broadcast, and those copy through the host too) is staged through
    host memory here: each input (and an in-place ``out``) is copied into
    a pinned host buffer, the collective runs on the host buffers, and the
    result is copied back into ``out`` on the card. The collective is the
    same one, only its buffers live on the host; no collective becomes a
    computation on one rank.

    With ``async_op`` the collective is started with ``async_op=True``
    (``collective`` returns its c10d work) and a
    :class:`PendingCollective` is returned instead, whose ``wait`` does
    the copy back."""
    if out.is_cuda and dist.get_backend(group) == "gloo":
        def host(t, read):
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            return h.copy_(t) if read else h

        host_out = host(out, read=not inputs)
        host_in = tuple(host(t, True) for t in inputs)
        pending = PendingCollective(collective(host_out, *host_in), out,
                                    host_out, host_in)
        STAGED["collectives"] += 1
        STAGED["bytes"] += (out.nbytes * (1 if inputs else 2)
                            + sum(t.nbytes for t in inputs))
    else:
        pending = PendingCollective(collective(out, *inputs), out)
    return pending if async_op else pending.wait()


def _record(op: str, x, group, **kw) -> None:
    """The collective-traffic ledger's record of this call (a no-op
    unless a ``monitor.xray.ledger.comms_ledger`` is active)."""
    from apex_tpu_torch.monitor.xray import ledger

    ledger.record(op, x, group, **kw)


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """Elementwise sum (or ``op="max"``) of ``x`` over ``group``, as a new
    tensor; ``x`` itself when there is no group."""
    if group is None:
        return x
    _record({"sum": "psum", "max": "pmax"}[op], x, group)
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    return staged_through_host(
        group, lambda o: dist.all_reduce(o, op=red, group=group),
        x.contiguous().clone())


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order."""
    if group is None:
        return x
    _record("all_gather", x, group)
    n = group_size(group)
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0],) + tuple(xt.shape[1:]))
    staged_through_host(group, lambda o, i: _ALL_GATHER(o, i, group=group),
                        out, xt)
    return out.movedim(0, dim)


def all_gather_async(x: torch.Tensor, group) -> PendingCollective:
    """Starts the all-gather of the ranks' 1-D ``x`` in rank order and
    returns its :class:`PendingCollective`, whose ``wait`` gives what
    :func:`all_gather` would. Recorded in the ledger as one
    ``all_gather``."""
    if group is None:
        return PendingCollective(None, x)
    _record("all_gather", x, group)
    src = x.contiguous()
    out = src.new_empty((group_size(group) * src.shape[0],)
                        + tuple(src.shape[1:]))
    return staged_through_host(
        group, lambda o, i: _ALL_GATHER(o, i, group=group, async_op=True),
        out, src, async_op=True)


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
    _record("psum_scatter", x, group)
    out = xt.new_empty((xt.shape[0] // n,) + tuple(xt.shape[1:]))
    staged_through_host(
        group, lambda o, i: _REDUCE_SCATTER(o, i, group=group), out, xt)
    return out.movedim(0, dim)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all_single``: ``x``'s dim 0, cut into one equal chunk per
    rank of ``group``, sends chunk j to the group's j-th rank; returns the
    chunks this rank received, in rank order along dim 0."""
    if group is None:
        return x
    n = group_size(group)
    if x.shape[0] % n:
        raise ValueError(f"dim 0 ({x.shape[0]}) does not divide by the "
                         f"group's {n} ranks")
    _record("all_to_all", x, group)
    xt = x.contiguous()
    out = torch.empty_like(xt)
    staged_through_host(
        group, lambda o, i: dist.all_to_all_single(o, i, group=group), out,
        xt)
    return out


def broadcast_object(obj, group="layout"):
    """The first rank's ``obj`` (any picklable value) on every rank of
    ``group``, by default the layout's (:func:`get_model_world_group`);
    ``obj`` itself without a group of more than one rank."""
    if group == "layout":
        group = get_model_world_group()
    if group is None or group_size(group) == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0),
                               group=group)
    return box[0]


def all_gather_object(obj, group="layout") -> list:
    """Every rank's ``obj`` (any picklable value) in group rank order, on
    every rank of ``group`` (by default the layout's); ``[obj]`` without
    a group of more than one rank."""
    if group == "layout":
        group = get_model_world_group()
    if group is None or group_size(group) == 1:
        return [obj]
    out = [None] * group_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def broadcast(x: torch.Tensor, group, src_index: int = 0) -> torch.Tensor:
    """``x`` of the group's ``src_index``-th rank on every rank, written
    into ``x`` (which is returned)."""
    if group is None:
        return x
    _record("broadcast", x, group)
    src = dist.get_global_rank(group, src_index)
    return staged_through_host(
        group, lambda o: dist.broadcast(o, src=src, group=group), x)


# -- point to point ----------------------------------------------------------

# sends posted and not yet waited for, with the host buffers they read
_PENDING_SENDS: list = []


def _staged(group) -> bool:
    return dist.get_backend(group) == "gloo"


def _stream(group, tag: int):
    """The group that a message under ``tag`` between ranks of ``group``
    takes: the pp group's twin for its tag where it has one, else
    ``group``."""
    if _AXES is not None and group is _AXES.pp_group and \
            0 < tag <= len(_AXES.pp_streams):
        return _AXES.pp_streams[tag - 1]
    return group


def p2p(group, sends=(), recvs=()) -> list:
    """Posts every send, then every receive, of one step between ranks of
    ``group`` and returns the received tensors in ``recvs``' order.

    ``sends``: ``(tensor, dst, tag)``; ``recvs``: ``(like, src, tag)``,
    a tensor whose shape, dtype and device the message has (the receiver
    knows them in advance, as Megatron's ``tensor_shape``). ``dst`` and
    ``src`` are indices in the group. A send is waited for only by a
    later :func:`wait_sends` (the schedules call it when they end, and
    ``destroy_model_parallel`` before it takes a group down), so a rank
    blocks only on the data it receives; the receives are waited for
    here. Gloo takes host tensors only: a CUDA tensor is copied into
    a pinned host buffer before its send, and a CUDA receive lands in one
    and is copied to the card; each counts in ``STAGED``. On the pp
    group at pp = 2, a message under tag t > 0 takes the group's t-th
    twin (module docstring)."""
    staged = _staged(group)
    for t, dst, tag in sends:
        _record("ppermute", t, group, edge=(dist.get_rank(group), dst),
                tag=tag)
        t = t.detach().contiguous()
        if staged and t.is_cuda:
            t = torch.empty(t.shape, dtype=t.dtype,
                            pin_memory=True).copy_(t)
            STAGED["p2p"] += 1
            STAGED["p2p_bytes"] += t.nbytes
        work = dist.isend(t, dist.get_global_rank(group, dst),
                          group=_stream(group, tag), tag=tag)
        _PENDING_SENDS.append((work, t))
    posted = []
    for like, src, tag in recvs:
        buf = (torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
               if staged and like.is_cuda
               else torch.empty_like(like, memory_format=torch.contiguous_format))
        work = dist.irecv(buf, dist.get_global_rank(group, src),
                          group=_stream(group, tag), tag=tag)
        posted.append((work, buf, like))
    out = []
    for work, buf, like in posted:
        work.wait()
        if buf.device != like.device:
            STAGED["p2p"] += 1
            STAGED["p2p_bytes"] += buf.nbytes
            buf = buf.to(like.device)
        out.append(buf)
    return out


def wait_sends() -> None:
    """Waits for every send :func:`p2p` has posted in this process."""
    while _PENDING_SENDS:
        work, _ = _PENDING_SENDS.pop(0)
        work.wait()
