"""Collective-traffic ledger: byte accounting of the port's collectives
(counterpart of apex_tpu/monitor/xray/ledger.py).

Every collective of the port goes through ``parallel.parallel_state``'s
helpers (``all_reduce``, ``all_gather``, ``reduce_scatter``,
``all_to_all`` and the pipeline's ``p2p``), and each of them records
itself here. Recording is free when no ledger is active (one check of a
process-wide list a call; process-wide, so that the collectives of a
backward, which autograd runs on its device thread on the card, record
too).

Under an active :func:`comms_ledger` context each helper records, per
tensor: op kind under the JAX package's names (``psum``/``pmax`` for an
all-reduce of that op, ``all_gather``, ``psum_scatter`` for a
reduce-scatter, ``all_to_all``, ``ppermute`` for each point-to-point
send; ``broadcast``, the port's own, for ``parallel_state.broadcast``,
where JAX's pipeline publishes its losses with a psum), the mesh axis its process group lays out (``tp``, ``dp``, ``pp``
or ``cp``; ``world`` for a sub-world's group), the axis size, shape,
dtype, payload bytes and the ring-algorithm wire bytes, by the JAX
ledger's conventions:

- ``bytes``     — the operand payload: ``numel * itemsize`` of this
  rank's input (for all_gather the local shard; for psum_scatter the
  full pre-scatter tensor).
- ``ici_bytes`` — per-rank wire traffic of the bandwidth-optimal ring:
  psum/pmax ``2(n-1)/n * bytes``, all_gather ``(n-1) * bytes``,
  psum_scatter and all_to_all ``(n-1)/n * bytes``, ppermute (and
  broadcast) ``bytes``.
- ``count``     — 1, multiplied by every enclosing :func:`scaled` region.

A collective over a group of one rank moves nothing and is not recorded
among the entries, as in JAX; it goes to the ledger's ``dead`` list,
which no byte total reads (the collective pass's ``dead-traffic`` check
reads it). A point-to-point send records its edge: ``src`` and ``dst``
(ranks in the group) and its ``tag``. A ledger made with ``site_fn``
stamps each entry with ``site_fn()``, the call site in the caller's
terms (``analysis.passes``).

WHAT IS CAPTURED: the JAX ledger records while jax TRACES, so it sees a
step's forward collectives and every ``custom_vjp`` backward rule, but
not the collectives jax's transpose rules synthesize (the reversed
``ppermute`` edges of a differentiated pipeline scan). This ledger is
eager: a helper records when it RUNS, so it sees every collective the
step executed, the backward's included, once per execution; a branch
the step did not take records nothing (JAX traces both sides of a
``lax.cond``). ``parallel_state.STAGED`` is a different count: the gloo
transport's host copies (both directions, every staged collective,
broadcasts included), where this ledger counts the logical payload.
The wire roofline is the JAX ledger's: :func:`ici_bandwidth_per_device`
gives a card's link bandwidth from a table keyed by the CUDA device name
(``APEX_TPU_TORCH_LINK_BANDWIDTH``, bytes/s, overrides it), and
:meth:`CommsLedger.roofline_seconds` and the records' ``ici_seconds``
divide each axis's wire bytes by it. Both are None where the link is
unknown (the CPU, a card missing from the table) and for an axis whose
collectives gloo staged through the host (``parallel_state
.staged_through_host``): that traffic never crosses the link, so a
roofline against it would be a made-up number.
:func:`predict_comms` (JAX: an ``eval_shape`` trace) runs the function
once under a fresh ledger.
"""

import contextlib
import dataclasses
import math
import os
from typing import Dict, List, Optional, Tuple

import torch

__all__ = [
    "CollectiveEntry",
    "CommsLedger",
    "axis_of",
    "comms_ledger",
    "ici_bandwidth_per_device",
    "muted",
    "predict_comms",
    "record",
    "scaled",
]

#: the environment variable that pins the link bandwidth (bytes/s)
LINK_BANDWIDTH_ENV = "APEX_TPU_TORCH_LINK_BANDWIDTH"

#: per-card link bandwidth (bytes/s, one direction, all links), by a
#: substring of the lower-cased CUDA device name. H100 SXM5: NVLink 4,
#: 18 links of 25 GB/s a direction, 450 GB/s (NVIDIA's H100 datasheet
#: gives "NVLink: 900GB/s", both directions together). The SXM part
#: reports itself as "NVIDIA H100 80GB HBM3". Any other card returns
#: None: a roofline against a made-up link speed is worse than none
#: (the contract of ``monitor.flops.peak_flops_per_device``).
_LINK_BW = (
    ("h100 80gb hbm3", 450e9),
    ("h100 sxm", 450e9),
)


def ici_bandwidth_per_device(device=None, group=None) -> Optional[float]:
    """A card's link bandwidth in bytes/s (JAX's per-chip ICI figure), or
    None when unknown: on the CPU, for a card missing from the table, and
    whenever ``group``'s collectives are staged through the host (gloo),
    whose traffic never crosses the link. ``LINK_BANDWIDTH_ENV`` (bytes/s)
    overrides the table. ``device`` is a CUDA device (index or
    ``torch.device``) or a device name; default: the current card."""
    if group is not None and _staged(group):
        return None
    env = os.environ.get(LINK_BANDWIDTH_ENV)
    if env:
        return float(env)
    if isinstance(device, str) and not device.startswith(("cuda", "cpu")):
        name = device
    else:
        if device is None and not torch.cuda.is_available():
            return None
        if device is not None and torch.device(device).type != "cuda":
            return None
        name = torch.cuda.get_device_name(device)
    name = name.lower()
    for sub, bw in _LINK_BW:
        if sub in name:
            return bw
    return None


def _staged(group) -> bool:
    """Does ``group`` (a process group) stage its collectives through the
    host (gloo)?"""
    import torch.distributed as dist

    from apex_tpu_torch.parallel import parallel_state as ps

    return isinstance(group, dist.ProcessGroup) and ps._staged(group)


@dataclasses.dataclass(frozen=True)
class CollectiveEntry:
    """One recorded collective (see the module docstring for the byte
    conventions)."""

    op: str
    axis: str
    axis_size: int
    shape: Tuple[int, ...]
    dtype: str
    bytes: int
    ici_bytes: int
    count: int = 1
    # a point-to-point send's ranks in the group, and its tag
    src: Optional[int] = None
    dst: Optional[int] = None
    tag: Optional[int] = None
    site: str = ""

    @property
    def total_bytes(self) -> int:
        return self.bytes * self.count

    @property
    def total_ici_bytes(self) -> int:
        return self.ici_bytes * self.count


class CommsLedger:
    """Collectives recorded under one :func:`comms_ledger` context."""

    def __init__(self, site_fn=None):
        self.entries: List[CollectiveEntry] = []
        #: collectives over one-rank groups: moved nothing, counted
        #: nowhere else
        self.dead: List[CollectiveEntry] = []
        self.site_fn = site_fn
        #: axes some of whose collectives gloo staged through the host:
        #: no link bounds them (:meth:`roofline_seconds`)
        self.staged_axes = set()

    def _add(self, entry: CollectiveEntry, dead: bool) -> None:
        if self.site_fn is not None:
            entry = dataclasses.replace(entry, site=self.site_fn())
        (self.dead if dead else self.entries).append(entry)

    def __len__(self) -> int:
        return len(self.entries)

    def filter(self, op: Optional[str] = None, axis: Optional[str] = None):
        """Entries matching ``op`` and/or ``axis`` (None = any)."""
        return [
            e for e in self.entries
            if (op is None or e.op == op) and (axis is None or e.axis == axis)
        ]

    def total_bytes(self, op=None, axis=None) -> int:
        return sum(e.total_bytes for e in self.filter(op, axis))

    def total_ici_bytes(self, op=None, axis=None) -> int:
        return sum(e.total_ici_bytes for e in self.filter(op, axis))

    def per_axis(self) -> Dict[str, Dict[str, int]]:
        """``{axis: {bytes, ici_bytes, calls, axis_size}}`` aggregates."""
        out: Dict[str, Dict[str, int]] = {}
        for e in self.entries:
            d = out.setdefault(
                e.axis,
                {"bytes": 0, "ici_bytes": 0, "calls": 0,
                 "axis_size": e.axis_size},
            )
            d["bytes"] += e.total_bytes
            d["ici_bytes"] += e.total_ici_bytes
            d["calls"] += e.count
        return out

    def per_op(self, axis: Optional[str] = None) -> Dict[str, Dict[str, int]]:
        out: Dict[str, Dict[str, int]] = {}
        for e in self.filter(axis=axis):
            d = out.setdefault(e.op, {"bytes": 0, "ici_bytes": 0, "calls": 0})
            d["bytes"] += e.total_bytes
            d["ici_bytes"] += e.total_ici_bytes
            d["calls"] += e.count
        return out

    def roofline_seconds(self, bandwidth: Optional[float] = None
                         ) -> Dict[str, Optional[float]]:
        """Per-axis lower-bound seconds: wire bytes over the link's
        bandwidth (default: :func:`ici_bandwidth_per_device`). None for
        an axis staged through the host and wherever the link is unknown,
        never a made-up number."""
        if bandwidth is None:
            bandwidth = ici_bandwidth_per_device()
        return {axis: (d["ici_bytes"] / bandwidth
                       if bandwidth and axis not in self.staged_axes
                       else None)
                for axis, d in self.per_axis().items()}

    def to_records(self, step: int = 0) -> List[dict]:
        """One ``kind="comms"`` record per mesh axis (the MetricRouter
        schema; route with ``router.emit``), ``ici_seconds`` its
        :meth:`roofline_seconds`."""
        from apex_tpu_torch.monitor.router import make_record

        roof = self.roofline_seconds()
        return [make_record(
            "comms", step, axis=axis, axis_size=d["axis_size"],
            bytes=d["bytes"], ici_bytes=d["ici_bytes"], calls=d["calls"],
            ici_seconds=roof[axis])
            for axis, d in sorted(self.per_axis().items())]

    def summary(self) -> str:
        """Human-readable per-axis/per-op breakdown."""
        if not self.entries:
            return "comms ledger: no collectives recorded"
        lines = ["comms ledger (per step):"]
        for axis, d in sorted(self.per_axis().items()):
            lines.append(
                f"  axis {axis!r} (n={d['axis_size']}): "
                f"{d['bytes'] / 2**20:.2f} MiB payload, "
                f"{d['ici_bytes'] / 2**20:.2f} MiB wire, "
                f"{d['calls']} calls"
            )
            for op, od in sorted(self.per_op(axis).items()):
                lines.append(
                    f"    {op:12s} {od['calls']:5d} calls "
                    f"{od['bytes'] / 2**20:9.2f} MiB"
                )
        return "\n".join(lines)


class _State:
    """The active ledgers and the ``scaled`` multiplier, process-wide: on
    the card autograd runs a backward's collectives on its own device
    thread, and a thread-local state would miss every one of them (the
    recorder's ``hlo-comms`` audit found it: the tp mappings' backward
    all-reduces, reduce-scatters and all-gathers were unrecorded)."""

    def __init__(self):
        self.ledgers: List[CommsLedger] = []
        self.multiplier = 1


_STATE = _State()


@contextlib.contextmanager
def comms_ledger(site_fn=None):
    """Activate a :class:`CommsLedger` for the collectives that run
    within. Nesting is supported (each active ledger records).
    ``site_fn()`` names each entry's call site (module docstring)."""
    led = CommsLedger(site_fn)
    _STATE.ledgers.append(led)
    try:
        yield led
    finally:
        _STATE.ledgers.remove(led)


@contextlib.contextmanager
def muted():
    """Suppress recording within (collectives that are no part of the
    step being accounted, such as a probe's)."""
    with scaled(0):
        yield


@contextlib.contextmanager
def scaled(n: int):
    """Mark a region whose collectives stand for ``n`` executions each:
    entries recorded within get ``count`` multiplied by ``n``; nested
    regions multiply."""
    n = int(n)
    if n < 0:
        raise ValueError(f"scaled() multiplier must be >= 0, got {n}")
    prev = _STATE.multiplier
    _STATE.multiplier = prev * n
    try:
        yield
    finally:
        _STATE.multiplier = prev


def predict_comms(fn, *args, **kwargs) -> CommsLedger:
    """Runs ``fn(*args, **kwargs)`` once under a fresh ledger and returns
    it (JAX's traces the function abstractly; eager torch has no abstract
    run, so the call does its work)."""
    with comms_ledger() as led:
        fn(*args, **kwargs)
    return led


# -- recording core ---------------------------------------------------------


def axis_of(group) -> str:
    """The mesh axis name of ``group`` in the present layout: ``tp``,
    ``dp``, ``pp`` or ``cp``; ``world`` for a sub-world's group (or the
    default group); ``group`` for any other."""
    import torch.distributed as dist

    from apex_tpu_torch.parallel import parallel_state as ps

    axes = ps._AXES
    if axes is not None:
        for name in ps.AXIS_ORDER:
            if getattr(axes, f"{name}_group") is group:
                return name
        if axes.world_group is not None and group is axes.world_group:
            return "world"
    if dist.is_initialized() and group is dist.group.WORLD:
        return "world"
    return "group"


def _ici_bytes(op: str, nbytes: int, n: int, nonempty: bool = True) -> int:
    if n <= 1 or not nonempty:
        return 0
    if op in ("psum", "pmean", "pmax", "pmin"):
        return math.ceil(2 * (n - 1) * nbytes / n)
    if op == "all_gather":
        return (n - 1) * nbytes
    if op in ("psum_scatter", "all_to_all"):
        return math.ceil((n - 1) * nbytes / n)
    return nbytes  # ppermute: the busiest rank ships its payload once


def record(op: str, x, group, *, nonempty: bool = True,
           edge: Optional[Tuple[int, int]] = None,
           tag: Optional[int] = None) -> None:
    """Record ``x`` (a tensor, or a list or tuple of them) as one ``op``
    occurrence over ``group``; ``edge`` is a send's ``(src, dst)`` ranks
    in the group. No-op when no ledger is active or there is no group; a
    group of one rank goes to the ``dead`` lists."""
    if not _STATE.ledgers or _STATE.multiplier == 0 or group is None:
        return
    from apex_tpu_torch.parallel import parallel_state as ps

    n = ps.group_size(group)
    axis = axis_of(group)
    mult = _STATE.multiplier
    src, dst = edge if edge is not None else (None, None)
    staged = n > 1 and _staged(group)
    for t in (x if isinstance(x, (list, tuple)) else (x,)):
        nbytes = t.numel() * t.element_size()
        entry = CollectiveEntry(
            op=op, axis=axis, axis_size=n, shape=tuple(t.shape),
            dtype=str(t.dtype).replace("torch.", ""), bytes=nbytes,
            ici_bytes=_ici_bytes(op, nbytes, n, nonempty), count=mult,
            src=src, dst=dst, tag=tag)
        for led in _STATE.ledgers:
            led._add(entry, dead=n <= 1)
            if staged:
                led.staged_axes.add(axis)
