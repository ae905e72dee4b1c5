"""Device-time breakdown and the measured-against-predicted bandwidth
join (counterpart of apex_tpu/monitor/xray/timeline/analyzer.py).

Per step (segmented on the ``ProfilerStep#N`` ranges that
``utils.timers.step_annotation`` opens around each step):

- **compute / collective / memcpy time**: the union of the op intervals
  of each class (never a sum: ops overlap across streams and lanes);
  compute is every kernel but NCCL's, collectives are NCCL's kernels on
  the card and gloo's (or NCCL's) ranges on the host, memcpy the card's
  copies and sets. Over gloo a collective of CUDA tensors is staged
  through pinned host memory (``parallel_state.staged_through_host``):
  those copies land in memcpy, and the collective itself on the host
  lane;
- **exposed collective time**: collective time not covered by compute;
- **overlap fraction**: hidden / total collective time;
- **idle time and bubble fraction**: step span covered by no op.

The partition identity, pinned in the tests: ``compute +
exposed_collective + exposed_memcpy + idle == span``.

The bandwidth join: each measured collective is matched to one of the
step's dispatched ``c10d`` ops (``analysis.hlo.parser``'s module, which
carries each op's process group): within a step the host and NCCL
collectives, in start order, take the module's collectives of their
kind in dispatch order. The op's group is attributed to a layout axis
(``analysis/hlo/attribution.py``) and the per-axis measured seconds are
divided into the ledger's predicted per-axis wire bytes. ``utilization``
is the achieved rate over the axis's link roofline: the ledger's
(``ledger.ici_bandwidth_per_device``, None for an axis gloo staged
through the host and for a card missing from the table) unless the
caller pins ``ici_bandwidth``; where no link is known it stays None, and
a number is never faked.

Everything emits ``kind="profile"`` records through the MetricRouter
schema; ``python -m apex_tpu_torch.monitor.xray.timeline`` is the
command line.

On a CPU capture the aten ops stand in for the device's, so compute and
collective durations are the host's measured seconds and idle time is
the host's Python between ops: the math is the card's, the meaning of
its absolute numbers is not.
"""

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

from apex_tpu_torch.monitor.xray.timeline.parser import (
    StepSpan,
    Timeline,
    TraceEvent,
    parse_logdir,
)

__all__ = [
    "CLASS_COMPUTE",
    "CLASS_COLLECTIVE",
    "CLASS_MEMCPY",
    "classify_op",
    "op_base",
    "merge_intervals",
    "total_us",
    "intersect_intervals",
    "subtract_intervals",
    "clip_intervals",
    "pair_async_collectives",
    "OpInterval",
    "StepBreakdown",
    "AxisBandwidth",
    "TimelineReport",
    "analyze",
    "analyze_logdir",
]

CLASS_COMPUTE = "compute"
CLASS_COLLECTIVE = "collective"
CLASS_MEMCPY = "memcpy"

#: the JAX package's collective opcodes (XProf's op names), kept so that
#: one name classifies alike in both packages
_HLO_COLLECTIVES = frozenset({"all-reduce", "all-gather", "reduce-scatter",
                              "collective-permute", "all-to-all"})

#: op stems that move bytes without computing
_MEMCPY_STEMS = frozenset({
    "copy", "copy-start", "copy-done", "infeed", "outfeed",
    "send", "send-done", "recv", "recv-done",
})

#: name prefixes of a collective: the host transports' ranges, the c10d
#: ops on the host lane, NCCL's kernels on the card
_COLLECTIVE_PREFIXES = ("gloo:", "nccl:", "c10d::", "nccldevkernel",
                        "ncclkernel")

Interval = Tuple[float, float]


def op_base(name: str) -> str:
    """An op name's stem: ``%`` and one trailing ``.N`` ordinal stripped,
    lowercased (``all-reduce.17`` -> ``all-reduce``)."""
    base = name.lstrip("%").lower()
    head, dot, tail = base.rpartition(".")
    if dot and tail.isdigit():
        return head
    return base


def classify_op(name: str) -> str:
    """``compute`` / ``collective`` / ``memcpy`` for one op name: the
    card's copies and sets (``Memcpy HtoD ...``, ``Memset ...``) are
    memcpy, gloo's and NCCL's ranges, the c10d ops and NCCL's kernels
    collectives, every other kernel (or aten op) compute. XProf's names
    classify as in the JAX package."""
    stem = op_base(name)
    if stem in _MEMCPY_STEMS or "memcpy" in stem or "memset" in stem:
        return CLASS_MEMCPY
    if stem.startswith(_COLLECTIVE_PREFIXES):
        return CLASS_COLLECTIVE
    if stem.endswith("-start"):
        stem = stem[: -len("-start")]
    elif stem.endswith("-done"):
        stem = stem[: -len("-done")]
    if stem in _HLO_COLLECTIVES:
        return CLASS_COLLECTIVE
    return CLASS_COMPUTE


_FAMILY_RE = re.compile(r"[^a-z]")


def collective_family(name: str) -> Optional[str]:
    """The kind of a transport's collective range or NCCL kernel, in the
    c10d ops' terms (``allreduce``, ``allgather``, ``reducescatter``,
    ``alltoall``, ``send``, ``recv``, ``broadcast``); None for anything
    else (a c10d op on the host lane is its dispatch, not the transfer)."""
    low = name.lower()
    if low.startswith(("gloo:", "nccl:")):
        body = low.split(":", 1)[1]
    elif low.startswith(("nccldevkernel_", "ncclkernel_")):
        body = low.split("_", 1)[1].split("_", 1)[0]
    else:
        return None
    return _FAMILY_RE.sub("", body) or None


# -- interval algebra (all inputs/outputs in microseconds) -------------------


def merge_intervals(intervals: Sequence[Interval]) -> List[Interval]:
    """Disjoint, sorted union of ``intervals`` (zero-length dropped)."""
    out: List[Interval] = []
    for lo, hi in sorted(i for i in intervals if i[1] > i[0]):
        if out and lo <= out[-1][1]:
            if hi > out[-1][1]:
                out[-1] = (out[-1][0], hi)
        else:
            out.append((lo, hi))
    return out


def total_us(merged: Sequence[Interval]) -> float:
    return sum(hi - lo for lo, hi in merged)


def intersect_intervals(a: Sequence[Interval],
                        b: Sequence[Interval]) -> List[Interval]:
    """Intersection of two MERGED interval lists."""
    out: List[Interval] = []
    i = j = 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract_intervals(a: Sequence[Interval],
                       b: Sequence[Interval]) -> List[Interval]:
    """``a`` minus ``b``, both MERGED."""
    out: List[Interval] = []
    j = 0
    for lo, hi in a:
        cur = lo
        while j < len(b) and b[j][1] <= cur:
            j += 1
        k = j
        while k < len(b) and b[k][0] < hi:
            if b[k][0] > cur:
                out.append((cur, b[k][0]))
            cur = max(cur, b[k][1])
            k += 1
        if cur < hi:
            out.append((cur, hi))
    return out


def clip_intervals(intervals: Sequence[Interval], lo: float,
                   hi: float) -> List[Interval]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if min(b, hi) > max(a, lo)]


# -- async start/done fusion -------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OpInterval:
    """One classified op occupancy interval; for a fused ``-start`` /
    ``-done`` pair it spans launch to completion."""

    cls: str
    name: str
    ts: float
    end: float
    family: Optional[str] = None  # collective_family of the event

    @property
    def interval(self) -> Interval:
        return (self.ts, self.end)


def pair_async_collectives(events: Sequence[TraceEvent]) -> List[OpInterval]:
    """Classified intervals of op ``events``, each async collective's
    ``-start``/``-done`` pair fused into one in-flight interval (FIFO per
    (pid, kind) in time order; an unpaired half keeps its own span).
    torch's exporter writes no such pairs: a collective is one event, and
    this is the identity there; XProf-form traces fuse as in the JAX
    package."""
    out: List[OpInterval] = []
    pending: Dict[Tuple[int, str], List[TraceEvent]] = {}
    for e in sorted(events, key=lambda e: (e.ts, e.end)):
        cls = classify_op(e.name)
        stem = op_base(e.name)
        if cls == CLASS_COLLECTIVE and stem.endswith("-start"):
            pending.setdefault((e.pid, stem[:-6]), []).append(e)
            continue
        if cls == CLASS_COLLECTIVE and stem.endswith("-done"):
            queue = pending.get((e.pid, stem[:-5]), [])
            if queue:
                start = queue.pop(0)
                out.append(OpInterval(
                    cls=CLASS_COLLECTIVE, name=start.name.lstrip("%"),
                    ts=start.ts, end=max(e.end, start.end)))
                continue
        out.append(OpInterval(cls=cls, name=e.name.lstrip("%"), ts=e.ts,
                              end=e.end, family=collective_family(e.name)))
    for queue in pending.values():  # starts whose done fell off the capture
        for e in queue:
            out.append(OpInterval(cls=CLASS_COLLECTIVE,
                                  name=e.name.lstrip("%"), ts=e.ts,
                                  end=e.end))
    return out


# -- per-step breakdown ------------------------------------------------------


@dataclasses.dataclass
class StepBreakdown:
    """One step's partition (all times microseconds); identity:
    ``compute_us + exposed_collective_us + exposed_memcpy_us + idle_us ==
    span_us``."""

    step: int
    ts: float
    end: float
    compute_us: float
    collective_us: float
    memcpy_us: float
    exposed_collective_us: float
    exposed_memcpy_us: float
    busy_us: float
    n_ops: int

    @property
    def span_us(self) -> float:
        return self.end - self.ts

    @property
    def idle_us(self) -> float:
        return self.span_us - self.busy_us

    @property
    def bubble_fraction(self) -> float:
        return self.idle_us / self.span_us if self.span_us > 0 else 0.0

    @property
    def overlap_fraction(self) -> Optional[float]:
        """Hidden / total collective time; None when the step ran no
        collective (0/0 is not perfect overlap)."""
        if self.collective_us <= 0:
            return None
        return 1.0 - self.exposed_collective_us / self.collective_us


def _fmt_util(u: Optional[float]) -> str:
    return "None: no link roofline" if u is None else f"{100 * u:.1f}%"


@dataclasses.dataclass
class AxisBandwidth:
    """Measured seconds joined to predicted bytes for one layout axis."""

    axis: str
    n_events: int
    n_steps: int
    measured_us_per_step: float
    predicted_bytes_per_step: int  # ledger payload convention
    predicted_ici_bytes_per_step: int  # ring-algorithm wire bytes
    roofline_bytes_per_s: Optional[float]

    @property
    def achieved_bytes_per_s(self) -> Optional[float]:
        """Predicted wire bytes per measured second (None when nothing
        was measured)."""
        if self.measured_us_per_step <= 0:
            return None
        return self.predicted_ici_bytes_per_step / (
            self.measured_us_per_step * 1e-6)

    @property
    def utilization(self) -> Optional[float]:
        """Achieved / roofline, or None when either is unknown (never a
        fake number)."""
        a = self.achieved_bytes_per_s
        if a is None or not self.roofline_bytes_per_s:
            return None
        return a / self.roofline_bytes_per_s


@dataclasses.dataclass
class TimelineReport:
    """The analyzer's output: per-step partitions and the per-axis
    measured-against-predicted join. ``predicted_bubble_fraction``, when
    the caller supplies the schedule algebra's number, rides next to the
    measured one in every per-step record."""

    steps: List[StepBreakdown]
    axes: List[AxisBandwidth]
    n_device_ops: int
    n_unattributed_collectives: int = 0
    files: List[str] = dataclasses.field(default_factory=list)
    synthetic_step: bool = False  # no markers: whole capture = one span
    predicted_bubble_fraction: Optional[float] = None
    schedule: Optional[str] = None
    #: (name, total us over the steps, launches) of the device ops that
    #: took the most time, longest first
    top_ops: List[Tuple[str, float, int]] = dataclasses.field(
        default_factory=list)

    def to_records(self) -> List[dict]:
        """``kind="profile"`` records in the MetricRouter schema: one per
        step (milliseconds), then one per joined axis."""
        from apex_tpu_torch.monitor.router import make_record

        records = []
        for s in self.steps:
            extra = {}
            if self.predicted_bubble_fraction is not None:
                extra["predicted_bubble_fraction"] = (
                    self.predicted_bubble_fraction)
                extra["schedule"] = self.schedule
            records.append(make_record(
                "profile", s.step,
                span_ms=s.span_us / 1e3,
                compute_ms=s.compute_us / 1e3,
                collective_ms=s.collective_us / 1e3,
                exposed_comms_ms=s.exposed_collective_us / 1e3,
                memcpy_ms=s.memcpy_us / 1e3,
                exposed_memcpy_ms=s.exposed_memcpy_us / 1e3,
                idle_ms=s.idle_us / 1e3,
                overlap_fraction=s.overlap_fraction,
                bubble_fraction=s.bubble_fraction,
                n_ops=s.n_ops,
                **extra,
            ))
        last_step = self.steps[-1].step if self.steps else 0
        for ax in self.axes:
            records.append(make_record(
                "profile", last_step,
                axis=ax.axis,
                events=ax.n_events,
                measured_ms_per_step=ax.measured_us_per_step / 1e3,
                predicted_bytes=ax.predicted_bytes_per_step,
                predicted_ici_bytes=ax.predicted_ici_bytes_per_step,
                achieved_bytes_per_s=ax.achieved_bytes_per_s,
                roofline_bytes_per_s=ax.roofline_bytes_per_s,
                utilization=ax.utilization,
            ))
        return records

    def summary(self, top: int = 0) -> str:
        """The readable breakdown (``--profile-analyze`` and the CLI);
        ``top`` > 0 adds that many of the longest device ops."""
        if not self.steps:
            return "timeline: no steps found (no device ops in capture)"
        lines = [
            f"timeline: {len(self.steps)} step(s), "
            f"{self.n_device_ops} device op events"
            + (" [no step markers: whole capture analyzed as one span]"
               if self.synthetic_step else "")
        ]
        for s in self.steps:
            ov = (f"{100 * s.overlap_fraction:5.1f}%"
                  if s.overlap_fraction is not None else "    -")
            lines.append(
                f"  step {s.step:4d}: span {s.span_us / 1e3:9.3f} ms | "
                f"compute {s.compute_us / 1e3:8.3f} | "
                f"collective {s.collective_us / 1e3:8.3f} "
                f"(exposed {s.exposed_collective_us / 1e3:8.3f}) | "
                f"memcpy {s.memcpy_us / 1e3:7.3f} | "
                f"idle {s.idle_us / 1e3:8.3f} "
                f"(bubble {100 * s.bubble_fraction:5.1f}%) | "
                f"overlap {ov}")
        for ax in self.axes:
            a = ax.achieved_bytes_per_s
            ach = (f"{a / 1e9:.3f} GB/s achieved" if a is not None
                   else "no time measured")
            lines.append(
                f"  axis {ax.axis!r}: {ax.n_events} collective events, "
                f"{ax.measured_us_per_step / 1e3:.3f} ms/step measured, "
                f"{ax.predicted_ici_bytes_per_step / 2**20:.2f} MiB/step "
                f"predicted wire -> {ach} (utilization "
                f"{_fmt_util(ax.utilization)})")
        if self.n_unattributed_collectives:
            lines.append(
                f"  ({self.n_unattributed_collectives} collective event(s) "
                f"matched no dispatched c10d op / axis: not joined)")
        if self.predicted_bubble_fraction is not None and self.steps:
            measured = sum(s.bubble_fraction for s in self.steps) / len(
                self.steps)
            sched = f" ({self.schedule})" if self.schedule else ""
            lines.append(
                f"  bubble join{sched}: predicted "
                f"{100 * self.predicted_bubble_fraction:5.1f}% (schedule "
                f"algebra) vs measured {100 * measured:5.1f}% (mean over "
                f"{len(self.steps)} step(s))")
        for name, us, n in self.top_ops[:top]:
            lines.append(f"  op {us / 1e3 / max(len(self.steps), 1):9.3f} "
                         f"ms/step x{n}: {name[:110]}")
        return "\n".join(lines)


def _predicted_per_axis(ledger, mesh) -> Dict[str, Dict[str, int]]:
    """The ledger's per-axis totals re-keyed onto attribution labels
    (size-1 axes dropped, layout order)."""
    from apex_tpu_torch.analysis.hlo import attribution

    out: Dict[str, Dict[str, int]] = {}
    for axis, d in ledger.per_axis().items():
        key = attribution.canon_axis_key(mesh, axis)
        if key == attribution.AXIS_NONE:
            continue
        agg = out.setdefault(key, {"bytes": 0, "ici_bytes": 0})
        agg["bytes"] += d["bytes"]
        agg["ici_bytes"] += d["ici_bytes"]
    return out


def _event_axes(intervals, spans, module, mesh):
    """(axis -> intervals, axis -> event count, unattributed): each
    transport collective of a step matched, in start order, to the next
    dispatched c10d op of its kind (module docstring)."""
    from apex_tpu_torch.analysis.hlo import attribution

    partitions = attribution.mesh_axis_partitions(mesh)
    by_family: Dict[str, List[str]] = {}
    for c in module.collectives_in_entry():
        by_family.setdefault(c.family, []).append(
            attribution.axis_of_collective(mesh, c, partitions))
    axis_intervals: Dict[str, List[Interval]] = {}
    axis_events: Dict[str, int] = {}
    unattributed = 0
    for span in spans:
        taken: Dict[str, int] = {}
        for o in sorted(intervals, key=lambda o: o.ts):
            if o.cls != CLASS_COLLECTIVE or o.family is None or not (
                    span.ts <= o.ts < span.end):
                continue
            seq = by_family.get(o.family, [])
            i = taken.get(o.family, 0)
            taken[o.family] = i + 1
            axis = seq[i] if i < len(seq) else None
            if axis is None or axis in (attribution.AXIS_NONE,
                                        attribution.AXIS_UNKNOWN):
                unattributed += 1
                continue
            axis_intervals.setdefault(axis, []).append(o.interval)
            axis_events[axis] = axis_events.get(axis, 0) + 1
    return axis_intervals, axis_events, unattributed


def analyze(
    timeline: Timeline,
    module=None,
    mesh=None,
    ledger=None,
    ici_bandwidth: Optional[float] = None,
    predicted_bubble_fraction: Optional[float] = None,
    schedule: Optional[str] = None,
) -> TimelineReport:
    """The report of one parsed capture. ``module`` (the step's recorded
    ``analysis.hlo.parser.HloModule``), ``mesh`` (the layout,
    ``attribution.layout_mesh``) and ``ledger`` (a ``CommsLedger``)
    enable the bandwidth join; ``ici_bandwidth`` pins the utilization
    column's link speed, which is otherwise the ledger's per axis (module
    docstring)."""
    ops = timeline.device_op_events()
    intervals = pair_async_collectives(ops)
    spans = timeline.step_spans()
    synthetic = False
    if not spans and intervals:
        synthetic = True
        spans = [StepSpan(step=-1, ts=min(o.ts for o in intervals),
                          end=max(o.end for o in intervals))]

    by_class: Dict[str, List[Interval]] = {
        CLASS_COMPUTE: [], CLASS_COLLECTIVE: [], CLASS_MEMCPY: [],
    }
    for o in intervals:
        by_class[o.cls].append(o.interval)

    steps: List[StepBreakdown] = []
    for span in spans:
        comp = merge_intervals(
            clip_intervals(by_class[CLASS_COMPUTE], span.ts, span.end))
        coll = merge_intervals(
            clip_intervals(by_class[CLASS_COLLECTIVE], span.ts, span.end))
        memc = merge_intervals(
            clip_intervals(by_class[CLASS_MEMCPY], span.ts, span.end))
        busy = merge_intervals(list(comp) + list(coll) + list(memc))
        n_ops = sum(1 for o in intervals
                    if o.end > span.ts and o.ts < span.end)
        steps.append(StepBreakdown(
            step=span.step, ts=span.ts, end=span.end,
            compute_us=total_us(comp),
            collective_us=total_us(coll),
            memcpy_us=total_us(memc),
            exposed_collective_us=total_us(subtract_intervals(coll, comp)),
            exposed_memcpy_us=total_us(subtract_intervals(
                memc, merge_intervals(list(comp) + list(coll)))),
            busy_us=total_us(busy),
            n_ops=n_ops,
        ))

    # the device ops that took the most time inside the steps
    per_op: Dict[str, List[float]] = {}
    for e in ops:
        for span in spans:
            if span.ts <= e.ts < span.end:
                acc = per_op.setdefault(e.name, [0.0, 0])
                acc[0] += e.dur
                acc[1] += 1
                break
    top_ops = sorted(((n, us, int(c)) for n, (us, c) in per_op.items()),
                     key=lambda r: -r[1])

    axes: List[AxisBandwidth] = []
    unattributed = 0
    if module is not None and mesh is not None and steps:
        axis_intervals, axis_events, unattributed = _event_axes(
            intervals, spans, module, mesh)
        predicted = (_predicted_per_axis(ledger, mesh)
                     if ledger is not None else {})
        from apex_tpu_torch.analysis.hlo import attribution

        staged = ({attribution.canon_axis_key(mesh, a)
                   for a in getattr(ledger, "staged_axes", ())}
                  if ledger is not None else set())
        for axis in sorted(set(axis_intervals) | set(predicted)):
            measured = 0.0
            for span in spans:
                measured += total_us(merge_intervals(clip_intervals(
                    axis_intervals.get(axis, []), span.ts, span.end)))
            pred = predicted.get(axis, {"bytes": 0, "ici_bytes": 0})
            roof = ici_bandwidth
            if roof is None and ledger is not None and axis not in staged:
                from apex_tpu_torch.monitor.xray.ledger import (
                    ici_bandwidth_per_device,
                )

                roof = ici_bandwidth_per_device()
            axes.append(AxisBandwidth(
                axis=axis, n_events=axis_events.get(axis, 0),
                n_steps=len(steps),
                measured_us_per_step=measured / len(steps),
                predicted_bytes_per_step=pred["bytes"],
                predicted_ici_bytes_per_step=pred["ici_bytes"],
                roofline_bytes_per_s=roof,
            ))

    return TimelineReport(
        steps=steps, axes=axes, n_device_ops=len(ops),
        n_unattributed_collectives=unattributed, synthetic_step=synthetic,
        predicted_bubble_fraction=predicted_bubble_fraction,
        schedule=schedule, top_ops=top_ops,
    )


def analyze_logdir(
    logdir: str,
    module=None,
    mesh=None,
    ledger=None,
    ici_bandwidth: Optional[float] = None,
    predicted_bubble_fraction: Optional[float] = None,
    schedule: Optional[str] = None,
) -> TimelineReport:
    """Parse the newest capture under ``logdir`` and :func:`analyze` it
    (the ``--profile-analyze`` and CLI path)."""
    timeline, files = parse_logdir(logdir)
    report = analyze(
        timeline, module=module, mesh=mesh, ledger=ledger,
        ici_bandwidth=ici_bandwidth,
        predicted_bubble_fraction=predicted_bubble_fraction,
        schedule=schedule,
    )
    report.files = files
    return report
