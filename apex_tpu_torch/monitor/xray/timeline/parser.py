"""Profiler trace-event reader: the one blessed home of the port's
profiler traces (counterpart of apex_tpu/monitor/xray/timeline/parser.py).

``utils.timers.trace`` writes ``<log_dir>/trace.json`` and
``ProfilerTrigger`` its ``TRACE_FILE`` under each capture's directory:
``torch.profiler``'s Chrome trace-event export, the format XProf writes
for the JAX package. This module is the only place that format is parsed
(``analysis/lint.py`` pins that): every consumer goes through the
structured records here.

Stdlib only (gzip, json, dataclasses): a trace is analyzable on any box,
without torch or a card.

What the reader understands, verified against this torch's exporter (and
nothing more):

- top level ``{"traceEvents": [...], ...}``; ``ts``/``dur`` are
  microseconds (the Chrome convention);
- metadata events (``ph="M"``): ``process_name`` / ``thread_name`` with
  ``args.name``, the lane labels. ``pid`` is an int for a process or a
  device and may be a string (``"Spans"``); strings get a stable int;
- complete events (``ph="X"``) with ``cat``, ``name``, ``pid``, ``tid``,
  ``ts``, ``dur``, ``args``. The classes that matter downstream:

  - **step markers**: the ``ProfilerStep#N`` ranges that
    ``utils.timers.step_annotation`` opens (category
    ``user_annotation``; on the card torch also writes each range's
    projection onto the device lane, ``gpu_user_annotation``, which is
    not a marker), in place of XProf's ``StepTraceAnnotation`` spans
    with ``args.step_num``; either spelling is read;
  - **device ops**: the card's ``kernel``, ``gpu_memcpy`` and
    ``gpu_memset`` events (a kernel's name is its CUDA symbol, NCCL's
    ``ncclDevKernel_*`` among them);
  - **host collectives**: gloo's ``gloo:*`` ranges (run on gloo's own
    threads) and NCCL's ``nccl:*``: over gloo a collective runs on the
    host, so it is the host lane that holds it;
  - on a capture with no device lane (the CPU), the aten ops
    (``cpu_op``) stand in for the device ops: there the host does the
    step's work;
  - everything else (python frames, runtime calls, other annotations)
    is host noise the analyzer ignores.
"""

import dataclasses
import gzip
import json
import os
import re
import zlib
from typing import Dict, List, Optional, Tuple

__all__ = [
    "TraceEvent",
    "StepSpan",
    "Timeline",
    "find_trace_files",
    "load_trace_json",
    "parse_trace",
    "parse_trace_file",
    "parse_logdir",
]

#: filename suffixes of the trace-event export (gzipped and plain)
TRACE_SUFFIXES = (".json.gz", ".json")

#: the card's event categories that occupy it
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

#: prefixes of the host ranges that run a collective on gloo or NCCL
HOST_COLLECTIVE_PREFIXES = ("gloo:", "nccl:")

_STEP_RE = re.compile(r"^ProfilerStep#(\d+)$")


def _lane_id(v) -> int:
    """A pid or tid as an int: a number as itself, any other string as a
    stable id of its text (torch writes ``"Spans"`` for one lane)."""
    try:
        return int(v)
    except (TypeError, ValueError):
        return -(zlib.crc32(str(v).encode()) & 0x7FFFFFFF) - 1


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One complete (``ph="X"``) trace event; times in microseconds."""

    name: str
    pid: int
    tid: int
    ts: float
    dur: float
    args: dict = dataclasses.field(default_factory=dict)
    cat: str = ""

    @property
    def end(self) -> float:
        return self.ts + self.dur

    @property
    def step_num(self) -> Optional[int]:
        """The step number when this is a step marker: a
        ``ProfilerStep#N`` range, or an event carrying ``args.step_num``."""
        m = _STEP_RE.match(self.name)
        if m:
            return int(m.group(1))
        v = self.args.get("step_num")
        if v is None:
            return None
        try:
            return int(v)
        except (TypeError, ValueError):
            return None

    @property
    def on_device(self) -> bool:
        """A kernel, copy or set on the card."""
        return self.cat in DEVICE_CATEGORIES

    @property
    def host_collective(self) -> bool:
        """A collective's range on the host (gloo's or NCCL's)."""
        return self.name.startswith(HOST_COLLECTIVE_PREFIXES)


@dataclasses.dataclass(frozen=True)
class StepSpan:
    """One segmented step: the wall-clock window of ``step``."""

    step: int
    ts: float
    end: float

    @property
    def dur(self) -> float:
        return self.end - self.ts


@dataclasses.dataclass
class Timeline:
    """One capture's events plus its lane labels."""

    events: List[TraceEvent]
    process_names: Dict[int, str]
    thread_names: Dict[Tuple[int, int], str]

    def lane(self, e: TraceEvent) -> str:
        """Label of the event's lane: ``process/thread``."""
        proc = self.process_names.get(e.pid, str(e.pid))
        thread = self.thread_names.get((e.pid, e.tid), str(e.tid))
        return f"{proc}/{thread}"

    def step_spans(self) -> List[StepSpan]:
        """The step markers' windows, ordered by start time; repeated
        step numbers (two captures in one file) stay distinct spans. The
        card's projection of a range (``gpu_user_annotation``, over the
        kernels launched inside it) is no marker: the host's range is."""
        spans = [StepSpan(step=e.step_num, ts=e.ts, end=e.end)
                 for e in self.events
                 if e.step_num is not None and not e.cat.startswith("gpu_")]
        return sorted(spans, key=lambda s: (s.ts, s.step))

    def device_op_events(self) -> List[TraceEvent]:
        """The events that occupy the device: the card's kernels, copies
        and sets, with the host collectives (a gloo collective runs on
        the host); on a capture without a device lane, the aten ops
        (``cpu_op``) with the host collectives. A step marker is never
        an op."""
        device = [e for e in self.events if e.on_device]
        host_coll = [e for e in self.events
                     if e.host_collective and e.step_num is None]
        if device:
            return device + host_coll
        cpu = [e for e in self.events
               if e.cat == "cpu_op" and e.step_num is None
               and not e.host_collective]
        return cpu + host_coll

    def merged(self, other: "Timeline") -> "Timeline":
        """This capture plus ``other`` (another process's file of the
        same run); the first file's labels win where lanes collide."""
        return Timeline(
            events=self.events + other.events,
            process_names={**other.process_names, **self.process_names},
            thread_names={**other.thread_names, **self.thread_names},
        )


def find_trace_files(logdir: str) -> List[str]:
    """Every trace-event file under ``logdir``, newest capture first:
    sorted by containing directory, then file name, descending (a
    ``ProfilerTrigger`` capture's directory names start with its step)."""
    found = []
    for dirpath, _, names in os.walk(logdir):
        for fn in sorted(names):
            if fn.endswith(TRACE_SUFFIXES):
                found.append(os.path.join(dirpath, fn))
    return sorted(found, key=lambda p: (os.path.dirname(p),
                                        os.path.basename(p)), reverse=True)


def load_trace_json(path: str) -> dict:
    """The raw trace dict of one ``*.json[.gz]`` file."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def parse_trace(data: dict) -> Timeline:
    """Structure one loaded trace dict (tests hand synthetic dicts
    here)."""
    raw = data.get("traceEvents")
    if not isinstance(raw, list):
        raise ValueError(
            "not a trace-event export: no traceEvents list (schema drift? "
            "this parser reads the Chrome trace-event format "
            "torch.profiler exports)")
    events: List[TraceEvent] = []
    process_names: Dict[int, str] = {}
    thread_names: Dict[Tuple[int, int], str] = {}
    for e in raw:
        if not isinstance(e, dict):
            continue
        ph = e.get("ph")
        if ph == "M":
            args = e.get("args") or {}
            pid = _lane_id(e.get("pid", 0))
            if e.get("name") == "process_name" and "name" in args:
                process_names[pid] = str(args["name"])
            elif e.get("name") == "thread_name" and "name" in args:
                thread_names[(pid, _lane_id(e.get("tid", 0)))] = str(
                    args["name"])
        elif ph == "X" and "ts" in e:
            events.append(TraceEvent(
                name=str(e.get("name", "")),
                pid=_lane_id(e.get("pid", 0)),
                tid=_lane_id(e.get("tid", 0)),
                ts=float(e["ts"]),
                dur=float(e.get("dur", 0.0)),
                args=e.get("args") or {},
                cat=str(e.get("cat", "")),
            ))
    return Timeline(events=events, process_names=process_names,
                    thread_names=thread_names)


def parse_trace_file(path: str) -> Timeline:
    return parse_trace(load_trace_json(path))


def parse_logdir(logdir: str) -> Tuple[Timeline, List[str]]:
    """Parse the newest capture under ``logdir`` (all its files merged);
    returns ``(timeline, files_used)`` and raises ``FileNotFoundError``
    when there is no trace file. Only one capture's directory is merged:
    two captures' clocks would make every duration nonsense."""
    files = find_trace_files(logdir)
    if not files:
        raise FileNotFoundError(
            f"no *.json[.gz] trace under {logdir!r}: is this the directory "
            f"given to utils.timers.trace or ProfilerTrigger?")
    newest = os.path.dirname(files[0])
    used = [p for p in files if os.path.dirname(p) == newest]
    timeline = parse_trace_file(used[0])
    for path in used[1:]:
        timeline = timeline.merged(parse_trace_file(path))
    return timeline, used
