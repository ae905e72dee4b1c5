"""Device-time timeline: measured profiler seconds joined to predicted
bytes (counterpart of apex_tpu/monitor/xray/timeline/).

The consumer of the traces ``utils.timers.trace`` and ``ProfilerTrigger``
write (``torch.profiler``'s Chrome trace-event JSON):

- ``parser``   — the one blessed reader of the trace format
  (``analysis/lint.py`` pins that): complete events, lane labels, the
  ``ProfilerStep#N`` step spans, the card's kernels, copies and sets and
  the host collectives;
- ``analyzer`` — step segmentation, the compute / collective / memcpy /
  idle partition (union math over overlapping lanes), exposed-comms
  time, overlap and bubble fractions, the device ops that took the most
  time, and the bandwidth join: measured per-axis collective seconds
  (each matched to a dispatched c10d op of the step, whose process group
  names its axis) against the xray ledger's predicted per-axis bytes.

CLI: ``python -m apex_tpu_torch.monitor.xray.timeline <logdir>``; the
examples' ``--profile-analyze`` runs the same path on the capture they
just took. Records emit as ``kind="profile"`` through the MetricRouter
schema.
"""

from apex_tpu_torch.monitor.xray.timeline.parser import (
    StepSpan,
    Timeline,
    TraceEvent,
    find_trace_files,
    load_trace_json,
    parse_logdir,
    parse_trace,
    parse_trace_file,
)
from apex_tpu_torch.monitor.xray.timeline.analyzer import (
    AxisBandwidth,
    StepBreakdown,
    TimelineReport,
    analyze,
    analyze_logdir,
    classify_op,
    pair_async_collectives,
)

__all__ = [
    "TraceEvent",
    "StepSpan",
    "Timeline",
    "find_trace_files",
    "load_trace_json",
    "parse_trace",
    "parse_trace_file",
    "parse_logdir",
    "classify_op",
    "pair_async_collectives",
    "StepBreakdown",
    "AxisBandwidth",
    "TimelineReport",
    "analyze",
    "analyze_logdir",
]
