"""Telemetry (counterpart of apex_tpu/monitor/): the record router and
the run-level goodput ledger, the parts serving uses.

- ``router``  — :class:`MetricRouter` fanning one shared record schema
  (``make_record``) out to pluggable sinks: jsonl, CSV, stdout,
  TensorBoard when importable, in-memory.
- ``goodput`` — phase spans (``kind="span"``), run headers and the
  goodput/badput accountant.
- ``xray.hbm.live.kv_pool_fields`` — the serving engine's
  ``kind="memory"`` KV-pool record.

Not ported yet: the in-step metric taps, the FLOP counters, the stall
watchdog and the rest of the x-ray.
"""

from apex_tpu_torch.monitor.router import (
    CsvSink,
    JsonlSink,
    MemorySink,
    MetricRouter,
    Sink,
    StdoutSink,
    make_record,
    try_tensorboard_sink,
)
from apex_tpu_torch.monitor import goodput, xray  # noqa: E402

__all__ = [
    "CsvSink", "JsonlSink", "MemorySink", "MetricRouter", "Sink",
    "StdoutSink", "goodput", "make_record", "router",
    "try_tensorboard_sink", "xray",
]
