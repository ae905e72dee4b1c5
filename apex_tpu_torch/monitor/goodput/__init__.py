"""Run-level goodput (counterpart of apex_tpu/monitor/goodput/): the
span ledger and the accountant.

- ``spans``      — the ``kind="span"`` phase ledger (closed taxonomy
  :data:`~apex_tpu_torch.monitor.goodput.spans.PHASES`), ``kind="run"``
  incarnation headers, and the torn-stream teardown flush.
- ``accountant`` — replays one or more streams into a goodput/badput
  partition whose identity ``productive + sum(badput) + unattributed ==
  wall`` is exact.
- ``fleet``      — straggler hosts (robust z-score on step duration) and
  silent-corruption suspects (cross-host replicated-value mismatch).
- ``live``       — the same fleet checks run IN the job over a rolling
  MemorySink window (``LiveFleetMonitor``).
- ``sentinel``   — the perf-regression gate over ``kind="bench"`` /
  ``"metrics"`` / ``"goodput"`` records (same-platform baselines only).

``python -m apex_tpu_torch.monitor.goodput`` accounts streams, checks a
fleet (``--fleet``) or gates a run against its baseline (``--check``).
"""

from apex_tpu_torch.monitor.goodput.accountant import (
    BADPUT_PHASES,
    GoodputReport,
    account,
    read_records,
)
from apex_tpu_torch.monitor.goodput.fleet import FleetReport, detect_divergence
from apex_tpu_torch.monitor.goodput.live import LiveFleetMonitor
from apex_tpu_torch.monitor.goodput.spans import (
    PHASE_PRIORITY,
    PHASES,
    PRODUCTIVE_PHASE,
    PRODUCTIVE_PHASES,
    Span,
    begin_span,
    derive_run_id,
    emit_span,
    flush_open_spans,
    get_router,
    run_header,
    set_router,
    span,
)

__all__ = [
    "BADPUT_PHASES", "FleetReport", "GoodputReport", "LiveFleetMonitor",
    "PHASES", "PHASE_PRIORITY",
    "PRODUCTIVE_PHASE", "PRODUCTIVE_PHASES", "Span", "account",
    "begin_span", "derive_run_id", "detect_divergence", "emit_span", "flush_open_spans",
    "get_router", "read_records", "run_header", "set_router", "span",
]
