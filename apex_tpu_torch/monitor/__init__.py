"""Telemetry (counterpart of apex_tpu/monitor/): in-step taps -> host
router -> sinks, and the instruments around them.

- ``metrics``  — :class:`MetricBag`, named scalar aggregates folded on
  the device with no host read and fetched once per log interval
  (:func:`read_bag`, counted by :func:`host_fetch_count`), the grad-norm
  helpers and the tap reader.
- ``router``   — :class:`MetricRouter` fanning one shared record schema
  (``make_record``) out to pluggable sinks: jsonl, CSV, stdout,
  TensorBoard when importable, in-memory.
- ``flops``    — analytic model-FLOPs counters for GPT and BERT, and the
  MFU / tokens-per-second arithmetic against the card's peak.
- ``watchdog`` — :class:`StallWatchdog` (a heartbeat thread flagging a
  step past its deadline, with the escalation ladder the incident
  responder builds on) and :class:`ProfilerTrigger` (a ``torch.profiler``
  window at a requested step or when the anomaly sentinel escalates).
- ``taps``     — the registered-taps table.
- ``goodput``  — phase spans, run headers, the goodput/badput accountant
  and the fleet-health checks.
- ``xray``     — the HBM x-ray (analytic ledger, allocator report, live
  watermarks, OOM forensics), the collective-traffic ledger, the
  recompile sentinel and the profiler timeline analyzer (``timeline``);
- ``goodput``'s perf-regression sentinel and its command line
  (``python -m apex_tpu_torch.monitor.goodput --check``).
"""

from apex_tpu_torch.monitor.flops import (
    bert_flops_per_token,
    gpt_flops_per_token,
    mfu,
    peak_flops_per_device,
    tokens_per_second,
    training_flops_per_step,
    transformer_layer_flops_per_token,
)
from apex_tpu_torch.monitor.metrics import (
    MetricBag,
    global_grad_norm,
    host_fetch_count,
    metric_bag,
    per_layer_grad_norms,
    read_bag,
    reset_bag,
    taps_from_intermediates,
)
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
from apex_tpu_torch.monitor.taps import REGISTERED_TAPS
from apex_tpu_torch.monitor.watchdog import ProfilerTrigger, StallWatchdog
from apex_tpu_torch.monitor import goodput, xray  # noqa: E402

__all__ = [
    "CsvSink", "JsonlSink", "MemorySink", "MetricBag", "MetricRouter",
    "ProfilerTrigger", "REGISTERED_TAPS", "Sink", "StallWatchdog",
    "StdoutSink", "bert_flops_per_token", "flops", "global_grad_norm",
    "goodput", "gpt_flops_per_token", "host_fetch_count", "make_record",
    "metric_bag", "metrics", "mfu", "peak_flops_per_device",
    "per_layer_grad_norms", "read_bag", "reset_bag", "router", "taps",
    "taps_from_intermediates", "tokens_per_second",
    "training_flops_per_step", "transformer_layer_flops_per_token",
    "try_tensorboard_sink", "watchdog", "xray",
]
