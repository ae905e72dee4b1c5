"""Timeline smoke check: does this torch still write traces the timeline
reads? (counterpart of apex_tpu/analysis/trace_smoke.py)

The timeline analyzer (``apex_tpu_torch.monitor.xray.timeline``) parses
the Chrome trace-event JSON ``torch.profiler`` exports, a format torch
does not version. If an upgrade changes the exporter (renames the
``ProfilerStep#N`` ranges, moves the kernels to another category, drops
the lane metadata), the analyzer would degrade without a word: no steps
segmented, every capture one span. This module makes that drift loud in
``python -m apex_tpu_torch.analysis``: it captures two steps of a tiny
torch step under ``utils.timers.trace`` and ``step_annotation``, runs
parse -> segment -> classify -> partition over the capture, and reports
``profile.trace-schema`` on any broken link.

On the CPU it checks the aten-op lane (the ops the timeline reads there);
on the card it also checks the kernel lane (``kernel`` events inside the
steps), which is what makes the smoke worth having: the card's device
ops are what every ``--profile-analyze`` reads.
"""

import os
import tempfile
from typing import List

from apex_tpu_torch.analysis.findings import SEV_ERROR, Finding

__all__ = ["timeline_smoke_findings"]

_SITE = "apex_tpu_torch/monitor/xray/timeline/parser.py:1"
_RULE = "profile.trace-schema"
_STEPS = 2


def _drift(message: str, **data) -> Finding:
    return Finding(
        rule=_RULE,
        message=(f"{message} — the Chrome trace this torch's profiler writes "
                 f"no longer matches what the timeline parser reads; fix "
                 f"the parser (the one blessed reader) before any "
                 f"capture-based claim is trusted"),
        site=_SITE, severity=SEV_ERROR, data=data)


def timeline_smoke_findings(device="cpu") -> List[Finding]:
    """Capture and analyze a two-step trace on ``device``; findings on any
    schema drift (an empty list: the exporter still writes the step
    markers, the op events and a partition that sums to each span)."""
    import torch

    from apex_tpu_torch.monitor.xray import timeline
    from apex_tpu_torch.utils.timers import step_annotation, trace

    dev = torch.device(device)
    x = torch.ones((64, 64), device=dev)

    def step():
        return (x @ x).sum()

    step()  # first-call set-up outside the capture
    with tempfile.TemporaryDirectory(prefix="apex_tpu_torch_trace_smoke_") \
            as d:
        try:
            with trace(d):
                for i in range(_STEPS):
                    with step_annotation(i):
                        step()
                        if dev.type == "cuda":
                            torch.cuda.synchronize(dev)
        except Exception as e:  # the profiler itself unusable here
            return [_drift(f"torch.profiler capture failed: {e!r}")]
        try:
            tl, files = timeline.parse_logdir(d)
        except FileNotFoundError:
            return [_drift("the capture wrote no trace file")]
        except ValueError as e:
            return [_drift(f"trace file unparseable: {e}")]
        report = timeline.analyze(tl)

    findings: List[Finding] = []
    spans = tl.step_spans()
    if len(spans) < _STEPS:
        findings.append(_drift(
            f"segmented {len(spans)} step(s) from a capture of {_STEPS} "
            f"annotated steps (ProfilerStep#N ranges missing or unreadable)",
            steps_found=len(spans),
            files=[os.path.basename(f) for f in files]))
    lane = "kernel" if dev.type == "cuda" else "cpu_op"
    in_steps = [e for e in tl.device_op_events() if e.cat == lane and any(
        s.ts <= e.ts < s.end for s in spans)]
    if not in_steps:
        findings.append(_drift(
            f"no {lane} events inside the steps (the "
            f"{'card' if lane == 'kernel' else 'CPU'}'s op lane came up "
            f"empty for a matmul)", lane=lane))
    for s in report.steps:
        resid = abs(s.compute_us + s.exposed_collective_us
                    + s.exposed_memcpy_us + s.idle_us - s.span_us)
        if resid > 1e-6 * max(s.span_us, 1.0):
            findings.append(_drift(
                f"step {s.step} partition does not sum to its span "
                f"(residual {resid:.6f}us of {s.span_us:.3f}us)",
                step=s.step))
    return findings
