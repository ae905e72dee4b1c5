"""Concurrency x-ray: static race/deadlock analysis of the host runtime.

Counterpart of apex_tpu/analysis/concurrency/, run over the port's
threaded host runtime — watchdog poller + fire batch, incident
teardown, async checkpoint writer, MetricRouter SIGTERM/atexit
teardown, remediation controller, the serving fleet router — otherwise
hand-proved in
comments ("GIL-atomic identity-swap handshake", "the sink must never
take the controller lock"). This package puts the same gate discipline
behind those claims that the trace passes put behind the step: pure
AST (no execution, no torch import), whole-package, wired into
``python -m apex_tpu_torch.analysis``.

Four passes over one shared model (model.py):

- ``roots``     — thread/timer/executor/signal/atexit/callback root
  inventory + best-effort call graph; every edge the resolver cannot
  follow is ``concurrency.unresolved`` info, never silently dropped.
- ``shared``    — module globals and self-attributes written from ≥2
  roots without a common lock on every write path →
  ``concurrency.unguarded-write`` (error); benign patterns downgrade
  to named ``concurrency.shared-state`` info.
- ``lockgraph`` — lock-order cycles (``concurrency.lock-cycle``,
  error) and blocking calls — router fan-out, unbounded join/wait,
  file/subprocess I/O, imports — under a lock
  (``concurrency.blocking-under-lock`` /
  ``concurrency.unbounded-wait``, warnings).
- ``handlers``  — signal/atexit handler reach restricted to an
  async-signal-safe vocabulary (``concurrency.handler-unsafe``,
  error).

Findings flow through the same :class:`Finding`/Allowlist machinery as
every other pass; the repo's documented lock-free handshakes carry
``require_hit`` allowlist entries whose reasons ARE the hand-proofs —
when the code changes, the entry goes stale and the gate demands the
proof be re-made. Run standalone::

    from apex_tpu_torch.analysis.concurrency import run_concurrency
    findings = run_concurrency()           # scans apex_tpu_torch/
    findings = run_concurrency(files={...})  # synthetic (tests)
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from apex_tpu_torch.analysis.findings import Finding
from apex_tpu_torch.analysis.concurrency.model import Model, build_model
from apex_tpu_torch.analysis.concurrency import roots as _roots
from apex_tpu_torch.analysis.concurrency import shared as _shared
from apex_tpu_torch.analysis.concurrency import lockgraph as _lockgraph
from apex_tpu_torch.analysis.concurrency import handlers as _handlers

#: the concurrency scan covers the library only: examples drive the
#: blessed entry points (AutoResume, monitor wiring) and own no threads
SCAN_DIRS = ("apex_tpu_torch",)

#: pass registry, same shape as LINT_RULES / JAXPR_PASSES
CONCURRENCY_PASSES = {
    "roots": _roots.unresolved_findings,
    "shared": _shared.shared_state_findings,
    "lock-order": _lockgraph.lock_order_findings,
    "blocking": _lockgraph.blocking_findings,
    "handlers": _handlers.handler_findings,
}


def run_concurrency(
    files: Optional[Dict[str, str]] = None,
    root: Optional[str] = None,
    passes: Optional[Sequence[str]] = None,
) -> List[Finding]:
    """Build the model over ``files`` (default: scan ``apex_tpu_torch/``) and
    run ``passes`` (default all), returning raw findings — apply an
    Allowlist afterwards, exactly like the lint/trace passes."""
    if files is None:
        from apex_tpu_torch.analysis.lint import collect_sources

        files = collect_sources(root=root, scan_dirs=SCAN_DIRS)
    model = build_model(files)
    findings: List[Finding] = []
    for name in (passes or CONCURRENCY_PASSES):
        findings.extend(CONCURRENCY_PASSES[name](model))
    return findings


__all__ = [
    "CONCURRENCY_PASSES", "Model", "build_model", "run_concurrency",
    "SCAN_DIRS",
]
