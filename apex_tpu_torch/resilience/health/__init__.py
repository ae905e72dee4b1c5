"""In-job incident response (counterpart of
apex_tpu/resilience/health/): the hung-job defense.

- ``incident``  — forensic bundle capture (:func:`capture_incident`,
  :func:`thread_stacks`): all-thread stacks, the in-process record-tail
  window, the last sentinel/rollback verdicts and a best-effort profiler
  arm, emitted as ``kind="incident"`` records.
- ``responder`` — :class:`IncidentResponder`, the warn -> dump ->
  terminate ladder over :class:`~apex_tpu_torch.monitor.StallWatchdog`,
  ending in a coordinated self-termination (interrupted-span flush and
  ``os._exit`` with :data:`INCIDENT_EXIT_CODE`).

Plain Python: the package must work precisely when the loop thread, the
card or the runtime is the thing that is wedged.
"""

from apex_tpu_torch.resilience.health.incident import (
    VERDICT_KINDS,
    capture_incident,
    thread_stacks,
)
from apex_tpu_torch.resilience.health.responder import (
    INCIDENT_EXIT_CODE,
    IncidentResponder,
)

__all__ = [
    "VERDICT_KINDS",
    "capture_incident",
    "thread_stacks",
    "INCIDENT_EXIT_CODE",
    "IncidentResponder",
]
