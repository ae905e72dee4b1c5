"""Live fleet health: the offline divergence checks, run IN the job
(counterpart of apex_tpu/monitor/goodput/live.py, copied as it is
there: plain Python).

:class:`LiveFleetMonitor` runs ``detect_divergence`` periodically over a
rolling in-process :class:`~apex_tpu_torch.monitor.router.MemorySink`
window and emits ``kind="fleet"`` records while the job runs: one
``check="summary"`` record per check (proof that the check RAN), and the
offline detector's ``check="straggler"`` / ``check="corruption"`` records
for anything flagged. Single-host runs emit summaries with ``n_hosts=1``
and can never flag (straggler math needs >= 3 hosts, corruption >= 2).
The window should carry ``kinds=("span", "metrics")``.
"""

import logging
from typing import Optional, Sequence

from apex_tpu_torch.monitor.goodput.fleet import FleetReport, detect_divergence

logger = logging.getLogger("apex_tpu_torch.monitor.goodput")

__all__ = ["LiveFleetMonitor"]


class LiveFleetMonitor:
    """Periodic in-job fleet-health checks over a record window.

    Call :meth:`maybe_check` once per step; every ``interval_steps``
    steps it replays the window through ``detect_divergence`` and emits
    the records described in the module docstring. The first call only
    anchors the cadence (a fresh window has nothing sound to judge).
    """

    def __init__(
        self,
        router,
        window,
        interval_steps: int = 50,
        z_threshold: float = 4.0,
        rtol: float = 1e-5,
        fields: Sequence[str] = ("loss", "grad_norm"),
        min_hosts_for_straggler: int = 3,
    ):
        if interval_steps < 1:
            raise ValueError(
                f"interval_steps must be >= 1, got {interval_steps}"
            )
        self.router = router
        self.window = window
        self.interval_steps = int(interval_steps)
        self.z_threshold = z_threshold
        self.rtol = rtol
        self.fields = tuple(fields)
        self.min_hosts_for_straggler = min_hosts_for_straggler
        self.reports: list = []
        self._last_check: Optional[int] = None

    def maybe_check(self, step: int) -> Optional[FleetReport]:
        """Run the divergence check when the cadence is due; returns the
        report (None when not due / on the anchoring first call)."""
        step = int(step)
        if self._last_check is None:
            self._last_check = step
            return None
        if step - self._last_check < self.interval_steps:
            return None
        self._last_check = step
        # snapshot(): the watchdog thread emits stall SPANS into the same
        # window concurrently — a raw deque iteration can raise mid-check
        report = detect_divergence(
            self.window.snapshot(),
            z_threshold=self.z_threshold,
            rtol=self.rtol,
            fields=self.fields,
            min_hosts_for_straggler=self.min_hosts_for_straggler,
        )
        self.reports.append(report)
        self.router.event(
            "fleet", step, check="summary", ok=report.ok,
            n_hosts=len(report.hosts),
            stragglers=len(report.stragglers),
            suspects=len(report.suspects),
        )
        for rec in report.to_records(step=step):
            self.router.emit(rec)
        if not report.ok:
            logger.warning("live fleet check flagged divergence:\n%s",
                           report.summary())
        return report
