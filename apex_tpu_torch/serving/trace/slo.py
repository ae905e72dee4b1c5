"""SLO burn-rate monitor: rolling error-budget accounting per request.

An SLO is a promise with a budget: "99% of requests get first token
within the TTFT budget" leaves 1% of requests allowed to miss. The
BURN RATE is how fast the fleet is spending that allowance — the SRE
multi-window idiom: burn rate 1.0 exhausts the budget exactly at the
window's natural pace; a fast-burn alert (default 14.4x, the classic
"1-hour window spends a 30-day budget in ~2 days" multiplier) means the
fleet is hemorrhaging budget NOW and paging/scaling is justified on far
fewer samples than a raw violation-rate threshold would need.

Wiring (the ControllerSink enqueue-drain idiom — never do work inside
the MetricRouter fan-out, a sink that re-enters ``router.event`` would
deadlock on the router lock):

- :meth:`SLOMonitor.sink` returns a Sink that ENQUEUES terminal
  ``kind="request"`` records and nothing else;
- :meth:`SLOMonitor.poll` — called by the fleet tick, outside fan-out —
  drains the queue into a count-based rolling window, classifies each
  terminal (shed / failed / timed-out / TTFT over budget = violation),
  and emits one ``kind="slo"`` record whenever the window moved or the
  alert state flipped;
- the ``alert`` field is the fast-burn verdict. The fleet feeds it to
  the autoscaler's debounce as SECONDARY evidence (a breach tick counts
  double while burning; sheds burn budget even when the TTFT signal
  looks healthy) and the remediation controller consumes alerting
  ``kind="slo"`` records as evidence like any detector finding.

Classification is deliberately one-sided: CANCELLED is the client's
choice and spends no budget (unless the first token was already late),
while a shed (REJECTED) is ALWAYS a violation — admission control
protects the served requests' latency by spending error budget, and
the monitor makes that spend visible instead of letting load shedding
launder an overload into a clean TTFT histogram.

This module is the ONE blessed construction site for ``kind="slo"``
records. Copied from apex_tpu/serving/trace/slo.py, which imports no
JAX.
"""

from collections import deque
from typing import Deque, Optional, Tuple

from apex_tpu_torch.monitor.router import Sink

__all__ = ["FAST_BURN", "SLOMonitor"]

#: default fast-burn alert multiplier (Google SRE workbook: the 14.4x
#: page-now threshold)
FAST_BURN = 14.4

#: terminal states that always spend error budget
_VIOLATION_STATES = frozenset({"rejected", "failed", "timed_out"})


class _Tap(Sink):
    """Enqueue-only sink: terminal request records in, nothing else —
    all classification happens at :meth:`SLOMonitor.poll` time."""

    def __init__(self, pending: Deque[dict]):
        self._pending = pending

    def emit(self, record: dict) -> None:
        if record.get("kind") == "request" and record.get("terminal"):
            self._pending.append(record)


class SLOMonitor:
    """Rolling-window error-budget accountant (module docstring).

    ``target`` is the SLO fraction (0.99 = 1% budget); ``window`` is
    count-based (last N terminals) so virtual-time chaos drills and
    wall-clock fleets share one definition; ``min_count`` keeps a
    two-request fleet from paging on its first shed.
    """

    def __init__(self, router, ttft_budget_s: float,
                 target: float = 0.99, window: int = 64,
                 min_count: int = 8, fast_burn: float = FAST_BURN):
        if not (0.0 < target < 1.0):
            raise ValueError(
                f"slo target must be in (0, 1), got {target!r} — "
                f"target 1.0 has zero budget and every burn rate is "
                f"infinite")
        self.router = router
        self.ttft_budget_s = float(ttft_budget_s)
        self.target = float(target)
        self.window = int(window)
        self.min_count = int(min_count)
        self.fast_burn = float(fast_burn)
        self._pending: Deque[dict] = deque()
        #: (violation?, state) per terminal, newest right
        self._seen: Deque[Tuple[bool, str]] = deque(maxlen=self.window)
        self._burning = False
        self._last: Optional[dict] = None

    def sink(self) -> Sink:
        """The enqueue-only tap to register on the shared router."""
        return _Tap(self._pending)

    @property
    def burning(self) -> bool:
        """Fast-burn alert as of the last :meth:`poll`."""
        return self._burning

    @property
    def last(self) -> Optional[dict]:
        """The most recent ``kind="slo"`` record's fields (None before
        the first emission)."""
        return self._last

    def _violation(self, record: dict) -> bool:
        state = record.get("state")
        if state in _VIOLATION_STATES:
            return True
        ttft = record.get("ttft_s")
        return ttft is not None and float(ttft) > self.ttft_budget_s

    def poll(self, tick: int) -> Optional[dict]:
        """Drain the tap, roll the window, emit when something moved.

        Returns the emitted ``kind="slo"`` record (None when the window
        neither grew nor flipped alert state — a quiet fleet does not
        spam the stream with identical rows)."""
        moved = False
        while self._pending:
            record = self._pending.popleft()
            self._seen.append(
                (self._violation(record), str(record.get("state"))))
            moved = True
        n = len(self._seen)
        violations = sum(1 for v, _ in self._seen if v)
        rate = (violations / n) if n else 0.0
        burn = rate / (1.0 - self.target)
        burning = n >= self.min_count and burn >= self.fast_burn
        flipped = burning != self._burning
        self._burning = burning
        if not (moved or flipped):
            return None
        sheds = sum(1 for v, s in self._seen if v and s == "rejected")
        fields = {
            "window": self.window,
            "n": n,
            "violations": violations,
            "sheds": sheds,
            "burn_rate": burn,
            "alert": burning,
            "ttft_budget_s": self.ttft_budget_s,
            "target": self.target,
        }
        self._last = fields
        if self.router is None:
            return None
        return self.router.event("slo", int(tick), **fields)
