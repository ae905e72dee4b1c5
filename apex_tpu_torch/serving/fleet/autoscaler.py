"""SLO-driven elastic scaling: the TTFT budget signal drives fleet size.

The admission estimator (``ServingEngine.estimated_ttft_s``) already
computes, per replica, the wait a NEW submission would see — the exact
quantity the TTFT SLO bounds. The engine uses it to SHED (refuse work the
replica cannot serve in budget); the autoscaler here uses the same
signal to GROW: when the fleet-wide estimate (the minimum over
dispatchable replicas — a new request goes to the least-loaded one, so
the fleet is overloaded only when even the BEST placement breaches)
holds above the budget for ``breach_ticks`` consecutive fleet ticks,
the fleet is under-provisioned and a replica is added; when it holds
below ``low_water`` x budget for ``clear_ticks``, a replica is surplus
and one is drained away.

Hysteresis is load-bearing, not decoration: serving load is bursty by
construction (the Poisson arrivals the drills replay), and a scaler
that reacts to single-tick spikes oscillates — paying a compile burst
on every flap. Consecutive-tick counters + the low-water gap between
the up and down thresholds are the standard two-sided debounce.

The scaler only DECIDES (``observe`` returns ``"scale_up"`` /
``"scale_down"`` / None); the router executes — scale-up through the
engine factory with the compile burst booked as the new replica's own
``compile`` span (and survivors' watchers re-anchored,
``acknowledge_compiles``), scale-down through ``drain(deadline=)`` so
the victim's in-flight requests all reach terminal states before it
leaves. Every decision is a ``kind="fleet"`` ``check="autoscale"``
record: the drill asserts the scale-up happened by QUERYING THE STREAM,
not by trusting a counter.

Copied from apex_tpu/serving/fleet/autoscaler.py, which imports no JAX.
"""

import logging
from typing import Optional

logger = logging.getLogger("apex_tpu_torch.serving")

__all__ = ["FleetAutoscaler"]


class FleetAutoscaler:
    """Two-sided debounced scaling decisions (module docstring).

    ``observe(tick, signal_s, n_replicas, burning=False)`` with the
    fleet's current best-placement TTFT estimate (None until any
    replica's estimator arms — cold fleets neither grow nor shrink on
    no evidence) returns the decided action or None. ``burning`` is the
    SLO monitor's fast-burn alert (trace/slo.py): secondary evidence
    that counts toward the breach debounce even when the estimator has
    no signal (a shed-heavy fleet burns error budget without ever
    breaching the estimate), doubles the count when both agree, and
    vetoes the clear path — a fleet on fire never looks surplus.
    """

    def __init__(self, ttft_budget_s: float,
                 min_replicas: int, max_replicas: int,
                 breach_ticks: int = 3, clear_ticks: int = 20,
                 low_water: float = 0.25, router=None):
        if ttft_budget_s <= 0:
            raise ValueError(
                f"ttft_budget_s must be > 0, got {ttft_budget_s}")
        if not (1 <= min_replicas <= max_replicas):
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{min_replicas}/{max_replicas}")
        if breach_ticks < 1 or clear_ticks < 1:
            raise ValueError("breach_ticks and clear_ticks must be >= 1")
        if not (0.0 < low_water < 1.0):
            raise ValueError(
                f"low_water must be in (0, 1), got {low_water}")
        self.ttft_budget_s = float(ttft_budget_s)
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.breach_ticks = int(breach_ticks)
        self.clear_ticks = int(clear_ticks)
        self.low_water = float(low_water)
        self.router = router
        self._breaches = 0
        self._clears = 0
        self.scale_ups = 0
        self.scale_downs = 0

    def observe(self, tick: int, signal_s: Optional[float],
                n_replicas: int, burning: bool = False) -> Optional[str]:
        """One fleet tick of evidence; returns the decided action."""
        if signal_s is None and not burning:
            # no estimator armed anywhere and no burn alert: no
            # evidence, no action, and the debounce counters hold (a
            # dead spot in the signal must not count as "cleared")
            return None
        breach = signal_s is not None and signal_s > self.ttft_budget_s
        if breach or burning:
            # the burn alert counts as a breach tick on its own (sheds
            # burn error budget without a TTFT estimate); when BOTH the
            # estimator and the burn window agree, the evidence is
            # corroborated — count double so the debounce halves
            self._breaches += 1 + (1 if (breach and burning) else 0)
            self._clears = 0
        elif (signal_s is not None
                and signal_s < self.low_water * self.ttft_budget_s):
            self._clears += 1
            self._breaches = 0
        else:
            # the hysteresis band: healthy, but not surplus
            self._breaches = 0
            self._clears = 0
        action = None
        if (self._breaches >= self.breach_ticks
                and n_replicas < self.max_replicas):
            action = "scale_up"
            self.scale_ups += 1
            self._breaches = 0
            logger.warning(
                "fleet autoscale: TTFT evidence (estimate %s, budget "
                "%.3fs, slo_burning=%s) held for %d ticks — scaling "
                "%d -> %d replicas",
                ("n/a" if signal_s is None else f"{signal_s:.3f}s"),
                self.ttft_budget_s, burning, self.breach_ticks,
                n_replicas, n_replicas + 1,
            )
        elif (self._clears >= self.clear_ticks
                and n_replicas > self.min_replicas):
            action = "scale_down"
            self.scale_downs += 1
            self._clears = 0
            logger.info(
                "fleet autoscale: TTFT estimate %.3fs held below %.0f%% "
                "of budget for %d ticks — scaling %d -> %d replicas",
                signal_s, 100 * self.low_water, self.clear_ticks,
                n_replicas, n_replicas - 1,
            )
        if action is not None and self.router is not None:
            self.router.event(
                "fleet", int(tick), check="autoscale", action=action,
                signal_s=(None if signal_s is None else float(signal_s)),
                budget_s=self.ttft_budget_s,
                replicas=int(n_replicas), slo_burning=bool(burning),
            )
        return action

    def stats(self) -> dict:
        return {
            "scale_ups": self.scale_ups,
            "scale_downs": self.scale_downs,
            "breach_streak": self._breaches,
            "clear_streak": self._clears,
        }
