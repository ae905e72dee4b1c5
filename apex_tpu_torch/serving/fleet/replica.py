"""One fleet replica: an engine, a heartbeat, and a remediation case.

The fleet's unit of failure is the replica — an engine incarnation that
can die (process loss: heartbeats stop, in-flight KV vanishes), stall,
or fall behind. The :class:`Replica` here wraps one
:class:`~apex_tpu_torch.serving.engine.ServingEngine` with exactly the
evidenced-action discipline the remediation policy applies to training faults, REUSING
its machinery rather than inventing a parallel one:

- **heartbeat**: every successful engine tick beats the replica; the
  router counts consecutive missed beats per fleet tick (tick-keyed,
  not wall-keyed — chaos drills replay deterministically) and a replica
  past ``miss_ticks_to_detect`` is a finding, not a guess.
- **case state machine**: a detected replica opens a case walked on the
  closed case machine (``resilience.remediation.policy.advance`` —
  detected → quarantined → probation → readmitted, with escalated as
  the bounded-retries ending). The response comes from the SAME
  :class:`~apex_tpu_torch.resilience.remediation.policy.RemediationPolicy`
  response table (``incident`` → restart), and ``max_restarts`` bounds
  replica restarts exactly as it bounds trainer restarts.
- **exit-code taxonomy**: a replica death is booked with
  ``ExitCode.INCIDENT`` (the restart-me code) and the restart decision
  routes through ``RESTARTABLE_EXIT_CODES`` — the supervisor's
  branch-on-code contract (resilience/exit_codes.py), applied to an
  in-process incarnation. A replica whose relaunch factory ITSELF
  fails books ``ExitCode.FAILURE`` and escalates: re-running does not
  fix a broken build.
- **probation/readmit**: a restarted replica serves under probation —
  dispatchable but watched — and the case closes ``recovered`` (or
  ``readmitted`` after a quarantine) only after ``probation_steps``
  clean ticks, the readmission contract.

Every health action emits a ``kind="fleet"`` ``check="replica"`` record
through the shared router, so the failover story is a stream query like
every other recovery story in the tree.
"""

import logging
from typing import Callable, Optional

from apex_tpu_torch.resilience.exit_codes import (
    RESTARTABLE_EXIT_CODES,
    ExitCode,
)
from apex_tpu_torch.resilience.remediation.policy import (
    TERMINAL_VERDICTS,
    RemediationPolicy,
    advance,
)

logger = logging.getLogger("apex_tpu_torch.serving")

__all__ = ["Replica"]


class Replica:
    """One engine incarnation under fleet health management
    (module docstring).

    ``engine_factory(name, incarnation)`` builds (but does not start) a
    fresh engine; :meth:`start` compiles it. ``role`` partitions the
    fleet for disaggregation: ``"prefill"`` replicas run prompt
    ingestion only (their decodes are handed off), ``"decode"``
    replicas adopt handoffs, ``"any"`` replicas do both (the unified
    topology).
    """

    def __init__(self, name: str,
                 engine_factory: Callable[[str, int], object],
                 role: str = "any",
                 policy: Optional[RemediationPolicy] = None,
                 router=None):
        if role not in ("any", "prefill", "decode"):
            raise ValueError(
                f"replica role must be any/prefill/decode, got {role!r}"
            )
        self.name = str(name)
        self.role = role
        self.policy = policy if policy is not None else RemediationPolicy()
        self.router = router
        self._factory = engine_factory
        self.incarnation = 0
        self.engine = engine_factory(self.name, self.incarnation)
        self._stamp_trace_site()
        self.alive = True
        self.missed_beats = 0
        self.restarts = 0
        #: open remediation case: None = healthy, else a policy.STATES
        #: member; terminal verdicts close the case back to None
        self.case_state: Optional[str] = None
        self.case_kind: Optional[str] = None
        self._probation_clean = 0

    def _stamp_trace_site(self) -> None:
        """Name the engine's trace-span emitter after THIS incarnation
        (``r0.1`` = replica r0's first restart): span ids stay unique
        across restarts, and the x-ray shows which incarnation did the
        work. getattr-guarded — test fakes need not carry an emitter."""
        tr = getattr(self.engine, "trace", None)
        if tr is not None:
            tr.site = f"{self.name}.{self.incarnation}"

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "Replica":
        self.engine.start()
        return self

    def kill(self) -> None:
        """The chaos process-death shape: heartbeats stop, the engine
        is never ticked again, its in-flight KV is gone. Nothing is
        booked HERE — detection must come from the missed heartbeats,
        exactly like a real dead process."""
        self.alive = False

    def beat(self) -> None:
        self.missed_beats = 0

    def miss(self) -> None:
        self.missed_beats += 1

    @property
    def dispatchable(self) -> bool:
        """May the router place NEW work here? Excludes replicas with an
        open case past detection (quarantined/escalated) — but NOT
        undetected-dead ones: the router has no oracle for a silent
        death, which is why re-dispatch exists."""
        return self.case_state not in ("quarantined", "escalated")

    @property
    def healthy(self) -> bool:
        return self.alive and self.case_state is None

    # -- the case machine ---------------------------------------------------

    def _event(self, tick: int, action: str, **fields) -> None:
        if self.router is not None:
            self.router.event(
                "fleet", int(tick), check="replica", replica=self.name,
                action=action, state=self.case_state,
                incarnation=self.incarnation, **fields,
            )

    def detect(self, tick: int, kind: str = "incident") -> str:
        """Open a case for this replica (missed-heartbeat evidence);
        returns the policy's configured response. The case starts
        ``detected`` — what happens next is a policy row, not a router
        improvisation."""
        if self.case_state is not None:
            raise ValueError(
                f"replica {self.name} already has an open case "
                f"({self.case_state}); one case per fault"
            )
        self.case_state = "detected"
        self.case_kind = kind
        response = self.policy.response_for(kind)
        self._event(tick, "detected", case_kind=kind, response=response,
                    missed_beats=self.missed_beats)
        logger.warning(
            "fleet: replica %s detected %s (%d missed beats) -> %s",
            self.name, kind, self.missed_beats, response,
        )
        return response

    def quarantine(self, tick: int) -> None:
        """detected -> quarantined: out of the dispatch set while the
        failover path re-homes its work."""
        self.case_state = advance(self.case_state, "quarantined")
        self._event(tick, "quarantined")

    def restart(self, tick: int) -> bool:
        """Relaunch a fresh engine incarnation under the supervisor's
        exit-code contract: the dead incarnation is booked
        ``ExitCode.INCIDENT`` (restartable); a restart past the
        policy's ``max_restarts`` budget — or a factory that itself
        fails (``ExitCode.FAILURE``, not restartable) — escalates
        instead. True when the replica is back (in probation)."""
        exit_code = ExitCode.INCIDENT
        if (exit_code not in RESTARTABLE_EXIT_CODES
                or self.restarts >= self.policy.max_restarts):
            return self._escalate(
                tick, f"restart budget exhausted "
                      f"({self.restarts}/{self.policy.max_restarts})",
                exit_code=int(exit_code))
        try:
            engine = self._factory(self.name, self.incarnation + 1)
            engine.start()
        except Exception as e:
            logger.exception("fleet: replica %s relaunch failed", self.name)
            return self._escalate(
                tick, f"relaunch failed: {type(e).__name__}",
                exit_code=int(ExitCode.FAILURE))
        self.engine = engine
        self.incarnation += 1
        self._stamp_trace_site()
        self.restarts += 1
        self.alive = True
        self.missed_beats = 0
        self._probation_clean = 0
        self.case_state = advance(self.case_state, "probation")
        self._event(tick, "restarted", exit_code=int(exit_code),
                    restarts=self.restarts)
        logger.info(
            "fleet: replica %s restarted (incarnation %d, exit code %d "
            "adopted) — on probation for %d clean ticks",
            self.name, self.incarnation, int(exit_code),
            self.policy.probation_steps,
        )
        return True

    def _escalate(self, tick: int, reason: str, exit_code: int) -> bool:
        self.case_state = advance(self.case_state, "escalated")
        self.alive = False
        self._event(tick, "escalated", reason=reason, exit_code=exit_code,
                    verdict=TERMINAL_VERDICTS["escalated"])
        logger.error("fleet: replica %s escalated: %s", self.name, reason)
        return False

    def probation_tick(self, tick: int) -> None:
        """One clean serving tick under probation; closes the case
        ``recovered`` (restart path) once the policy's probation length
        passes — the readmission contract."""
        if self.case_state != "probation":
            return
        self._probation_clean += 1
        if self._probation_clean >= self.policy.probation_steps:
            self.case_state = advance(self.case_state, "recovered")
            verdict = TERMINAL_VERDICTS["recovered"]
            self._event(tick, "readmitted", verdict=verdict,
                        clean_ticks=self._probation_clean)
            self.case_state = None
            self.case_kind = None
            logger.info("fleet: replica %s case closed (%s)",
                        self.name, verdict)

    # -- load signals -------------------------------------------------------

    @property
    def load(self) -> int:
        """Dispatch-ordering signal: queued + in-flight requests."""
        eng = self.engine
        return len(eng._queue) + len(eng._active)

    def stats(self) -> dict:
        return {
            "name": self.name,
            "role": self.role,
            "alive": self.alive,
            "incarnation": self.incarnation,
            "restarts": self.restarts,
            "case_state": self.case_state,
            "case_kind": self.case_kind,
            "load": self.load,
        }
