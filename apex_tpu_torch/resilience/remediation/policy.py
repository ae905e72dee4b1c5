"""Remediation policy: the closed action state machine + the response
table that maps detector findings to bounded recovery actions.

The controller (controller.py) is deliberately dumb about *what to do*:
every decision it takes is a row in this module — a closed transition
graph (the serving ``lifecycle.py`` idiom: ``advance`` refuses
unregistered edges, terminal states absorb) plus a
:class:`RemediationPolicy` whose fields bound every action (canary
verification before any restart, probation length, restart budget,
quarantine granularity). A policy change is therefore reviewable as a
data change, and the chaos campaign (campaign.py) can prove a policy
table against seeded fault sequences — including the deliberately
broken ``verify_before_quarantine=False`` table the false-positive pin
must catch.

Case kinds (what the detectors report):

=============  ============================================  ==========
kind           source                                        response
=============  ============================================  ==========
straggler      ``kind="fleet"`` ``check="straggler"``        verify
corruption     ``kind="fleet"`` ``check="corruption"``       verify
stall          ``kind="stall"`` (watchdog warn)              verify
sentinel       ``kind="skip"`` / ``kind="rollback"``         observe
sdc            canary-audit divergence / ``kind="divergence"``  quarantine
incident       exit-43 adoption (supervisor ``pending``)     restart
preemption     SIGTERM termination (``on_preemption``)       restart
halt           ``kind="halt"`` (escalation ladder exhausted) escalate
slo            ``kind="slo"`` ``alert=True`` (burn monitor)  observe
memory         ``kind="memory"`` ``headroom_breach=True``    observe
=============  ============================================  ==========

Responses:

- **verify** — canary re-execution of the suspect segment through the
  replayer before ANY restart: a robust-z blip whose computation
  replays bitwise-clean is a transient (thermal throttle, noisy
  neighbor) and the case closes ``cleared`` with zero restarts. Only a
  canary CONFIRMATION (the replay disagrees with the journal) may
  quarantine.
- **observe** — the in-step ladder (sentinel skip/rollback) already
  acted; the case just tracks the recovery and closes ``recovered``
  after ``clean_steps_to_close`` clean steps.
- **quarantine** — exclude devices, tombstone the checkpoints carrying
  the confirmed corruption, restart on the reduced topology from the
  clean anchor, probation, then readmit (4→8) when
  ``probation_steps`` clean steps pass.
- **restart** — resume on the SAME topology (the fault was external:
  preemption, a wedged process the incident responder killed), then
  close ``recovered`` after probation.
- **escalate** — bounded retries exhausted or no admissible topology
  left: halt the job (``ExitCode.REMEDIATION_HALT``) instead of
  burning goodput on a fault the machinery already failed to heal.

State machine (``TRANSITIONS``)::

    detected ──verify──▶ verifying ──clean──▶ cleared (terminal)
       │                    └──confirmed──▶ quarantined
       ├──observe──▶ observing ──N clean──▶ recovered (terminal)
       ├──quarantine──▶ quarantined ──restart──▶ probation
       ├──restart──▶ probation ──N clean──▶ readmitted/recovered
       └──escalate──▶ escalated (terminal)          (terminal)

Copied from apex_tpu/resilience/remediation/policy.py, which imports
no JAX.
"""

import dataclasses
from typing import Dict, FrozenSet, Mapping, Tuple

__all__ = [
    "CASE_KINDS",
    "RESPONSES",
    "STATES",
    "TERMINAL_STATES",
    "TRANSITIONS",
    "TERMINAL_VERDICTS",
    "RemediationPolicy",
    "advance",
]

#: every detector finding the controller opens a case for
CASE_KINDS = (
    "straggler", "corruption", "stall", "sentinel", "sdc",
    "incident", "preemption", "halt", "slo", "memory",
)

#: the closed response vocabulary (module docstring)
RESPONSES = ("verify", "observe", "quarantine", "restart", "escalate")

#: case states; terminal states absorb (the lifecycle.py contract)
STATES = (
    "detected", "verifying", "observing", "quarantined", "probation",
    "cleared", "recovered", "readmitted", "escalated",
)

TERMINAL_STATES: FrozenSet[str] = frozenset(
    {"cleared", "recovered", "readmitted", "escalated"}
)

#: the closed edge set: state -> states reachable from it. ``advance``
#: refuses anything else — an undrilled recovery path must fail loudly
#: at the transition, not improvise.
TRANSITIONS: Dict[str, Tuple[str, ...]] = {
    "detected": ("verifying", "observing", "quarantined", "probation",
                 "escalated"),
    "verifying": ("cleared", "quarantined", "observing", "escalated"),
    "observing": ("recovered", "escalated"),
    "quarantined": ("probation", "escalated"),
    "probation": ("readmitted", "recovered", "escalated"),
    "cleared": (),
    "recovered": (),
    "readmitted": (),
    "escalated": (),
}

#: terminal state -> the verdict its closing record carries
TERMINAL_VERDICTS: Dict[str, str] = {
    "cleared": "cleared",
    "recovered": "recovered",
    "readmitted": "readmitted",
    "escalated": "halted",
}

assert set(TRANSITIONS) == set(STATES)
assert all(s in STATES for outs in TRANSITIONS.values() for s in outs)
assert set(TERMINAL_VERDICTS) == set(TERMINAL_STATES)
assert all(not TRANSITIONS[s] for s in TERMINAL_STATES)


def advance(state: str, new_state: str) -> str:
    """``new_state`` if the edge ``state -> new_state`` is registered,
    else ``ValueError`` (terminal states absorb nothing — closing a
    closed case is a controller bug, not a policy question)."""
    if state not in TRANSITIONS:
        raise ValueError(f"unknown case state {state!r} (have {STATES})")
    if new_state not in TRANSITIONS[state]:
        raise ValueError(
            f"unregistered case transition {state!r} -> {new_state!r} "
            f"(registered: {TRANSITIONS[state] or 'none — terminal'})"
        )
    return new_state


#: the default response table (module docstring). ``sdc`` cases arrive
#: PRE-verified — the canary audit or the divergence bisector already
#: re-executed the segment — so their response is quarantine directly;
#: re-verifying would replay the same evidence twice.
_DEFAULT_RESPONSES: Dict[str, str] = {
    "straggler": "verify",
    "corruption": "verify",
    "stall": "verify",
    "sentinel": "observe",
    "sdc": "quarantine",
    "incident": "restart",
    "preemption": "restart",
    "halt": "escalate",
    # an SLO fast-burn alert is a SYMPTOM, not a located fault: the
    # autoscaler/fleet machinery is already reacting (the alert vetoes
    # scale-down debounce), so the case just tracks whether the burn
    # clears — restarting replicas on a demand spike would convert
    # badput into MORE badput
    "slo": "observe",
    # an HBM headroom breach (the x-ray watermark monitor,
    # monitor.xray.hbm.live) is likewise a symptom: restarting cannot
    # shrink a footprint the config books — the case tracks whether
    # the watermark recedes, and the FIX is a knob change (the OOM
    # forensics' suggestions), a human decision
    "memory": "observe",
}


@dataclasses.dataclass(frozen=True)
class RemediationPolicy:
    """Bounds for every automated action (module docstring).

    - ``verify_before_quarantine``: the canary gate. ``False`` is the
      DELIBERATELY BROKEN table the campaign's false-positive pin must
      catch (a quarantine record with no confirming verify record is an
      invariant violation) — never ship it.
    - ``canary_audit``: periodically re-execute the newest journaled
      segment at checkpoint anchors, so silent corruption (the fault no
      streaming detector sees) is caught within one anchor interval.
      Costs roughly one extra execution of each audited segment, booked
      honestly as ``phase="remediation"`` badput.
    - ``probation_steps``: clean steps a quarantined (or restarted)
      incarnation must run before the case closes / the excluded
      devices are readmitted.
    - ``clean_steps_to_close``: clean steps that close an ``observing``
      case (the sentinel already healed the step; this just confirms).
    - ``max_restarts``: total controller-driven restarts per job before
      escalate-to-halt.
    - ``min_devices``: refuse to quarantine below this device count —
      escalate instead.
    - ``quarantine_fraction``: the topology slice excluded when the
      suspect is unattributable (a single-host SDC names a leaf, not a
      device): the upper ``fraction`` of device ordinals is excluded
      and re-verified under probation. Halving keeps every power-of-two
      batch geometry divisible; finer granularity needs attributable
      suspects AND a divisible geometry, which the controller refuses
      to guess.
    - ``responses``: the finding -> response table; every key must be a
      :data:`CASE_KINDS` member and every value a :data:`RESPONSES`
      member (validated — an ad-hoc response string is exactly the
      improvisation the closed machine exists to prevent).
    """

    verify_before_quarantine: bool = True
    canary_audit: bool = True
    probation_steps: int = 4
    clean_steps_to_close: int = 2
    max_restarts: int = 4
    min_devices: int = 1
    quarantine_fraction: float = 0.5
    responses: Mapping[str, str] = dataclasses.field(
        default_factory=lambda: dict(_DEFAULT_RESPONSES)
    )

    def __post_init__(self):
        if self.probation_steps < 1:
            raise ValueError(
                f"probation_steps must be >= 1, got {self.probation_steps}"
            )
        if self.clean_steps_to_close < 1:
            raise ValueError(
                f"clean_steps_to_close must be >= 1, got "
                f"{self.clean_steps_to_close}"
            )
        if self.max_restarts < 0:
            raise ValueError(
                f"max_restarts must be >= 0, got {self.max_restarts}"
            )
        if not (0.0 < self.quarantine_fraction < 1.0):
            raise ValueError(
                f"quarantine_fraction must be in (0, 1), got "
                f"{self.quarantine_fraction}"
            )
        unknown_kinds = set(self.responses) - set(CASE_KINDS)
        if unknown_kinds:
            raise ValueError(
                f"responses table names unknown case kind(s) "
                f"{sorted(unknown_kinds)} (have {CASE_KINDS})"
            )
        bad = {k: v for k, v in self.responses.items() if v not in RESPONSES}
        if bad:
            raise ValueError(
                f"responses table uses unregistered response(s) {bad} "
                f"(registered: {RESPONSES})"
            )

    def response_for(self, kind: str) -> str:
        """The configured response for a finding ``kind`` (defaults to
        the table above for kinds the custom table omits)."""
        return self.responses.get(kind, _DEFAULT_RESPONSES[kind])
