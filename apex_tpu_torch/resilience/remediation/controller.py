"""The remediation controller: detector findings in, bounded recovery
actions out (counterpart of
apex_tpu/resilience/remediation/controller.py).

The trust layer detects everything — the stall ladder, the fleet
straggler/SDC flags, the sentinel verdicts, the replay referee — and
until now a human turned those findings into fixes.
:class:`RemediationController` closes that loop as a host-side state
machine over :mod:`~apex_tpu_torch.resilience.remediation.policy`'s closed
transition graph:

- **detect** — detector records (``kind="fleet"``/``"stall"``/
  ``"skip"``/``"rollback"``/``"halt"``/``"divergence"``, plus serving's
  ``kind="slo"`` burn-rate alerts) open a *case*;
  :class:`ControllerSink` taps them straight off the MetricRouter so
  the wiring is one ``add_sink`` call, and repeated flags for the same
  (kind, suspect) attach as evidence to the open case instead of
  fanning out.
- **verify** — before any restart, the suspect segment is re-executed
  through the replayer (the injected ``canary_fn``): a robust-z
  blip whose computation replays clean closes ``cleared`` with ZERO
  restarts — the false-positive path is first-class, not an accident.
- **quarantine** — a CONFIRMED corruption excludes devices
  (``RemediationPolicy.quarantine_fraction``), moves the checkpoints
  carrying the corruption aside (``state.quarantine_checkpoints`` —
  reversible, evidence-preserving), persists the plan, and requests a
  restart on the reduced topology (``ExitCode.REMEDIATION_RESTART``);
  the next incarnation elastic-restores the clean anchor via the
  resharder (``resilience.elastic``).
- **probation / readmit** — the reduced incarnation must run
  ``probation_steps`` clean steps; then the exclusion is lifted and a
  second restart readmits the full topology.
- **escalate-to-halt** — the restart budget or the minimum topology is
  a hard floor: past it the controller emits a terminal ``halted``
  verdict and requests ``ExitCode.REMEDIATION_HALT``.

Every transition is ONE ``kind="remediation"`` record with the
triggering detector records attached as ``evidence`` (the
incident-bundle idiom: the record is the post-mortem), and every
expensive action (the canary) runs inside a ``phase="remediation"``
goodput span — which outranks ``step`` in PHASE_PRIORITY, so automated
recovery time books as badput, never silently productive.

The controller DECIDES; the hosting loop ACTS: :meth:`poll` hands back
a :class:`RemediationDecision` (restart/halt + exit code + target
topology) and the loop exits with it — the supervisor
(supervisor.py) or the in-process campaign runner performs the actual
relaunch. In-process state mutation of a live topology is exactly
the improvisation the closed machine refuses.

At world > 1 every rank of the layout runs its own controller over the
same inputs, so every rank reaches the same decision at the same step:
the hosting loop hands every rank the first rank's detector records
(:meth:`RemediationController.queued` and :meth:`replace_queue`) and
the canary every rank the first rank's verdict. Only the ``writer``
(the first rank) persists the state and moves checkpoints.

Thread-safe (RLock): :class:`ControllerSink` delivers records from
whatever thread emits them — the stall watchdog warns from its own
daemon thread — while the training loop drives :meth:`process`/
:meth:`poll` from the main thread. Host-only: the canary is an injected
callable, so the machine itself is auditable anywhere.
"""

import collections
import dataclasses
import logging
import threading
from typing import Callable, Dict, List, Optional

from apex_tpu_torch.monitor.goodput.spans import span as _goodput_span
from apex_tpu_torch.monitor.router import Sink, make_record
from apex_tpu_torch.resilience.exit_codes import ExitCode
from apex_tpu_torch.resilience.remediation.policy import (
    TERMINAL_VERDICTS,
    RemediationPolicy,
    advance,
)
from apex_tpu_torch.resilience.remediation.state import (
    RemediationState,
    quarantine_checkpoints,
)

logger = logging.getLogger("apex_tpu_torch.resilience.remediation")

__all__ = [
    "DETECTOR_KINDS",
    "RemediationDecision",
    "RemediationController",
    "ControllerSink",
    "after_step",
    "sync_queue",
]

#: record kinds the controller consumes as detector findings.
#: ``slo`` is the serving burn-rate monitor's stream (trace/slo.py):
#: only records with ``alert=True`` open a case — the monitor emits
#: window summaries continuously, and a healthy window is evidence the
#: check ran, not a finding. ``memory`` is the HBM x-ray's watermark
#: stream (monitor.xray.hbm.live) under the same contract: only
#: ``headroom_breach=True`` rows open a case.
DETECTOR_KINDS = frozenset({
    "fleet", "stall", "skip", "rollback", "halt", "divergence", "slo",
    "memory",
})

#: evidence records kept verbatim per case (the rest are counted — a
#: week of straggler flags must not turn one record into a megabyte)
_EVIDENCE_CAP = 6


@dataclasses.dataclass(frozen=True)
class RemediationDecision:
    """What the hosting loop must do next (module docstring)."""

    action: str                      # "restart" | "halt"
    exit_code: int
    reason: str
    case: str
    restore_step: Optional[int] = None   # clean anchor to resume from
    device_count: Optional[int] = None   # topology to relaunch with


class RemediationController:
    """The detector→action state machine (module docstring).

    ``canary_fn`` is a zero-arg callable re-executing the newest
    journaled segment(s) and returning
    ``{"ok": bool, "clean_anchor": int|None, "evidence": dict}``
    (``canary.GPTCanary`` is the replayer-backed one); ``None`` demotes
    every ``verify`` response to ``observe`` — the controller never
    claims a verification it cannot perform. ``world_devices`` is the
    FULL topology (what a readmit restores); ``save_dir`` roots the
    persisted state and the checkpoint-quarantine moves, which only a
    ``writer`` (the layout's first rank; the default) performs.
    """

    def __init__(
        self,
        policy: Optional[RemediationPolicy] = None,
        router=None,
        save_dir: Optional[str] = None,
        world_devices: Optional[int] = None,
        canary_fn: Optional[Callable[[], dict]] = None,
        state: Optional[RemediationState] = None,
        run_id: Optional[str] = None,
        writer: bool = True,
    ):
        self.policy = policy if policy is not None else RemediationPolicy()
        self.router = router
        self.save_dir = save_dir
        self.world_devices = world_devices
        self.canary_fn = canary_fn
        self.run_id = run_id
        self.state = (state if state is not None
                      else RemediationState.load(save_dir))
        self.writer = writer
        if not writer:
            self.state.path = None  # the writer's file, read not written
        self.cases: List[Dict] = []
        self.records: List[dict] = []
        self._decisions: List[RemediationDecision] = []
        self._lock = threading.RLock()
        # detector records queued by ControllerSink and drained on the
        # hosting thread (deque appends are GIL-atomic, no lock). The
        # indirection is load-bearing: a sink that took the controller
        # lock inside the router's fan-out would deadlock against a
        # canary replay — main thread holds controller lock and emits
        # spans (wants the router lock) while a watchdog warn holds the
        # router lock and would want the controller's.
        self._queue: "collections.deque" = collections.deque()

    # -- record plumbing -----------------------------------------------------

    def _emit(self, case: Dict, action: str, step: int,
              terminal: bool = False, **fields) -> dict:
        payload = dict(
            case=case["id"], finding=case["kind"], action=action,
            state=case["state"], suspect=case.get("suspect"),
            evidence=list(case["evidence"]),
            n_evidence=case["n_evidence"], **fields,
        )
        if self.run_id is not None:
            payload.setdefault("run_id", self.run_id)
        if terminal:
            payload["terminal"] = True
            payload["verdict"] = TERMINAL_VERDICTS[case["state"]]
        if self.router is not None:
            record = self.router.event("remediation", step, **payload)
        else:
            record = make_record("remediation", step, **payload)
        self.records.append(record)
        case["records"].append(record)
        logger.warning(
            "remediation %s [%s] %s -> %s%s", case["id"], case["kind"],
            action, case["state"],
            f" verdict={payload['verdict']}" if terminal else "",
        )
        return record

    # -- case bookkeeping ----------------------------------------------------

    def _open_case(self, kind: str, step: int, suspect=None,
                   evidence: Optional[dict] = None) -> Dict:
        case = {
            "id": self.state.next_case_id(),
            "kind": kind,
            "state": "detected",
            "suspect": suspect,
            "opened_step": int(step),
            "evidence": [evidence] if evidence else [],
            "n_evidence": 1 if evidence else 0,
            "clean_done": 0,
            "clean_needed": None,
            "quarantine": False,
            "records": [],
        }
        self.cases.append(case)
        self._emit(case, "open", step)
        return case

    def _attach(self, case: Dict, evidence: dict) -> None:
        case["n_evidence"] += 1
        if len(case["evidence"]) < _EVIDENCE_CAP:
            case["evidence"].append(evidence)

    def _find_open(self, kind: str, suspect=None) -> Optional[Dict]:
        for case in self.cases:
            if (case["kind"] == kind and case.get("suspect") == suspect
                    and case["state"] not in TERMINAL_VERDICTS):
                return case
        return None

    def _close(self, case: Dict, terminal_state: str, step: int,
               action: str, **fields) -> None:
        case["state"] = advance(case["state"], terminal_state)
        self._emit(case, action, step, terminal=True, **fields)
        self.cases.remove(case)
        self.state.cases = [
            c for c in self.state.cases if c.get("id") != case["id"]
        ]
        self.state.history.append({
            "id": case["id"], "kind": case["kind"],
            "verdict": TERMINAL_VERDICTS[terminal_state],
            "opened_step": case["opened_step"], "closed_step": int(step),
            "suspect": case.get("suspect"),
        })
        self.state.save()

    def _snapshot(self, case: Dict) -> Dict:
        """The restart-surviving slice of a case (no records/evidence
        bodies — the stream is the durable record of those)."""
        return {
            "id": case["id"], "kind": case["kind"], "state": case["state"],
            "suspect": case.get("suspect"),
            "opened_step": case["opened_step"],
            "clean_done": case["clean_done"],
            "clean_needed": case["clean_needed"],
            "quarantine": case["quarantine"],
            "excluded": list(case.get("excluded") or []),
        }

    def _persist_open(self) -> None:
        # observing persists too: a stall case mid-observation when an
        # UNRELATED confirmed corruption restarts the incarnation must
        # finish its clean-step closure in the next one — dropping it
        # would leave a detector finding with no terminal verdict (the
        # campaign's one-terminal-per-fault invariant caught exactly
        # this: slow@N with a bitflip quarantine at N+1)
        self.state.cases = [
            self._snapshot(c) for c in self.cases
            if c["state"] in ("observing", "quarantined", "probation")
        ]
        self.state.save()

    # -- detector input ------------------------------------------------------

    def enqueue(self, record: dict) -> None:
        """Queue a detector record for the next :meth:`process`-side
        drain. Lock-free by design (see ``_queue`` above) — this is the
        only controller entry point that may run inside the router's
        fan-out."""
        if record.get("kind") in DETECTOR_KINDS:
            self._queue.append(record)

    def queued(self) -> List[dict]:
        """The detector records queued and not yet drained (the first
        rank's, which every rank takes at world > 1)."""
        return list(self._queue)

    def replace_queue(self, records: List[dict]) -> None:
        """Replace the queue with ``records`` (the first rank's
        :meth:`queued`), so every rank's controller observes the same
        findings in the same order."""
        self._queue.clear()
        self._queue.extend(records)

    def _drain(self) -> None:
        while True:
            try:
                record = self._queue.popleft()
            except IndexError:
                return
            self.observe(record)

    def observe(self, record: dict) -> Optional[Dict]:
        """Classify one detector record into a case (module docstring);
        returns the case touched (None for records the controller does
        not consume). The expensive reactions run in :meth:`process`.
        """
        kind = record.get("kind")
        if kind not in DETECTOR_KINDS:
            return None
        step = int(record.get("step", -1))
        with self._lock:
            if kind == "fleet":
                check = record.get("check")
                if check not in ("straggler", "corruption"):
                    return None  # summaries prove the check ran; no case
                case_kind = check
                suspect = record.get("flagged_host")
            elif kind == "stall":
                case_kind, suspect = "stall", None
            elif kind in ("skip", "rollback"):
                case_kind, suspect = "sentinel", None
            elif kind == "halt":
                case_kind, suspect = "halt", None
            elif kind == "slo":
                # burn-rate summaries flow continuously; only a fired
                # fast-burn alert is a finding (repeat alerts attach as
                # evidence to the open case, so a sustained burn is one
                # case with a deep evidence trail, not an alert storm)
                if not record.get("alert"):
                    return None
                case_kind, suspect = "slo", None
            elif kind == "memory":
                # per-interval watermark rows flow continuously (the
                # HBM x-ray's live monitor); only a headroom breach —
                # the watermark inside the guard band of capacity — is
                # a finding, and repeat breaches attach as evidence
                if not record.get("headroom_breach"):
                    return None
                case_kind, suspect = "memory", None
            else:  # divergence: the bisector's forensic verdict
                if not record.get("found"):
                    return None
                case_kind, suspect = "sdc", None
            case = self._find_open(case_kind, suspect)
            if case is not None:
                self._attach(case, record)
                return case
            return self._open_case(case_kind, step, suspect=suspect,
                                   evidence=record)

    def observe_fleet(self, report, step: int) -> List[Dict]:
        """Convenience hand-off from :class:`LiveFleetMonitor`: feed a
        ``FleetReport``'s flag records through :meth:`observe`."""
        touched = []
        for rec in report.to_records(step=step):
            case = self.observe(rec)
            if case is not None:
                touched.append(case)
        return touched

    def on_preemption(self, step: int) -> RemediationDecision:
        """The hosting loop is exiting on a termination notice: open the
        preemption case, persist it for the next incarnation, and hand
        back the restart decision (same topology)."""
        with self._lock:
            case = self._open_case(
                "preemption", step,
                evidence={"kind": "preemption", "step": int(step)},
            )
            case["state"] = advance(case["state"], "probation")
            case["clean_needed"] = self.policy.probation_steps
            self.state.restarts += 1
            self._persist_open()
            self._emit(case, "restart", step, restarts=self.state.restarts)
            decision = RemediationDecision(
                action="restart",
                exit_code=int(ExitCode.REMEDIATION_RESTART),
                reason="preemption: resume on the same topology",
                case=case["id"],
                device_count=self.world_devices and self.state.device_count(
                    self.world_devices),
            )
            self._decisions.append(decision)
            return decision

    def adopt_pending(self, step: int) -> List[Dict]:
        """Startup adoption: re-bind the persisted open cases (a
        quarantine entering probation) and open a case for a
        supervisor-recorded unclean exit (``state.pending``). Call once
        per incarnation, after the restore."""
        with self._lock:
            adopted: List[Dict] = []
            pending = self.state.pending
            if pending is not None:
                self.state.pending = None
                case = self._open_case(
                    "incident", step, evidence=dict(pending),
                )
                case["state"] = advance(case["state"], "probation")
                case["clean_needed"] = self.policy.probation_steps
                # the incident restart already happened (we are it) and
                # counts against the bounded budget exactly like a
                # controller-driven one — an endlessly wedging job must
                # still converge on escalate-to-halt
                self.state.restarts += 1
                self._emit(case, "adopt", step,
                           exit_code=pending.get("exit_code"),
                           restarts=self.state.restarts)
                adopted.append(case)
            for snap in list(self.state.cases):
                case = {
                    **snap,
                    "evidence": [], "n_evidence": 0, "records": [],
                }
                self.cases.append(case)
                if case["state"] == "quarantined":
                    # the restart the quarantine requested HAS happened
                    # (we are the reduced incarnation): probation starts
                    case["state"] = advance(case["state"], "probation")
                    case["clean_needed"] = self.policy.probation_steps
                    self._emit(case, "probation", step,
                               excluded=list(self.state.excluded),
                               clean_needed=case["clean_needed"])
                else:
                    self._emit(case, "adopt", step)
                adopted.append(case)
            self._persist_open()
            return adopted

    # -- the reaction loop ---------------------------------------------------

    def process(self, step: int) -> Optional[RemediationDecision]:
        """Advance every case whose next action is due (verification,
        quarantine, escalation). Call once per training-loop iteration
        AFTER feeding the step's records; returns the first queued
        decision (also available via :meth:`poll`)."""
        self._drain()
        with self._lock:
            for case in list(self.cases):
                if case["state"] != "detected":
                    continue
                response = self.policy.response_for(case["kind"])
                if response == "verify":
                    self._do_verify(case, step)
                elif response == "observe":
                    self._start_observing(case, step)
                elif response == "quarantine":
                    self._do_quarantine(case, step)
                elif response == "restart":
                    case["state"] = advance(case["state"], "probation")
                    case["clean_needed"] = self.policy.probation_steps
                    self._emit(case, "restart", step)
                    self._persist_open()
                else:  # escalate
                    self._escalate(case, step, reason="policy: escalate")
            return self.poll()

    def _start_observing(self, case: Dict, step: int) -> None:
        case["state"] = advance(case["state"], "observing")
        case["clean_needed"] = self.policy.clean_steps_to_close
        self._emit(case, "observe", step,
                   clean_needed=case["clean_needed"])

    def _do_verify(self, case: Dict, step: int) -> None:
        if not self.policy.verify_before_quarantine:
            # the DELIBERATELY BROKEN table (policy.py): quarantine on
            # the raw finding. The campaign's false-positive invariant
            # exists to catch exactly this record shape — a quarantine
            # with no confirming verify record in its case.
            self._do_quarantine(case, step)
            return
        if self.canary_fn is None:
            # a verification the controller cannot perform must not be
            # claimed: demote to observation, loudly
            logger.warning(
                "remediation %s: no canary wired — %s finding demoted "
                "to observation (verify_before_quarantine needs a "
                "canary_fn)", case["id"], case["kind"],
            )
            self._start_observing(case, step)
            return
        case["state"] = advance(case["state"], "verifying")
        with _goodput_span("remediation", step=step, case=case["id"],
                           action="verify"):
            try:
                result = self.canary_fn()
            except Exception as e:  # noqa: BLE001 - canary failure != verdict
                logger.warning(
                    "remediation %s: canary raised (%r) — cannot verify, "
                    "demoting to observation", case["id"], e,
                )
                case["state"] = advance(case["state"], "observing")
                case["clean_needed"] = self.policy.clean_steps_to_close
                self._emit(case, "observe", step, canary_error=repr(e))
                return
        if result.get("ok") and result.get("skipped"):
            # the canary had nothing sound to re-execute (no verified
            # segment yet): that is NOT a verification, and claiming
            # "cleared" on it would be the vacuous pass this machine
            # exists to refuse — observe instead
            case["state"] = advance(case["state"], "observing")
            case["clean_needed"] = self.policy.clean_steps_to_close
            self._emit(case, "observe", step,
                       canary_skipped=result.get("reason"))
            return
        if result.get("ok"):
            case["state"] = advance(case["state"], "cleared")
            self._emit(case, "clear", step, terminal=True,
                       canary=result.get("evidence"))
            # _close's bookkeeping without a second record: the clear IS
            # the terminal record
            self.cases.remove(case)
            self.state.history.append({
                "id": case["id"], "kind": case["kind"],
                "verdict": "cleared", "opened_step": case["opened_step"],
                "closed_step": int(step), "suspect": case.get("suspect"),
            })
            self.state.save()
        else:
            self._emit(case, "verify", step, verdict="confirmed",
                       canary=result.get("evidence"),
                       clean_anchor=result.get("clean_anchor"))
            case["canary"] = result
            self._do_quarantine(case, step)

    def _do_quarantine(self, case: Dict, step: int) -> None:
        world = self.world_devices
        if world is None:
            self._escalate(case, step,
                           reason="no topology registered to quarantine")
            return
        if self.state.restarts >= self.policy.max_restarts:
            self._escalate(
                case, step,
                reason=f"restart budget exhausted "
                       f"({self.state.restarts}/{self.policy.max_restarts})",
            )
            return
        # slice the REMAINING (not-yet-excluded) ordinals: a second
        # confirmed corruption after an earlier quarantine must shrink
        # the topology again (8→4→2), not re-exclude the same upper
        # half and relaunch the identical device set while claiming
        # action was taken
        alive = [d for d in range(world) if d not in set(self.state.excluded)]
        drop = max(1, int(round(len(alive)
                                * self.policy.quarantine_fraction)))
        excluded = sorted(set(self.state.excluded) | set(alive[-drop:]))
        remaining = len(alive) - drop
        if remaining < self.policy.min_devices:
            self._escalate(
                case, step,
                reason=f"quarantine would leave {remaining} device(s) "
                       f"(< min_devices {self.policy.min_devices})",
            )
            return
        canary = case.get("canary") or {}
        restore_step = canary.get("clean_anchor")
        if restore_step is None:
            for ev in case["evidence"]:
                if isinstance(ev, dict) and ev.get("clean_anchor") is not None:
                    restore_step = ev["clean_anchor"]
                    break
        tombstoned: List[int] = []
        if (self.save_dir is not None and restore_step is not None
                and self.writer):
            tombstoned = quarantine_checkpoints(
                self.save_dir, restore_step, case["id"]
            )
        case["state"] = advance(case["state"], "quarantined")
        case["quarantine"] = True
        # the ordinals THIS case excluded: its readmit lifts exactly
        # these, so an overlapping quarantine's exclusions survive
        case["excluded"] = list(alive[-drop:])
        self.state.excluded = excluded
        self.state.restarts += 1
        self._persist_open()
        self._emit(
            case, "quarantine", step,
            excluded=excluded, device_count=remaining,
            restore_step=restore_step, tombstoned=tombstoned,
            restarts=self.state.restarts,
        )
        self._decisions.append(RemediationDecision(
            action="restart",
            exit_code=int(ExitCode.REMEDIATION_RESTART),
            reason=f"quarantine: {case['kind']} confirmed; restart on "
                   f"{remaining} device(s) from the clean anchor",
            case=case["id"],
            restore_step=restore_step,
            device_count=remaining,
        ))

    def _escalate(self, case: Dict, step: int, reason: str) -> None:
        case_state = advance(case["state"], "escalated")
        case["state"] = case_state
        self._emit(case, "escalate", step, terminal=True, reason=reason)
        self.cases.remove(case)
        self.state.cases = [
            c for c in self.state.cases if c.get("id") != case["id"]
        ]
        self.state.history.append({
            "id": case["id"], "kind": case["kind"], "verdict": "halted",
            "opened_step": case["opened_step"], "closed_step": int(step),
            "suspect": case.get("suspect"), "reason": reason,
        })
        self.state.save()
        self._decisions.append(RemediationDecision(
            action="halt", exit_code=int(ExitCode.REMEDIATION_HALT),
            reason=reason, case=case["id"],
        ))

    # -- clean-step / anchor cadence -----------------------------------------

    def on_clean_step(self, step: int) -> None:
        """One clean (verdict-OK, no new findings) step completed:
        probation and observation counters advance; cases whose budget
        is met close (readmit for a quarantine, recover otherwise)."""
        self._drain()
        with self._lock:
            for case in list(self.cases):
                if case["state"] not in ("observing", "probation"):
                    continue
                case["clean_done"] += 1
                if (case["clean_needed"] is not None
                        and case["clean_done"] < case["clean_needed"]):
                    continue
                if case["state"] == "observing":
                    self._close(case, "recovered", step, "recover",
                                clean_steps=case["clean_done"])
                elif case["quarantine"]:
                    self._readmit(case, step)
                else:
                    self._close(case, "recovered", step, "recover",
                                clean_steps=case["clean_done"])

    def _readmit(self, case: Dict, step: int) -> None:
        # lift only the ordinals THIS case excluded: a second overlapping
        # quarantine's probation must keep its devices out until its OWN
        # readmit — wiping the whole set here would silently break the
        # other case's bounded-quarantine guarantee
        own = set(case.get("excluded") or [])
        if own:
            self.state.excluded = [
                d for d in self.state.excluded if d not in own
            ]
        else:  # pre-ordinal-tracking snapshot: the legacy full lift
            self.state.excluded = []
        world = self.world_devices
        devices = (self.state.device_count(world)
                   if world is not None else None)
        self._close(case, "readmitted", step, "readmit",
                    clean_steps=case["clean_done"],
                    device_count=devices)
        self._decisions.append(RemediationDecision(
            action="restart",
            exit_code=int(ExitCode.REMEDIATION_RESTART),
            reason="probation complete: readmit the quarantined devices",
            case=case["id"],
            device_count=devices,
        ))

    def on_anchor(self, step: int) -> None:
        """A checkpoint anchor landed: run the periodic canary audit
        (``policy.canary_audit``) and persist open-case progress.

        The audit is how SILENT corruption — the fault no streaming
        detector flags — enters the machine: a divergence between the
        journal and a clean re-execution opens an ``sdc`` case whose
        evidence (first divergent step, the exact leaf when the
        corruption entered at an anchor boundary) is already verified,
        so the response table quarantines it directly."""
        self._drain()
        with self._lock:
            self._persist_open()
            if not (self.policy.canary_audit and self.canary_fn):
                return
            with _goodput_span("remediation", step=step, action="audit"):
                try:
                    result = self.canary_fn()
                except Exception as e:  # noqa: BLE001 - audit is best-effort
                    logger.warning("remediation canary audit failed: %r", e)
                    return
            if result.get("ok") or result.get("skipped"):
                return
            case = self._find_open("sdc")
            if case is not None:
                self._attach(case, result.get("evidence") or {})
                return
            case = self._open_case(
                "sdc", step, evidence=result.get("evidence"),
            )
            case["canary"] = result

    # -- decisions / lifecycle -----------------------------------------------

    def poll(self) -> Optional[RemediationDecision]:
        """The oldest pending decision (None when there is none). The
        hosting loop acts on it: print, finalize, exit with its code."""
        with self._lock:
            if self._decisions:
                return self._decisions.pop(0)
            return None

    @property
    def in_probation(self) -> bool:
        with self._lock:
            return any(c["state"] == "probation" for c in self.cases)

    @property
    def has_pending(self) -> bool:
        """True when :meth:`process` has reactions to run (a queued
        detector record or a case still in ``detected``) — the hosting
        loop uses this to fence the potentially-slow verification work
        from its stall watchdog."""
        if self._queue:
            return True
        with self._lock:
            return any(c["state"] == "detected" for c in self.cases)

    @property
    def open_cases(self) -> List[Dict]:
        with self._lock:
            return list(self.cases)

    def metrics_fields(self) -> dict:
        """Per-interval gauges for the metrics record (the CsvSink
        ``TOLERATED_EXTRA_KEYS`` pair): remaining probation steps (0
        when none) and open-case count."""
        with self._lock:
            probation = 0
            for c in self.cases:
                if c["state"] == "probation" and c["clean_needed"]:
                    probation = max(
                        probation, c["clean_needed"] - c["clean_done"]
                    )
            return {"probation": probation,
                    "remediation_cases": len(self.cases)}

    def run_end(self, step: int) -> List[Dict]:
        """The run completed normally: close observation/probation cases
        that saw clean recovery (``recovered``), persist the rest (a
        quarantine probation cut short survives into the next
        incarnation); returns the cases left open."""
        self._drain()
        with self._lock:
            for case in list(self.cases):
                if (case["state"] in ("observing", "probation")
                        and case["clean_done"] > 0
                        and not case["quarantine"]):
                    self._close(case, "recovered", step, "recover",
                                clean_steps=case["clean_done"],
                                at_run_end=True)
            self._persist_open()
            return list(self.cases)


def sync_queue(controller: RemediationController) -> None:
    """At world > 1, replace every layout rank's queued detector records
    with the first rank's (collective: every rank calls it at the same
    point, before the drain of ``process``/``on_clean_step``/
    ``on_anchor``/``run_end``); a no-op at a world of one."""
    from apex_tpu_torch.parallel import parallel_state as ps

    if ps.get_model_world_size() > 1:
        controller.replace_queue(ps.broadcast_object(controller.queued()))


def after_step(controller: RemediationController, ar, recorder,
               responder, save_interval: int,
               step: int) -> Optional[RemediationDecision]:
    """The controller's work after a good step of a training loop (the
    GPT example's and the campaign's): at a checkpoint anchor, commit it
    (``ar.finalize``: the canary audits committed anchors only) and run
    the canary audit; then the pending reactions. The stall watchdog
    (``responder``) stands down around it, since a canary replay is
    legitimate host time, and is restarted unless a decision ends the
    incarnation. On a decision the pending save is committed and the
    journal flushed. ``ar``, ``recorder`` and ``responder`` may be None.
    Returns the decision to act on, or None."""
    anchor_due = bool(ar is not None and save_interval
                      and (step + 1) % save_interval == 0)
    fence = responder is not None and (anchor_due or controller.has_pending)
    if fence:
        responder.stop()
    if anchor_due:
        ar.finalize()
        sync_queue(controller)
        controller.on_anchor(step + 1)
    sync_queue(controller)
    decision = controller.process(step)
    if decision is not None:
        if ar is not None:
            ar.finalize()
        if recorder is not None:
            recorder.flush()
    elif fence:
        responder.start()
    return decision


class ControllerSink(Sink):
    """Router sink tapping detector records straight into a controller.

    One ``router.add_sink(ControllerSink(controller))`` wires every
    detector the stream carries — fleet flags, watchdog stalls, the
    sentinel's skip/rollback/halt trail, bisector verdicts — with no
    per-producer plumbing. The sink only ENQUEUES (lock-free,
    GIL-atomic deque append); classification and reactions run on the
    hosting thread at the next ``process``/``on_clean_step`` drain.
    The indirection is a deadlock guard, not a nicety: the router holds
    its fan-out lock while sinks run, and the controller emits through
    that same router while verifying — a sink that took the controller
    lock here would close the cycle (see ``RemediationController._queue``)."""

    def __init__(self, controller: RemediationController):
        self.controller = controller

    def emit(self, record: dict) -> None:
        self.controller.enqueue(record)
