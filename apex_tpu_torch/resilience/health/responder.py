"""Escalating incident response: warn -> dump -> coordinated self-exit
(counterpart of apex_tpu/resilience/health/responder.py).

A wedged job (a hung collective, a stuck host fetch, a deadlocked input
pipeline) announces nothing: it just stops beating.
:class:`IncidentResponder` turns that infinite stall into a bounded,
documented restart, built on the :class:`~apex_tpu_torch.monitor.
StallWatchdog` escalation ladder:

1. **warn** (``deadline_s``) — the watchdog's base level: a
   ``kind="stall"`` event and a ``phase="stall"`` span.
2. **dump** (``dump_after x deadline_s``) — a forensic incident bundle
   (:func:`~apex_tpu_torch.resilience.health.capture_incident`) emitted as
   a ``kind="incident"`` record while the evidence still exists.
3. **terminate** (``terminate_after x deadline_s``, opt-in) — coordinated
   self-termination. A wedged main thread runs neither signal handlers
   nor atexit hooks, so a teardown thread bounded by
   ``teardown_timeout_s`` does it from here: the ``phase="incident"``
   span over the dead time since the last heartbeat, the pending save's
   tombstone through ``autoresume.prepare_incident_exit()`` where one is
   given, the ``kind="incident"`` terminate record, then
   :func:`~apex_tpu_torch.monitor.router.flush_all_routers` (open spans
   land ``interrupted=True``, sinks close). Then ``os._exit`` with
   :data:`INCIDENT_EXIT_CODE`, which skips atexit and CUDA's teardown:
   the process cannot hang in either.

Why ``os._exit`` and not SIGTERM-to-self: Python signal handlers run only
in the main thread between bytecodes, and a main thread parked in a
blocking call never runs another one.
"""

import logging
import os
import threading
import time
from typing import List, Optional

from apex_tpu_torch.monitor.goodput.spans import emit_span
from apex_tpu_torch.monitor.router import flush_all_routers
from apex_tpu_torch.monitor.watchdog import StallWatchdog
from apex_tpu_torch.resilience.exit_codes import ExitCode
from apex_tpu_torch.resilience.health.incident import capture_incident

logger = logging.getLogger("apex_tpu_torch.resilience.health")

__all__ = ["INCIDENT_EXIT_CODE", "IncidentResponder"]

#: the self-termination exit status (resilience/exit_codes.py): distinct
#: from success, tracebacks, argparse and signal deaths, so a supervisor
#: can tell "ended by incident response, restart me" from other endings
INCIDENT_EXIT_CODE = int(ExitCode.INCIDENT)


class IncidentResponder:
    """The warn -> dump -> terminate ladder over a step deadline (module
    docstring).

    Drop-in for the bare watchdog in a loop::

        responder = IncidentResponder(
            deadline_s, router=router, window=mem_sink, trigger=trigger,
            terminate_after=3.0)
        responder.start()
        ...
        responder.beat(step)       # once per completed step

    ``window`` is the in-process MemorySink the bundle quotes; ``trigger``
    a ProfilerTrigger to arm best-effort; ``autoresume`` anything with
    ``prepare_incident_exit()`` whose pending save is tombstoned before
    exit. ``terminate_after=None`` (default) stops the ladder at the dump.
    ``exit_fn`` is injectable for tests. ``bundle_extra`` is an optional
    zero-arg callable whose dict is merged into the dump bundle (the
    serving engine's in-flight request table); it runs on the watchdog
    thread and a raise is logged, never allowed to cost the bundle.
    """

    def __init__(
        self,
        deadline_s: float,
        router=None,
        window=None,
        trigger=None,
        autoresume=None,
        dump_after: float = 2.0,
        terminate_after: Optional[float] = None,
        window_tail: int = 64,
        poll_s: Optional[float] = None,
        exit_code: int = INCIDENT_EXIT_CODE,
        exit_fn=None,
        teardown_timeout_s: float = 10.0,
        bundle_extra=None,
    ):
        if dump_after < 1.0:
            raise ValueError(
                f"dump_after is a multiple of deadline_s and must be >= 1.0 "
                f"(the warn level), got {dump_after}"
            )
        if terminate_after is not None and terminate_after <= dump_after:
            raise ValueError(
                f"terminate_after ({terminate_after}) must exceed "
                f"dump_after ({dump_after}): termination without the "
                f"forensic dump defeats the ladder"
            )
        self.router = router
        self.window = window
        self.trigger = trigger
        self.autoresume = autoresume
        self.window_tail = int(window_tail)
        self.exit_code = int(exit_code)
        self.teardown_timeout_s = float(teardown_timeout_s)
        self._exit_fn = exit_fn if exit_fn is not None else os._exit
        self.bundle_extra = bundle_extra
        self.incidents: List[dict] = []
        escalations = [(float(dump_after), self._dump)]
        if terminate_after is not None:
            escalations.append((float(terminate_after), self._terminate))
        self.watchdog = StallWatchdog(
            deadline_s, router=router, poll_s=poll_s,
            escalations=escalations,
        )

    # -- watchdog surface (delegation) -------------------------------------

    @property
    def stalls(self) -> List[dict]:
        return self.watchdog.stalls

    def start(self) -> "IncidentResponder":
        self.watchdog.start()
        return self

    def beat(self, step: Optional[int] = None) -> None:
        self.watchdog.beat(step)

    def stop(self) -> None:
        self.watchdog.stop()

    def __enter__(self) -> "IncidentResponder":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- the ladder ---------------------------------------------------------

    def _dump(self, info: dict) -> None:
        extra = {}
        if self.bundle_extra is not None:
            try:
                extra = dict(self.bundle_extra() or {})
            except Exception as e:  # the bundle must not die of its garnish
                logger.warning("incident bundle_extra failed: %s", e)
        bundle = capture_incident(
            self.router, info.get("step"), stage="dump",
            overdue_s=info.get("overdue_s"),
            deadline_s=info.get("deadline_s"),
            window=self.window, tail=self.window_tail,
            trigger=self.trigger, **extra,
        )
        self.incidents.append(bundle)

    def _terminate(self, info: dict) -> None:
        step = info.get("step")
        overdue = info.get("overdue_s")
        logger.error(
            "incident: no heartbeat for %.1fs (deadline %.1fs, last step "
            "%s) — self-terminating with exit code %d; restart resumes "
            "from the last verified checkpoint",
            overdue if overdue is not None else float("nan"),
            info.get("deadline_s", float("nan")), step, self.exit_code,
        )
        # the teardown runs on a helper thread bounded by
        # teardown_timeout_s: when the wedge IS the telemetry path (a sink
        # hung on dead storage, the router lock held by the blocked
        # thread) it would block forever, and the bounded exit is the one
        # guarantee this class makes
        done = threading.Event()

        def teardown() -> None:
            abandoned = None
            if self.autoresume is not None:
                try:
                    abandoned = self.autoresume.prepare_incident_exit()
                except Exception as e:  # noqa: BLE001 - exit must proceed
                    logger.warning(
                        "incident checkpoint abandon failed: %s", e)
            if self.router is not None:
                try:
                    # the dead time as a goodput span, anchored at the last
                    # heartbeat (the dog's clock and perf_counter share
                    # CLOCK_MONOTONIC on linux)
                    beat_mono = info.get("beat_mono")
                    if beat_mono is not None:
                        emit_span(
                            self.router, "incident", beat_mono,
                            time.monotonic() - beat_mono, step=step,
                        )
                    self.router.event(
                        "incident", -1 if step is None else int(step),
                        stage="terminate", overdue_s=overdue,
                        deadline_s=info.get("deadline_s"),
                        exit_code=self.exit_code,
                        abandoned_step=abandoned,
                    )
                except Exception as e:  # noqa: BLE001 - exit must proceed
                    logger.warning(
                        "incident termination record failed: %s", e)
            # the exit teardown, run by hand: open spans flush
            # interrupted=True, sinks close, THEN the process ends
            flush_all_routers()
            done.set()

        threading.Thread(
            target=teardown, name="apex-tpu-incident-teardown", daemon=True,
        ).start()
        if not done.wait(self.teardown_timeout_s):
            logger.error(
                "incident teardown did not finish within %.1fs (the "
                "telemetry path may be part of the wedge); exiting anyway",
                self.teardown_timeout_s,
            )
        self._exit_fn(self.exit_code)
