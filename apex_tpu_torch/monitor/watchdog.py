"""Stall watchdog and on-anomaly profiler capture (counterpart of
apex_tpu/monitor/watchdog.py).

:class:`StallWatchdog` is a daemon heartbeat thread that flags a step
exceeding its deadline from OUTSIDE the (possibly stuck) loop thread, with
an ``escalations`` ladder of once-per-episode callbacks at higher
multiples of the deadline: the machinery the incident responder
(``apex_tpu_torch.resilience.health``) builds warn, dump and terminate on.
It is plain Python, copied from the JAX package.

:class:`ProfilerTrigger` captures a ``torch.profiler`` window around the
next steps when the anomaly sentinel escalates, or at a step requested up
front (``--profile-step``), and writes it as a Chrome trace
(``trace.json``) into its own capture directory. The profiler is one
process-wide session: one capture at a time, and a capture that cannot
start (another session is open) is logged and dropped, never raised.
"""

import logging
import os
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

logger = logging.getLogger("apex_tpu_torch.monitor")

__all__ = ["ProfilerTrigger", "StallWatchdog"]


class StallWatchdog:
    """Fire ``on_stall`` when no heartbeat lands within ``deadline_s``.

    The loop calls :meth:`beat` once per step; a daemon thread polls the
    wall clock. On expiry the base warn runs ONCE in a fresh daemon thread
    (info: last step, seconds since its beat) and the dog re-arms on the
    next beat: a recovered stall can fire again, a dead loop does not
    spam. With ``router=`` each stall also lands in the record stream as a
    ``kind="stall"`` event plus a ``phase="stall"`` span anchored at the
    last heartbeat, which the goodput accountant books as badput.

    ``escalations`` is a sequence of ``(multiplier, callback)`` pairs:
    when the overdue time exceeds ``multiplier * deadline_s`` the callback
    fires once per episode with the same ``info`` (plus ``beat_mono``, the
    monotonic time of the last heartbeat). A beat re-arms every level; a
    callback that raises is logged and does not stop later levels.

    Usable as a context manager; ``beat`` and ``stop`` are thread-safe.
    """

    def __init__(
        self,
        deadline_s: float,
        on_stall: Optional[Callable[[dict], None]] = None,
        poll_s: Optional[float] = None,
        router=None,
        escalations: Sequence[Tuple[float, Callable[[dict], None]]] = (),
    ):
        if deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        self.deadline_s = float(deadline_s)
        self.poll_s = float(poll_s) if poll_s else min(1.0, self.deadline_s / 4)
        self.on_stall = on_stall
        self.router = router
        # key= so equal multipliers never compare the callbacks; ties keep
        # registration order
        self.escalations: List[Tuple[float, Callable[[dict], None]]] = sorted(
            ((float(mult), cb) for mult, cb in escalations),
            key=lambda pair: pair[0],
        )
        for mult, _ in self.escalations:
            if mult < 1.0:
                raise ValueError(
                    f"escalation multipliers are in units of deadline_s and "
                    f"must be >= 1.0 (the base warn), got {mult}"
                )
        self.stalls: List[dict] = []
        self._lock = threading.Lock()
        self._last_beat = time.monotonic()
        self._last_step: Optional[int] = None
        self._fired = False
        self._fired_levels: set = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "StallWatchdog":
        if self._thread is not None:
            raise RuntimeError("watchdog already started")
        self._stop.clear()  # restartable after stop()
        self._last_beat = time.monotonic()
        self._thread = threading.Thread(
            target=self._run, name="apex-tpu-stall-watchdog", daemon=True
        )
        self._thread.start()
        return self

    def beat(self, step: Optional[int] = None) -> None:
        """Mark the loop alive (call once per completed step)."""
        with self._lock:
            self._last_beat = time.monotonic()
            if step is not None:
                self._last_step = int(step)
            self._fired = False
            self._fired_levels.clear()

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            fire: List[Optional[Callable[[dict], None]]] = []
            with self._lock:
                overdue = time.monotonic() - self._last_beat
                beat_mono = self._last_beat
                step = self._last_step
                if overdue <= self.deadline_s:
                    continue
                if not self._fired:
                    self._fired = True
                    fire.append(None)  # the base warn level
                for i, (mult, cb) in enumerate(self.escalations):
                    if (overdue > mult * self.deadline_s
                            and i not in self._fired_levels):
                        self._fired_levels.add(i)
                        fire.append(cb)
            if not fire:
                continue
            info = {
                "step": step,
                "overdue_s": overdue,
                "deadline_s": self.deadline_s,
                "beat_mono": beat_mono,
            }
            # each poll's actions run on their own daemon thread: a handler
            # blocked forever (router.event stuck behind a hung sink) must
            # not stall the poll loop, or the terminate level would never
            # fire; within one poll they run in ladder order
            threading.Thread(
                target=self._fire, args=(fire, info),
                name="apex-tpu-watchdog-fire", daemon=True,
            ).start()

    def _fire(self, fire: List[Optional[Callable[[dict], None]]],
              info: dict) -> None:
        for cb in fire:
            # staleness gate before EACH action: a fresh beat or stop()
            # since the poll ends the episode; a still-dead loop re-fires
            with self._lock:
                if (self._stop.is_set()
                        or self._last_beat != info["beat_mono"]):
                    return
            if cb is None:
                self._warn(dict(info))
            else:
                try:
                    cb(dict(info))
                except Exception as e:  # outlive the escalation too
                    logger.warning("watchdog escalation failed: %s", e)

    def _warn(self, info: dict) -> None:
        """The base (1x deadline) level: log, stall record, stall span."""
        step, overdue = info["step"], info["overdue_s"]
        self.stalls.append(info)
        logger.warning(
            "stall: no step heartbeat for %.1fs (deadline %.1fs, "
            "last step %s)", overdue, self.deadline_s, step,
        )
        if self.router is not None:
            try:
                self.router.event(
                    "stall", -1 if step is None else step,
                    overdue_s=overdue, deadline_s=self.deadline_s,
                )
                # the dead time started when the loop went quiet
                from apex_tpu_torch.monitor.goodput.spans import emit_span

                emit_span(self.router, "stall", info["beat_mono"], overdue,
                          step=step)
            except Exception as e:  # the dog must outlive its sinks
                logger.warning("stall record emit failed: %s", e)
        if self.on_stall is not None:
            try:
                self.on_stall(info)
            except Exception as e:  # the dog must outlive its handler
                logger.warning("on_stall handler failed: %s", e)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5 * self.poll_s)
            self._thread = None

    def __enter__(self) -> "StallWatchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def _new_profile():
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities)


class ProfilerTrigger:
    """Capture a ``torch.profiler`` window on demand.

    Drive it from the step loop::

        trigger = ProfilerTrigger(log_dir, window_steps=2)
        trigger.request(step=args.profile_step)      # up-front request
        while ...:
            trigger.maybe_start(step)                # BEFORE the step
            ... run step, read verdict ...
            trigger.on_verdict(step, int(verdict))   # anomaly capture
            trigger.maybe_stop(step)                 # AFTER the step

    ``on_verdict`` arms a capture of the NEXT ``window_steps`` steps when
    the sentinel says ROLLBACK or worse. One capture at a time; each
    lands in ``<log_dir>/<tag>-step<NNNNNN>/trace.json`` (a Chrome trace)
    and is appended to ``captures``. :meth:`maybe_stop` synchronizes the
    card before it stops the profiler, so the window holds every kernel
    the steps queued. Profiler failures are logged, never raised: losing
    a trace must not lose the run. With ``router=`` each completed
    capture emits a ``kind="profile"`` record (path, reason, end_step at
    the capture's start step).
    """

    TRACE_FILE = "trace.json"

    def __init__(
        self,
        log_dir: str,
        window_steps: int = 2,
        on_capture: Optional[Callable[[dict], None]] = None,
        router=None,
    ):
        if window_steps < 1:
            raise ValueError(f"window_steps must be >= 1, got {window_steps}")
        self.log_dir = log_dir
        self.window_steps = int(window_steps)
        self.on_capture = on_capture
        self.router = router
        self.captures: List[dict] = []
        # request() runs on the watchdog thread (the incident dump arms
        # the trigger) while maybe_start/maybe_stop run on the loop:
        # check-then-act on _requested/_active is atomic under this lock;
        # profiler IO never runs under it
        self._state_lock = threading.Lock()
        self._requested: Optional[dict] = None  # {"step": int|None, "reason"}
        self._active: Optional[dict] = None
        self._prof = None

    # -- arming ------------------------------------------------------------

    def request(self, step: Optional[int] = None,
                reason: str = "requested") -> None:
        """Arm a capture at ``step`` (None or past-due: the next step).

        An immediate request (``step=None``, the anomaly path) REPLACES a
        pending scheduled one; a capture already rolling is never
        preempted, and a request while one rolls is refused.
        """
        with self._state_lock:
            if self._active is not None:
                return
            pending = self._requested
            if pending is None or (step is None
                                   and pending["step"] is not None):
                self._requested = {"step": step, "reason": reason}

    def on_verdict(self, step: int, verdict: int) -> None:
        """Arm on sentinel escalation (>= VERDICT_ROLLBACK)."""
        from apex_tpu_torch.resilience.sentinel import VERDICT_ROLLBACK

        if int(verdict) >= VERDICT_ROLLBACK:
            self.request(reason=f"verdict={int(verdict)}")

    # -- step-loop hooks ---------------------------------------------------

    def maybe_start(self, step: int) -> bool:
        """Start the profiler if a request is due at ``step``; True if so."""
        with self._state_lock:
            req = self._requested
            if req is None or self._active is not None:
                return False
            if req["step"] is not None and step < req["step"]:
                return False
            path = os.path.join(
                self.log_dir,
                f"{req['reason'].replace('=', '')}-step{step:06d}"
            )
            self._requested = None
            self._active = {
                "path": path, "start_step": step, "reason": req["reason"],
            }
        try:
            os.makedirs(path, exist_ok=True)
            prof = _new_profile()
            prof.start()
        except Exception as e:  # another session open, no CUPTI, ...
            logger.warning("profiler capture failed to start: %s", e)
            with self._state_lock:
                self._active = None
            return False
        self._prof = prof
        logger.info("profiler capture started: %s", path)
        return True

    def maybe_stop(self, step: int) -> Optional[dict]:
        """Stop after ``window_steps`` steps and write the trace; returns
        the capture info."""
        with self._state_lock:
            act = self._active
            if act is None or \
                    step - act["start_step"] + 1 < self.window_steps:
                return None
            self._active = None  # exactly one caller stops this capture
        prof, self._prof = self._prof, None
        trace = os.path.join(act["path"], self.TRACE_FILE)
        try:
            import torch

            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            prof.stop()
            prof.export_chrome_trace(trace)
        except Exception as e:
            logger.warning("profiler capture failed to stop: %s", e)
            return None
        info = {**act, "end_step": step, "trace": trace}
        self.captures.append(info)
        if self.router is not None:
            try:
                self.router.event(
                    "profile", info["start_step"], path=info["path"],
                    reason=info["reason"], end_step=step,
                )
            except Exception as e:
                logger.warning("profile record emit failed: %s", e)
        if self.on_capture is not None:
            try:
                self.on_capture(info)
            except Exception as e:
                logger.warning("on_capture handler failed: %s", e)
        logger.info("profiler capture written: %s", trace)
        return info

    def close(self) -> None:
        """Abort any in-flight capture (end of run); writes nothing."""
        with self._state_lock:
            act = self._active
            self._active = None
        prof, self._prof = self._prof, None
        if act is not None and prof is not None:
            try:
                prof.stop()
            except Exception:
                pass
