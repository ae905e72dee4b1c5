"""Forensic incident bundles (counterpart of
apex_tpu/resilience/health/incident.py, copied as it is there: plain
Python): everything a post-mortem needs, captured from a live (wedged)
process and emitted as ONE ``kind="incident"`` record.

``capture_incident`` runs on the WATCHDOG thread, because the loop
thread is the one that is stuck, and gathers:

- **all-thread stacks** — a ``faulthandler``-style dump built from
  ``sys._current_frames()`` (it must land in the record stream, which
  ``faulthandler``'s fd-only API cannot do);
- **the record tail** — the last N records of an in-process
  :class:`~apex_tpu_torch.monitor.router.MemorySink` window;
- **last verdicts** — the sentinel/rollback/stall/preemption records of
  that tail;
- **the journal tail** — the last ``kind="journal"`` records of that
  tail;
- **a best-effort profiler request** — arming the
  :class:`~apex_tpu_torch.monitor.ProfilerTrigger` costs nothing and
  pays off when the loop is merely crawling (recorded as
  ``profile_requested``, not promised as a capture).

The record keeps the JAX package's schema and keys.
"""

import logging
import sys
import threading
import traceback
from typing import List, Optional

from apex_tpu_torch.monitor.router import make_record

logger = logging.getLogger("apex_tpu_torch.resilience.health")

__all__ = ["VERDICT_KINDS", "thread_stacks", "capture_incident"]

#: record kinds extracted from the window tail as the "last verdicts"
#: slice of the bundle: the sentinel/rollback escalation trail
#: (resilience.rollback), watchdog stalls, and preemption decisions
VERDICT_KINDS = frozenset({
    "skip", "rollback", "rollback_restore", "halt", "stall", "preemption",
})


def thread_stacks(max_frames: int = 40) -> str:
    """A ``faulthandler``-style dump of every live thread's stack.

    Innermost frames last, ``max_frames`` outermost frames dropped first
    (the wedged frame is at the bottom; an unbounded asyncio stack must
    not drown it). Safe to call from any thread — including on the
    calling thread's own (watchdog) stack, which is included just as
    faulthandler includes it.
    """
    names = {t.ident: t.name for t in threading.enumerate()}
    chunks: List[str] = []
    for ident, frame in sorted(sys._current_frames().items()):
        name = names.get(ident, "?")
        chunks.append(f"Thread {name} (ident {ident}):")
        stack = traceback.format_stack(frame)
        if len(stack) > max_frames:
            chunks.append(f"  ... {len(stack) - max_frames} outer "
                          f"frame(s) dropped ...")
            stack = stack[-max_frames:]
        chunks.extend(line.rstrip("\n") for line in stack)
        chunks.append("")
    return "\n".join(chunks)


def capture_incident(
    router,
    step: Optional[int],
    stage: str = "dump",
    overdue_s: Optional[float] = None,
    deadline_s: Optional[float] = None,
    window=None,
    tail: int = 64,
    trigger=None,
    **extra,
) -> dict:
    """Capture a forensic bundle and emit it as a ``kind="incident"``
    record (module docstring); returns the record.

    ``window`` is the in-process MemorySink whose last ``tail`` records
    become the bundle's record tail (previous incident bundles are
    excluded — a bundle quoting a bundle quoting a bundle is noise, not
    forensics). With ``router=None`` the record is built and returned
    but not emitted (tests, ad-hoc captures).
    """
    stacks = thread_stacks()
    tail_records: List[dict] = []
    if window is not None:
        # snapshot(), not list(window.records): this runs on the WATCHDOG
        # thread while a merely-slow training thread may still be
        # emitting into the same window — a raw deque iteration could
        # raise mid-dump and lose the bundle for the episode
        source = (window.snapshot() if hasattr(window, "snapshot")
                  else list(window.records))
        tail_records = [
            r for r in source if r.get("kind") != "incident"
        ][-int(tail):]
    verdicts = [
        r for r in tail_records if r.get("kind") in VERDICT_KINDS
    ][-8:]
    journal_tail = [
        r for r in tail_records if r.get("kind") == "journal"
    ][-8:]
    profile_requested = False
    if trigger is not None:
        try:
            # best-effort: outranks any scheduled --profile-step request
            # (the trigger's immediate-request precedence), captures only
            # if the loop ever moves again
            trigger.request(reason="incident")
            profile_requested = True
        except Exception as e:  # noqa: BLE001 - forensics must not raise
            logger.warning("incident profiler request failed: %s", e)
    fields = dict(
        stage=str(stage),
        overdue_s=overdue_s,
        deadline_s=deadline_s,
        n_threads=len(sys._current_frames()),
        stacks=stacks,
        record_tail=tail_records,
        verdicts=verdicts,
        journal_tail=journal_tail,
        profile_requested=profile_requested,
        **extra,
    )
    logger.warning(
        "incident bundle captured (stage=%s step=%s): %d thread stack(s), "
        "%d tail record(s), %d verdict record(s)",
        stage, step, fields["n_threads"], len(tail_records), len(verdicts),
    )
    if router is not None:
        try:
            return router.event(
                "incident", -1 if step is None else int(step), **fields
            )
        except Exception as e:  # noqa: BLE001 - forensics must not raise
            logger.warning("incident record emit failed: %s", e)
    return make_record("incident", -1 if step is None else int(step),
                       **fields)
