"""Run-level phase spans: the wall-clock side of the record stream.

The step timeline answers "where did the STEP's wall clock go" from a
profiler capture; nothing answered "where did the JOB's wall clock go" —
compile, checkpoint save/restore, rollback recovery, stalls, and
restarts were invisible to the record stream. Following TorchTitan's
framing of production training as a *goodput* problem (arXiv:2410.06511:
productive step time over total occupancy, checkpointing and recovery
off the critical path), every host-side phase of a run now emits a
``kind="span"`` record through the shared MetricRouter schema:

    {"t", "step", "kind": "span", "host", "phase", "start", "dur_s"}

``start`` is ``time.perf_counter()`` (monotonic, process-local — NEVER
comparable across incarnations; the accountant re-anchors per
incarnation), ``dur_s`` the span's wall seconds, ``phase`` one of the
CLOSED registry :data:`PHASES`. The registry is deliberately closed —
:func:`span` rejects ad-hoc strings at runtime — because the goodput partition is only
comparable across runs if every run buckets time the same way.

Wiring: library call sites (``AutoResume`` save/restore,
``ResilienceManager.do_rollback``, ``AmpOptimizer.init``,
``StallWatchdog``) emit through the process-global router registered
with :func:`set_router`; with no router registered every span is a
no-op, so the library costs nothing un-wired. Each training incarnation
announces itself with :func:`run_header` (a ``kind="run"`` record
carrying a stable ``run_id``) so the accountant can join the multiple
jsonl incarnations of a crashed/restarted job.

Torn-stream protection: open spans are tracked; ``flush_open_spans``
emits them with ``interrupted=True``, and registering a router installs
the router module's best-effort atexit/SIGTERM teardown so a real
SIGTERM (the chaos harness's preemption drill) cannot tear the final
spans off the stream.

Copied from apex_tpu/monitor/goodput/spans.py, which imports no JAX;
the ``host`` field comes from ``make_record`` (router.py), the process
group rank when one is initialized.
"""

import hashlib
import os
import threading
import time
import uuid
from contextlib import contextmanager
from typing import Optional

from apex_tpu_torch.monitor import router as _router_mod

__all__ = [
    "PHASES",
    "PHASE_PRIORITY",
    "PRODUCTIVE_PHASE",
    "PRODUCTIVE_PHASES",
    "Span",
    "span",
    "begin_span",
    "emit_span",
    "run_header",
    "derive_run_id",
    "set_router",
    "get_router",
    "flush_open_spans",
]

#: The closed phase taxonomy. Every span names exactly one of these;
#: ``span()`` raises on anything else.
#:
#: - ``step``          — a productive optimizer step (the goodput numerator)
#: - ``compile``       — compilation blocking the loop (in this port: a
#:   kernel library built and loaded, as in ``ServingEngine.start``)
#: - ``data_wait``     — host blocked on the input pipeline
#: - ``ckpt_save``     — host blocked issuing/finalizing a checkpoint
#: - ``ckpt_restore``  — restoring one at startup
#: - ``rollback``      — in-memory snapshot restore after an anomaly
#: - ``stall``         — watchdog-detected dead time (no heartbeat)
#: - ``incident``      — a stall that escalated: the wedged time from the
#:   last heartbeat to the incident responder's self-termination
#:   (resilience.health; docs/resilience.md "Incident response")
#: - ``remediation``   — the auto-remediation controller's envelope
#:   (resilience.remediation; docs/resilience.md "Auto-remediation"):
#:   canary re-execution of a suspect segment, quarantine bookkeeping,
#:   probation accounting. Outranks ``step`` in PHASE_PRIORITY so a
#:   canary replay's nested ``step``/``ckpt_restore`` spans book as
#:   recovery badput, never silently productive — automated recovery
#:   time is still recovery time
#: - ``prefill``       — a serving prefill pass: prompt tokens entering
#:   the KV cache (apex_tpu_torch.serving; productive, like ``step``)
#: - ``decode``        — a serving decode tick: one token per in-flight
#:   request through the batched KV-cache step (productive)
#: - ``handoff``       — a fleet KV handoff: a request's cache blocks
#:   moving between a prefill replica's pool and a decode replica's
#:   (serving.fleet, docs/serving.md "Fleet"). Badput by definition —
#:   no tokens move while blocks are in flight — and ledgered like a
#:   collective (the HandoffLedger books both sides' bytes).
#: - ``failover``      — the fleet router's failover envelope: a dead
#:   replica detected and its in-flight requests re-dispatched. Outranks
#:   the serving work phases the way ``remediation`` outranks ``step``:
#:   automated recovery time is still recovery time.
#: - ``drain``         — the graceful-drain window after a termination
#:   notice: admission closed, in-flight requests finishing or being
#:   deadline-evicted (docs/serving.md). Outranked by prefill/decode so
#:   only the drain OVERHEAD (waiting, teardown) books as badput.
#: - ``init``          — everything else before the loop (model build,
#:   corpus, audits, banners)
#: - ``shutdown``      — everything after it (final saves, analysis)
PHASES = (
    "init",
    "compile",
    "data_wait",
    "step",
    "prefill",
    "decode",
    "handoff",
    "failover",
    "ckpt_save",
    "ckpt_restore",
    "rollback",
    "stall",
    "incident",
    "remediation",
    "drain",
    "shutdown",
)

PRODUCTIVE_PHASE = "step"

#: Phases that count as PRODUCTIVE wall clock in the accountant's
#: partition. Training has one ("step"); serving adds two — a prefill
#: or decode second is the serving analogue of a step second (tokens
#: moving through the model), and booking it as badput would make every
#: healthy serving run read as 0% goodput. The partition identity is
#: unchanged: productive_s is the union-seconds of ALL these phases.
PRODUCTIVE_PHASES = ("step", "prefill", "decode")

#: Attribution order for overlapping spans (accountant.py): a second of
#: wall time belongs to the FIRST phase in this tuple whose span covers
#: it, so an async checkpoint save overlapped by a step stays off the
#: badput books (TorchTitan's off-the-critical-path accounting) and a
#: ckpt_restore nested inside the broad ``init`` span is not counted
#: twice. Same union-not-sum discipline as the timeline analyzer.
#:
#: ``incident`` outranks even ``step``: an incident span exists only when
#: the escalating watchdog PROVED the time was dead (a wedged step is
#: indistinguishable from a long one until the deadline blows), so the
#: still-open pseudo-step span it overlaps must not book as productive.
#: ``remediation`` outranks ``step`` for the same reason from the other
#: side: the controller's canary re-executes journaled steps (which book
#: their own ``step``/``ckpt_restore`` spans through the replayer), and
#: a re-executed step moves no NEW tokens — the whole envelope is
#: recovery badput by definition, so the envelope must claim the wall
#: time before the nested work phases can.
#: ``failover`` sits with the recovery envelopes (below ``remediation``,
#: above ``step``): a re-dispatch storm's wall time is recovery badput
#: even where a survivor's decode span overlaps it.
#: ``handoff`` sits just below the serving work phases: the block copy
#: blocks the fleet loop, but a decode tick overlapping it (another
#: replica's lane advancing) is still productive time.
#: ``drain`` sits below the serving work phases (a drain window is an
#: envelope: decode ticks inside it are still productive) but above
#: ``init``/``shutdown`` so its exposed overhead is named, not generic.
PHASE_PRIORITY = (
    "incident",
    "remediation",
    "failover",
    "step",
    "prefill",
    "decode",
    "handoff",
    "ckpt_save",
    "ckpt_restore",
    "rollback",
    "compile",
    "data_wait",
    "stall",
    "drain",
    "init",
    "shutdown",
)

assert set(PHASE_PRIORITY) == set(PHASES)

_ROUTER: Optional["_router_mod.MetricRouter"] = None
_OPEN: dict = {}  # id(span) -> Span, insertion-ordered
_LOCK = threading.Lock()


def set_router(router) -> None:
    """Register the process-global router library spans emit through.

    Also registers :func:`flush_open_spans` with the router module's
    atexit/SIGTERM teardown (router.py ``register_flush_hook``, which
    dedups — re-registering on every call keeps the torn-stream
    guarantee self-healing even after a test clears the hook list), so a
    termination that bypasses the normal shutdown path still lands the
    in-flight spans — marked ``interrupted=True`` — before sinks close.
    Pass ``None`` to un-register (tests).
    """
    global _ROUTER
    _ROUTER = router
    if router is not None:
        _router_mod.register_flush_hook(flush_open_spans)


def get_router():
    """The process-global span router (None when un-wired)."""
    return _ROUTER


def emit_span(router, phase: str, start: float, dur_s: float,
              step: Optional[int] = None, interrupted: bool = False,
              **fields) -> Optional[dict]:
    """Emit one ``kind="span"`` record (the one span record shape).

    ``start`` is a ``time.perf_counter()`` value; producers that measure
    a span themselves (the stall watchdog reconstructs one from its last
    heartbeat) emit through here so the accountant sees a single schema.
    """
    if router is None:
        return None
    extra = dict(fields)
    if interrupted:
        extra["interrupted"] = True
    return router.event(
        "span", -1 if step is None else step,
        phase=str(phase), start=float(start), dur_s=float(dur_s), **extra,
    )


class Span:
    """One open phase span; emits its record on :meth:`close`.

    Construct via :func:`begin_span` (explicit begin/end around a block
    that would be ugly to indent) or :func:`span` (context manager).
    ``close`` is idempotent; an un-closed span is flushed
    ``interrupted=True`` by the teardown hooks.
    """

    def __init__(self, phase: str, step: Optional[int] = None,
                 router=None, **fields):
        if phase not in PHASES:
            raise ValueError(
                f"unknown span phase {phase!r}; the taxonomy is closed "
                f"(see goodput.spans.PHASES): {PHASES}"
            )
        self.phase = phase
        self.step = step
        self.fields = fields
        self._router = router
        self._closed = False
        self.start = time.perf_counter()
        with _LOCK:
            _OPEN[id(self)] = self

    def close(self, interrupted: bool = False) -> Optional[dict]:
        if self._closed:
            return None
        self._closed = True
        with _LOCK:
            _OPEN.pop(id(self), None)
        dur = time.perf_counter() - self.start
        router = self._router if self._router is not None else _ROUTER
        return emit_span(
            router, self.phase, self.start, dur, step=self.step,
            interrupted=interrupted, **self.fields,
        )

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def begin_span(phase: str, step: Optional[int] = None, router=None,
               **fields) -> Span:
    """Start a span now; caller owns ``.close()`` (see :class:`Span`)."""
    return Span(phase, step=step, router=router, **fields)


@contextmanager
def span(phase: str, step: Optional[int] = None, router=None, **fields):
    """Context manager emitting one ``kind="span"`` record on exit::

        with goodput.span("data_wait", step=i):
            batch = next(it)

    ``router`` overrides the process-global one (library components that
    already hold a router — ResilienceManager — pass theirs explicitly);
    with neither, the span is measured and dropped (no-op wiring).
    """
    s = Span(phase, step=step, router=router, **fields)
    try:
        yield s
    finally:
        s.close()


def flush_open_spans() -> int:
    """Emit every still-open span ``interrupted=True``; returns the count.

    The teardown half of the torn-stream guarantee: called by the router
    module's atexit/SIGTERM hooks (and usable directly in tests) so the
    final spans of a killed run exist in the stream with their partial
    durations instead of vanishing.
    """
    with _LOCK:
        open_spans = list(_OPEN.values())
    for s in open_spans:
        s.close(interrupted=True)
    return len(open_spans)


def derive_run_id(anchor: Optional[str] = None) -> str:
    """A run id: stable across incarnations when ``anchor`` names the
    job's durable identity (the ``--save`` directory — every restart of
    the same job points at the same path), random otherwise.

    The accountant joins incarnations on this id, so a crashed job's
    restarts partition into ONE goodput ledger.
    """
    if anchor:
        digest = hashlib.sha1(
            os.path.abspath(anchor).encode("utf-8")
        ).hexdigest()
        return f"run-{digest[:12]}"
    return f"run-{uuid.uuid4().hex[:12]}"


def run_header(router, run_id: str, step: int = 0, **fields) -> dict:
    """Emit this incarnation's ``kind="run"`` header record.

    Every incarnation of a job emits one at startup (before any span):
    ``run_id`` is the join key across incarnations, ``mono`` anchors the
    incarnation's monotonic clock (wall time before the first span —
    interpreter start-up, imports — lands in ``unattributed`` instead of
    silently shrinking the wall), ``pid`` disambiguates incarnations that
    share a second.
    """
    return router.event(
        "run", step, run_id=str(run_id), mono=time.perf_counter(),
        pid=os.getpid(), **fields,
    )
