"""Trace-context emission: one causal span tree per served request.

The serving fleet closes every request's LIFECYCLE (``kind="request"``
transition records, exactly one terminal per fleet-wide global id) — but
those records are flat: a request that crosses the router, a prefill
replica, a ledgered KV handoff, a decode replica, and a failover
re-dispatch leaves its wall-clock story scattered over five emitters,
and "where did p99 TTFT go?" has no per-request answer. This module adds
the causal view — the step timeline's discipline at request granularity:

- the request's fleet-wide global id IS the trace id (``trace`` field);
- every wall-clock segment the request occupies becomes one
  ``kind="trace"`` span record (``span``/``parent`` links, ``attempt``
  tag, emitting ``site``) through the shared MetricRouter, so the spans
  of one request land in one stream even when they come from different
  replicas and incarnations;
- the tree is two-level BY CONSTRUCTION: one root span (``span="r"``,
  ``parent=None``, emitted exactly once at the terminal transition;
  its ``start`` is the ORIGINAL submit time, so the root is the
  client-visible wall) plus flat phase children with ``parent="r"`` —
  rebuilding a tree is grouping by ``trace``, not graph search.

Phase children carry ``phase`` in :data:`~apex_tpu_torch.serving.trace.
analyze.REQUEST_PHASES` (queue / prefill / handoff / decode / recovery)
and feed the exclusive-time decomposition; informational markers
(dispatch, stall exposure) carry ``phase=None`` and never enter the
partition — they explain overhead, they don't bill it.

Clock discipline: every span anchor comes from the emitter's INJECTED
``time_fn`` — the same clock the engine schedules with (fleet
chaos drills replay on virtual time) — so span intervals are comparable with ``submit_t``/``end_t``
within one process. Recovery and handoff spans additionally carry
goodput TWIN fields (``gp_phase``/``gp_start``/``gp_dur_s``, copied
verbatim from the closed goodput span record, perf_counter domain) so
the analyzer can reconcile per-request attribution against the fleet
accountant's failover/handoff badput digit-for-digit.

Lost work is honest: a decode segment opened on a replica that dies is
never closed, so the time between the last heartbeat and the failover
re-dispatch books as exposed overhead in the decomposition — exactly the
window the fleet's ``miss_ticks_to_detect`` knob controls.

This module is the ONE blessed construction site for ``kind="trace"``
records (:mod:`apex_tpu_torch.serving.trace.slo` is the one for
``kind="slo"``), so the span schema cannot fork.

Copied from apex_tpu/serving/trace/emit.py, which imports no JAX.
"""

from typing import Any, Callable, Dict, Iterable, Optional, Tuple

from apex_tpu_torch.serving.lifecycle import (
    ADMITTED, DECODE, PREFILL, QUEUED, TERMINAL_STATES, Request,
)

__all__ = ["ROOT_SPAN", "TraceEmitter"]

#: the reserved span id of every trace tree's single root
ROOT_SPAN = "r"


def _attempt_of(req: Request) -> int:
    """The dispatch attempt this request is on (1 outside a fleet)."""
    try:
        return int(req.tags.get("attempt", 1))
    except (TypeError, ValueError):
        return 1


class TraceEmitter:
    """Stateful per-emitter trace-span producer (module docstring).

    One instance per engine (``site`` is the replica incarnation, e.g.
    ``"r1.2"``; the fleet router sets it on restart) plus one for the
    fleet router itself (``site="fleet"``). Engine-side spans are driven
    by :func:`~apex_tpu_torch.serving.lifecycle.emit_request_record` — the
    single request-record emission point — via its ``trace=`` hook, so
    every lifecycle transition feeds the tree without per-call-site
    wiring; the engine adds explicit calls only where a timestamp is not
    on the request (:meth:`extracted`/:meth:`adopted` for KV handoff,
    :meth:`stall` for hang exposure). With ``router=None`` every emit is
    a no-op (un-wired library cost: nothing), but state tracking still
    runs so a late-wired router sees a consistent emitter.
    """

    def __init__(self, router, site: str = "engine",
                 time_fn: Optional[Callable[[], float]] = None):
        self.router = router
        self.site = site
        self.time_fn = time_fn if time_fn is not None else (lambda: 0.0)
        self._enq: Dict[int, float] = {}      # rid -> local enqueue time
        self._pf: Dict[int, float] = {}       # rid -> prefill start
        #: rid -> (start, span_id, attempt) of the OPEN decode segment
        self._seg: Dict[int, Tuple[float, str, int]] = {}
        self._n = 0                           # per-emitter unique suffix

    # -- the one kind="trace" construction site -------------------------

    def _emit(self, tick: int, rid: int, name: str, span_id: str, *,
              parent: Optional[str], phase: Optional[str], start: float,
              dur_s: float, attempt: int, **extra) -> Optional[dict]:
        if self.router is None:
            return None
        return self.router.event(
            "trace", int(tick), trace=int(rid), span=span_id,
            parent=parent, name=name, phase=phase, start=float(start),
            dur_s=float(dur_s), attempt=int(attempt), site=self.site,
            **extra)

    def _child(self, tick: int, rid: int, name: str, span_id: str,
               phase: Optional[str], start: float, dur_s: float,
               attempt: int, **extra) -> Optional[dict]:
        return self._emit(tick, rid, name, span_id, parent=ROOT_SPAN,
                          phase=phase, start=start, dur_s=dur_s,
                          attempt=attempt, **extra)

    # -- engine-side: driven by emit_request_record(trace=...) ----------

    def on_record(self, tick: int, req: Request) -> None:
        """One lifecycle transition happened; grow ``req``'s tree."""
        rid = req.rid
        attempt = _attempt_of(req)
        state = req.state
        if state == QUEUED:
            # at QUEUED-emit time submit_t IS the local enqueue instant
            # (the fleet restores the original only after submit returns)
            self._enq[rid] = float(req.submit_t)
        elif state == ADMITTED:
            enq = self._enq.pop(rid, None)
            if enq is not None and req.admit_t is not None:
                self._child(tick, rid, "queue",
                            f"{self.site}.queue.{attempt}", "queue",
                            enq, req.admit_t - enq, attempt)
        elif state == PREFILL:
            self._pf[rid] = self.time_fn()
        elif state == DECODE:
            pf = self._pf.pop(rid, None)
            first = req.first_token_t
            if pf is not None and first is not None:
                self._child(tick, rid, "prefill",
                            f"{self.site}.prefill.{attempt}", "prefill",
                            pf, first - pf, attempt)
            self._open_seg(rid, first if first is not None
                           else self.time_fn(), attempt)
        elif state in TERMINAL_STATES:
            self._terminal(tick, req, attempt)

    def _open_seg(self, rid: int, start: float, attempt: int) -> None:
        self._n += 1
        self._seg[rid] = (
            float(start), f"{self.site}.decode.{attempt}.{self._n}",
            attempt)

    def _close_seg(self, tick: int, rid: int, end: float) -> None:
        seg = self._seg.pop(rid, None)
        if seg is not None:
            start, span_id, attempt = seg
            self._child(tick, rid, "decode", span_id, "decode",
                        start, end - start, attempt)

    def _terminal(self, tick: int, req: Request, attempt: int) -> None:
        rid = req.rid
        end = req.end_t if req.end_t is not None else self.time_fn()
        self._close_seg(tick, rid, end)
        pf = self._pf.pop(rid, None)
        if pf is not None:
            # single-token completion (the first token IS the terminal
            # token) or a death during prefill: close at whichever of
            # first-token/terminal exists
            first = req.first_token_t
            self._child(tick, rid, "prefill",
                        f"{self.site}.prefill.{attempt}", "prefill",
                        pf, (first if first is not None else end) - pf,
                        attempt)
        enq = self._enq.pop(rid, None)
        if enq is not None and req.admit_t is None:
            # terminal straight from the queue (timeout/cancel/drain
            # shed): the whole residence here was queue wait
            self._child(tick, rid, "queue",
                        f"{self.site}.queue.{attempt}", "queue",
                        enq, end - enq, attempt)
        self._emit(tick, rid, "request", ROOT_SPAN, parent=None,
                   phase=None, start=float(req.submit_t),
                   dur_s=end - float(req.submit_t), attempt=attempt,
                   state=req.state, reason=req.reason,
                   ttft_s=req.ttft_s, tokens_out=len(req.tokens_out))

    # -- engine-side: explicit hooks (no lifecycle transition) ----------

    def extracted(self, tick: int, req: Request) -> None:
        """``req`` left this engine mid-decode (KV handoff extract):
        close its open decode segment and drop all local state — the
        request's story continues on the adopter (or at the fleet)."""
        rid = req.rid
        self._close_seg(tick, rid, self.time_fn())
        self._enq.pop(rid, None)
        self._pf.pop(rid, None)

    def adopted(self, tick: int, req: Request) -> None:
        """``req`` arrived mid-decode (KV handoff adopt): open a fresh
        decode segment on this engine's clock."""
        self._open_seg(req.rid, self.time_fn(), _attempt_of(req))

    def stall(self, tick: int, reqs: Iterable[Request], start: float,
              dur_s: float) -> None:
        """The engine was hung for ``dur_s`` with ``reqs`` in flight:
        mark the exposure on every affected tree (informational,
        ``phase=None`` — the time already belongs to whatever phase
        segment covers it; the marker explains WHY it was slow)."""
        for req in reqs:
            self._n += 1
            self._child(tick, req.rid, "stall",
                        f"{self.site}.stall.{self._n}", None,
                        start, dur_s, _attempt_of(req))

    # -- fleet-side: router dispatch / failover / handoff ---------------

    def dispatched(self, tick: int, req: Request, replica: str) -> None:
        """Zero-duration marker: the fleet routed ``req`` to ``replica``
        (one per attempt — the parent link any cross-replica span tree
        reader can anchor the placement story on)."""
        attempt = _attempt_of(req)
        self._child(tick, req.rid, "dispatch",
                    f"{self.site}.dispatch.{attempt}", None,
                    self.time_fn(), 0.0, attempt, replica=replica)

    def recovery(self, tick: int, rid: int, attempt: int, start: float,
                 end: float, gp: Optional[dict],
                 replica: Optional[str] = None) -> None:
        """The failover envelope as seen by one orphaned request:
        detect -> restart -> re-dispatch. ``gp`` is the CLOSED goodput
        ``failover`` span record; its start/dur ride along verbatim as
        reconciliation twins (perf_counter domain, vs this span's
        ``time_fn`` domain)."""
        self._child(tick, rid, "recovery",
                    f"{self.site}.recovery.{attempt}", "recovery",
                    start, end - start, attempt, replica=replica,
                    **_gp_twin(gp))

    def handoff(self, tick: int, rid: int, attempt: int, start: float,
                end: float, gp: Optional[dict],
                src: Optional[str] = None,
                dst: Optional[str] = None) -> None:
        """One KV migration of ``rid``: extract -> ledger -> adopt.
        ``gp`` is the closed goodput ``handoff`` span covering this
        tick's moves (shared twin across the batch — the analyzer
        dedups by (gp_start, gp_dur_s))."""
        self._n += 1
        self._child(tick, rid, "handoff",
                    f"{self.site}.handoff.{attempt}.{self._n}",
                    "handoff", start, end - start, attempt,
                    src=src, dst=dst, **_gp_twin(gp))


def _gp_twin(gp: Optional[dict]) -> Dict[str, Any]:
    """The goodput-twin fields of a closed span record (empty when the
    producer ran router-less and there is no record to twin)."""
    if not gp:
        return {}
    return {
        "gp_phase": gp.get("phase"),
        "gp_start": gp.get("start"),
        "gp_dur_s": gp.get("dur_s"),
    }
