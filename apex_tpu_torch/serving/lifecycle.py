"""Request lifecycle: the closed state machine every request traverses
(counterpart of apex_tpu/serving/lifecycle.py).

A serving request is only trustworthy if its ending is ACCOUNTED: a
request that vanishes (client never hears back, no record says why) is
the serving analogue of a silently-dropped batch. Every request admitted
to — or refused by — the :class:`~apex_tpu_torch.serving.engine.ServingEngine`
walks this CLOSED machine:

    queued -> admitted -> prefill -> decode -> {completed, timed_out,
                                                cancelled, failed}

with ``rejected`` reachable straight from submission (admission-control
shedding: bounded queue, TTFT budget, malformed payload, drain) and the
other terminal states reachable from every live state — a deadline or a
client disconnect does not wait for a convenient phase. The machine is
closed the same way the goodput span taxonomy is closed
(monitor/goodput/spans.py): :func:`transition` refuses any edge not in
:data:`TRANSITIONS`, so a new engine code path cannot invent a
half-state that fragments the accounting.

Every transition emits ONE ``kind="request"`` record through the shared
MetricRouter schema (StdoutSink skips the kind — a loaded server emits
several per tick; the jsonl stream is the durable home):

    {"t", "step", "kind": "request", "host", "id", "state", "reason",
     "prompt_len", "max_new", "tokens_out", ...}

plus latency fields as they become known (``queue_wait_s`` on
admission, ``ttft_s`` at the first token, ``total_s`` on a terminal
state). ``step`` is the scheduler tick. The terminal record carries
``terminal: true``, so "every submitted request reached exactly one
terminal state" is a one-pass assertion over the stream — the overload
drill's no-silent-drops contract.

Copied from the JAX package's module, which imports no JAX, but for the
``bucket`` field (see :class:`Request`).
"""

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "QUEUED", "ADMITTED", "PREFILL", "DECODE",
    "COMPLETED", "REJECTED", "TIMED_OUT", "CANCELLED", "FAILED",
    "STATES", "TERMINAL_STATES", "TRANSITIONS",
    "Request", "transition", "emit_request_record",
]

QUEUED = "queued"
ADMITTED = "admitted"
PREFILL = "prefill"
DECODE = "decode"
COMPLETED = "completed"
REJECTED = "rejected"
TIMED_OUT = "timed_out"
CANCELLED = "cancelled"
FAILED = "failed"

#: every state a request can be in; the machine below is closed over it
STATES = (
    QUEUED, ADMITTED, PREFILL, DECODE,
    COMPLETED, REJECTED, TIMED_OUT, CANCELLED, FAILED,
)

#: the five endings; exactly one per request, each with a ``reason``
TERMINAL_STATES = frozenset(
    {COMPLETED, REJECTED, TIMED_OUT, CANCELLED, FAILED}
)

#: the closed edge set. ``None`` is the pre-submission pseudo-state: a
#: submission lands in the queue or is shed at the door, nothing else.
TRANSITIONS: Dict[Optional[str], frozenset] = {
    None: frozenset({QUEUED, REJECTED}),
    QUEUED: frozenset({ADMITTED, TIMED_OUT, CANCELLED, REJECTED}),
    ADMITTED: frozenset({PREFILL, TIMED_OUT, CANCELLED, FAILED}),
    PREFILL: frozenset({DECODE, COMPLETED, TIMED_OUT, CANCELLED, FAILED}),
    DECODE: frozenset({COMPLETED, TIMED_OUT, CANCELLED, FAILED}),
}


@dataclasses.dataclass
class Request:
    """One request's mutable lifecycle record (host-side bookkeeping).

    ``prompt`` is a host int array (list/np) — the engine validates it at
    the door; a malformed submission may carry ``prompt=None``.
    ``deadline_s`` is the request's wall budget RELATIVE to submission;
    :meth:`expires_at` is the absolute monotonic instant the scheduler
    enforces at every tick. ``tokens_out`` accumulates generated token
    ids; ``lane``/``blocks`` are the engine's placement (a decode slot
    and the KV pool blocks reserved for the request's worst case).

    The JAX package's ``bucket`` field (the padded prefill shape the
    request was compiled into) has no counterpart: the port has no
    prefill buckets, a prompt runs at its own length.
    """

    rid: int
    prompt: Any
    max_new_tokens: int
    temperature: float = 0.0
    deadline_s: Optional[float] = None
    submit_t: float = 0.0
    state: Optional[str] = None
    reason: Optional[str] = None
    tokens_out: List[int] = dataclasses.field(default_factory=list)
    lane: Optional[int] = None
    blocks: Tuple[int, ...] = ()
    admit_t: Optional[float] = None
    first_token_t: Optional[float] = None
    end_t: Optional[float] = None
    #: per-step next-token logits (host np arrays), populated only under
    #: the engine's ``collect_logits`` debug/test mode
    logits: Optional[List[Any]] = None
    #: caller-owned routing metadata merged into EVERY record this
    #: request emits (the fleet router stamps replica placement, the
    #: prefix-cache hit rate, and the re-dispatch attempt here)
    tags: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def prompt_len(self) -> int:
        return 0 if self.prompt is None else len(self.prompt)

    @property
    def ttft_s(self) -> Optional[float]:
        """Submission -> first generated token (None before it exists)."""
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.submit_t

    @property
    def queue_wait_s(self) -> Optional[float]:
        if self.admit_t is None:
            return None
        return self.admit_t - self.submit_t

    @property
    def terminal(self) -> bool:
        return self.state in TERMINAL_STATES

    def expires_at(self) -> Optional[float]:
        """Absolute monotonic deadline (None = no deadline)."""
        if self.deadline_s is None:
            return None
        return self.submit_t + self.deadline_s


def transition(req: Request, new_state: str, now: Optional[float] = None,
               reason: Optional[str] = None) -> Request:
    """Walk ``req`` one edge of the closed machine (module docstring).

    Refuses unknown states and unregistered edges with a reasoned error
    — an engine bug must fail loudly at the transition, not surface as
    a request stuck in a state the accountants have no bucket for.
    Terminal states are absorbing: transitioning OUT of one raises.

    ``now`` is the caller's injected clock reading (the engine passes
    its ``time_fn()``, which fleet chaos drills replace with a virtual
    clock). With ``now=None`` the edge is walked but no timestamp is
    stamped: ``admit_t``/``end_t`` stay as they were, and the record's
    latency fields simply don't exist yet (None-not-fake-number).
    """
    if new_state not in STATES:
        raise ValueError(
            f"unknown request state {new_state!r}; the machine is closed "
            f"(serving.lifecycle.STATES): {STATES}"
        )
    allowed = TRANSITIONS.get(req.state)
    if allowed is None:
        raise ValueError(
            f"request {req.rid} is terminal ({req.state!r}); terminal "
            f"states are absorbing — exactly one ending per request"
        )
    if new_state not in allowed:
        raise ValueError(
            f"illegal transition {req.state!r} -> {new_state!r} for "
            f"request {req.rid} (allowed: {sorted(allowed)})"
        )
    req.state = new_state
    if reason is not None:
        req.reason = reason
    if now is not None:
        if new_state == ADMITTED:
            req.admit_t = now
        if new_state in TERMINAL_STATES:
            req.end_t = now
    return req


def emit_request_record(router, tick: int, req: Request, trace=None,
                        **extra) -> Optional[dict]:
    """One ``kind="request"`` record for ``req``'s current state.

    Called once per transition by the engine; with ``router=None`` the
    record is a no-op (un-wired library cost: nothing). Latency fields
    are included only once they exist — None-not-fake-number.

    ``trace`` is the emitter's :class:`~apex_tpu_torch.serving.trace.emit.
    TraceEmitter` (or None): because this function is the SINGLE
    request-record emission point, hooking it here grows the request's
    causal span tree on every transition without per-call-site wiring —
    the hook runs after the flat record so the stream reads
    transition-then-spans.
    """
    rec = None
    if router is not None:
        fields = {
            "id": int(req.rid),
            "state": req.state,
            "reason": req.reason,
            "prompt_len": int(req.prompt_len),
            "max_new": int(req.max_new_tokens),
            "tokens_out": len(req.tokens_out),
        }
        if req.tags:
            fields.update(req.tags)
        if req.queue_wait_s is not None:
            fields["queue_wait_s"] = float(req.queue_wait_s)
        if req.ttft_s is not None:
            fields["ttft_s"] = float(req.ttft_s)
        if req.end_t is not None:
            fields["total_s"] = float(req.end_t - req.submit_t)
        if req.terminal:
            fields["terminal"] = True
        fields.update(extra)
        rec = router.event("request", int(tick), **fields)
    if trace is not None:
        trace.on_record(int(tick), req)
    return rec
