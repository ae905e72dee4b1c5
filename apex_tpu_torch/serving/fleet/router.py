"""FleetRouter: N serving replicas behind one submit/tick/drain surface.

The fleet is the serving tree's answer to the training tree's
supervisor: one process loss must cost a recovery envelope, not the
run. The router owns N :class:`~apex_tpu_torch.serving.fleet.replica.Replica`
wrapped engines and drives them from ONE tick loop, adding exactly four
behaviors on top of the single-engine contract — each one auditable in
the shared record stream:

**Failover** (replica.py): replicas heartbeat per tick; a replica whose
beats stop for ``miss_ticks_to_detect`` consecutive ticks opens a
remediation case (the policy table, ``incident`` -> restart), and the
router — inside a ``failover`` goodput span — re-dispatches every
non-terminal request the dead replica owned as a fresh attempt UNDER
THE SAME GLOBAL ID with the ORIGINAL submit time. Idempotence falls out
of the lifecycle machine: the dead incarnation's records never reach a
terminal state (its engine is never ticked again), the re-dispatched
attempt terminates exactly once, so the stream shows exactly one
terminal record per id — the same closure assertion the single-engine
drills run, now fleet-wide. The replica itself restarts through the
supervisor's exit-code contract and serves under probation until the
case closes.

**KV handoff / disaggregation** (handoff.py): with
``prefill_replicas > 0`` the first N replicas run prompt ingestion only
— each tick, their freshly-prefilled requests migrate mid-flight to a
decode replica via ``engine.extract``/``adopt``, inside a ``handoff``
goodput span, with both sides of every block transfer booked in the
:class:`~apex_tpu_torch.serving.fleet.handoff.HandoffLedger` (the collective-
ledger rule applied to KV traffic: bytes out must equal bytes in, or
the audit says which seq lost them).

**Prefix-aware placement** (prefix.py): a radix index over past prompts
routes a new request to the replica already holding its longest shared
prefix; the hit lands on the request's OWN records
(``prefix_hit_tokens``/``prefix_hit_rate`` tags), falling back to
least-loaded placement on a miss.

**Elastic scaling** (autoscaler.py): the fleet's best-placement TTFT
estimate drives a two-sided debounced scaler; scale-up builds a replica
through the same factory (its kernel-load burst, this port's
counterpart of a compile, booked as the new replica's
``compile`` span, every SURVIVOR's watcher re-anchored via
``acknowledge_compiles`` so the process-global compile counter doesn't
charge them); scale-down picks the least-loaded victim and retires it
through ``drain(deadline=)`` so all of its requests reach terminal
states first.

Single-threaded by design: replicas tick sequentially inside one loop,
so the shared record stream's goodput spans never overlap and the accountant's
partition identity holds fleet-wide with ``==``.
"""

import dataclasses
import logging
import time
from typing import Any, Dict, List, Optional

import numpy as np

from apex_tpu_torch.monitor.goodput.spans import begin_span
from apex_tpu_torch.resilience.remediation.policy import RemediationPolicy
from apex_tpu_torch.serving.fleet.autoscaler import FleetAutoscaler
from apex_tpu_torch.serving.fleet.handoff import HandoffLedger
from apex_tpu_torch.serving.fleet.prefix import RadixPrefixIndex
from apex_tpu_torch.serving.fleet.replica import Replica
from apex_tpu_torch.serving.trace.emit import TraceEmitter
from apex_tpu_torch.serving.trace.slo import SLOMonitor
from apex_tpu_torch.serving.lifecycle import (
    DECODE,
    FAILED,
    QUEUED,
    Request,
    emit_request_record,
    transition,
)

logger = logging.getLogger("apex_tpu_torch.serving")

__all__ = ["FleetConfig", "FleetRouter", "engine_factory"]


def engine_factory(model, config, router=None, device="cuda",
                   **engine_kw):
    """The ``engine_factory(name, incarnation)`` a :class:`FleetRouter`
    takes: each call builds one unstarted
    :class:`~apex_tpu_torch.serving.engine.ServingEngine` over the shared
    ``model`` with a KV pool of its own, on ``device`` (CUDA unless the
    caller names another: without a card the first call raises)."""
    from apex_tpu_torch.serving.engine import ServingEngine

    def factory(name, incarnation):
        return ServingEngine(model, config, device=device, router=router,
                             **engine_kw)

    return factory


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Fleet topology and health/scaling policy (docs/serving.md).

    ``replicas`` is the initial size; ``prefill_replicas`` first N of
    them run prefill-only (0 = unified fleet, no disaggregation — there
    must remain at least one non-prefill replica to decode).
    ``miss_ticks_to_detect`` is the heartbeat watchdog threshold in
    fleet ticks (tick-keyed: chaos drills replay deterministically).
    ``ttft_budget_s`` arms the autoscaler (None = fixed fleet) between
    ``min_replicas`` and ``max_replicas``; ``scale_down_grace_s`` is
    the drain budget a retiring replica gets. The same TTFT budget also
    arms the SLO burn-rate monitor (trace/slo.py) when a record router
    is wired: ``slo_target`` is the promised good-request fraction over
    the last ``slo_window`` terminals (``slo_min_count`` keeps a
    near-empty window from paging), and a fast-burn alert feeds the
    autoscaler's debounce as secondary evidence.
    """

    replicas: int = 2
    prefill_replicas: int = 0
    min_replicas: int = 1
    max_replicas: int = 4
    miss_ticks_to_detect: int = 3
    ttft_budget_s: Optional[float] = None
    breach_ticks: int = 3
    clear_ticks: int = 20
    scale_down_grace_s: float = 5.0
    prefix_max_nodes: int = 4096
    slo_target: float = 0.99
    slo_window: int = 64
    slo_min_count: int = 8

    def __post_init__(self):
        if self.replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {self.replicas}")
        if not (0 <= self.prefill_replicas < self.replicas):
            raise ValueError(
                f"prefill_replicas ({self.prefill_replicas}) must leave "
                f"at least one decode replica (fleet of {self.replicas})"
            )
        if not (1 <= self.min_replicas <= self.max_replicas):
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{self.min_replicas}/{self.max_replicas}"
            )
        if self.miss_ticks_to_detect < 1:
            raise ValueError(
                f"miss_ticks_to_detect must be >= 1, got "
                f"{self.miss_ticks_to_detect}"
            )


class FleetRouter:
    """The fleet front door (module docstring).

    ``engine_factory(name, incarnation)`` builds one UNSTARTED
    :class:`~apex_tpu_torch.serving.engine.ServingEngine` per call
    (:func:`engine_factory` makes one) — the router starts them (and
    restarts/scales through the same factory).
    Drop-in for the single-engine drive loop: ``submit``/``cancel``/
    ``tick``/``drain``/``idle`` keep the engine's signatures, so the
    load generator pumps a fleet unchanged.
    """

    def __init__(self, engine_factory, config: FleetConfig,
                 policy: Optional[RemediationPolicy] = None,
                 router=None, fault_plan=None, time_fn=time.monotonic):
        self.config = config
        self.policy = policy if policy is not None else RemediationPolicy()
        self.router = router
        self.fault_plan = fault_plan
        self.time_fn = time_fn
        self._factory = engine_factory
        self._next_rid = 0
        self._next_replica_idx = 0
        self._tick = 0
        self._started = False
        self._draining = False
        self._drain_report: Optional[dict] = None
        self.failovers = 0
        self.redispatched = 0
        #: rid -> dispatch entry: the request's CURRENT home plus
        #: everything needed to re-dispatch it (failover) or find it
        #: (cancel); ``req`` tracks the latest attempt's Request object
        self._dispatch: Dict[int, Dict[str, Any]] = {}
        self.replicas: List[Replica] = []
        for _ in range(config.replicas):
            self._new_replica()
        self.ledger = HandoffLedger(router=router)
        block_size = self.replicas[0].engine.config.block_size
        self.prefix = RadixPrefixIndex(
            block_size=block_size, max_nodes=config.prefix_max_nodes)
        #: the fleet's own trace-span producer: dispatch markers plus
        #: the recovery/handoff spans no single engine can see
        self.trace = TraceEmitter(router, site="fleet", time_fn=time_fn)
        self.slo = None
        if router is not None and config.ttft_budget_s is not None:
            self.slo = SLOMonitor(
                router, ttft_budget_s=config.ttft_budget_s,
                target=config.slo_target, window=config.slo_window,
                min_count=config.slo_min_count,
            )
            # enqueue-only tap (the ControllerSink idiom): terminal
            # request records feed the burn window; classification
            # happens at poll time, outside the router fan-out
            router.add_sink(self.slo.sink())
        self.autoscaler = None
        if config.ttft_budget_s is not None:
            self.autoscaler = FleetAutoscaler(
                ttft_budget_s=config.ttft_budget_s,
                min_replicas=config.min_replicas,
                max_replicas=config.max_replicas,
                breach_ticks=config.breach_ticks,
                clear_ticks=config.clear_ticks,
                router=router,
            )

    def _new_replica(self) -> Replica:
        idx = self._next_replica_idx
        self._next_replica_idx += 1
        role = ("prefill" if idx < self.config.prefill_replicas
                else ("decode" if self.config.prefill_replicas else "any"))
        rep = Replica(
            f"r{idx}", self._factory, role=role, policy=self.policy,
            router=self.router,
        )
        self.replicas.append(rep)
        return rep

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "FleetRouter":
        """Start every replica, then re-anchor every compile watcher:
        each engine's start() compiles AFTER earlier engines created
        their (process-global-counter) watchers, so without the
        re-anchor the LAST replica's warmup would land on the first
        replica's steady-state violation count."""
        if self._started:
            return self
        for rep in self.replicas:
            rep.start()
        for rep in self.replicas:
            rep.engine.acknowledge_compiles()
        self._started = True
        logger.info(
            "fleet ready: %d replicas (%d prefill), autoscale %s",
            len(self.replicas), self.config.prefill_replicas,
            "armed" if self.autoscaler else "off",
        )
        return self

    def _ensure_started(self) -> None:
        if not self._started:
            self.start()

    # -- placement / admission ----------------------------------------------

    def _admissible(self, role_ok=None) -> List[Replica]:
        """Replicas new work may go to: dispatchable (no open case past
        detection), not retired — NOT filtered on ``alive``: an
        undetected-dead replica still takes traffic (the router has no
        oracle), which is exactly what re-dispatch exists to repair."""
        out = []
        for rep in self.replicas:
            if not rep.dispatchable or rep.engine.draining:
                continue
            if role_ok is not None and rep.role not in role_ok:
                continue
            out.append(rep)
        return out

    def _pick(self, reps: List[Replica]) -> Replica:
        return min(reps, key=lambda r: (r.load, r.name))

    def submit(self, prompt, max_new_tokens: int,
               temperature: float = 0.0,
               deadline_s: Optional[float] = None) -> Request:
        """Place and admit one request (engine.submit semantics: never
        raises on bad input, sheds with a booked reason). Placement is
        prefix-affine when the radix index knows a replica holding a
        prefix of this prompt, least-loaded otherwise; disaggregated
        fleets always submit to a prefill replica (the decode home is
        chosen at handoff time). The returned Request carries the
        placement on its ``tags`` — every record it ever emits names
        its replica, attempt and prefix hit."""
        self._ensure_started()
        rid = self._next_rid
        self._next_rid += 1
        role_ok = (("prefill",) if self.config.prefill_replicas
                   else ("any",))
        reps = self._admissible(role_ok=role_ok)
        if not reps:
            # every admissible replica is gone (mass escalation or a
            # fleet-wide drain): shed through ANY replica so the
            # rejection is still a booked record, not an exception
            rep = self.replicas[0]
            req = rep.engine.submit(
                prompt, max_new_tokens, temperature=temperature,
                deadline_s=deadline_s, rid=rid,
                tags={"replica": rep.name, "attempt": 1},
            )
            return req
        target, hit_tokens = None, 0
        toks = self._prompt_tokens(prompt)
        if toks is not None:
            by_name = {r.name: r for r in reps}
            owner, hit_tokens = self.prefix.lookup(toks, live=by_name)
            if owner is not None:
                target = by_name[owner]
        if target is None:
            target = self._pick(reps)
        tags = {
            "replica": target.name,
            "attempt": 1,
            "prefix_hit_tokens": int(hit_tokens),
            "prefix_hit_rate": (
                float(hit_tokens) / len(toks) if toks is not None and toks
                else 0.0
            ),
        }
        req = target.engine.submit(
            prompt, max_new_tokens, temperature=temperature,
            deadline_s=deadline_s, rid=rid, tags=tags,
        )
        if req.state == QUEUED:
            self.trace.dispatched(self._tick, req, target.name)
            if toks is not None:
                self.prefix.insert(toks, target.name)
            self._dispatch[rid] = {
                "replica": target.name,
                "req": req,
                "prompt": req.prompt,
                "max_new_tokens": req.max_new_tokens,
                "temperature": req.temperature,
                "deadline_s": req.deadline_s,
                "submit_t": req.submit_t,
                "attempt": 1,
            }
        return req

    @staticmethod
    def _prompt_tokens(prompt) -> Optional[list]:
        """Prompt as a token list for the prefix index, or None when it
        is not index-able (malformed input — the engine will shed it
        with its own booked reason; the index must not choke first)."""
        try:
            arr = np.asarray(prompt)
            if arr.ndim != 1 or arr.size == 0 or not np.issubdtype(
                    arr.dtype, np.integer):
                return None
            return [int(t) for t in arr]
        except Exception:
            return None

    def cancel(self, rid: int) -> bool:
        """Client abandon, routed to wherever ``rid`` currently lives."""
        entry = self._dispatch.get(rid)
        if entry is None:
            return False
        rep = self._by_name(entry["replica"])
        if rep is None:
            return False
        return rep.engine.cancel(rid)

    def _by_name(self, name: str) -> Optional[Replica]:
        for rep in self.replicas:
            if rep.name == name:
                return rep
        return None

    # -- the fleet tick -----------------------------------------------------

    def tick(self) -> int:
        """One fleet iteration: chaos, per-replica engine ticks +
        heartbeats, disaggregation handoffs, the health machine
        (detect -> failover -> restart -> probation), autoscaling."""
        self._ensure_started()
        t = self._tick
        if self.fault_plan is not None and self.fault_plan.take_kill_replica(t):
            self._chaos_kill(t)
        for rep in list(self.replicas):
            if not rep.alive:
                rep.miss()
                continue
            try:
                rep.engine.tick()
                rep.beat()
            except Exception:
                # an engine tick that RAISES is a replica fault (the
                # engine already booked FAILED for its in-flight batch);
                # the health machine takes it from here like any death
                logger.exception(
                    "fleet: replica %s tick raised — treating as dead",
                    rep.name)
                rep.alive = False
                rep.miss()
        if self.config.prefill_replicas:
            self._migrate(t)
        self._health(t)
        if self.slo is not None:
            self.slo.poll(t)
        if self.autoscaler is not None and not self._draining:
            self._autoscale(t)
        self._tick += 1
        return t

    @property
    def idle(self) -> bool:
        return all(rep.engine.idle for rep in self.replicas if rep.alive)

    def _chaos_kill(self, t: int) -> None:
        """Kill the BUSIEST healthy replica (deterministic victim: the
        worst case for the failover path is the most-loaded loss)."""
        victims = [r for r in self.replicas if r.healthy]
        if not victims:
            logger.warning(
                "chaos: kill_replica fired but no healthy replica to "
                "kill at tick %d", t)
            return
        victim = max(victims, key=lambda r: (r.load, r.name))
        victim.kill()
        if self.router is not None:
            self.router.event(
                "fleet", t, check="chaos", action="kill_replica",
                replica=victim.name, load=victim.load,
            )

    # -- disaggregation -----------------------------------------------------

    def _migrate(self, t: int) -> None:
        """Move every freshly-prefilled request off the prefill pool:
        extract -> book out -> adopt on a decode replica -> book in,
        all inside ONE ``handoff`` span per tick (the span is the
        badput envelope; the ledger is the byte audit). A request no
        decode replica can take re-adopts into its source (nothing
        moved, nothing booked lost); if even that fails the blocks are
        gone — booked ``abandoned`` and the request FAILED, loudly."""
        moves = []
        for rep in self.replicas:
            if rep.role != "prefill" or not rep.alive:
                continue
            for req in list(rep.engine._active.values()):
                if req.state == DECODE:
                    moves.append((rep, req.rid))
        if not moves:
            return
        hops = []   # (rid, attempt, start, end, src, dst) per extract
        gp_span = begin_span("handoff", router=self.router, step=t,
                             moves=len(moves))
        try:
            for src, rid in moves:
                h0 = self.time_fn()
                payload = src.engine.extract(rid)
                if payload is None:
                    continue
                req = payload["request"]
                seq = self.ledger.book_out(
                    rid, src.name, payload["n_blocks"], payload["bytes"], t)
                targets = [r for r in self._admissible(role_ok=("decode",))
                           if r.alive]
                placed = None
                for dst in sorted(targets, key=lambda r: (r.load, r.name)):
                    if dst.engine.adopt(payload):
                        placed = dst
                        break
                if placed is not None:
                    self.ledger.book_in(
                        seq, placed.name, payload["n_blocks"],
                        payload["bytes"], t)
                    entry = self._dispatch.get(rid)
                    if entry is not None:
                        entry["replica"] = placed.name
                    req.tags["replica"] = placed.name
                    hops.append((rid, req, h0, self.time_fn(),
                                 src.name, placed.name))
                    continue
                if src.engine.adopt(payload):
                    # decode pool full this tick: stay home, retry next
                    # tick — the extract/adopt round-trip moved nothing,
                    # but the request still SPENT the round trip in
                    # handoff machinery; its trace span says so
                    self.ledger.book_in(
                        seq, src.name, payload["n_blocks"],
                        payload["bytes"], t)
                    hops.append((rid, req, h0, self.time_fn(),
                                 src.name, src.name))
                    continue
                self.ledger.abandon(seq, t, "no_adopter")
                transition(req, FAILED, now=self.time_fn(),
                           reason="handoff_no_adopter")
                emit_request_record(self.router, t, req,
                                    trace=self.trace)
                hops.append((rid, req, h0, self.time_fn(),
                             src.name, None))
        finally:
            # close FIRST, then emit the per-request handoff spans: the
            # closed goodput record's start/dur ride along as twins so
            # the analyzer reconciles both views digit-for-digit
            gp = gp_span.close()
        for rid, req, h0, h1, src_name, dst_name in hops:
            self.trace.handoff(
                t, rid, int(req.tags.get("attempt", 1)), h0, h1, gp,
                src=src_name, dst=dst_name)

    # -- health / failover --------------------------------------------------

    def _health(self, t: int) -> None:
        for rep in list(self.replicas):
            if (not rep.alive and rep.case_state is None
                    and rep.missed_beats >= self.config.miss_ticks_to_detect):
                response = rep.detect(t, kind="incident")
                self._failover(rep, t, response)
            elif rep.case_state == "probation" and rep.alive:
                rep.probation_tick(t)

    def _failover(self, rep: Replica, t: int, response: str) -> None:
        """The recovery envelope for one dead replica, booked as a
        ``failover`` span: re-home its non-terminal requests, drop its
        prefix claims, then restart it under the policy's budget. The
        nested restart compile burst books under THIS span (failover
        outranks compile in the phase priority: the whole envelope is
        recovery time)."""
        self.failovers += 1
        fo_t0 = self.time_fn()
        gp_span = begin_span("failover", router=self.router, step=t,
                             replica=rep.name)
        try:
            self.prefix.evict_replica(rep.name)
            orphans = [
                (rid, entry) for rid, entry in self._dispatch.items()
                if entry["replica"] == rep.name
                and not entry["req"].terminal
            ]
            for rid, entry in orphans:
                self._redispatch(rid, entry, t)
            if self.router is not None:
                self.router.event(
                    "fleet", t, check="failover", replica=rep.name,
                    redispatched=len(orphans),
                )
            if response == "restart":
                if rep.restart(t):
                    # the new incarnation's warmup compiles are its own
                    # booked span — survivors' watchers must not be
                    # charged for them (process-global counter)
                    for other in self.replicas:
                        if other is not rep and other.alive:
                            other.engine.acknowledge_compiles()
            elif rep.case_state == "detected":
                rep.quarantine(t)
        finally:
            gp = gp_span.close()
        fo_t1 = self.time_fn()
        for rid, entry in orphans:
            req = entry["req"]
            # the whole envelope (detect-to-restart) is recovery time
            # for every orphan; accumulate it on the request's tags
            # (satellite of the trace span below — terminal records
            # then carry the recovery total the decomposition books)
            req.tags["recovery_s"] = (
                float(req.tags.get("recovery_s", 0.0)) + (fo_t1 - fo_t0))
            self.trace.recovery(
                t, rid, int(req.tags.get("attempt", 1)), fo_t0, fo_t1,
                gp, replica=rep.name)

    def _redispatch(self, rid: int, entry: Dict[str, Any], t: int) -> None:
        """Second attempt under the SAME global id and ORIGINAL submit
        time. The first attempt's records never terminate (its engine
        is dead); this attempt does — exactly once — so the stream's
        one-terminal-per-id closure holds through the failure. TTFT
        stays honest: the clock started when the CLIENT submitted, not
        when the fleet recovered.

        Pinned semantics (tests/test_trace.py): ``queue_wait_s`` and
        ``ttft_s`` on the flat records keep measuring from the ORIGINAL
        submission — client-visible latency, recovery included. The
        SPLIT lives in the trace tree: the recovery envelope is its own
        ``recovery`` span (mirroring the ``failover`` goodput span),
        and the re-attempt's queue span anchors at the actual local
        re-enqueue instant (``redispatch_t`` tag), so recovery time is
        never double-booked as queue wait in the decomposition."""
        dead = entry["replica"]
        role_ok = (("prefill",) if self.config.prefill_replicas
                   else ("any",))
        reps = [r for r in self._admissible(role_ok=role_ok)
                if r.name != dead and r.alive]
        if not reps:
            reps = [r for r in self._admissible() if r.name != dead
                    and r.alive]
        attempt = entry["attempt"] + 1
        if not reps:
            # nowhere to go: the ending must still be booked — FAILED on
            # the request object, through the shared stream
            req = entry["req"]
            req.tags["attempt"] = attempt
            transition(req, FAILED, now=self.time_fn(),
                       reason="no_replica_for_failover")
            emit_request_record(self.router, t, req, trace=self.trace)
            return
        target = self._pick(reps)
        tags = dict(entry["req"].tags)
        tags.update({"replica": target.name, "attempt": attempt})
        req = target.engine.submit(
            entry["prompt"], entry["max_new_tokens"],
            temperature=entry["temperature"],
            deadline_s=entry["deadline_s"], rid=rid, tags=tags,
        )
        # the engine stamped the LOCAL re-enqueue instant; keep it as a
        # tag (the trace queue span's anchor) before restoring the
        # client-visible original submit time
        req.tags["redispatch_t"] = float(req.submit_t)
        req.submit_t = entry["submit_t"]
        entry.update(replica=target.name, req=req, attempt=attempt)
        self.redispatched += 1

    # -- elastic scaling ----------------------------------------------------

    def _signal(self) -> Optional[float]:
        """Best-placement TTFT estimate: the minimum armed estimate over
        admissible live replicas (new work goes to the best one, so the
        fleet breaches only when even IT does)."""
        ests = [
            e for rep in self._admissible() if rep.alive
            for e in [rep.engine.estimated_ttft_s()] if e is not None
        ]
        return min(ests) if ests else None

    def _n_live(self) -> int:
        return sum(1 for r in self.replicas
                   if r.alive and r.case_state != "escalated")

    def _autoscale(self, t: int) -> None:
        action = self.autoscaler.observe(
            t, self._signal(), self._n_live(),
            burning=self.slo.burning if self.slo is not None else False)
        if action == "scale_up":
            rep = self._new_replica()
            rep.start()
            for other in self.replicas:
                if other is not rep and other.alive:
                    other.engine.acknowledge_compiles()
            if self.router is not None:
                self.router.event(
                    "fleet", t, check="autoscale", action="added",
                    replica=rep.name, replicas=self._n_live(),
                )
        elif action == "scale_down":
            victims = [r for r in self._admissible() if r.alive
                       and r.role != "prefill"]
            if len(victims) <= 1:
                return
            victim = self._pick(victims)
            self._retire(victim, t)

    def _retire(self, rep: Replica, t: int) -> None:
        """Scale-down through drain: every request the victim holds
        reaches a terminal state (finished, or booked evicted/rejected)
        before the replica leaves the fleet."""
        report = rep.engine.drain(
            deadline=self.time_fn() + self.config.scale_down_grace_s)
        self.prefix.evict_replica(rep.name)
        self.replicas.remove(rep)
        if self.router is not None:
            self.router.event(
                "fleet", t, check="autoscale", action="removed",
                replica=rep.name, replicas=self._n_live(),
                drained_finished=report.get("finished", 0),
                drained_evicted=report.get("evicted", 0),
            )

    # -- drain --------------------------------------------------------------

    def drain(self, grace_s: Optional[float] = None,
              deadline: Optional[float] = None) -> dict:
        """Fleet shutdown with the engine drain's closure contract: a
        terminal record for EVERY request ever submitted. Undetected-
        dead replicas get a final failover sweep first (their orphans
        re-home or book FAILED — a shutdown must not strand a request
        in a non-terminal state just because the watchdog hadn't fired
        yet), then every live replica drains. Re-entrant like the
        engine's: a second call returns the first report marked
        ``redundant=True``."""
        self._ensure_started()
        if self._drain_report is not None:
            return dict(self._drain_report, redundant=True)
        self._draining = True
        t0 = self.time_fn()
        if deadline is None and grace_s is not None:
            deadline = t0 + grace_s
        for rep in list(self.replicas):
            if not rep.alive and rep.case_state is None:
                response = rep.detect(self._tick, kind="incident")
                # shutdown sweep: re-home the orphans, but do NOT
                # restart a replica we are about to retire anyway
                self._failover(rep, self._tick,
                               "quarantine" if response == "restart"
                               else response)
        reports = {}
        for rep in list(self.replicas):
            if rep.alive:
                reports[rep.name] = rep.engine.drain(deadline=deadline)
        out = {
            "drain_s": self.time_fn() - t0,
            "finished": sum(r.get("finished", 0) for r in reports.values()),
            "evicted": sum(r.get("evicted", 0) for r in reports.values()),
            "timed_out": sum(
                r.get("timed_out", 0) for r in reports.values()),
            "replicas": reports,
        }
        self._drain_report = dict(out)
        return out

    # -- introspection ------------------------------------------------------

    def requests(self) -> List[Request]:
        """Latest attempt of every request ever dispatched (rejected-
        at-the-door submissions never enter the dispatch table — their
        single REJECTED record is already terminal)."""
        return [entry["req"] for entry in self._dispatch.values()]

    def stats(self) -> dict:
        """The fleet outcome block: per-replica stats plus the fleet-
        only surfaces (prefix hit rates, handoff audit, failover and
        scaling counters)."""
        return {
            "replicas": {r.name: r.stats() for r in self.replicas},
            "submitted": self._next_rid,
            "failovers": self.failovers,
            "redispatched": self.redispatched,
            "prefix": self.prefix.stats(),
            "handoff": self.ledger.audit(),
            "autoscaler": (self.autoscaler.stats()
                           if self.autoscaler else None),
            "steady_state_compiles": sum(
                r.engine.steady_state_compiles for r in self.replicas),
            "ticks": self._tick,
        }
