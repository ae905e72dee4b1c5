"""apex_tpu_torch.serving.fleet and the pieces it stands on, against the
JAX package's on the same inputs.

Each pure-logic case runs one script against the JAX package's classes
and against the port's, and compares everything the script observed:
return values, raised errors and emitted records. The drill runs a
disaggregated fleet (1 prefill + 2 decode replicas) of each package over
the same tiny GPT's weights under the same seeded load and the same
chaos plan, and compares the ``kind="fleet"`` action sequences.
"""

import dataclasses
import signal
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.monitor.router as jax_router
import apex_tpu.resilience.chaos as jax_chaos
import apex_tpu.resilience.remediation.policy as jax_policy
import apex_tpu.serving.fleet as jax_fleet
import apex_tpu.serving.lifecycle as jax_lifecycle
import apex_tpu.serving.loadgen as jax_loadgen
import apex_tpu.serving.trace.analyze as jax_analyze
import apex_tpu.serving.trace.emit as jax_emit
import apex_tpu.serving.trace.slo as jax_slo
import apex_tpu_torch.monitor.router as port_router
import apex_tpu_torch.resilience.chaos as port_chaos
import apex_tpu_torch.resilience.remediation.policy as port_policy
import apex_tpu_torch.serving.fleet as port_fleet
import apex_tpu_torch.serving.lifecycle as port_lifecycle
import apex_tpu_torch.serving.loadgen as port_loadgen
import apex_tpu_torch.serving.trace.analyze as port_analyze
import apex_tpu_torch.serving.trace.emit as port_emit
import apex_tpu_torch.serving.trace.slo as port_slo


@pytest.fixture(autouse=True)
def _restore_process_state():
    """Both packages' routers install a SIGTERM flush and register flush
    hooks on first use: put the handler back and drop the hooks after
    each test, so none outlives it."""
    handler = signal.getsignal(signal.SIGTERM)
    hooks = {m: list(m._FLUSH_HOOKS) for m in (jax_router, port_router)}
    yield
    signal.signal(signal.SIGTERM, handler)
    for m, saved in hooks.items():
        m._FLUSH_HOOKS[:] = saved


def _ns(fleet, policy, chaos, loadgen, lifecycle, slo, emit, analyze):
    return types.SimpleNamespace(
        RadixPrefixIndex=fleet.RadixPrefixIndex,
        HandoffLedger=fleet.HandoffLedger,
        FleetAutoscaler=fleet.FleetAutoscaler,
        Replica=fleet.Replica, FleetConfig=fleet.FleetConfig,
        RemediationPolicy=policy.RemediationPolicy, policy=policy,
        FaultPlan=chaos.FaultPlan, parse_steps=chaos.parse_steps,
        PoissonLoadGenerator=loadgen.PoissonLoadGenerator,
        percentile=loadgen.percentile, lifecycle=lifecycle,
        SLOMonitor=slo.SLOMonitor, TraceEmitter=emit.TraceEmitter,
        analyze=analyze.analyze)


SIDES = {
    "jax": _ns(jax_fleet, jax_policy, jax_chaos, jax_loadgen,
               jax_lifecycle, jax_slo, jax_emit, jax_analyze),
    "port": _ns(port_fleet, port_policy, port_chaos, port_loadgen,
                port_lifecycle, port_slo, port_emit, port_analyze),
}


class CapRouter:
    """The ``MetricRouter.event`` surface, capturing records."""

    def __init__(self):
        self.records = []

    def event(self, kind, step, **fields):
        rec = {"kind": kind, "step": int(step), **fields}
        self.records.append(rec)
        return rec


def call(fn, *args, **kw):
    """What one call did: its value, or the error it raised."""
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:
        return ("raise", type(e).__name__, str(e))


def radix(m):
    rs = np.random.RandomState(0)
    idx = m.RadixPrefixIndex(block_size=4, max_nodes=12)
    obs = [call(m.RadixPrefixIndex, block_size=0),
           call(m.RadixPrefixIndex, block_size=4, max_nodes=0)]
    base = list(rs.randint(0, 9, size=16))
    for i in range(30):
        toks = [int(t) for t in base[:rs.randint(1, 17)]] + \
            [int(t) for t in rs.randint(0, 9, size=rs.randint(0, 6))]
        rep = f"r{rs.randint(0, 3)}"
        if rs.rand() < 0.5:
            obs.append(call(idx.insert, toks, rep))
        else:
            live = None if rs.rand() < 0.5 else {f"r{rs.randint(0, 3)}"}
            obs.append(call(idx.lookup, toks, live=live))
        if i % 11 == 10:
            obs.append(call(idx.evict_replica, rep))
    return obs + [idx.stats()]


def handoff(m):
    cap = CapRouter()
    led = m.HandoffLedger(router=cap)
    obs = [call(led.book_in, 99, dst="r1", n_blocks=1, nbytes=1, tick=0)]
    seqs = [led.book_out(rid=i, src="r0", n_blocks=i + 1,
                         nbytes=589824 * (i + 1), tick=i) for i in range(4)]
    obs.append(call(led.book_in, seqs[0], dst="r1", n_blocks=1,
                    nbytes=589824, tick=1))
    obs.append(call(led.book_in, seqs[1], dst="r2", n_blocks=2,
                    nbytes=1000, tick=2))
    obs.append(call(led.abandon, seqs[2], tick=3, reason="no_adopter"))
    obs.append(led.audit())
    obs.append(call(led.book_in, seqs[0], dst="r2", n_blocks=1, nbytes=1,
                    tick=4))
    obs.append(call(led.abandon, seqs[2], tick=4, reason="late"))
    obs.append(call(led.book_in, seqs[3], dst="r1", n_blocks=4,
                    nbytes=589824 * 4, tick=5))
    return obs + [led.audit(), cap.records]


def autoscaler(m):
    cap = CapRouter()
    rs = np.random.RandomState(1)
    obs = [call(m.FleetAutoscaler, 0.0, 1, 4),
           call(m.FleetAutoscaler, 1.0, 3, 2),
           call(m.FleetAutoscaler, 1.0, 1, 4, breach_ticks=0),
           call(m.FleetAutoscaler, 1.0, 1, 4, low_water=1.5)]
    sc = m.FleetAutoscaler(ttft_budget_s=1.0, min_replicas=1,
                           max_replicas=4, breach_ticks=2, clear_ticks=3,
                           router=cap)
    n = 2
    for t in range(60):
        sig = None if rs.rand() < 0.15 else float(rs.choice(
            [0.01, 0.5, 2.0, 5.0]))
        act = sc.observe(t, sig, n, burning=bool(rs.rand() < 0.2))
        n += {"scale_up": 1, "scale_down": -1}.get(act, 0)
        obs.append((act, n))
    return obs + [sc.stats(), cap.records]


class FakeEngine:
    """The engine surface a Replica touches."""

    def __init__(self):
        self._queue, self._active = [], {}

    def start(self):
        pass


def replica(m):
    cap = CapRouter()
    obs = [call(m.Replica, "x", lambda n, i: FakeEngine(), role="oracle")]
    builds = {"n": 0}

    def flaky(name, incarnation):
        builds["n"] += 1
        if builds["n"] == 4:
            raise RuntimeError("broken build")
        return FakeEngine()

    rep = m.Replica("r0", flaky, role="decode", router=cap,
                    policy=m.RemediationPolicy(probation_steps=2,
                                               max_restarts=3))
    for t in range(6):
        rep.kill()
        rep.miss(), rep.miss()
        obs.append((rep.alive, rep.dispatchable, rep.healthy))
        obs.append(call(rep.detect, t))
        obs.append(call(rep.detect, t))
        if t == 1:
            rep.quarantine(t)
            obs.append(rep.dispatchable)
        obs.append(call(rep.restart, t))
        for k in range(3):
            rep.probation_tick(10 * t + k)
        rep.engine._queue.extend([1, 2])
        obs.append((rep.load, rep.stats()))
    return obs + [cap.records]


def policy(m):
    p = m.policy
    obs = [dataclasses.asdict(m.RemediationPolicy()), p.CASE_KINDS,
           p.RESPONSES, p.STATES, sorted(p.TERMINAL_STATES),
           p.TERMINAL_VERDICTS]
    obs += [call(p.advance, a, b) for a in p.STATES + ("bogus",)
            for b in p.STATES + ("bogus",)]
    pol = m.RemediationPolicy()
    obs += [call(pol.response_for, k) for k in p.CASE_KINDS + ("bogus",)]
    return obs


def slo_monitor(m):
    cap = CapRouter()
    rs = np.random.RandomState(2)
    obs = [call(m.SLOMonitor, None, ttft_budget_s=1.0, target=1.0)]
    mon = m.SLOMonitor(cap, ttft_budget_s=1.0, target=0.9, window=16,
                       min_count=4, fast_burn=5.0)
    tap = mon.sink()
    tap.emit({"kind": "span", "phase": "step"})
    tap.emit({"kind": "request", "state": "queued"})
    states = ["completed", "rejected", "cancelled", "timed_out", "failed"]
    for t in range(40):
        for _ in range(rs.randint(0, 4)):
            rec = {"kind": "request", "step": t, "terminal": True,
                   "state": str(rs.choice(states, p=[.6, .1, .1, .1, .1]))}
            if rs.rand() < 0.7:
                rec["ttft_s"] = float(rs.choice([0.1, 0.5, 2.0]))
            tap.emit(rec)
        obs.append((mon.poll(t), mon.burning))
    return obs + [cap.records]


def fault_plan(m):
    obs = [m.parse_steps("3,7,10-12, ,4"), m.parse_steps(None),
           m.parse_steps([1, 2])]
    plan = m.FaultPlan(nan_steps="1,3", slow_decode_steps={2},
                       abandon_requests={0, 5}, malformed_requests="1-2",
                       burst_steps={0, 4}, burst_n=3,
                       kill_replica_steps={4, 9}, hang_steps={1},
                       hang_timeout_s=0.0)
    for step in range(12):
        obs.append((plan.take_nan(step), plan.take_abandon(step),
                    plan.take_malformed(step), plan.take_burst(step),
                    plan.take_kill_replica(step), plan.maybe_hang(step)))
    obs.append([plan.take_nan(1), plan.take_kill_replica(4)])
    sticky = m.FaultPlan(kill_replica_steps={2}, persistent=True)
    obs.append([sticky.take_kill_replica(2) for _ in range(3)])
    return obs


class LoadEngine:
    """A duck-typed engine for the load generator: everything queues but
    empty prompts, which are rejected."""

    def __init__(self, lifecycle):
        self.lc, self.log, self._rid = lifecycle, [], 0

    def submit(self, prompt, max_new_tokens, temperature=0.0,
               deadline_s=None):
        req = self.lc.Request(rid=self._rid, prompt=np.asarray(prompt),
                              max_new_tokens=max_new_tokens,
                              temperature=temperature, deadline_s=deadline_s,
                              submit_t=0.0)
        self._rid += 1
        self.lc.transition(req, "rejected" if req.prompt_len == 0
                           else "queued", now=0.0)
        self.log.append(("submit", req.rid, [int(t) for t in req.prompt],
                         max_new_tokens, req.state))
        return req

    def cancel(self, rid):
        self.log.append(("cancel", rid))
        return True


def load_generator(m):
    clock = {"t": 0.0}
    plan = m.FaultPlan(burst_steps={1}, burst_n=3, malformed_requests={2},
                       abandon_requests={0, 4})
    gen = m.PoissonLoadGenerator(rate_rps=40.0, vocab=61, n_requests=12,
                                 prompt_len=(4, 24), max_new=(4, 8), seed=7,
                                 fault_plan=plan,
                                 time_fn=lambda: clock["t"])
    eng = LoadEngine(m.lifecycle)
    obs = [gen._arrivals.tolist()]
    for t in np.linspace(0.0, 0.5, 6):
        clock["t"] = float(t)
        obs.append(len(gen.pump(eng)))
    obs.append((gen.done, eng.log))
    obs.append([m.percentile([], 99.0), m.percentile([1.0, 3.0], 50.0),
                m.percentile(gen._arrivals.tolist(), 99.0)])
    return obs


def fleet_config(m):
    def make(**kw):
        return dataclasses.asdict(m.FleetConfig(**kw))

    return [call(make), call(make, replicas=0),
            call(make, replicas=2, prefill_replicas=2),
            call(make, min_replicas=5, max_replicas=4),
            call(make, miss_ticks_to_detect=0)]


def trace_tree(m):
    """One request walked through the emitter on a hand-set clock, a
    handoff and a stall included, then the analyzer over the stream."""
    cap = CapRouter()
    clock = {"t": 10.0}
    em = m.TraceEmitter(cap, site="r0.0", time_fn=lambda: clock["t"])
    fl = m.TraceEmitter(cap, site="fleet", time_fn=lambda: clock["t"])
    lc = m.lifecycle
    req = lc.Request(rid=3, prompt=np.arange(5), max_new_tokens=4,
                     submit_t=10.0, tags={"attempt": 1})
    for state, dt in (("queued", 0.0), ("admitted", 0.5),
                      ("prefill", 0.1), ("decode", 0.2)):
        clock["t"] += dt
        if state == "decode":
            req.first_token_t = clock["t"]
        lc.transition(req, state, now=clock["t"])
        em.on_record(0, req)
    fl.dispatched(0, req, "r0")
    em.stall(1, [req], clock["t"], 0.05)
    clock["t"] += 0.3
    em.extracted(2, req)
    gp = {"phase": "handoff", "start": 1.0, "dur_s": 0.01}
    fl.handoff(2, 3, 1, clock["t"], clock["t"] + 0.01, gp, src="r0",
               dst="r1")
    cap.event("span", 2, phase="handoff", start=1.0, dur_s=0.01)
    clock["t"] += 0.01
    em.adopted(2, req)
    clock["t"] += 0.4
    lc.transition(req, "completed", now=clock["t"])
    em.on_record(3, req)
    cap.event("request", 3, id=3, state="completed", terminal=True)
    rep = m.analyze(cap.records)
    return [cap.records, rep.ok, rep.n_traces, rep.decompositions,
            rep.problems]


CASES = [radix, handoff, autoscaler, replica, policy, slo_monitor,
         fault_plan, load_generator, fleet_config, trace_tree]


@pytest.mark.parametrize("script", CASES, ids=[c.__name__ for c in CASES])
def test_pure_logic_matches_jax(script):
    want = script(SIDES["jax"])
    got = script(SIDES["port"])
    assert got == want


# -- the drill: the same chaos plan over both packages' fleets --------------

TINY = dict(num_layers=1, hidden_size=32, num_attention_heads=4,
            vocab_size=61, max_position_embeddings=64, hidden_dropout=0.0,
            attention_dropout=0.0, position_embedding_type="rope")
KILL_TICK = 6


class Clock:
    """Virtual time: 1 ms more on every read."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-3
        return self.t


def _fleet_drill(side, variables):
    clock = Clock()
    kinds = ("request", "fleet", "handoff", "span", "trace")
    # lanes, not blocks, bound every replica (2 lanes x 4 blocks <= 16):
    # the two engines' block reservations differ (engine.py), their
    # admissions do not
    cfg = dict(lanes=2, block_size=8, num_blocks=16, max_seq_len=32,
               max_queue_depth=64, seed=0)
    if side == "jax":
        from apex_tpu.models import GPTModel as JaxGPT
        from apex_tpu.monitor import MemorySink, MetricRouter
        from apex_tpu.serving import ServingConfig, ServingEngine
        from apex_tpu.transformer import TransformerConfig as JaxConfig

        mem = MemorySink(kinds=kinds)
        router = MetricRouter([mem])
        jmodel = JaxGPT(config=JaxConfig(compute_dtype=jnp.float32, **TINY))

        def make(name, incarnation):
            return ServingEngine(jmodel, variables, ServingConfig(**cfg),
                                 router=router, time_fn=clock)
    else:
        from apex_tpu_torch.models import GPTModel, gpt_params_from_jax
        from apex_tpu_torch.monitor import MemorySink, MetricRouter
        from apex_tpu_torch.serving import ServingConfig
        from apex_tpu_torch.transformer import TransformerConfig

        mem = MemorySink(kinds=kinds)
        router = MetricRouter([mem])
        model = GPTModel(TransformerConfig(compute_dtype=torch.float32,
                                           **TINY), device="cpu")
        model.load_state_dict(gpt_params_from_jax(
            jax.tree_util.tree_map(np.asarray, variables["params"])))
        make = port_fleet.engine_factory(model, ServingConfig(**cfg),
                                         router=router, device="cpu",
                                         time_fn=clock)
    m = SIDES[side]
    fleet_mod = jax_fleet if side == "jax" else port_fleet
    fleet = fleet_mod.FleetRouter(
        make,
        m.FleetConfig(replicas=3, prefill_replicas=1, miss_ticks_to_detect=2,
                      ttft_budget_s=1e-4, breach_ticks=2, min_replicas=1,
                      max_replicas=4),
        router=router, fault_plan=m.FaultPlan(kill_replica_steps={KILL_TICK}),
        time_fn=clock)
    fleet.start()
    gen = m.PoissonLoadGenerator(rate_rps=150.0, vocab=61, n_requests=16,
                                 prompt_len=(4, 24), max_new=(4, 8), seed=7)
    gen.pump(fleet, now=0.0)
    gen.pump(fleet, now=1e6)
    n = 0
    while not fleet.idle and n < 400:
        fleet.tick()
        n += 1
    for _ in range(8):
        fleet.tick()
    fleet.drain(grace_s=10.0)
    router.close()
    records = mem.snapshot()
    actions = [(r["step"], r["check"], r.get("action"), r.get("replica"),
                r.get("redispatched"))
               for r in records if r.get("kind") == "fleet"]
    terminal = {}
    for r in records:
        if r.get("kind") == "request" and r.get("terminal"):
            terminal.setdefault(r["id"], []).append(
                (r["state"], r["reason"], r["tokens_out"]))
    tokens = {r.rid: r.tokens_out for r in fleet.requests()}
    return actions, terminal, tokens, fleet.ledger.audit(), n


@pytest.fixture(scope="module")
def drills():
    from apex_tpu.models import GPTModel as JaxGPT
    from apex_tpu.transformer import TransformerConfig as JaxConfig

    jmodel = JaxGPT(config=JaxConfig(compute_dtype=jnp.float32, **TINY))
    variables = jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 4), jnp.int32))
    return {side: _fleet_drill(side, variables) for side in ("jax", "port")}


def test_fleet_drill_actions_match_jax(drills):
    """The kill, detection, failover, restart, probation, readmission and
    scale-up happen at the same fleet ticks, to the same replicas."""
    actions, _, _, _, n = drills["port"]
    want, *_ = drills["jax"]
    kinds = {(c, a) for _, c, a, _, _ in actions}
    for need in (("chaos", "kill_replica"), ("replica", "detected"),
                 ("replica", "restarted"), ("replica", "readmitted"),
                 ("autoscale", "scale_up"), ("autoscale", "added")):
        assert need in kinds
    assert any(c == "failover" and r for _, c, _, _, r in actions)
    assert actions == want and n < 400


def test_fleet_drill_closes_like_jax(drills):
    """One terminal record per global id, with JAX's state, reason and
    token count, the same tokens, and a matched handoff ledger."""
    _, terminal, tokens, audit, _ = drills["port"]
    _, jterminal, jtokens, jaudit, _ = drills["jax"]
    assert set(terminal) == set(range(16))
    assert all(len(v) == 1 for v in terminal.values())
    assert terminal == jterminal and tokens == jtokens
    assert audit["matched"] and jaudit["matched"]
    assert audit["handoffs"] == jaudit["handoffs"] > 0
