"""``python -m apex_tpu_torch.serving --selftest`` — the serving gate
(counterpart of ``python -m apex_tpu.serving --selftest``).

Exit-nonzero self-test of the serving core on the JAX gate's tiny GPT
(2 layers, hidden 32, 4 heads, vocab 61, rotary positions, fp32; seeded
random weights), on the card unless ``--device cpu`` is passed:

1.  correctness — three staggered requests through the continuous-
    batching engine (different prompt lengths, a queue wait forced by
    the 4-block KV pool) give exactly ``models.generate``'s tokens per
    prompt, and the per-step decode logits match a full forward over the
    final sequence;
2.  zero post-start kernel loads — every kernel the path runs is loaded
    in ``ServingEngine.start()``; none loads while serving (the JAX
    gate's zero-recompile check);
3.  in-place pool — ``k_pool``/``v_pool`` keep their storage across
    every tick (the JAX gate's donation check);
4.  admission control — queue-depth shedding, TTFT-budget shedding
    (armed by a chaos slow-decode tick inflating the measured EMAs),
    and malformed / out-of-vocab / too-long refusals, each with its
    booked reason;
5.  deadlines — queued and in-batch expiry evict with ``timed_out``
    and reclaim their blocks; client cancel likewise;
6.  graceful drain — in-flight requests finish inside the grace
    budget, the still-queued are rejected ``draining``, and a
    zero-grace drain on a second engine deadline-evicts;
7.  accounting closure — every submitted request reaches exactly one
    terminal ``kind="request"`` record, the KV pool returns to fully
    free, and the goodput partition identity over the run's spans holds
    with ``==``.

``--fleet`` runs the fleet gate instead: in-process replicas behind a
:class:`~apex_tpu_torch.serving.fleet.FleetRouter`, a prefill/decode
pair giving ``generate``'s tokens through a KV handoff with the ledger's
byte audit matched, then a chaos replica kill mid-load (detection,
re-dispatch, restart, probation close) plus an SLO-driven scale-up, with
the same closure checks fleet-wide: one terminal record per global id,
zero steady-state kernel loads on every replica, the goodput identity
exact over the shared stream, and the request x-ray
(``serving.trace.analyze``) passing on both streams.
"""

import argparse
import sys


def _check(failures, ok, label):
    status = "ok" if ok else "FAIL"
    print(f"  [{status}] {label}", flush=True)
    if not ok:
        failures.append(label)


def tiny_config():
    """The JAX gate's target: 2 x 32, 4 heads, vocab 61, rotary
    positions, fp32 (a tight logits-parity pin)."""
    import torch

    from apex_tpu_torch.transformer import TransformerConfig

    return TransformerConfig(
        num_layers=2, hidden_size=32, num_attention_heads=4, vocab_size=61,
        max_position_embeddings=64, hidden_dropout=0.0,
        attention_dropout=0.0, position_embedding_type="rope",
        compute_dtype=torch.float32,
    )


class _HeldClock:
    """The engine's clock (``time_fn``): the host's monotonic clock,
    which the deadline checks hold still and step by hand, so that where
    a deadline lands does not depend on how loaded the host is. It never
    runs backwards: released, it goes on from the instant it was held
    at."""

    def __init__(self):
        import time

        self._now = time.monotonic
        self._offset = 0.0
        self._held = None

    def __call__(self) -> float:
        if self._held is not None:
            return self._held
        return self._now() + self._offset

    def hold(self) -> None:
        self._held = self()

    def step(self, dt: float) -> None:
        self._held += dt

    def release(self) -> None:
        self._offset = self._held - self._now()
        self._held = None


def _identity_holds(rep) -> bool:
    lhs = rep.productive_s
    for phase in sorted(rep.badput_s):
        lhs = lhs + rep.badput_s[phase]
    return lhs + rep.unattributed_s == rep.wall_s and rep.productive_s > 0.0


def _finish(failures, name: str) -> int:
    from apex_tpu_torch.resilience.exit_codes import ExitCode

    if failures:
        print(f"{name}: {len(failures)} check(s) FAILED:", flush=True)
        for f in failures:
            print(f"  - {f}", flush=True)
        return int(ExitCode.FAILURE)
    print(f"{name}: all checks passed", flush=True)
    return int(ExitCode.OK)


def selftest(device="cuda", model=None) -> int:
    import dataclasses

    import numpy as np
    import torch

    from apex_tpu_torch.models import GPTModel
    from apex_tpu_torch.models.generate import generate
    from apex_tpu_torch.monitor import MemorySink, MetricRouter
    from apex_tpu_torch.monitor.goodput import account, run_header
    from apex_tpu_torch.resilience.chaos import FaultPlan
    from apex_tpu_torch.serving.engine import ServingConfig, ServingEngine
    from apex_tpu_torch.serving.lifecycle import TERMINAL_STATES

    failures = []
    if model is None:
        model = GPTModel(tiny_config(), device=device, seed=0)
    device = model.device
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 61, size=n).astype(np.int32)
               for n in (5, 9, 12)]
    max_news = (6, 5, 4)
    refs = [generate(model, p[None], m, device=device)[0, len(p):].tolist()
            for p, m in zip(prompts, max_news)]
    fulls = {}
    with torch.no_grad():
        for i, p in enumerate(prompts):
            seq = np.concatenate([p, refs[i]]).astype(np.int64)
            fulls[p.tobytes()] = model(
                torch.as_tensor(seq, device=device)[None]).float()[0].cpu(
                ).numpy()

    mem = MemorySink(kinds=("request", "run", "span"))
    router = MetricRouter([mem])
    run_header(router, "serving-selftest")
    # the TTFT budget is armed on an engine of its own (section 9): its
    # estimate is the measured prefill and decode times, which a loaded
    # host inflates enough to shed the other checks' requests
    cfg = ServingConfig(
        lanes=3, block_size=8, num_blocks=4, max_seq_len=32,
        max_queue_depth=4, seed=0, collect_logits=True,
    )
    clock = _HeldClock()
    eng = ServingEngine(model, cfg, device=device, router=router,
                        time_fn=clock)
    print(f"serving selftest on {device} (pool {cfg.num_blocks}x"
          f"{cfg.block_size})", flush=True)
    eng.start()

    # -- 1. correctness under continuous batching + forced queue wait ----
    reqs = [eng.submit(p, max_new_tokens=m)
            for p, m in zip(prompts, max_news)]
    _check(failures, all(r.state == "queued" for r in reqs),
           "submissions queued")
    # the pool has 4 blocks; the requests need 2+2+2: the third waits
    ptrs = (eng.k_pool.data_ptr(), eng.v_pool.data_ptr())
    pools = (eng.k_pool, eng.v_pool)
    n = waited = 0
    while not eng.idle and n < 100:
        eng.tick()
        waited += reqs[2].state == "queued"
        n += 1
    _check(failures,
           (eng.k_pool.data_ptr(), eng.v_pool.data_ptr()) == ptrs
           and (eng.k_pool, eng.v_pool) == pools,
           "KV pool written in place across every tick (same storage)")
    _check(failures, waited > 0,
           "the third request waited in the queue for pool blocks")
    _check(failures, all(r.state == "completed" for r in reqs),
           "staggered requests all completed")
    _check(failures,
           all(r.tokens_out == ref for r, ref in zip(reqs, refs)),
           "served tokens == models.generate reference, per request")
    _check(failures, [len(r.blocks) for r in reqs] == [2, 2, 2],
           "each request reserved blocks_needed(prompt + new) blocks")
    logit_ok = True
    for r, p in zip(reqs, prompts):
        full = fulls[p.tobytes()]
        for i, row in enumerate(r.logits):
            pos = len(p) - 1 + i
            logit_ok &= bool(np.max(np.abs(row - full[pos])) <= 2e-4)
    _check(failures, logit_ok,
           "per-step decode logits match the full forward (atol 2e-4)")
    _check(failures, eng.allocator.free_blocks == cfg.num_blocks,
           "all KV blocks reclaimed after completion")

    # -- 2. deadlines: queued and in-batch ------------------------------
    # on the held clock, 5 ms a tick: the deadline lands mid-decode
    # however long a tick takes on this host
    clock.hold()
    r_q = eng.submit(prompts[0], max_new_tokens=4, deadline_s=0.0)
    clock.step(0.005)
    eng.tick()
    _check(failures,
           r_q.state == "timed_out" and r_q.reason == "deadline",
           "queued request past deadline evicted as timed_out")
    r_a = eng.submit(prompts[0], max_new_tokens=20, deadline_s=0.05)
    n = 0
    while not r_a.terminal and n < 200:
        eng.tick()
        clock.step(0.005)
        n += 1
    clock.release()
    _check(failures,
           r_a.state == "timed_out" and len(r_a.tokens_out) > 0,
           "in-batch request evicted at its deadline, tokens booked")
    _check(failures, eng.allocator.free_blocks == cfg.num_blocks,
           "timed-out requests' blocks reclaimed")

    # -- 3. client abandon ----------------------------------------------
    r_c = eng.submit(prompts[0], max_new_tokens=20)
    eng.tick()
    eng.cancel(r_c.rid)
    _check(failures,
           r_c.state == "cancelled" and r_c.reason == "client_cancel"
           and eng.allocator.free_blocks == cfg.num_blocks,
           "client abandon mid-decode: cancelled, blocks reclaimed")

    # -- 4. admission: malformed / too_long / queue_full ----------------
    bad = eng.submit(np.zeros((0,), np.int32), max_new_tokens=3)
    oov = eng.submit(np.array([999], np.int32), max_new_tokens=3)
    r_long = eng.submit(rng.randint(0, 61, size=31).astype(np.int32),
                        max_new_tokens=9)
    _check(failures,
           (bad.state, bad.reason) == ("rejected", "malformed")
           and (oov.state, oov.reason) == ("rejected", "malformed")
           and (r_long.state, r_long.reason) == ("rejected", "too_long"),
           "malformed / out-of-vocab / too-long shed with reasons")
    garbage = [
        eng.submit(prompts[0], max_new_tokens=None),
        eng.submit(prompts[0], max_new_tokens=2, temperature="hot"),
        eng.submit(prompts[0], max_new_tokens=2, deadline_s="soon"),
    ]
    _check(failures,
           all((g.state, g.reason) == ("rejected", "malformed")
               for g in garbage),
           "non-numeric max_new/temperature/deadline shed, never raise")
    # park a pool-filling long decode (4 of 4 blocks), leave a second
    # one queued, then overflow the bounded queue: depth 4 minus the
    # 1 already queued admits 3 more and sheds the rest
    parked = [eng.submit(prompts[0], max_new_tokens=20) for _ in range(2)]
    eng.tick()  # parked[0] admitted; parked[1] waits on blocks
    overflow = [eng.submit(prompts[0], max_new_tokens=2)
                for _ in range(cfg.max_queue_depth + 2)]
    shed = [r for r in overflow
            if (r.state, r.reason) == ("rejected", "queue_full")]
    _check(failures, len(shed) == 3 and parked[1].state == "queued",
           "bounded queue sheds exactly the overflow (queue_full)")
    n = 0
    while not eng.idle and n < 400:
        eng.tick()
        n += 1
    _check(failures, eng.idle, "backlog drains to idle")

    # -- 5. graceful drain ----------------------------------------------
    d1 = eng.submit(prompts[0], max_new_tokens=6)
    d2 = eng.submit(prompts[1], max_new_tokens=6)
    eng.tick()
    queued_at_drain = [r for r in (d1, d2) if r.state == "queued"]
    report = eng.drain(grace_s=60.0)
    _check(failures,
           all(r.terminal for r in (d1, d2)) and report["drain_s"] < 60.0,
           "drain finished in-flight work inside the grace budget")
    _check(failures,
           all(r.reason == "draining" for r in queued_at_drain),
           "still-queued requests rejected 'draining' at drain")
    post = eng.submit(prompts[0], max_new_tokens=2)
    _check(failures, (post.state, post.reason) == ("rejected", "draining"),
           "post-drain submissions shed as draining")
    _check(failures, eng.drain().get("redundant") is True,
           "a second drain is redundant, not an exception")

    # -- 6. zero steady-state kernel loads -------------------------------
    _check(failures, eng.steady_state_compiles == 0,
           "zero kernel loads after start() across the whole run")

    # -- 7. accounting closure ------------------------------------------
    records = mem.snapshot()
    terminal = {}
    for rec in records:
        if rec.get("kind") == "request" and rec.get("terminal"):
            terminal.setdefault(rec["id"], []).append(rec["state"])
    _check(failures,
           all(len(v) == 1 and v[0] in TERMINAL_STATES
               for v in terminal.values())
           and set(terminal) == {r.rid for r in eng.requests()},
           "every submitted request reached exactly ONE terminal record")
    _check(failures, eng.allocator.free_blocks == cfg.num_blocks,
           "KV pool fully free at shutdown")
    phases = {r.get("phase") for r in records if r.get("kind") == "span"}
    _check(failures, {"prefill", "decode", "drain", "compile"} <= phases,
           "prefill/decode/drain/compile spans in the stream")
    _check(failures, _identity_holds(account(records)),
           "goodput partition identity holds digit-for-digit")

    # -- 8. zero-grace drain deadline-evicts (fresh engine) -------------
    cfg2 = ServingConfig(lanes=1, block_size=8, num_blocks=2,
                         max_seq_len=16, seed=1)
    eng2 = ServingEngine(model, cfg2, device=device, router=router)
    eng2.start()
    r_e = eng2.submit(prompts[0], max_new_tokens=11)
    eng2.tick()
    report2 = eng2.drain(grace_s=0.0)
    _check(failures,
           r_e.state == "timed_out" and r_e.reason == "drain_deadline"
           and report2["evicted"] == 1
           and eng2.allocator.free_blocks == cfg2.num_blocks,
           "zero-grace drain deadline-evicts and reclaims")

    # -- 9. TTFT budget (fresh engine, built with the budget armed) -----
    # a pool-filling decode parks three requests behind it; a chaos
    # slow-decode tick (the first) sets the decode EMA to 0.3 s, so the
    # estimate is at least 4 x 0.3 s > 0.5 s (a loaded host only adds to
    # it). Before the first prefill there is no estimate and nothing is
    # shed.
    cfg3 = dataclasses.replace(cfg, ttft_budget_s=0.5)
    eng3 = ServingEngine(model, cfg3, device=device, router=router,
                         fault_plan=FaultPlan(slow_decode_steps={0},
                                              slow_decode_s=0.3))
    eng3.start()
    waiting = ([eng3.submit(prompts[0], max_new_tokens=20)
                for _ in range(2)]
               + [eng3.submit(prompts[0], max_new_tokens=2)
                  for _ in range(2)])
    eng3.tick()
    est = eng3.estimated_ttft_s()
    r_ttft = eng3.submit(prompts[0], max_new_tokens=2)
    _check(failures,
           all(r.state != "rejected" for r in waiting)
           and est is not None and est > cfg3.ttft_budget_s
           and (r_ttft.state, r_ttft.reason) == ("rejected", "ttft_budget"),
           "TTFT budget sheds when the estimate exceeds it")
    eng3.drain(grace_s=0.0)
    router.close()
    return _finish(failures, "serving selftest")


def fleet_selftest(device="cuda", model=None) -> int:
    import numpy as np

    from apex_tpu_torch.models import GPTModel
    from apex_tpu_torch.models.generate import generate
    from apex_tpu_torch.monitor import MemorySink, MetricRouter
    from apex_tpu_torch.monitor.goodput import account, run_header
    from apex_tpu_torch.resilience.chaos import FaultPlan
    from apex_tpu_torch.serving.engine import ServingConfig
    from apex_tpu_torch.serving.fleet import (
        FleetConfig,
        FleetRouter,
        engine_factory,
    )
    from apex_tpu_torch.serving.lifecycle import TERMINAL_STATES
    from apex_tpu_torch.serving.trace.analyze import analyze as xray

    failures = []
    if model is None:
        model = GPTModel(tiny_config(), device=device, seed=0)
    device = model.device
    rng = np.random.RandomState(0)
    # greedy decode, so parity survives a mid-flight KV handoff: at
    # temperature 0 the KV bytes are the whole decode cursor
    prompts = [rng.randint(0, 61, size=n).astype(np.int32) for n in (9, 12)]
    max_news = (5, 4)
    refs = [generate(model, p[None], m, device=device)[0, len(p):].tolist()
            for p, m in zip(prompts, max_news)]
    cfg = ServingConfig(lanes=2, block_size=8, num_blocks=8, max_seq_len=32,
                        max_queue_depth=16, seed=0)

    def terminal_closure(mem, fleet):
        terminal = {}
        for rec in mem.snapshot():
            if rec.get("kind") == "request" and rec.get("terminal"):
                terminal.setdefault(rec["id"], []).append(rec["state"])
        return (set(terminal) == set(range(fleet._next_rid))
                and all(len(v) == 1 and v[0] in TERMINAL_STATES
                        for v in terminal.values()))

    kinds = ("request", "run", "span", "fleet", "handoff", "trace", "slo")

    # -- part A: disaggregated parity through a ledgered KV handoff ------
    print(f"fleet selftest A on {device}: prefill/decode disaggregation",
          flush=True)
    mem_a = MemorySink(kinds=kinds)
    router_a = MetricRouter([mem_a])
    run_header(router_a, "fleet-selftest-a")
    fleet_a = FleetRouter(
        engine_factory(model, cfg, router=router_a, device=device),
        FleetConfig(replicas=2, prefill_replicas=1), router=router_a)
    fleet_a.start()
    reqs = [fleet_a.submit(p, max_new_tokens=m)
            for p, m in zip(prompts, max_news)]
    n = 0
    while not fleet_a.idle and n < 100:
        fleet_a.tick()
        n += 1
    _check(failures,
           all(r.state == "completed" for r in reqs)
           and all(r.tokens_out == ref for r, ref in zip(reqs, refs)),
           "disaggregated decode == models.generate, through a handoff")
    audit = fleet_a.ledger.audit()
    _check(failures,
           audit["matched"] and audit["handoffs"] >= 2
           and audit["bytes_out"] > 0
           and audit["bytes_in"] == audit["bytes_out"],
           "handoff ledger matched: every byte out arrived, both booked")
    _check(failures, all(r.tags.get("replica") == "r1" for r in reqs),
           "requests re-homed onto the decode replica")
    fleet_a.drain(grace_s=5.0)
    phases_a = {r.get("phase") for r in mem_a.snapshot()
                if r.get("kind") == "span"}
    _check(failures, "handoff" in phases_a,
           "handoff booked as its own goodput phase")
    _check(failures, terminal_closure(mem_a, fleet_a),
           "part A: exactly one terminal record per global id")
    _check(failures,
           all(rep.engine.allocator.free_blocks == cfg.num_blocks
               for rep in fleet_a.replicas),
           "part A: every replica's KV pool fully free after drain")
    xr_a = xray(mem_a.snapshot())
    _check(failures, xr_a.n_traces > 0 and xr_a.ok,
           "part A: trace closure — complete trees, exact identity, "
           "handoff badput reconciled")
    deco_a = {d["trace"]: d for d in xr_a.decompositions}
    _check(failures, all(deco_a[r.rid]["handoff_s"] > 0.0 for r in reqs),
           "part A: migrated requests book handoff as its own phase")
    router_a.close()

    # -- part B: replica kill -> failover -> restart, plus a scale-up ----
    print("fleet selftest B: chaos kill + failover + autoscale", flush=True)
    mem_b = MemorySink(kinds=kinds)
    router_b = MetricRouter([mem_b])
    run_header(router_b, "fleet-selftest-b")
    fleet_b = FleetRouter(
        engine_factory(model, cfg, router=router_b, device=device),
        FleetConfig(
            replicas=3, miss_ticks_to_detect=2,
            # the autoscaler's budget, not the engines' (admission never
            # sheds here): a micro-budget so the armed estimate breaches
            # at once and the scale-up fires under load
            ttft_budget_s=1e-4, breach_ticks=2,
            min_replicas=1, max_replicas=4,
        ),
        router=router_b, fault_plan=FaultPlan(kill_replica_steps={4}))
    fleet_b.start()
    load = [fleet_b.submit(prompts[i % 2], max_new_tokens=max_news[i % 2])
            for i in range(10)]
    n = 0
    while not fleet_b.idle and n < 400:
        fleet_b.tick()
        n += 1
    for _ in range(10):  # probation needs clean ticks past idle
        fleet_b.tick()
    fleet_records = [r for r in mem_b.snapshot() if r.get("kind") == "fleet"]
    actions = {(r.get("check"), r.get("action")) for r in fleet_records}
    _check(failures, ("chaos", "kill_replica") in actions,
           "chaos kill fired mid-load")
    _check(failures,
           ("replica", "detected") in actions
           and any(r.get("check") == "failover" for r in fleet_records),
           "missed heartbeats opened a case and ran failover")
    _check(failures,
           ("replica", "restarted") in actions
           and ("replica", "readmitted") in actions,
           "killed replica restarted and closed its case via probation")
    _check(failures, all(r.healthy for r in fleet_b.replicas),
           "every replica healthy after recovery")
    req_records = [r for r in mem_b.snapshot() if r.get("kind") == "request"]
    _check(failures, any(r.get("attempt", 1) > 1 for r in req_records),
           "orphaned in-flight requests re-dispatched (attempt > 1)")
    # fleet.requests(), not the submit-time objects: a re-dispatched
    # request terminates on its latest attempt's Request
    _check(failures,
           all(r.state == "completed" for r in fleet_b.requests())
           and len(fleet_b.requests()) == len(load),
           "every request completed despite the kill")
    _check(failures,
           any(r.get("prefix_hit_tokens", 0) > 0 for r in req_records)
           and fleet_b.prefix.stats()["hits"] > 0,
           "prefix-cache hits emitted on request records")
    _check(failures,
           ("autoscale", "scale_up") in actions
           and ("autoscale", "added") in actions,
           "SLO breach scaled the fleet up")
    _check(failures,
           sum(rep.engine.steady_state_compiles
               for rep in fleet_b.replicas) == 0,
           "zero steady-state kernel loads on every replica "
           "(restart and scale-up bursts booked, not charged)")
    fleet_b.drain(grace_s=5.0)
    _check(failures, fleet_b.drain()["redundant"] is True,
           "second fleet drain is redundant, not an exception")
    _check(failures, terminal_closure(mem_b, fleet_b),
           "part B: exactly one terminal record per global id, "
           "through kill and failover")
    phases_b = {r.get("phase") for r in mem_b.snapshot()
                if r.get("kind") == "span"}
    _check(failures, "failover" in phases_b,
           "failover booked as its own goodput phase")
    _check(failures, _identity_holds(account(mem_b.snapshot())),
           "fleet-wide goodput partition identity holds digit-for-digit")
    xr_b = xray(mem_b.snapshot())
    _check(failures, xr_b.n_traces > 0 and xr_b.ok,
           "part B: trace closure through kill+failover — complete "
           "trees, exact identity, failover badput reconciled")
    recovered = [d for d in xr_b.decompositions
                 if (d.get("attempt") or 1) > 1]
    _check(failures,
           bool(recovered) and all(d["recovery_s"] > 0.0 for d in recovered),
           "part B: failed-over requests book recovery as its own phase")
    slo_recs = [r for r in mem_b.snapshot() if r.get("kind") == "slo"]
    _check(failures,
           any(r.get("alert") for r in slo_recs)
           and all(r["n"] >= r["violations"] >= 0 for r in slo_recs),
           "part B: SLO burn-rate records emitted, fast-burn alert "
           "fired under the micro-budget")
    router_b.close()
    return _finish(failures, "fleet selftest")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.serving",
        description="serving-core self-test (exit nonzero on any failed "
                    "check): admission/shed/deadline/drain on a tiny GPT "
                    "with zero kernel loads after start() asserted",
    )
    parser.add_argument("--selftest", action="store_true",
                        help="run the self-test (the default mode)")
    parser.add_argument("--fleet", action="store_true",
                        help="run the fleet gate instead: in-process "
                             "replicas, KV handoff parity, a chaos "
                             "replica kill with failover, and an "
                             "SLO-driven scale-up")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without a card) "
                             "or cpu (the plain PyTorch path)")
    args = parser.parse_args(argv)
    if args.fleet:
        return fleet_selftest(args.device)
    return selftest(args.device)


if __name__ == "__main__":
    sys.exit(main())
