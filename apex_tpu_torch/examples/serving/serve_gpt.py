"""Serve a randomly initialized GPT under Poisson load (the JAX package's
examples/serving/serve_gpt.py).

    python -m apex_tpu_torch.examples.serving.serve_gpt \\
        --requests 40 --rate 50 --ttft-budget 2.0 \\
        --metrics-jsonl /tmp/serving.jsonl
    python -m apex_tpu_torch.examples.serving.serve_gpt --layers 12 \\
        --hidden 768 --heads 12 --vocab 50257 --max-seq-len 1024 \\
        --lanes 8 --blocks 512 --requests 96 --rate 12 \\
        --prompt-len 32 768 --max-new 32 64

The drill surface of the overload-hardened serving engine: builds a GPT
with rotary positions from ``--seed``, then drives a seeded Poisson
arrival stream through the continuous-batching engine with every
robustness knob on the command line:

- ``--rate`` / ``--requests``: the load (above the sustainable
  throughput the engine SHEDS instead of queueing);
- ``--ttft-budget`` / ``--queue-depth`` / ``--deadline``: admission
  control and per-request deadlines;
- ``--chaos-*``: the serving fault plan (slow-decode ticks, client
  abandons, malformed prompts, arrival bursts, a host-loop wedge);
- ``--stall-deadline/--stall-dump-after/--stall-terminate-after``: the
  incident ladder, beaten once a tick, with the engine's in-flight
  request table in the forensic bundle; its terminate level ends the
  process with exit code 43;
- SIGTERM at any point drains gracefully within ``--grace-s`` (default
  ``APEX_TPU_PREEMPTION_GRACE_S``): admission closes, in-flight requests
  finish or are deadline-evicted, and every request still reaches
  exactly one terminal state.

Telemetry lands in ``--metrics-jsonl`` (request records, prefill, decode
and drain goodput spans, the end-of-run goodput summary). The process
prints the JAX example's summary lines and ends with one JSON line: the
run's numbers, its kernel launch counts and ``steady_state_compiles``.
Runs on the card unless ``--device cpu``.
"""

import argparse
import json
import sys
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    # model
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--vocab", type=int, default=128)
    # engine geometry
    p.add_argument("--lanes", type=int, default=4)
    p.add_argument("--block-size", type=int, default=16)
    p.add_argument("--blocks", type=int, default=32,
                   help="KV pool capacity in blocks")
    p.add_argument("--max-seq-len", type=int, default=64)
    p.add_argument("--queue-depth", type=int, default=16)
    p.add_argument("--ttft-budget", type=float, default=None,
                   help="admission-time TTFT budget (s); beyond it "
                        "submissions shed instead of queueing")
    p.add_argument("--deadline", type=float, default=None,
                   help="per-request wall deadline (s)")
    p.add_argument("--prefills-per-tick", type=int, default=1)
    # load
    p.add_argument("--requests", type=int, default=40)
    p.add_argument("--rate", type=float, default=50.0,
                   help="Poisson arrival rate (req/s)")
    p.add_argument("--prompt-len", type=int, nargs=2, default=(4, 24))
    p.add_argument("--max-new", type=int, nargs=2, default=(4, 16))
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    # robustness / chaos
    p.add_argument("--grace-s", type=float, default=None,
                   help="drain grace budget on SIGTERM (default: "
                        "APEX_TPU_PREEMPTION_GRACE_S)")
    p.add_argument("--chaos-slow-decode-steps", default=None,
                   help="ticks to inflate, e.g. '10,20-22'")
    p.add_argument("--chaos-slow-decode-s", type=float, default=0.5)
    p.add_argument("--chaos-abandon", default=None,
                   help="request ordinals the client abandons")
    p.add_argument("--chaos-malformed", default=None,
                   help="request ordinals submitted malformed")
    p.add_argument("--chaos-burst-steps", default=None,
                   help="load-generator pumps that burst")
    p.add_argument("--chaos-burst-n", type=int, default=8)
    p.add_argument("--chaos-hang-step", type=int, default=None,
                   help="wedge the scheduler loop at this tick "
                        "(the incident ladder must end the job)")
    p.add_argument("--stall-deadline", type=float, default=None,
                   help="per-tick stall deadline (s); arms the watchdog")
    p.add_argument("--stall-dump-after", type=float, default=2.0)
    p.add_argument("--stall-terminate-after", type=float, default=None)
    # telemetry
    p.add_argument("--metrics-jsonl", default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu for the plain path")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    # a drain needs SIGTERM OBSERVED (flag), not obeyed (die): the notice
    # supersedes the router module's die-by-signal flush hook in either
    # install order, and chains any flag-style handler
    from apex_tpu_torch.utils.autoresume import TerminationNotice

    notice = TerminationNotice(grace_s=args.grace_s)
    try:
        return _serve(args, notice)
    finally:
        notice.close()


def _serve(args, notice):
    import torch

    from apex_tpu_torch import _kernels
    from apex_tpu_torch._kernels import resolve_device
    from apex_tpu_torch.models import GPTModel
    from apex_tpu_torch.monitor import (
        JsonlSink,
        MemorySink,
        MetricRouter,
        StdoutSink,
    )
    from apex_tpu_torch.monitor.goodput import (
        account,
        derive_run_id,
        run_header,
        set_router,
        span,
    )
    from apex_tpu_torch.resilience.chaos import FaultPlan, parse_steps
    from apex_tpu_torch.resilience.health import IncidentResponder
    from apex_tpu_torch.serving import (
        PoissonLoadGenerator,
        ServingConfig,
        ServingEngine,
    )
    from apex_tpu_torch.transformer import TransformerConfig

    device = resolve_device(args.device)  # raises without a card
    sinks = [StdoutSink()]
    mem = MemorySink(kinds=("run", "span", "request"))
    sinks.append(mem)
    if args.metrics_jsonl:
        sinks.append(JsonlSink(args.metrics_jsonl))
    router = MetricRouter(sinks)
    set_router(router)
    run_header(router, derive_run_id(args.metrics_jsonl))

    with span("init"):
        tcfg = TransformerConfig(
            num_layers=args.layers, hidden_size=args.hidden,
            num_attention_heads=args.heads, vocab_size=args.vocab,
            max_position_embeddings=args.max_seq_len,
            hidden_dropout=0.0, attention_dropout=0.0,
            position_embedding_type="rope",
        )
        model = GPTModel(tcfg, device=device, seed=args.seed)
        plan = FaultPlan(
            slow_decode_steps=parse_steps(args.chaos_slow_decode_steps),
            slow_decode_s=args.chaos_slow_decode_s,
            abandon_requests=parse_steps(args.chaos_abandon),
            malformed_requests=parse_steps(args.chaos_malformed),
            burst_steps=parse_steps(args.chaos_burst_steps),
            burst_n=args.chaos_burst_n,
            hang_steps=frozenset(
                () if args.chaos_hang_step is None
                else {args.chaos_hang_step}),
        )
        responder = None
        if args.stall_deadline is not None:
            responder = IncidentResponder(
                args.stall_deadline, router=router, window=mem,
                dump_after=args.stall_dump_after,
                terminate_after=args.stall_terminate_after,
            )
        cfg = ServingConfig(
            lanes=args.lanes, block_size=args.block_size,
            num_blocks=args.blocks, max_seq_len=args.max_seq_len,
            max_queue_depth=args.queue_depth,
            ttft_budget_s=args.ttft_budget,
            default_deadline_s=args.deadline,
            max_prefills_per_tick=args.prefills_per_tick,
            seed=args.seed,
        )
        eng = ServingEngine(model, cfg, device=device, router=router,
                            fault_plan=plan, watchdog=responder)
        gen = PoissonLoadGenerator(
            rate_rps=args.rate, vocab=args.vocab,
            n_requests=args.requests, prompt_len=tuple(args.prompt_len),
            max_new=tuple(args.max_new), temperature=args.temperature,
            deadline_s=args.deadline, seed=args.seed, fault_plan=plan,
        )
    eng.start()
    with span("compile", step=-1), torch.no_grad():
        # the card's first matmuls set up their library handles: done here,
        # before the watchdog arms, as the JAX engine's start() compiles
        model(torch.zeros((1, args.block_size), dtype=torch.long,
                          device=device))
    if responder is not None:
        responder.bundle_extra = eng.inflight_table
        responder.start()
    _kernels.reset_launch_counts()

    drained = None
    try:
        while not (gen.done and eng.idle):
            if notice.signaled:
                print("termination notice: draining", flush=True)
                drained = eng.drain(deadline=notice.grace_deadline(),
                                    grace_s=notice.grace_s)
                break
            gen.pump(eng)
            eng.tick()
            if eng.idle and not gen.done:
                # nothing in flight: wait for the next Poisson arrival
                # instead of burning empty scheduler ticks
                time.sleep(0.0005)
        if drained is None and notice.signaled:
            drained = eng.drain(deadline=notice.grace_deadline(),
                                grace_s=notice.grace_s)
    finally:
        if responder is not None:
            responder.stop()

    stats = eng.stats()
    report = gen.report().summary()
    wall = (max(time.monotonic() - gen.start_t, 1e-9)
            if gen.start_t else 1e-9)
    terminal = stats["terminal"]
    print(
        "serving summary: submitted {} completed {} rejected {} "
        "timed_out {} cancelled {} failed {}".format(
            stats["submitted"],
            terminal.get("completed", 0), terminal.get("rejected", 0),
            terminal.get("timed_out", 0), terminal.get("cancelled", 0),
            terminal.get("failed", 0),
        ), flush=True,
    )
    print(
        "serving latency: ttft p50 {} p99 {} s | per-token p50 {} "
        "p99 {} s | tokens/s {:.1f} | steady-state compiles {}".format(
            _fmt(report["ttft_p50_s"]), _fmt(report["ttft_p99_s"]),
            _fmt(report["per_token_p50_s"]),
            _fmt(report["per_token_p99_s"]),
            stats["tokens_out"] / wall,
            stats["steady_state_compiles"],
        ), flush=True,
    )
    if drained is not None:
        print(
            "serving drain: {:.3f}s, {} finished, {} evicted "
            "(grace {})".format(
                drained["drain_s"], drained["finished"],
                drained["evicted"], _fmt(notice.grace_s),
            ), flush=True,
        )
    rep = account(mem.snapshot())
    router.event("goodput", stats["ticks"], **rep.fields())
    print(rep.summary(), flush=True)
    router.close()
    print(json.dumps({
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "submitted": stats["submitted"], "terminal": terminal,
        "reasons": stats["reasons"], "tokens_out": stats["tokens_out"],
        "wall_s": wall, "tokens_per_s": stats["tokens_out"] / wall,
        "ttft_p50_s": report["ttft_p50_s"],
        "ttft_p99_s": report["ttft_p99_s"],
        "per_token_p50_s": report["per_token_p50_s"],
        "drain": drained, "ticks": stats["ticks"],
        "kv_pool_bytes": eng.k_pool.nbytes + eng.v_pool.nbytes,
        "launch_counts": _kernels.launch_counts(),
        "steady_state_compiles": stats["steady_state_compiles"],
    }), flush=True)
    return 0


def _fmt(v):
    return "-" if v is None else f"{v:.4f}"


if __name__ == "__main__":
    sys.exit(main())
