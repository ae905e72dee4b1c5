"""Pretrain a GPT on the synthetic token stream (the core loop of the JAX
package's examples/gpt/pretrain_gpt.py).

    python -m apex_tpu_torch.examples.gpt.pretrain_gpt --steps 20
    python -m apex_tpu_torch.examples.gpt.pretrain_gpt --vocab 50257 \\
        --seq-len 1024 --layers 12 --hidden 768 --heads 12 \\
        --micro-batch 8 --global-batch 16 --steps 9 --profile-steps 2
    python -m apex_tpu_torch.examples.gpt.pretrain_gpt --vocab 50257 \\
        --seq-len 1024 --layers 12 --hidden 768 --heads 12 \\
        --micro-batch 8 --global-batch 16 --steps 6 --log-interval 2 \\
        --metrics-jsonl /tmp/m.jsonl --profile-step 3 --xray-hbm \\
        --stall-deadline 120
    python -m torch.distributed.run --nproc_per_node 4 \\
        -m apex_tpu_torch.examples.gpt.pretrain_gpt --tp 2 --zero \\
        --vocab 50304 --seq-len 1024 --layers 12 --hidden 768 --heads 12 \\
        --micro-batch 4 --global-batch 16 --steps 4

Builds the step with ``build_gpt_training`` (resilience/replay/targets.py),
walks the JAX package's synthetic stream in order, ``global_batch``
samples a step, and prints one line per step:
``step N loss L grad_norm G loss_scale S tokens_per_s T step_ms M
verdict V``. ``--profile-steps N`` runs N further steps under
``torch.profiler`` and prints the device time by kernel as one JSON line
(needs the card). Runs on the card unless ``--device cpu``.

Under ``torch.distributed.run`` (which sets ``WORLD_SIZE``) every process
is one rank of a ``--dist-backend`` world (NCCL by default; gloo where
NCCL cannot run, such as several ranks on one card, moves CUDA tensors
through host memory) at tensor-parallel size ``--tp``, with sequence
parallelism unless ``--no-sequence-parallel``, and data-parallel size the
rest; ``--zero`` shards Adam's state over dp (ZeRO-2), and
``--compression int8|fp8`` (``--compression-block`` elements a scale)
quantizes the dp gradient sync with error feedback. ``--layer-rms``
appends each layer's output RMS to the step line. Rank r takes card
``LOCAL_RANK`` modulo the cards it sees. Only rank 0 prints; its last
line is one JSON object with its kernel launch counts of the run, every
rank's peak device memory, what rank 0 staged through host memory
(gloo with CUDA tensors), under ZeRO the length of a rank's
optimizer-state shard, and rank 0's parameters' element counts.

Telemetry (the JAX example's ``monitor`` wiring): each step folds its
metrics into a ``MetricBag`` on the device, and every ``--log-interval``
steps rank 0 fetches it ONCE and writes one ``kind="metrics"`` record
(loss, grad_norm, loss_scale, loss_z, skipped, anomalies, tokens_per_s,
step_ms and ``mfu`` against the card's peak, null where the peak is
unknown, as on the CPU) to ``--metrics-jsonl`` and ``--metrics-csv``,
beside the goodput spans and the run's summary. ``--profile-step N``
captures steps N and N + 1 with ``torch.profiler`` as a Chrome trace
under ``--profile-dir``; ``--stall-deadline`` arms the incident ladder
(warn, a ``kind="incident"`` dump at ``--stall-dump-after`` times the
deadline, and with ``--stall-terminate-after`` the exit with code 43);
``--xray-hbm`` prints the analytic HBM ledger, samples the allocator's
watermarks into ``kind="memory"`` records each interval and guards the
step with ``oom_guard``. On the card rank 0 prints one more JSON line,
before the others: ``{"telemetry": ...}``, the run's host fetches,
intervals, profiler captures, stalls, HBM summary and kernel launch
counts. Journaling, checkpoints,
remediation and the comms and compiled-memory x-rays are not ported yet.
"""

import argparse
import contextlib
import json
import os
import tempfile
import time

import torch
import torch.distributed as dist

from apex_tpu_torch import _kernels
from apex_tpu_torch import monitor
from apex_tpu_torch.data import LMDataset
from apex_tpu_torch.monitor import goodput
from apex_tpu_torch.monitor.xray import hbm as xhbm
from apex_tpu_torch.parallel import parallel_state as ps
from apex_tpu_torch.resilience.replay.targets import (
    GPTTargetConfig,
    build_gpt_training,
    synthetic_corpus,
)
from apex_tpu_torch.resilience.health import IncidentResponder
from apex_tpu_torch.resilience.sentinel import verdict_name
from apex_tpu_torch.transformer.testing.commons import initialize_distributed


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--vocab", type=int, default=512)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--sequence-parallel",
                   action=argparse.BooleanOptionalAction, default=True,
                   help="Megatron SP over tp (--no-sequence-parallel to "
                        "disable)")
    p.add_argument("--micro-batch", type=int, default=4)
    p.add_argument("--global-batch", type=int, default=16)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--weight-decay", type=float, default=0.01)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--zero", action="store_true",
                   help="ZeRO-2 optimizer (distributed_fused_adam): Adam "
                        "moments and the fp32 master sharded 1/dp over dp")
    p.add_argument("--compression", default="none",
                   choices=["none", "int8", "fp8"],
                   help="quantized gradient collectives (parallel."
                        "compress): the dp gradient sync travels "
                        "block-scaled int8/fp8 with fp32 scales and an "
                        "error-feedback residual; found_inf consensus and "
                        "the master update stay exact")
    p.add_argument("--compression-block", type=int, default=128,
                   help="elements per fp32 scale block for --compression")
    p.add_argument("--layer-rms", action="store_true",
                   help="collect each layer's output RMS (the step's "
                        "collect_layer_rms) and print it on the step line")
    p.add_argument("--dist-backend", default="nccl",
                   choices=["nccl", "gloo"],
                   help="torch.distributed backend under "
                        "torch.distributed.run")
    p.add_argument("--profile-steps", type=int, default=0,
                   help="after the run, profile this many more steps")
    # telemetry (apex_tpu_torch.monitor): metrics fold into a MetricBag on
    # the device and cross to the host once per interval
    p.add_argument("--log-interval", type=int, default=5,
                   help="steps between metric records (and bag fetches)")
    p.add_argument("--metrics-jsonl", default=None,
                   help="write metric/span/memory records to this jsonl")
    p.add_argument("--metrics-csv", default=None,
                   help="also write metric records to this CSV")
    p.add_argument("--profile-step", type=int, default=None,
                   help="capture a torch.profiler window at this step")
    p.add_argument("--profile-dir", default=None,
                   help="profiler capture dir (default: <tmp>/profiles)")
    p.add_argument("--stall-deadline", "--step-deadline", type=float,
                   default=None,
                   help="stall watchdog: flag a step exceeding this many "
                        "seconds; arms the incident ladder")
    p.add_argument("--stall-dump-after", type=float, default=2.0,
                   help="incident ladder: the forensic bundle at this "
                        "multiple of --stall-deadline")
    p.add_argument("--stall-terminate-after", type=float, default=None,
                   help="incident ladder: self-terminate (exit code 43, "
                        "spans flushed) at this multiple of "
                        "--stall-deadline (default: off)")
    p.add_argument("--xray-hbm", action="store_true",
                   help="HBM x-ray: the analytic ledger at startup, live "
                        "kind='memory' watermark records each interval and "
                        "kind='oom' forensics on device-memory exhaustion")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    """Runs the loop; returns the per-step records it printed."""
    args = parse_args(argv)
    distributed = "WORLD_SIZE" in os.environ  # under torch.distributed.run
    device = torch.device(args.device)
    if distributed:
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get(
                "LOCAL_RANK", 0)) % torch.cuda.device_count())
            torch.cuda.set_device(device)
        initialize_distributed(args.dist_backend,
                               tensor_model_parallel_size=args.tp)
    try:
        return _run(args, device, distributed)
    finally:
        if distributed:
            ps.destroy_model_parallel()
            dist.destroy_process_group()


def _telemetry_router(args, main_rank):
    """The run's router: rank 0 writes the jsonl and CSV sinks; every
    rank keeps an in-process window for the incident bundle."""
    window = monitor.MemorySink(max_records=512)
    sinks = [window]
    if main_rank and args.metrics_jsonl:
        sinks.append(monitor.JsonlSink(args.metrics_jsonl))
    if main_rank and args.metrics_csv:
        sinks.append(monitor.CsvSink(args.metrics_csv))
    router = monitor.MetricRouter(sinks)
    goodput.set_router(router)
    goodput.run_header(router, goodput.derive_run_id(args.metrics_jsonl))
    return router, window


def _hbm_prediction(cfg, training):
    """The analytic ledger of this step, at the JAX example's settings."""
    return xhbm.predict_train_memory(
        xhbm.TransformerDims.from_config(training.transformer_config),
        tp=cfg.tp, microbatch_size=cfg.micro_batch, seq_len=cfg.seq_len,
        optimizer="distributed_fused_adam" if cfg.zero else "fused_adam",
        zero_axis_size=training.dp if cfg.zero else None,
        error_feedback=cfg.zero and cfg.compression != "none",
        grad_scaler=True, remat="none",
        compression_wire_dtype=(
            None if cfg.compression == "none"
            else {"int8": "int8", "fp8": "float8_e4m3fn"}[cfg.compression]),
        label="gpt-pretrain",
        capacity_bytes=xhbm.device_memory_limit(training.device))


def _run(args, device, distributed):
    cfg = GPTTargetConfig(
        vocab=args.vocab, seq_len=args.seq_len, layers=args.layers,
        hidden=args.hidden, heads=args.heads, tp=args.tp,
        sequence_parallel=args.sequence_parallel,
        micro_batch=args.micro_batch, global_batch=args.global_batch,
        lr=args.lr, weight_decay=args.weight_decay, seed=args.seed,
        zero=args.zero, compression=args.compression,
        compression_block=args.compression_block,
        collect_layer_rms=args.layer_rms)
    if args.log_interval < 1:
        raise SystemExit("--log-interval must be >= 1")
    main_rank = not distributed or dist.get_rank() == 0
    say = print if main_rank else (lambda *a, **k: None)
    router, window = _telemetry_router(args, main_rank)
    with goodput.span("init"):
        training = build_gpt_training(cfg, device=device)
        if training.device.type == "cuda":
            _kernels.build_all()  # every nvcc at once, not one per launch
        state = training.init_state()
        bag = training.init_bag()
        lm = LMDataset(synthetic_corpus(args.vocab), args.seq_len)
    if len(lm) < cfg.global_batch:
        raise SystemExit(f"the stream holds {len(lm)} samples, fewer than "
                         f"one global batch ({cfg.global_batch})")
    if training.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    sync = (torch.cuda.synchronize if training.device.type == "cuda"
            else lambda: None)
    tokens_per_step = cfg.global_batch * cfg.seq_len
    world = dist.get_world_size() if distributed else 1
    # model FLOPs for MFU; the peak is None off the table's cards (the CPU
    # included) unless APEX_TPU_PEAK_FLOPS pins it, and mfu is then null
    step_flops = monitor.training_flops_per_step(
        monitor.gpt_flops_per_token(training.transformer_config,
                                    cfg.seq_len), tokens_per_step)
    peak_flops = monitor.peak_flops_per_device(training.device)
    trigger = monitor.ProfilerTrigger(
        args.profile_dir or os.path.join(tempfile.gettempdir(), "profiles"),
        window_steps=2, router=router)
    if args.profile_step is not None:
        trigger.request(step=args.profile_step)
    responder = None
    if args.stall_deadline:
        responder = IncidentResponder(
            args.stall_deadline, router=router, window=window,
            trigger=trigger, dump_after=args.stall_dump_after,
            terminate_after=args.stall_terminate_after)
    hbm_mon = predicted = None
    if args.xray_hbm:
        predicted = _hbm_prediction(cfg, training)
        say(predicted.format(), flush=True)
        hbm_mon = xhbm.HbmWatermarkMonitor(
            router, interval_steps=args.log_interval, predicted=predicted,
            device=training.device)

    def guard(step):
        if hbm_mon is None:
            return contextlib.nullcontext()
        return xhbm.oom_guard(router, step, breakdown=predicted)

    def run_step(i, bag=None):
        first = (i * cfg.global_batch) % (len(lm) - cfg.global_batch + 1)
        x, y = training.reshape_batch(
            *lm.batch(range(first, first + cfg.global_batch)))
        return training.train_step(state, x, y, bag=bag)

    records = []
    fetches0 = monitor.host_fetch_count()
    intervals = 0
    last_emit_t, since_emit = time.perf_counter(), 0
    for i in range(args.steps):
        trigger.maybe_start(i)
        t0 = time.perf_counter()
        # the first step loads kernels and sets up the card's libraries:
        # booked as compile, the rest as productive steps
        with goodput.span("compile" if i == 0 else "step", step=i), \
                guard(i):
            _, loss, verdict, metrics, *rms = run_step(i, bag)
            sync()
        secs = time.perf_counter() - t0
        if responder is not None:
            if i == 0:
                responder.start()  # armed once the first step is behind
            responder.beat(i)
        trigger.on_verdict(i, verdict)
        trigger.maybe_stop(i)
        since_emit += 1
        rec = dict(step=i, **metrics, tokens_per_s=tokens_per_step / secs,
                   step_ms=secs * 1e3, verdict=verdict_name(verdict))
        records.append(rec)
        tail = ""
        if rms:
            rec["layer_rms"] = rms[0]
            tail = " layer_rms " + ",".join(f"{v:.6g}" for v in rms[0])
        say(f"step {i:5d} loss {loss:.4f} grad_norm "
            f"{metrics['grad_norm']:.4f} loss_scale "
            f"{metrics['loss_scale']:.1f} tokens_per_s "
            f"{rec['tokens_per_s']:.1f} step_ms {rec['step_ms']:.2f} "
            f"verdict {rec['verdict']}{tail}", flush=True)
        if (i + 1) % args.log_interval == 0 or i == args.steps - 1:
            # ONE device-to-host fetch of the bag per interval; the rest of
            # the record is host arithmetic
            if hbm_mon is not None:
                hbm_mon.sample(i)
            vals = monitor.read_bag(bag)
            interval_s = time.perf_counter() - last_emit_t
            sec_per_step = interval_s / since_emit
            router.metrics(
                i, **vals,
                tokens_per_s=monitor.tokens_per_second(
                    tokens_per_step * since_emit, interval_s),
                mfu=monitor.mfu(step_flops, sec_per_step, num_devices=world,
                                peak_flops=peak_flops),
                step_ms=1e3 * sec_per_step,
                **(hbm_mon.metrics_fields() if hbm_mon is not None else {}))
            monitor.reset_bag(bag)
            intervals += 1
            last_emit_t, since_emit = time.perf_counter(), 0
    if responder is not None:
        responder.stop()
    trigger.close()  # abort a capture still open (end of run)
    fetches = monitor.host_fetch_count() - fetches0
    router.event("summary", args.steps - 1, steps_run=args.steps,
                 host_fetches=fetches, intervals=intervals,
                 profiles=len(trigger.captures),
                 stalls=len(responder.stalls) if responder else 0)
    telemetry = {
        "host_fetches": fetches, "intervals": intervals,
        "captures": [c["trace"] for c in trigger.captures],
        "stalls": len(responder.stalls) if responder else 0,
        "peak_flops": peak_flops,
        "flops_per_step": step_flops,
        "launch_counts": _kernels.launch_counts(),
    }
    if hbm_mon is not None:
        hs = hbm_mon.summary()
        telemetry["hbm"] = {**hs, "predicted_resident_bytes":
                            predicted.resident_bytes}
        say("hbm x-ray: predicted peak "
            f"{_mib(hs['predicted_peak_bytes'])}, achieved "
            f"{_mib(hs['achieved_peak_bytes'])}", flush=True)
    if training.device.type == "cuda":
        say(json.dumps({"telemetry": telemetry}), flush=True)
    if args.profile_steps > 0:
        from apex_tpu_torch.utils.profiling import profile_device

        report = profile_device(lambda: [
            run_step(args.steps + j) for j in range(args.profile_steps)])
        say(json.dumps({"profile_steps": args.profile_steps,
                        "tokens_per_step": tokens_per_step, **report}),
            flush=True)
    router.close()
    if distributed:
        peak = torch.tensor([torch.cuda.max_memory_allocated(device) / 1e9
                             if device.type == "cuda" else 0.0])
        peaks = ps.all_gather(peak.to(device), dist.group.WORLD).tolist()
        say(json.dumps({
            "world": dist.get_world_size(), "tp": cfg.tp,
            "dp": training.dp, "zero": cfg.zero,
            "sequence_parallel": training.transformer_config
            .sequence_parallel,
            "backend": args.dist_backend, "compression": args.compression,
            "launch_counts_rank0": _kernels.launch_counts(),
            "peak_mem_gb_by_rank": peaks,
            "staged_through_host_rank0": dict(ps.STAGED),
            "zero_shard_len": (state.opt.master_shard.numel() if cfg.zero
                               else None),
            "param_numels_rank0": [p.numel()
                                   for p in state.params.values()]}),
            flush=True)
    return records


def _mib(b):
    return "n/a" if b is None else f"{b / 2**20:.1f} MiB"


if __name__ == "__main__":
    main()
