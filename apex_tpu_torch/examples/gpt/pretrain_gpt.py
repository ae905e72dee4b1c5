"""Pretrain a GPT on a memory-mapped token file (the core loop of the JAX
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
reads the token file at ``--corpus PREFIX`` (``data.write_token_file``'s
format) or by default the JAX package's synthetic corpus written to a
temp dir (its 200,000 tokens, or as many as the run's batches need),
memory-mapped through ``data.IndexedTokenDataset`` with each batch
gathered by the native host library (``_native``), in order through
``MegatronPretrainingSampler`` (``global_batch`` samples a step, resumed
at ``step * global_batch``) and ``RobustBatches`` (``--data-skip-budget``
failed loads skipped and counted as ``data_skipped``), and prints one
line per step:
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
counts, and the recompile sentinel's records
(``monitor.xray.CompileWatcher``: a ``kind="compile"`` record for each
step that loaded a kernel, ``recompile`` true after the first step).
Each step is timed by ``utils.Timers`` (a ``kind="timer"``
record each interval) and marked by ``utils.step_annotation``
(``ProfilerStep#N`` in a profiler trace).

Resilience (the JAX example's wiring): the sentinel's verdict drives the
skip -> rollback -> halt ladder of ``resilience.ResilienceManager``
(``--spike-z``, ``--spike-warmup``, ``--skip-budget``,
``--rollback-budget``; a host ring of ``--snapshot-capacity`` snapshots
every ``--snapshot-interval`` steps, ``--max-rollbacks``, the LR dampened
by ``--lr-dampen`` and the data stream rewound on each rollback; the
anomaly log at ``--anomaly-log``, default ``<save>/anomalies.jsonl``).
``--save DIR`` checkpoints every ``--save-interval`` steps through
``utils.AutoResume`` (async, verified in the background unless
``--no-background-finalize``, ``--keep-last-n`` retention), saves and
exits on SIGTERM under the ``--grace-s`` budget, and on a rerun resumes
from the newest step that verifies. With ``--save`` the run journals
(``--journal``, default on with ``--save``): every step's batch ids and
crc, chaos arms, lr_scale, loss, verdict and layer RMS go to
``<save>/replay-journal.jsonl``, every checkpoint is a replay anchor, and
``python -m apex_tpu_torch.resilience.replay DIR [--bisect]`` re-executes
it. The chaos flags drive every recovery path: ``--chaos-nan-steps``,
``--chaos-sigterm-step``, ``--chaos-corrupt-latest`` (before the restore)
and ``--chaos-bitflip-step``/``--chaos-bitflip-bit`` (a silent flip of one
parameter bit after that step). The bitflip drill, on the card or with
``--device cpu``:

    python -m apex_tpu_torch.examples.gpt.pretrain_gpt --steps 8 \
        --layers 2 --hidden 64 --heads 4 --seq-len 32 --micro-batch 1 \
        --global-batch 16 --save-interval 2 --save /tmp/flip \
        --chaos-bitflip-step 3
    python -m apex_tpu_torch.resilience.replay /tmp/flip --bisect

At world > 1 a checkpoint holds the whole world's global state, written
by rank 0 (``utils.checkpoint``), and a rerun on another world size (dp
4 saved, dp 2 resumed, and back) restores it through the elastic
resharder (``resilience.elastic``): the ZeRO flat buffers regrouped,
every leaf's crc32 verified. ``--remediate`` (with ``--save``) arms the
remediation controller (``resilience.remediation``): detector records
(the sentinel's trail, stalls) open cases, a canary replays the
journaled segments before any quarantine, and the run exits 44 to be
relaunched (quarantine,
readmit after ``--remediation-probation`` clean steps, a preemption's
rejoin) on the persisted device count, or 45 to halt (past ``--remediation-max-restarts``). Run it
under the supervisor, which relaunches it as a world of the persisted
device count:

    python -m apex_tpu_torch.resilience.remediation --supervise \
        --save /tmp/heal --devices 4 -- -m \
        apex_tpu_torch.examples.gpt.pretrain_gpt --dist-backend gloo \
        --device cpu --zero --save /tmp/heal --save-interval 2 --remediate

The analysis flags (the JAX example's): ``--xray-report`` prints the
allocator's breakdown of one step against the card's memory (it needs
the card), ``--xray-comms`` the ledger's per-axis bytes a step,
``--audit-donation`` and ``--audit-comms`` hold one recorded step to the
donation auditor (its state, argument 0, declared updated in place) and
the ghost-collective differ; each of these runs one step before
training whose state is put back after it, and an audit that finds a
defect or cannot verify exits instead of printing ok.
``--profile-analyze`` (``--profile-step 1`` unless one is given) prints
the timeline of each capture after the run, joined to a recorded step's
collectives and ledger.
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
from apex_tpu_torch.data import (
    IndexedTokenDataset,
    LMDataset,
    MegatronPretrainingSampler,
    RobustBatches,
)
from apex_tpu_torch.monitor import goodput
from apex_tpu_torch.monitor.xray import hbm as xhbm
from apex_tpu_torch.parallel import parallel_state as ps
from apex_tpu_torch.resilience import chaos
from apex_tpu_torch.resilience.health import IncidentResponder
from apex_tpu_torch.resilience.integrity import save_checkpoint_verified
from apex_tpu_torch.resilience.remediation.controller import (
    after_step,
    sync_queue,
)
from apex_tpu_torch.resilience.replay.journal import (
    FlightRecorder,
    batch_crc,
    journal_path,
)
from apex_tpu_torch.resilience.replay.replayer import (
    determinism_guard,
    numerics_flags_kept,
)
from apex_tpu_torch.resilience.replay.targets import (
    GPTTargetConfig,
    build_gpt_training,
    synthetic_corpus,
)
from apex_tpu_torch.resilience.rollback import (
    EscalationPolicy,
    ResilienceManager,
    RollbackBuffer,
)
from apex_tpu_torch.resilience.sentinel import verdict_name
from apex_tpu_torch.transformer.testing.commons import initialize_distributed
from apex_tpu_torch.utils.autoresume import AutoResume
from apex_tpu_torch.utils.checkpoint import latest_step
from apex_tpu_torch.utils.pytree import tree_copy_
from apex_tpu_torch.utils.timers import Timers, step_annotation

#: the synthetic stream's shortest length (the JAX example's)
CORPUS_TOKENS = 200_000


def corpus_tokens(args) -> int:
    """The synthetic stream's length: the JAX example's, or enough for
    every batch the run may read (its steps, the profile steps and the
    data skip budget), whichever is more. The stream is prefix-stable,
    so a longer one begins with the same batches; the journal header
    records the length, and a replay regenerates the same stream."""
    samples = ((args.steps + args.profile_steps + args.data_skip_budget)
               * args.global_batch)
    return max(CORPUS_TOKENS, samples * args.seq_len + 1)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--corpus", default=None,
                   help="token file prefix (see apex_tpu_torch.data."
                        "write_token_file); default: a synthetic corpus in "
                        "a temp dir")
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
    p.add_argument("--tensorboard-dir", default=None,
                   help="also write scalars to TensorBoard (if the "
                        "tensorboard package is importable)")
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
    p.add_argument("--fleet-interval", type=int, default=None,
                   help="run the live fleet-health check (straggler "
                        "robust-z and replicated-value divergence) every N "
                        "steps over the in-process record window, emitting "
                        "kind='fleet' records (default: off)")
    p.add_argument("--profile-analyze", action="store_true",
                   help="after the run, analyze the profiler capture(s) "
                        "taken: per-step compute/collective/memcpy/idle "
                        "breakdown and per-axis collective bytes/s against "
                        "the ledger (monitor.xray.timeline; kind='profile' "
                        "records). Implies --profile-step 1 when no "
                        "capture was otherwise requested")
    p.add_argument("--xray-report", action="store_true",
                   help="startup banner: the allocator's breakdown of one "
                        "step against the card's memory (kind='memory' "
                        "record; needs the card)")
    p.add_argument("--xray-comms", action="store_true",
                   help="startup banner and kind='comms' records: per-axis "
                        "collective bytes a step from the ledger of one "
                        "recorded step (utilization None: no link roofline)")
    p.add_argument("--audit-donation", action="store_true",
                   help="check that the step keeps its state (argument 0) "
                        "in its storage, and find state it double-buffers "
                        "(apex_tpu_torch.analysis.donation) before "
                        "training; kind='analysis' records")
    p.add_argument("--audit-comms", action="store_true",
                   help="diff the step's dispatched collectives against "
                        "the ledger (apex_tpu_torch.analysis.hlo) before "
                        "training; kind='analysis' records")
    p.add_argument("--xray-hbm", action="store_true",
                   help="HBM x-ray: the analytic ledger at startup, live "
                        "kind='memory' watermark records each interval and "
                        "kind='oom' forensics on device-memory exhaustion")
    p.add_argument("--data-skip-budget", type=int, default=16,
                   help="batches whose host-side load may fail (skipped "
                        "and logged, data_skipped in the metrics records) "
                        "before the run fails loudly")
    # checkpoints and the journal (utils.autoresume, resilience.replay)
    p.add_argument("--save", default=None, help="checkpoint directory")
    p.add_argument("--save-interval", type=int, default=100)
    p.add_argument("--keep-last-n", type=int, default=None,
                   help="checkpoint retention: keep only the newest N steps")
    p.add_argument("--background-finalize",
                   action=argparse.BooleanOptionalAction, default=True,
                   help="verify and commit async interval saves on the "
                        "writer's background thread "
                        "(--no-background-finalize: at the next save)")
    p.add_argument("--grace-s", type=float, default=None,
                   help="preemption grace budget in seconds (default: "
                        "$APEX_TPU_PREEMPTION_GRACE_S); the SIGTERM save "
                        "downgrades to finalize-pending or skip when a "
                        "full save cannot fit")
    p.add_argument("--journal", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="flight-recorder journaling (default: on with "
                        "--save, recording the numerics flags; an explicit "
                        "--journal also pins them, determinism_guard)")
    # the resilience policy (resilience.sentinel, resilience.rollback)
    p.add_argument("--spike-z", type=float, default=6.0,
                   help="loss z-score above the running EMA that counts "
                        "as a spike")
    p.add_argument("--spike-warmup", type=int, default=10,
                   help="clean steps before spike detection arms")
    p.add_argument("--skip-budget", type=int, default=1,
                   help="consecutive anomalies answered by skipping the "
                        "batch")
    p.add_argument("--rollback-budget", type=int, default=2,
                   help="further consecutive anomalies answered by "
                        "rollback")
    p.add_argument("--snapshot-interval", type=int, default=10,
                   help="steps between in-memory rollback snapshots")
    p.add_argument("--snapshot-capacity", type=int, default=2,
                   help="rollback snapshots kept in host RAM")
    p.add_argument("--max-rollbacks", type=int, default=3,
                   help="rollbacks per run before halting")
    p.add_argument("--lr-dampen", type=float, default=0.5,
                   help="lr_scale multiplier applied on each rollback")
    p.add_argument("--anomaly-log", default=None,
                   help="jsonl anomaly log (default: <save>/anomalies.jsonl)")
    # fault injection (resilience.chaos), for tests and drills
    p.add_argument("--chaos-nan-steps", default="",
                   help="comma/range list of steps whose loss is "
                        "NaN-poisoned")
    p.add_argument("--chaos-sigterm-step", type=int, default=None,
                   help="deliver a real SIGTERM after this step")
    p.add_argument("--chaos-hang-step", type=int, default=None,
                   help="wedge the host loop at this step (a hung-"
                        "collective stand-in that never returns; only the "
                        "--stall-deadline incident ladder can end the job)")
    p.add_argument("--chaos-slow-steps", default="",
                   help="comma/range list of steps delayed by "
                        "--chaos-slow-s (straggler injection)")
    p.add_argument("--chaos-slow-s", type=float, default=1.0,
                   help="artificial delay a --chaos-slow-steps step")
    p.add_argument("--chaos-corrupt-latest", default="none",
                   choices=["none", "bitflip", "truncate"],
                   help="corrupt the newest checkpoint BEFORE restoring")
    p.add_argument("--chaos-bitflip-step", type=int, default=None,
                   help="flip one low-mantissa bit of one parameter in "
                        "memory AFTER this step (silent corruption that "
                        "only the replay bisector pins)")
    p.add_argument("--chaos-bitflip-bit", type=int, default=12,
                   help="bit index (from the LSB) for --chaos-bitflip-step")
    # auto-remediation (resilience.remediation): detector findings ->
    # canary-verified quarantine, probation, readmit, escalate-to-halt,
    # with kind="remediation" records and the exit codes a supervisor
    # relaunches on
    p.add_argument("--remediate", action="store_true",
                   help="arm the auto-remediation controller (requires "
                        "--save: the persisted plan, the replay journal "
                        "the canary re-executes and the checkpoints a "
                        "quarantine falls back to all live there); the "
                        "run exits 44 to request a restart (reduced "
                        "topology / readmit / post-preemption rejoin) and "
                        "45 on escalate-to-halt")
    p.add_argument("--remediation-probation", type=int, default=8,
                   help="clean steps a quarantined/restarted incarnation "
                        "must run before the case closes (readmit)")
    p.add_argument("--remediation-max-restarts", type=int, default=4,
                   help="controller-driven restarts before "
                        "escalate-to-halt")
    p.add_argument("--remediation-verify",
                   action=argparse.BooleanOptionalAction, default=True,
                   help="canary-verify findings before any quarantine "
                        "(--no-remediation-verify is the deliberately "
                        "broken policy the campaign's false-positive "
                        "check exists to catch; drills only)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


class RunRecords(list):
    """The run's per-step records, and its exit code (``exit_code``: 0
    done, 44 restart me with the persisted plan, 45 escalated halt;
    ``resilience/exit_codes.py``)."""

    exit_code = 0


def main(argv=None):
    """Runs the loop; returns the per-step records it printed (a
    :class:`RunRecords`, whose ``exit_code`` the command exits with)."""
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
        # --journal pins the numerics flags for the run (determinism_guard)
        with numerics_flags_kept():
            return _run(args, device, distributed)
    finally:
        if distributed:
            ps.destroy_model_parallel()
            dist.destroy_process_group()


def _telemetry_router(args, main_rank):
    """The run's router: rank 0 writes the jsonl and CSV sinks; every
    rank keeps an in-process window for the incident bundle. The run id
    comes from ``--save`` (every restart of a job joins one ledger), else
    ``--metrics-jsonl``."""
    window = monitor.MemorySink(max_records=512)
    sinks = [window]
    if main_rank and args.metrics_jsonl:
        sinks.append(monitor.JsonlSink(args.metrics_jsonl))
    if main_rank and args.metrics_csv:
        sinks.append(monitor.CsvSink(args.metrics_csv))
    if main_rank and args.tensorboard_dir:
        tb = monitor.try_tensorboard_sink(args.tensorboard_dir)
        if tb is None:
            print("no TensorBoard writer importable; --tensorboard-dir "
                  "ignored")
        else:
            sinks.append(tb)
    router = monitor.MetricRouter(sinks)
    goodput.set_router(router)
    run_id = goodput.derive_run_id(args.save or args.metrics_jsonl)
    goodput.run_header(router, run_id)
    return router, window, run_id


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
    if args.log_interval < 1:
        raise SystemExit("--log-interval must be >= 1")
    if args.remediate and not args.save:
        raise SystemExit(
            "--remediate requires --save: the persisted remediation plan, "
            "the replay journal, and the quarantine fallback checkpoints "
            "all live in the save directory")
    journal_on = (args.journal if args.journal is not None
                  else bool(args.save))
    cfg = GPTTargetConfig(
        vocab=args.vocab, seq_len=args.seq_len, layers=args.layers,
        hidden=args.hidden, heads=args.heads, tp=args.tp,
        sequence_parallel=args.sequence_parallel,
        micro_batch=args.micro_batch, global_batch=args.global_batch,
        lr=args.lr, weight_decay=args.weight_decay, seed=args.seed,
        zero=args.zero, compression=args.compression,
        compression_block=args.compression_block,
        spike_z=args.spike_z, spike_warmup=args.spike_warmup,
        skip_budget=args.skip_budget, rollback_budget=args.rollback_budget,
        collect_layer_rms=args.layer_rms or journal_on)
    main_rank = not distributed or dist.get_rank() == 0
    say = print if main_rank else (lambda *a, **k: None)
    router, window, run_id = _telemetry_router(args, main_rank)
    init_span = goodput.begin_span("init")
    # the numerics flags, recorded (and pinned only under an explicit
    # --journal) BEFORE the step is built, so a replay applies the same
    guard_flags = (determinism_guard(pin=args.journal is True,
                                     device=device) if journal_on else {})
    training = build_gpt_training(cfg, device=device)
    if training.device.type == "cuda":
        _kernels.build_all()  # every nvcc at once, not one per launch
    state = training.init_state()
    bag = training.init_bag()
    n_tokens = corpus_tokens(args)
    prefix = args.corpus or synthetic_corpus(args.vocab, n_tokens)
    lm = LMDataset(IndexedTokenDataset(prefix), args.seq_len)
    if len(lm) < cfg.global_batch:
        raise SystemExit(f"the stream holds {len(lm)} samples, fewer than "
                         f"one global batch ({cfg.global_batch})")
    world = dist.get_world_size() if distributed else 1
    recorder = None
    if journal_on:
        # rank 0 writes the journal; the other ranks keep theirs in memory
        recorder = FlightRecorder(
            journal_path(args.save) if args.save and main_rank else None,
            router=router)
        recorder.header(
            run_id, "gpt", config=cfg.to_json(),
            corpus={"prefix": prefix,
                    **({} if args.corpus
                       else {"synthetic": {"vocab": args.vocab,
                                           "n_tokens": n_tokens}})},
            devices=world, steps=args.steps, **guard_flags)
    # chaos drill: corrupt the newest checkpoint BEFORE the restore,
    # which must fall back to the previous step that verifies
    if args.save and args.chaos_corrupt_latest != "none":
        touched = (chaos.corrupt_latest_checkpoint(
            args.save, mode=args.chaos_corrupt_latest) if main_rank
            else None)
        if touched:
            say(f"[chaos] corrupted newest checkpoint: {touched}")
        if distributed:
            dist.barrier()
    ar = (AutoResume(args.save, interval=args.save_interval,
                     keep_last_n=args.keep_last_n, grace_s=args.grace_s,
                     background_finalize=args.background_finalize,
                     journal=recorder)
          if args.save else None)
    step0 = 0
    if ar is not None:
        try:
            # copied into the live state: the model trains its own
            # parameters from the restored values
            step0, _ = ar.restore(state.as_tuple())
        except ValueError as e:
            # an older payload layout: train fresh (the checkpoints stay
            # on disk). A refused restore across a change of layout is
            # ElasticRestoreError, a RuntimeError, and is not caught
            say(f"checkpoint in {args.save} has an incompatible layout "
                f"({e}); starting fresh")
        if step0 == 0 and latest_step(args.save) is not None:
            say(f"WARNING: checkpoints exist under {args.save} but none "
                f"restored under the current state layout; training "
                f"starts FRESH")
        if step0:
            say(f"resumed from step {step0}")
    if recorder is not None:
        # the segment start: a fresh run's init state is rebuilt from the
        # seed (init=True anchor), a resumed run's from its checkpoint
        recorder.anchor(step0, init=(step0 == 0))
    controller = (_controller(args, training, lm, router, run_id, step0,
                              world, main_rank, recorder)
                  if args.remediate else None)
    exit_code = 0
    if training.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    sync = (torch.cuda.synchronize if training.device.type == "cuda"
            else lambda: None)
    tokens_per_step = cfg.global_batch * cfg.seq_len
    # model FLOPs for MFU; the peak is None off the table's cards (the CPU
    # included) unless APEX_TPU_PEAK_FLOPS pins it, and mfu is then null
    step_flops = monitor.training_flops_per_step(
        monitor.gpt_flops_per_token(training.transformer_config,
                                    cfg.seq_len), tokens_per_step)
    peak_flops = monitor.peak_flops_per_device(training.device)
    trigger = monitor.ProfilerTrigger(
        args.profile_dir or os.path.join(
            args.save or tempfile.gettempdir(), "profiles"),
        window_steps=2, router=router)
    if args.profile_analyze and args.profile_step is None:
        args.profile_step = 1
    if args.profile_step is not None:
        trigger.request(step=args.profile_step)
    responder = None
    if args.stall_deadline:
        # its terminate stage tombstones ar's pending save
        responder = IncidentResponder(
            args.stall_deadline, router=router, window=window,
            trigger=trigger, autoresume=ar,
            dump_after=args.stall_dump_after,
            terminate_after=args.stall_terminate_after)
    # live fleet health: the straggler and replicated-value divergence
    # checks over a rolling window of the run's own records (kind="fleet")
    fleet_mon = None
    if args.fleet_interval:
        fleet_win = monitor.MemorySink(max_records=4096,
                                       kinds=("span", "metrics"))
        router.add_sink(fleet_win)
        fleet_mon = goodput.LiveFleetMonitor(
            router, fleet_win, interval_steps=args.fleet_interval)
    hbm_mon = predicted = None
    if args.xray_hbm:
        predicted = _hbm_prediction(cfg, training)
        say(predicted.format(), flush=True)
        hbm_mon = xhbm.HbmWatermarkMonitor(
            router, interval_steps=args.log_interval, predicted=predicted,
            device=training.device)

    audit = _pre_training_audits(args, training, state, lm, router, say,
                                 step0)

    def guard(step):
        if hbm_mon is None:
            return contextlib.nullcontext()
        return xhbm.oom_guard(router, step, breakdown=predicted)

    # the host half of the resilience loop: snapshot ring + escalation
    # policy (skip -> rollback + LR dampen -> halt) + the anomaly log
    mgr = ResilienceManager(
        buffer=RollbackBuffer(capacity=args.snapshot_capacity,
                              interval=args.snapshot_interval),
        policy=EscalationPolicy(max_rollbacks=args.max_rollbacks,
                                lr_dampen=args.lr_dampen),
        log_path=args.anomaly_log or (
            os.path.join(args.save, "anomalies.jsonl") if args.save
            else None),
        router=router)
    plan = chaos.FaultPlan(
        nan_steps=args.chaos_nan_steps,
        sigterm_steps=({args.chaos_sigterm_step}
                       if args.chaos_sigterm_step is not None
                       else frozenset()),
        hang_steps=({args.chaos_hang_step}
                    if args.chaos_hang_step is not None else frozenset()),
        slow_steps=args.chaos_slow_steps, slow_s=args.chaos_slow_s,
        bitflip_steps=({args.chaos_bitflip_step}
                       if args.chaos_bitflip_step is not None
                       else frozenset()),
        bitflip_bit=args.chaos_bitflip_bit)

    # the sampler's own resume: the stream picks up where the saved (or
    # rolled-back-to) run left off
    def make_iter(start_step):
        return iter(MegatronPretrainingSampler(
            total_samples=len(lm),
            consumed_samples=start_step * cfg.global_batch,
            local_minibatch_size=cfg.global_batch,  # each rank takes its
            data_parallel_rank=0,                   # dp columns itself
            data_parallel_size=1))

    timers = Timers(write_fn=router.timer_write_fn)
    it = make_iter(step0)
    # the ids the loader ACTUALLY consumed, journaled per step: a skipped
    # batch shifts every later one, and a replay fetches these ids
    last_ids = []

    def load_batch():
        ids = list(next(it))  # `it` late-bound: a rollback rewinds it
        last_ids[:] = ids
        return lm.batch(ids)

    batches = RobustBatches(load_batch, max_skips=args.data_skip_budget)
    # seed the ring so an anomaly before the first cadence point can
    # still roll back instead of halting
    mgr.buffer.snapshot(step0, state.as_tuple())
    # recompile sentinel: always on; a kernel loaded after the first step
    # escaped the warm-up, and every such step pays it
    compile_watcher = monitor.xray.CompileWatcher(router=router)
    init_span.close()

    records = []
    fetches0 = monitor.host_fetch_count()
    intervals = steps_run = 0
    last_emit_t, since_emit = time.perf_counter(), 0
    step_i = step0
    while step_i < args.steps:
        with goodput.span("data_wait", step=step_i):
            x0, y0 = batches()
            x, y = training.reshape_batch(x0, y0)
        batch_ids = list(last_ids)
        crc = batch_crc(x0, y0) if recorder is not None else None
        nan_armed = plan.take_nan(step_i)
        lr_scale_now = mgr.lr_scale
        trigger.maybe_start(step_i)
        t0 = time.perf_counter()
        # the first step loads kernels and sets up the card's libraries:
        # booked as compile, the rest as productive steps
        with goodput.span("compile" if steps_run == 0 else "step",
                          step=step_i), guard(step_i), \
                step_annotation(step_i):
            timers("step").start()
            _, loss, verdict, metrics, *rms = training.train_step(
                state, x, y, inject_nan=nan_armed, lr_scale=lr_scale_now,
                bag=bag)
            sync()
            timers("step").stop()
        secs = time.perf_counter() - t0
        steps_run += 1
        if responder is not None and steps_run == 1:
            responder.start()  # armed once the first step is behind
        # chaos: a straggler's delay or a host-loop wedge, after the
        # ladder is armed and before the step's beat, so the stall
        # watchdog flags this step (and only the ladder ends a wedge)
        plan.maybe_slow(step_i)
        plan.maybe_hang(step_i)
        if responder is not None:
            responder.beat(step_i)
        trigger.on_verdict(step_i, verdict)
        trigger.maybe_stop(step_i)
        since_emit += 1
        rec = dict(step=step_i, **metrics,
                   tokens_per_s=tokens_per_step / secs, step_ms=secs * 1e3,
                   verdict=verdict_name(verdict),
                   data_skipped=batches.skipped)
        records.append(rec)
        tail = ""
        if rms and args.layer_rms:
            rec["layer_rms"] = rms[0]
            tail = " layer_rms " + ",".join(f"{v:.6g}" for v in rms[0])
        say(f"step {step_i:5d} loss {loss:.4f} grad_norm "
            f"{metrics['grad_norm']:.4f} loss_scale "
            f"{metrics['loss_scale']:.1f} tokens_per_s "
            f"{rec['tokens_per_s']:.1f} step_ms {rec['step_ms']:.2f} "
            f"verdict {rec['verdict']}{tail}", flush=True)
        if recorder is not None:
            # what a replay needs to re-execute this step, and the output
            # fingerprints it is compared against
            contiguous = batch_ids == list(
                range(batch_ids[0], batch_ids[-1] + 1))
            recorder.step(
                step_i,
                batch=([batch_ids[0], batch_ids[-1] + 1]
                       if contiguous else None),
                batch_ids=None if contiguous else batch_ids,
                batch_crc=crc, inject_nan=nan_armed, lr_scale=lr_scale_now,
                loss=loss, verdict=verdict,
                loss_scale=metrics["loss_scale"],
                layer_rms=rms[0] if rms else None,
                data_skipped=batches.skipped)
        # chaos: silent in-memory corruption AFTER the step, so the next
        # checkpoint faithfully saves it; written into the live parameter
        flipped, flip_info = plan.maybe_bitflip(step_i, state.params)
        if flip_info is not None:
            tree_copy_(state.params, flipped)
            say(f"[chaos] bit-flipped {flip_info['path']}"
                f"[{flip_info['element']}] bit {flip_info['bit']}")
            if recorder is not None:
                recorder.event(step_i, "bitflip_injected", **flip_info)
        action = mgr.resolve(step_i, verdict, loss=loss)
        if action == "halt":
            if responder is not None:
                responder.stop()  # the final save is not a wedged step
            # save the newest KNOWN-GOOD state, not the live one
            if len(mgr.buffer):
                good_step, _ = mgr.buffer.rollback(into=state.as_tuple())
            else:
                good_step = step_i
            if args.save:
                ar.finalize()  # an interval save may still be in flight
                save_checkpoint_verified(args.save, good_step,
                                         state.as_tuple(),
                                         keep_last_n=args.keep_last_n)
            if recorder is not None:
                recorder.event(step_i, "halt", good_step=good_step)
            if controller is not None:
                # the halt record opened an escalation case: its terminal
                # verdict and exit code 45 tell the supervisor not to
                # restart what the ladder already failed to heal
                sync_queue(controller)
                decision = controller.process(step_i)
                if decision is not None:
                    exit_code = decision.exit_code
            say(f"halting at step {step_i}: anomaly persisted; "
                f"checkpointed known-good step {good_step}")
            break
        if action == "rollback":
            rolled_from = step_i
            step_i, _ = mgr.do_rollback(into=state.as_tuple())
            it = make_iter(step_i)
            if recorder is not None:
                # a non-replayable break (the ring is in memory only)
                recorder.event(rolled_from, "rollback", to_step=step_i)
            say(f"rolled back to step {step_i} "
                f"(lr_scale {mgr.lr_scale:.3f})")
            continue
        if action == "skip":
            say(f"anomalous step {step_i}: update skipped "
                f"(loss {loss:.4f})")
        else:
            mgr.observe_good(step_i + 1, state.as_tuple())
        if controller is not None and verdict == 0:
            # a clean step advances every open case toward its closure
            sync_queue(controller)
            controller.on_clean_step(step_i)
        if (step_i + 1) % args.log_interval == 0 or step_i == args.steps - 1:
            # ONE device-to-host fetch of the bag per interval; the rest of
            # the record is host arithmetic
            if hbm_mon is not None:
                hbm_mon.sample(step_i)
            vals = monitor.read_bag(bag)
            interval_s = time.perf_counter() - last_emit_t
            sec_per_step = interval_s / since_emit
            router.metrics(
                step_i, **vals,
                tokens_per_s=monitor.tokens_per_second(
                    tokens_per_step * since_emit, interval_s),
                mfu=monitor.mfu(step_flops, sec_per_step, num_devices=world,
                                peak_flops=peak_flops),
                step_ms=1e3 * sec_per_step, data_skipped=batches.skipped,
                **(hbm_mon.metrics_fields() if hbm_mon is not None else {}))
            timers.write(["step"], step_i, normalizer=since_emit)
            monitor.reset_bag(bag)
            intervals += 1
            last_emit_t, since_emit = time.perf_counter(), 0
        if fleet_mon is not None:
            fleet_mon.maybe_check(step_i)
        plan.maybe_sigterm(step_i)
        if (responder is not None and ar is not None
                and ar.termination_signaled):
            responder.stop()  # the termination save is not a wedged step
        if ar is not None and ar.step(step_i + 1, state.as_tuple()):
            if ar.termination_decision == "save":
                say(f"termination checkpoint at step {step_i + 1}; exiting")
            else:
                say(f"termination at step {step_i + 1}: "
                    f"{ar.termination_decision} (grace budget); exiting")
            if controller is not None:
                # under a supervisor a preemption is a restart: persist
                # the case, exit 44, rejoin on relaunch
                decision = controller.on_preemption(step_i)
                exit_code = decision.exit_code
                say(f"[remediation] {decision.reason} "
                    f"(exit {decision.exit_code})")
            break
        if controller is not None:
            decision = after_step(controller, ar, recorder, responder,
                                  args.save_interval, step_i)
            if decision is not None:
                exit_code = decision.exit_code
                say(f"[remediation] {decision.reason} "
                    f"(exit {decision.exit_code}, devices "
                    f"{decision.device_count}, restore step "
                    f"{decision.restore_step})", flush=True)
                break
        # compile accounting last in the iteration: the first step's
        # kernel loads land in its bucket (warm-up, not a recompile)
        compile_watcher.on_step(step_i)
        step_i += 1
    shutdown_span = goodput.begin_span("shutdown", step=step_i)
    if mgr.events:
        say(f"anomalies this run: {len(mgr.events)} "
            f"(rollbacks {mgr.rollbacks_used}, lr_scale {mgr.lr_scale:.3f})")
    if controller is not None:
        if exit_code == 0:
            # the run completed: close the cases that saw clean recovery;
            # what is left open persists for the next incarnation
            sync_queue(controller)
            controller.run_end(step_i)
        closed = controller.state.history
        if closed or controller.open_cases:
            say(f"[remediation] {len(closed)} case(s) closed "
                f"({[(c['kind'], c['verdict']) for c in closed]}), "
                f"{len(controller.open_cases)} open")
    if responder is not None:
        responder.stop()
    trigger.close()  # abort a capture still open (end of run)
    if args.profile_analyze:
        _profile_analyze(args, training, state, lm, trigger, audit, router,
                         say)
    if ar is not None:
        ar.close()  # commit an interval save still in flight
    if recorder is not None:
        recorder.close()
    fetches = monitor.host_fetch_count() - fetches0
    router.event("summary", step_i, steps_run=steps_run,
                 host_fetches=fetches, intervals=intervals,
                 profiles=len(trigger.captures),
                 stalls=len(responder.stalls) if responder else 0,
                 anomalies=len(mgr.events), rollbacks=mgr.rollbacks_used,
                 lr_scale=mgr.lr_scale, data_skipped=batches.skipped)
    telemetry = {
        "host_fetches": fetches, "intervals": intervals,
        "captures": [c["trace"] for c in trigger.captures],
        "stalls": len(responder.stalls) if responder else 0,
        "peak_flops": peak_flops,
        "flops_per_step": step_flops,
        "launch_counts": _kernels.launch_counts(),
        "compiles": [{k: r[k] for k in ("step", "compiles", "recompile")}
                     for r in compile_watcher.records],
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

        def run_step():
            x, y = training.reshape_batch(*batches())
            return training.train_step(state, x, y)

        report = profile_device(lambda: [
            run_step() for _ in range(args.profile_steps)])
        say(json.dumps({"profile_steps": args.profile_steps,
                        "tokens_per_step": tokens_per_step, **report}),
            flush=True)
    shutdown_span.close()
    goodput.set_router(None)
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
    records = RunRecords(records)
    records.exit_code = exit_code
    return records


def _audit_target(training, state, lm):
    """The step as an ``analysis.StepTarget`` on the stream's first batch:
    its state (argument 0) declared updated in place."""
    from apex_tpu_torch.analysis.passes import StepTarget
    from apex_tpu_torch.analysis.targets import layout_axes

    x, y = training.reshape_batch(*lm.batch(range(training.cfg.global_batch)))
    return StepTarget(
        "gpt-pretrain", training.train_step, (state, x, y),
        axes=layout_axes(), device=training.device, donate_argnums=(0,))


def _recorded(training, state, lm):
    """One recorded step (``analysis.passes.StepContext``) with the state
    put back after it: the audits must not train. Returns the context."""
    from apex_tpu_torch.analysis.passes import StepContext

    keep = RollbackBuffer(capacity=1)
    keep.snapshot(0, state.as_tuple())
    ctx = StepContext(_audit_target(training, state, lm))
    ctx.recording  # runs the step
    keep.rollback(into=state.as_tuple())
    return ctx


def _pre_training_audits(args, training, state, lm, router, say, step0):
    """``--xray-report``, ``--xray-comms``, ``--audit-donation`` and
    ``--audit-comms``: each on one step whose state is put back. An
    audit that finds a defect, or cannot verify, exits (the JAX
    example's hardening: it never prints ok vacuously). Returns the
    recorded context (for ``--profile-analyze``'s join) or None."""
    from apex_tpu_torch.analysis.passes import audit_or_exit

    if args.xray_report:
        keep = RollbackBuffer(capacity=1)
        keep.snapshot(0, state.as_tuple())
        x, y = training.reshape_batch(
            *lm.batch(range(training.cfg.global_batch)))
        try:
            report = monitor.xray.memory_report(training.train_step, state,
                                                x, y, device=training.device)
        except RuntimeError as e:
            raise SystemExit(f"xray report failed: {e}")
        keep.rollback(into=state.as_tuple())
        say(report.format(), flush=True)
        router.event("memory", step0, **report.fields())
    if not (args.xray_comms or args.audit_donation or args.audit_comms):
        return None
    ctx = _recorded(training, state, lm)
    led = ctx.recording.ledger
    if args.xray_comms:
        say(led.summary(), flush=True)
        for rec in led.to_records(step=step0):
            router.emit(rec)
    audit_or_exit(ctx, [name for flag, name in (
        (args.audit_donation, "donation"), (args.audit_comms, "hlo-comms"))
        if flag], router, step0, say)
    return ctx


def _profile_analyze(args, training, state, lm, trigger, audit, router, say):
    """The timeline of each capture taken (``monitor.xray.timeline``),
    joined to the recorded step's collectives and ledger; a capture with
    no trace file, or one the parser cannot read, is reported."""
    from apex_tpu_torch.monitor.xray import timeline

    ctx = audit if audit is not None else _recorded(training, state, lm)
    if not trigger.captures:
        say("profile analyze: no completed capture to analyze (the run "
            "must continue two steps past the capture's start)")
    for cap in trigger.captures:
        try:
            report = timeline.analyze_logdir(
                cap["path"], module=ctx.recording.module, mesh=ctx.mesh,
                ledger=ctx.recording.ledger)
        except (FileNotFoundError, ValueError) as e:
            say(f"profile analyze: {cap['path']}: {e}")
            continue
        say(f"profile timeline ({cap['path']}):")
        say(report.summary(top=10), flush=True)
        for rec in report.to_records():
            router.emit(rec)


def _controller(args, training, lm, router, run_id, step0, world,
                main_rank, recorder):
    """The remediation controller of ``--remediate``: detector records
    tap off the router, the canary replays the journaled segments
    through this process's own step, and rank 0 persists the plan.
    ``world_devices`` is the FULL topology (what a readmit restores):
    in a reduced incarnation the live world plus the quarantined
    ranks."""
    from apex_tpu_torch.resilience import remediation

    canary = (remediation.GPTCanary(
        journal_path(args.save), args.save, training=training, lm=lm,
        floor_step=step0) if recorder is not None else None)
    state = remediation.RemediationState.load(args.save)
    controller = remediation.RemediationController(
        policy=remediation.RemediationPolicy(
            probation_steps=args.remediation_probation,
            max_restarts=args.remediation_max_restarts,
            verify_before_quarantine=args.remediation_verify),
        router=router, save_dir=args.save,
        world_devices=world + len(state.excluded), canary_fn=canary,
        state=state, run_id=run_id, writer=main_rank)
    router.add_sink(remediation.ControllerSink(controller))
    controller.adopt_pending(step0)
    return controller


def _mib(b):
    return "n/a" if b is None else f"{b / 2**20:.1f} MiB"


if __name__ == "__main__":
    raise SystemExit(main().exit_code)
