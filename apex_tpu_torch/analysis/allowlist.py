"""The port's documented allowlist: every intentional flagged construct
(counterpart of apex_tpu/analysis/allowlist.py).

This file is the single home of "yes, we mean it" for the port's static
auditors. EVERY entry carries its numerical or design reason — the
:class:`~apex_tpu_torch.analysis.findings.AllowlistEntry` constructor
rejects bare entries — and lint-scope and concurrency entries
(``require_hit=True``) go stale loudly when the construct they document
disappears. Where an entry mirrors one of the JAX package's, its reason
says which (``JAX: <path>``).

Organization, as in JAX: precision entries (why each wide-dtype island
in a bf16 step is intentional), then host-sync, then the source-lint
entries, then the concurrency hand-proofs (the audited steps make no
collective-safety finding, so that section is empty). The
trace-pass entries do not require a hit: the card and the CPU record
different programs (a kernel is one opaque launch on the card, its plain
twin a run of aten ops on the CPU), and whether an entry fires depends
on which step was audited.
"""

from apex_tpu_torch.analysis.findings import Allowlist, AllowlistEntry

__all__ = ["REPO_ALLOWLIST", "repo_allowlist"]

_PRECISION = [
    AllowlistEntry(
        rule="precision.promotion",
        match="apex_tpu_torch/ops/layer_norm.py",
        reason=(
            "norm statistics in f32: mean/variance of bf16 activations "
            "lose all significance in an 8-bit mantissa; the plain "
            "version (the CPU's twin of the norm kernels) reduces in f32 "
            "and casts back, and the affine parameters go to the kernels "
            "as f32 (_param) — JAX: apex_tpu/ops/layer_norm.py"
        ),
    ),
    AllowlistEntry(
        rule="precision.promotion",
        match="apex_tpu_torch/ops/attention.py",
        reason=(
            "softmax statistics in f32: the plain flash versions (the "
            "CPU's twin of kernels #5-#7) take scores, probabilities and "
            "the logsumexp in f32, and the card's backward takes its "
            "delta = rowsum(dO * O) in f32; the context matmul returns "
            "to bf16 — JAX: apex_tpu/ops/attention.py"
        ),
    ),
    AllowlistEntry(
        rule="precision.promotion",
        match="apex_tpu_torch/parallel/layers.py",
        reason=(
            "master-weight casts: kernels, biases and embeddings are "
            "stored f32 and cast to the compute dtype per use; the "
            "flagged bf16 -> f32 copies are the backward of those casts "
            "(gradients accumulating into the f32 masters), attributed "
            "to the forward cast's line — JAX: apex_tpu/parallel/layers.py"
        ),
    ),
    AllowlistEntry(
        rule="precision.promotion",
        match="apex_tpu_torch/models/gpt.py",
        reason=(
            "embedding-output cast to the compute dtype: its backward "
            "returns the gradient to the f32 embedding table, and the "
            "head's logits go to f32 for the loss — JAX: "
            "apex_tpu/models/gpt.py"
        ),
    ),
    AllowlistEntry(
        rule="precision.promotion",
        match="apex_tpu_torch/models/bert.py",
        reason=(
            "as models/gpt.py: embedding casts' backward into the f32 "
            "tables and the f32 masked-LM logits — JAX: "
            "apex_tpu/models/bert.py"
        ),
    ),
    AllowlistEntry(
        rule="precision.promotion",
        match="apex_tpu_torch/models/gpt_pipeline.py",
        reason=(
            "the pipelined GPT's pre/post functions: the same embedding "
            "and head casts as models/gpt.py, split over stages"
        ),
    ),
]

# the GPT step's host waits (resilience/replay/targets.py), one entry a
# wait, each matched to its line and its method: a new wait in the step
# is a finding
_STEP = "*apex_tpu_torch/resilience/replay/targets.py:"
_HOST_SYNC = [
    AllowlistEntry(
        rule="host-sync.transfer",
        match=_STEP + "280",
        data={"method": "__bool__"},
        reason=(
            "the anomaly gate's `if not bool(gate)`: a gated step "
            "(found_inf or a sentinel spike) skips the optimizer update "
            "instead of computing and discarding it. JAX's gate is "
            "in-graph (a lax.cond over the update), so JAX's host-sync "
            "pass finds nothing there; eager torch cannot branch on a "
            "device value without reading it"
        ),
    ),
    AllowlistEntry(
        rule="host-sync.transfer",
        match=_STEP + "315",
        data={"method": "tolist"},
        reason=(
            "the step's scalars (loss, grad norm, scale, z, skipped, "
            "anomalies, verdict) fetched in one .tolist() at its end: the "
            "one transfer JAX's caller makes after its compiled step "
            "returns"
        ),
    ),
    AllowlistEntry(
        rule="host-sync.transfer",
        match=_STEP + "245",
        data={"method": "_to_copy"},
        reason=(
            "on the card: the token batch's copy to it. The step takes "
            "host token arrays, where JAX's jitted step receives them on "
            "the device"
        ),
    ),
    AllowlistEntry(
        rule="host-sync.transfer",
        match=_STEP + "246",
        data={"method": "_to_copy"},
        reason="on the card: the label batch's copy to it, as the tokens'",
    ),
]

_LINT = [
    AllowlistEntry(
        rule="lint.raw-collective",
        match="apex_tpu_torch/transformer/testing/analysis_workers.py:83",
        reason=(
            "the hlo-comms audit's seeded fixture (_bare_all_reduce): a "
            "collective issued outside parallel_state on purpose, which "
            "the differ must report as comms.unpredicted at this line "
            "(tests/test_torch_hlo_audits.py); JAX: its analysis tests "
            "seed theirs in the test file"
        ),
        require_hit=True,
    ),
    AllowlistEntry(
        rule="lint.raw-collective",
        match="apex_tpu_torch/parallel/parallel_state.py",
        reason=(
            "parallel_state's helpers ARE the instrumented call sites "
            "(each records itself in the traffic ledger before its "
            "torch.distributed call) — the one place raw collectives "
            "live — JAX: apex_tpu/monitor/xray/ledger.py"
        ),
        require_hit=True,
    ),
    AllowlistEntry(
        rule="lint.raw-collective",
        match="apex_tpu_torch/utils/autoresume.py",
        reason=(
            "the preemption consensus: one f32 flag all-reduced (max) "
            "over the layout's ranks at a step boundary so every rank "
            "saves and stops together — a control message outside every "
            "step, with no payload for the traffic ledger to account"
        ),
        require_hit=True,
    ),
    AllowlistEntry(
        rule="lint.raw-collective",
        match="apex_tpu_torch/resilience/elastic/layout.py",
        reason=(
            "the checkpoint gather: every layout rank's shard to the "
            "writer rank at save time (dist.gather, which parallel_state "
            "has no helper for) — checkpoint traffic, outside every step "
            "the ledger accounts"
        ),
        require_hit=True,
    ),
    AllowlistEntry(
        rule="lint.raw-collective",
        match="apex_tpu_torch/transformer/testing/standalone_gpt.py",
        reason=(
            "the run report's all_gather_object of each rank's peak "
            "memory and launch counts, after training ends — a report, "
            "not step traffic"
        ),
        require_hit=True,
    ),
    AllowlistEntry(
        rule="lint.raw-collective",
        match="apex_tpu_torch/transformer/testing/pipeline_workers.py",
        reason=(
            "untagged_schedules_worker rewraps torch.distributed's "
            "isend/irecv to force tag 0 (gloo then matches messages as "
            "NCCL does) — it reassigns the transport under "
            "parallel_state.p2p for a check, and moves no bytes itself"
        ),
        require_hit=True,
    ),
    AllowlistEntry(
        rule="lint.compressed-collective",
        match="apex_tpu_torch/parallel/compress.py",
        reason=(
            "the audited home: compress.py IS the one place quantize/"
            "dequant may compose with ledgered collectives — it records "
            "the true wire payloads (int8 codes + f32 scales), owns the "
            "error-feedback residual and the poisoned-scale found_inf "
            "contract — JAX: apex_tpu/parallel/compress.py"
        ),
        require_hit=True,
    ),
    AllowlistEntry(
        rule="lint.prefetch-gather",
        match="apex_tpu_torch/optimizers/distributed_fused_adam.py",
        reason=(
            "the blessed home: zero_prefetch_gather IS the bucketed "
            "param-gather pipeline — its loop starts one ledgered "
            "all_gather a bucket (async_op=True) by design, with the depth "
            "from choose_overlap_buckets (the link roofline) and an exact "
            "reconstruction transpose — JAX: the same entry"
        ),
        require_hit=True,
    ),
    AllowlistEntry(
        rule="lint.prefetch-gather",
        match="apex_tpu_torch/transformer/testing/parallel_workers.py",
        reason=(
            "staged_collectives_worker loops over two devices (the card "
            "and the CPU) calling each parallel_state collective once a "
            "device to compare them — a check, not a bucketed gather "
            "pipeline"
        ),
        require_hit=True,
    ),
    AllowlistEntry(
        rule="lint.hlo-text",
        match="apex_tpu_torch/utils/timers.py",
        reason=(
            "utils.timers.trace is the examples' --profile-steps "
            "capture: the second Chrome-trace writer beside "
            "monitor.ProfilerTrigger, with the same trace.json layout; "
            "every other profile routes through one of the two"
        ),
        require_hit=True,
    ),
    AllowlistEntry(
        rule="lint.memory-api",
        match="apex_tpu_torch/monitor/xray/hbm/",
        reason=(
            "the hbm package IS the memory-API home: live.py's "
            "device_watermarks() is the one memory_stats call site — "
            "JAX: apex_tpu/monitor/xray/hbm/"
        ),
        require_hit=True,
    ),
    AllowlistEntry(
        rule="lint.trace-file",
        match="apex_tpu_torch/analysis/lint.py",
        reason=(
            "the rule's own home: its docstring, detection literal and "
            "finding message necessarily spell the format marker they "
            "police — JAX: apex_tpu/analysis/lint.py"
        ),
        require_hit=True,
    ),
    AllowlistEntry(
        rule="lint.span-phases",
        match="apex_tpu_torch/monitor/goodput/spans.py",
        reason=(
            "the span ledger's own implementation: span()/begin_span() "
            "forward their phase argument into Span, and Span.close "
            "forwards self.phase into emit_span; Span.__init__ raises on "
            "any string outside PHASES — JAX: "
            "apex_tpu/monitor/goodput/spans.py"
        ),
        require_hit=True,
    ),
    AllowlistEntry(
        rule="lint.signal-handlers",
        match="apex_tpu_torch/utils/autoresume.py",
        reason=(
            "blessed home #1: the preemption handlers (flag + arrival "
            "timestamp only, no IO) and the close()-time restoration of "
            "the previous disposition — JAX: apex_tpu/utils/autoresume.py"
        ),
        require_hit=True,
    ),
    AllowlistEntry(
        rule="lint.signal-handlers",
        match="apex_tpu_torch/monitor/router.py",
        reason=(
            "blessed home #2: the router teardown's SIGTERM span-flush "
            "hook, installed only over SIG_DFL so AutoResume's handler "
            "keeps precedence, and re-raising so the process still dies "
            "by SIGTERM — JAX: apex_tpu/monitor/router.py"
        ),
        require_hit=True,
    ),
    AllowlistEntry(
        rule="lint.process-exit",
        match="apex_tpu_torch/resilience/health/responder.py",
        reason=(
            "the one deliberate hard-exit home: the incident responder's "
            "coordinated self-termination uses os._exit because a wedged "
            "main thread can run neither signal handlers nor atexit "
            "hooks; the responder does the teardown itself first — JAX: "
            "apex_tpu/resilience/health/responder.py"
        ),
        require_hit=True,
    ),
    AllowlistEntry(
        rule="lint.silent-except",
        match="apex_tpu_torch/monitor/router.py",
        reason=(
            "the teardown blanket guards (_flush_all_routers): the "
            "atexit/SIGTERM flush runs when the process is already dying "
            "and the sinks ARE the reporting channel — there is nowhere "
            "left to log a failure — JAX: apex_tpu/monitor/router.py"
        ),
        require_hit=True,
    ),
    AllowlistEntry(
        rule="lint.silent-except",
        match="apex_tpu_torch/monitor/watchdog.py",
        reason=(
            "ProfilerTrigger.close's abort-capture guard: stopping an "
            "already-torn capture raises at end of run, and losing a "
            "trace must not lose the run — JAX: "
            "apex_tpu/monitor/watchdog.py"
        ),
        require_hit=True,
    ),
    AllowlistEntry(
        rule="lint.trace-emit",
        match="apex_tpu_torch/serving/trace/emit.py",
        reason=(
            "the one kind=\"trace\" construction site: TraceEmitter._emit "
            "builds every span record — JAX: apex_tpu/serving/trace/emit.py"
        ),
        require_hit=True,
    ),
    AllowlistEntry(
        rule="lint.trace-emit",
        match="apex_tpu_torch/serving/trace/slo.py",
        reason=(
            "the one kind=\"slo\" construction site: SLOMonitor.poll "
            "emits the burn-rate record — JAX: apex_tpu/serving/trace/slo.py"
        ),
        require_hit=True,
    ),
    AllowlistEntry(
        rule="lint.nondeterminism",
        match="apex_tpu_torch/resilience/retry.py",
        reason=(
            "the retry jitter home: (rng or random).random() spreads a "
            "fleet's retries of one flaky filesystem — host-side sleep "
            "scheduling only; callers wanting determinism inject rng= or "
            "jitter=0 — JAX: apex_tpu/resilience/retry.py"
        ),
        require_hit=True,
    ),
    AllowlistEntry(
        rule="lint.nondeterminism",
        match="apex_tpu_torch/monitor/router.py",
        reason=(
            "the record-timestamp home: make_record's time.time() is the "
            "schema's 't' field, metadata never joined on and never an "
            "input to any computation — JAX: apex_tpu/monitor/router.py"
        ),
        require_hit=True,
    ),
    AllowlistEntry(
        rule="lint.float64",
        match="apex_tpu_torch/bench.py",
        reason=(
            "the bench's finiteness check of the trained parameters "
            "sums them in fp64 on the host after the timed chains — "
            "outside every step, where fp64 costs nothing measured"
        ),
        require_hit=True,
    ),
    AllowlistEntry(
        rule="lint.float64",
        match="apex_tpu_torch/transformer/testing/elastic_workers.py",
        reason=(
            "a check's relative distance |x - y| / |y| in fp64 2-norms, "
            "so the bound it is held to is not rounding of the check "
            "itself — outside every step"
        ),
        require_hit=True,
    ),
    AllowlistEntry(
        rule="lint.thread-create",
        match="apex_tpu_torch/monitor/watchdog.py",
        reason=(
            "a blessed thread home: the watchdog monitor loop and the "
            "escalation ladder own thread lifecycle (named daemon "
            "threads, stop event + join on close) — JAX: "
            "apex_tpu/monitor/watchdog.py"
        ),
        require_hit=True,
    ),
    AllowlistEntry(
        rule="lint.thread-create",
        match="apex_tpu_torch/resilience/health/responder.py",
        reason=(
            "a blessed thread home: the hard-exit escalation timer, the "
            "one thread that must not share lifecycle with what it "
            "escalates past — JAX: apex_tpu/resilience/health/responder.py"
        ),
        require_hit=True,
    ),
    AllowlistEntry(
        rule="lint.thread-create",
        match="apex_tpu_torch/utils/checkpoint.py",
        reason=(
            "a blessed thread home: AsyncCheckpointWriter's write thread "
            "(one at a time, joined by wait() under the writer's lock) "
            "and finalize_async's background finalizer — JAX: "
            "apex_tpu/utils/checkpoint.py"
        ),
        require_hit=True,
    ),
]

# ----------------------------------------------------------------------
# concurrency: the static race/deadlock analyzer's documented hand-proofs
# (apex_tpu_torch/analysis/concurrency). require_hit=True because the
# analyzer sees the whole package every run.
# ----------------------------------------------------------------------

_CONCURRENCY = [
    AllowlistEntry(
        rule="concurrency.unguarded-write",
        match="apex_tpu_torch/utils/autoresume.py",
        reason=(
            "the lock-free handshakes of the autoresume module: the "
            "_pending identity swap (the finalizer commits and clears "
            "only `if self._pending is pending`) and the GIL-atomic flag "
            "stores _signaled/_signal_t/_requested/_sigterm_t/"
            "_abandoned_step, written by a signal handler (which may not "
            "take locks) or the finalizer and only read elsewhere — "
            "JAX: apex_tpu/utils/autoresume.py"
        ),
        require_hit=True,
    ),
    AllowlistEntry(
        rule="concurrency.blocking-under-lock",
        match="apex_tpu_torch/monitor/router.py",
        reason=(
            "the sink fan-out IS the lock's purpose: MetricRouter._lock "
            "serializes emit() against close(); the lock is reentrant and "
            "a leaf (no sink calls back into the router), so it can "
            "stall, never deadlock — JAX: apex_tpu/monitor/router.py"
        ),
        require_hit=True,
    ),
    AllowlistEntry(
        rule="concurrency.blocking-under-lock",
        match="apex_tpu_torch/resilience/remediation/",
        reason=(
            "the controller's one-way lock order controller._lock -> "
            "router._lock, never the reverse; the state file's makedirs/"
            "rename under the same lock makes a decision and its durable "
            "record one critical section — JAX: "
            "apex_tpu/resilience/remediation/"
        ),
        require_hit=True,
    ),
    AllowlistEntry(
        rule="concurrency.unbounded-wait",
        match="apex_tpu_torch/resilience/chaos.py",
        reason=(
            "wedge() blocking forever is the feature: the chaos drill's "
            "hung-collective stand-in must look like a real wedge so the "
            "watchdog, not the wedge, ends the job — JAX: "
            "apex_tpu/resilience/chaos.py"
        ),
        require_hit=True,
    ),
    AllowlistEntry(
        rule="concurrency.unbounded-wait",
        match="apex_tpu_torch/utils/autoresume.py",
        reason=(
            "the durability barrier: _commit's writer wait joins the "
            "background write before the manifest commit — unbounded by "
            "contract (a checkpoint is durable or the save did not "
            "happen); the watchdog's deadline is the escape — JAX: "
            "apex_tpu/utils/autoresume.py"
        ),
        require_hit=True,
    ),
    AllowlistEntry(
        rule="concurrency.unbounded-wait",
        match="apex_tpu_torch/parallel/parallel_state.py",
        reason=(
            "p2p's receive waits and wait_sends: a pipeline stage blocks "
            "on the data it needs, and each wait is bounded by the "
            "process group's own timeout (init_process_group's timeout=, "
            "30 min by default), which the AST cannot see. The JAX twin "
            "has no host wait (its p2p is an in-graph ppermute); ROADMAP "
            "Queue 3 records it"
        ),
        require_hit=True,
    ),
    AllowlistEntry(
        rule="concurrency.unbounded-wait",
        match="apex_tpu_torch/optimizers/distributed_fused_adam.py",
        reason=(
            "zero_prefetch_gather waits on its buckets' all_gathers in "
            "order: each PendingCollective.wait is a c10d work handle's "
            "wait, bounded by the process group's own timeout "
            "(init_process_group's timeout=), which the AST cannot see. "
            "JAX's bucketed gather is dataflow inside one program and "
            "waits on nothing"
        ),
        require_hit=True,
    ),
    AllowlistEntry(
        rule="concurrency.handler-unsafe",
        match="apex_tpu_torch/monitor/router.py",
        reason=(
            "the audited teardown: _flush_all_routers runs the flush "
            "hooks and router.close() from atexit/SIGTERM, each wrapped "
            "in except-and-drop, under a reentrant lock; the hooks are "
            "the span accountant's lock-free flush — JAX: "
            "apex_tpu/monitor/router.py"
        ),
        require_hit=True,
    ),
    AllowlistEntry(
        rule="concurrency.handler-unsafe",
        match="apex_tpu_torch/utils/autoresume.py",
        reason=(
            "the coordinated handler chain: TerminationNotice's handler "
            "is flag-only and then chains prev(signum, frame), skipping "
            "the router teardown hook by its marker attribute; every "
            "other registrant is flag-style (lint.signal-handlers closes "
            "the set) — JAX: apex_tpu/utils/autoresume.py"
        ),
        require_hit=True,
    ),
    AllowlistEntry(
        rule="concurrency.unresolved",
        match="apex_tpu_torch/",
        reason=(
            "the resolver's honest remainder: calls through variables, "
            "stored callbacks and injected fns that pure-AST resolution "
            "cannot follow — visibility notes, not defect claims — JAX: "
            "apex_tpu/"
        ),
        require_hit=True,
    ),
    AllowlistEntry(
        rule="concurrency.shared-state",
        match="apex_tpu_torch/",
        reason=(
            "the benign sharing inventory: single-writer-many-reader "
            "handshakes and read-only state, surfaced as info so the "
            "sharing stays deliberate — JAX: apex_tpu/"
        ),
        require_hit=True,
    ),
]

# The recorded-step audits (analysis/hlo, donation.py): one entry a
# finding and a target, each matched to the target's step site. The info
# records are confirmations or honest "not verified" notes, kept so that
# the gate's jsonl is explained; the one error kept is GPT-2 small's
# rebound optimizer state. NO comms.unpredicted, comms.vanished,
# sharding.* or memory.unpredicted entry: the repo's targets raise none
# (the pipeline's loss broadcast, once unpredicted, now records itself in
# the ledger), and any would be the regression the audits exist for.
_RECORDED = [
    AllowlistEntry(
        rule="comms.quantized",
        match="<step:gpt-dp2tp2-int8>",
        reason=(
            "POSITIVE confirmation, not a defect: the int8 dp all-reduce's "
            "8-bit payloads (parallel/compress.py) were dispatched as the "
            "ledger recorded them — JAX: the same entry"
        ),
    ),
    AllowlistEntry(
        rule="memory.unverifiable",
        match="<step:gpt-dp2tp2>",
        reason=(
            "on the CPU no caching allocator reports a peak: the resident "
            "components are reconciled exactly (the finding says so, with "
            "the table), the temporaries are not; on the card the same "
            "target reconciles (memory.reconciled) or reports"
        ),
    ),
    AllowlistEntry(
        rule="memory.reconciled",
        match="<step:gpt-dp2tp2>",
        reason=(
            "POSITIVE confirmation on the card: weights, fused-Adam state, "
            "scaler, sentinel and batch reconciled exactly with the "
            "allocator's temporaries inside the band — JAX: the same entry"
        ),
    ),
    AllowlistEntry(
        rule="memory.reconciled",
        match="<step:gpt2-small>",
        reason=(
            "POSITIVE confirmation on the card (chip_smoke.py's analysis "
            "phase): GPT-2 small's state reconciled exactly with the HBM "
            "ledger and the allocator's temporaries inside the band"
        ),
    ),
    AllowlistEntry(
        rule="memory.unverifiable",
        match="<step:gpt-dp2tp2-int8>",
        reason=(
            "no closed form yet: the int8 DDP path keeps its fp32 error-"
            "feedback residual in the optimizer-state slot, which "
            "hbm.model's fused_adam prediction does not book"
        ),
    ),
    AllowlistEntry(
        rule="memory.unverifiable",
        match="<step:bert-dp2tp2>",
        reason=(
            "no closed form yet: hbm.model predicts GPT-family training "
            "only (JAX: the bert target carries no ledger either)"
        ),
    ),
    AllowlistEntry(
        rule="memory.unverifiable",
        match="<step:gpt-dp2pp2>",
        reason=(
            "no closed form yet for the zero-bubble pipeline with "
            "distributed_fused_adam at dp 2 x pp 2 (JAX: the pipeline "
            "target carries no ledger either)"
        ),
    ),
    AllowlistEntry(
        rule="memory.unverifiable",
        match="<step:gpt-zero-naive>",
        reason=(
            "autofix's proof target carries no analytic ledger (JAX: the "
            "same); its defects are the sharding and donation findings"
        ),
    ),
    AllowlistEntry(
        rule="autofix.prescription",
        match="<builder:*>",
        reason=(
            "a prescription is the FIX, not a defect: the defect it fixes "
            "(sharding.replicated-*, donation.missed) is on the stream "
            "under its own rule, and --fix exits nonzero itself when "
            "prescriptions remain unapplied or the apply is not "
            "idempotent — JAX: the same entry"
        ),
    ),
    AllowlistEntry(
        rule="donation.rejected",
        match="<step:llama-finetune>",
        data={"stage": "fresh-output"},
        reason=(
            "the Llama example's --audit-donation (parameters and ZeRO "
            "state declared in place): the parameters are updated in place "
            "(p.add_), but distributed_fused_adam is functional (as optax) "
            "and returns a new master shard and new moments, which the "
            "loop rebinds: a second copy of the ZeRO state at the "
            "update's peak. Kept, as GPT-2's below"
        ),
    ),
    AllowlistEntry(
        rule="donation.rejected",
        match="<step:gpt-pretrain>",
        data={"stage": "rebound"},
        reason=(
            "the GPT example's --audit-donation: the same step as GPT-2 "
            "small's below (build_gpt_training), the same rebound "
            "optimizer, scaler and sentinel state"
        ),
    ),
    AllowlistEntry(
        rule="donation.rejected",
        match="<step:gpt2-small>",
        data={"stage": "rebound"},
        reason=(
            "GPT-2 small's step (chip_smoke.py's analysis phase) declares "
            "its state updated in place: the parameters are (p.add_), but "
            "fused_adam is functional (as optax) and returns new moments, "
            "and the step rebinds state.opt, state.scaler and "
            "state.sentinel. The old moments are freed after the update: "
            "a second copy of the fp32 optimizer state at the update's "
            "peak. Kept, not repaired, in this slice: an in-place Adam "
            "changes the optimizer API every caller shares (ROADMAP)"
        ),
    ),
]

REPO_ALLOWLIST = Allowlist(
    _PRECISION + _HOST_SYNC + _LINT + _CONCURRENCY + _RECORDED
)


def repo_allowlist() -> Allowlist:
    """A fresh copy of the repo allowlist (callers may extend)."""
    return Allowlist(list(REPO_ALLOWLIST.entries))
