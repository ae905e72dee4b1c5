"""Fine-tune a Llama on one GPU (counterpart of the JAX package's
examples/llama/finetune_llama.py).

    python -m apex_tpu_torch.examples.llama.finetune_llama --steps 20
    python -m apex_tpu_torch.examples.llama.finetune_llama \\
        --model tinyllama-1.1b --bf16 --batch 4 --seq-len 2048 --steps 6 \\
        --profile-steps 1
    python -m apex_tpu_torch.examples.llama.finetune_llama \\
        --model tinyllama-1.1b --bf16 --batch 4 --seq-len 2048 --steps 6 \\
        --metrics-jsonl /tmp/llama.jsonl --xray-hbm --save /tmp/llama \\
        --run-deadline 600
    python -m apex_tpu_torch.examples.llama.finetune_llama \\
        --checkpoint TinyLlama/TinyLlama-1.1B-intermediate-step-1431k-3T --bf16

Without ``--checkpoint`` a Llama with random weights from ``--seed``
stands in: ``--model demo`` (the default) is the JAX demo's shape (2
layers, hidden 64, 4 heads over 2 KV heads, SwiGLU 160, vocab 256,
untied head), ``--model tinyllama-1.1b`` is TinyLlama-1.1B at full
width and depth (``models.tinyllama_1_1b_config``). ``--checkpoint``
imports a transformers checkpoint (``models.hf_import``) and needs the
``transformers`` package. One fixed batch of random tokens is revisited
every step, so the loss falls from ln(vocab) by memorisation. Each step
takes the mean token loss, backpropagates it through the RMSNorm and
flash-attention backward kernels, and updates with
``distributed_fused_adam(lr, max_grad_norm=clip)``, ZeRO-2 at a
data-parallel world of one, which clips through the sum-of-squares
kernel. It prints ``step N loss L step_ms M`` per step and runs on the
card unless ``--device cpu``. ``--profile-steps N`` runs N further steps
under ``torch.profiler`` and prints the device time by kernel as one
JSON line.

The runtime is the JAX script's:

- a router (console, ``--metrics-jsonl`` and an in-process window), the
  goodput run header (its id anchored on ``--save``), the ``init``,
  ``compile``, ``step`` and ``shutdown`` spans, and the closing goodput
  account whose identity holds with ``==``;
- the recompile sentinel (``monitor.xray.CompileWatcher``) after every
  step: the first step loads the kernels (booked as ``compile``), and a
  load after it is a ``recompile=True`` record;
- ``--xray-hbm``: the composed HBM ledger, reconciled against the
  allocator's ``memory_report`` of the first step (on the card; on the
  CPU there is no allocator and the line says n/a), one ``kind="memory"``
  watermark record after the run, ``oom_guard`` around the steps;
- ``--save``: ``AutoResume`` restores the parameters and the ZeRO state
  at dp = 1 (the manifest with its topology block, every leaf's crc32
  verified) and saves them once at the end, so a rerun resumes; the
  run's ``--steps`` are steps of this run, counted from the restored
  step;
- ``--journal`` (on by default with ``--save``): the batch crc and each
  step's loss, for ``python -m apex_tpu_torch.resilience.replay --diff``
  of two runs' journals (no checkpoint-anchored re-execution, as in
  JAX);
- ``--remediate``: a supervisor-recorded exit-43 incident is adopted as
  a case, and the clean run closes it;
- ``--run-deadline``: the incident ladder over the run as a unit, exit
  43 at 3x.

Where the port's eager steps differ from the JAX script's one compiled
scan: the first step is the compile (the JAX script compiles before the
scan and runs every step in it), so the deadline's clock starts after
that step and guards the rest of the run as a unit; the journal writes
each step's record as the step ends (the JAX script writes them all
after the scan), so a run killed midway keeps the steps it finished.

The analysis flags, as the JAX script's: ``--audit-donation`` and
``--audit-comms`` record one step before training (its parameters and
ZeRO state put back after it) and hold it to the donation auditor (the
parameters and the optimizer state, arguments 0 and 1, declared updated
in place) and the ghost-collective differ; a finding, or an audit that
cannot verify, exits instead of printing ok. ``--profile-analyze``
captures three more steps after training (and after ``--save``) under
``utils.timers.trace`` into ``--profile-dir`` (a temp dir by default),
one ``step_annotation`` each, and prints the timeline's breakdown.

:class:`LlamaFinetune` is the loop's state and step, and ``main(argv,
model=)`` runs the example on a model that no flag builds (TinyLlama's
width at a cut depth, in ``chip_smoke.py``'s recovery phase); the
journal header then records that model's architecture.
"""

import argparse
import contextlib
import json
import math
import time
import types
from typing import List, Optional

import numpy as np
import torch

from apex_tpu_torch import _kernels
from apex_tpu_torch.models.gpt import (
    GPTModel,
    gpt_loss_fn,
    tinyllama_1_1b_config,
)
from apex_tpu_torch.models.hf_import import config_from_hf_llama, llama_from_hf
from apex_tpu_torch.optimizers import distributed_fused_adam
from apex_tpu_torch.transformer import TransformerConfig

__all__ = ["LlamaFinetune", "demo_config", "load_model", "main"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint", default=None,
                   help="transformers name/path; omit for a random model")
    p.add_argument("--model", choices=("demo", "tinyllama-1.1b"),
                   default="demo", help="the random model's shape")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seq-len", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--clip", type=float, default=1.0)
    p.add_argument("--bf16", action=argparse.BooleanOptionalAction,
                   default=False, help="bf16 compute (fp32 params)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--profile-steps", type=int, default=0,
                   help="after the run, profile this many more steps")
    p.add_argument("--metrics-jsonl", default=None,
                   help="write run/span/goodput (and any other) records "
                        "to this jsonl (apex_tpu_torch.monitor schema)")
    p.add_argument("--audit-donation", action="store_true",
                   help="check that the step keeps its parameters and "
                        "optimizer state in their storage "
                        "(apex_tpu_torch.analysis.donation) before "
                        "training")
    p.add_argument("--audit-comms", action="store_true",
                   help="diff the step's dispatched collectives against "
                        "the ledger (apex_tpu_torch.analysis.hlo) before "
                        "training")
    p.add_argument("--profile-analyze", action="store_true",
                   help="after training, capture annotated steps with "
                        "torch.profiler and print the device-time "
                        "breakdown (apex_tpu_torch.monitor.xray.timeline)")
    p.add_argument("--profile-dir", default=None,
                   help="profiler capture dir for --profile-analyze "
                        "(default: a temp dir)")
    p.add_argument("--xray-hbm", action="store_true",
                   help="HBM x-ray (monitor.xray.hbm): the composed "
                        "per-device breakdown (weights off the real "
                        "parameter tree, the ZeRO state in closed form) "
                        "reconciled against the allocator's report of the "
                        "first step, a kind='memory' watermark record "
                        "after the run, and kind='oom' forensics")
    p.add_argument("--save", default=None,
                   help="checkpoint directory: resume from it at startup "
                        "and save the trained params + ZeRO opt state at "
                        "the end (manifest-verified, topology block "
                        "included)")
    p.add_argument("--journal", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="flight-recorder journaling (resilience.replay): "
                        "each step's loss and the batch crc as "
                        "kind='journal' records and the "
                        "<save>/replay-journal.jsonl sidecar, for "
                        "cross-run fingerprint diffs (replay --diff). "
                        "Default: on when --save is set")
    p.add_argument("--remediate", action="store_true",
                   help="adopt persisted remediation cases "
                        "(resilience.remediation; requires --save): a "
                        "supervisor-recorded exit-43 incident becomes a "
                        "case this run adopts, and a clean run closes it "
                        "with a terminal kind='remediation' verdict")
    p.add_argument("--run-deadline", type=float, default=None,
                   help="incident ladder over the run as a unit "
                        "(resilience.health): no heartbeat within this "
                        "many seconds of the first step means warn, a "
                        "forensic kind='incident' dump at 2x, "
                        "self-termination (exit 43) at 3x; a rerun with "
                        "the same --save resumes from the last verified "
                        "step (default: off)")
    return p.parse_args(argv)


def demo_config(seq_len: int, **overrides) -> TransformerConfig:
    """The JAX demo's LlamaConfig, mapped as ``config_from_hf_llama``
    maps it."""
    hf = types.SimpleNamespace(
        vocab_size=256, hidden_size=64, intermediate_size=160,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=seq_len, rms_norm_eps=1e-6,
        rope_theta=10000.0, tie_word_embeddings=False)
    return config_from_hf_llama(hf, **overrides)


def load_model(args) -> GPTModel:
    overrides = {"compute_dtype": torch.bfloat16} if args.bf16 else {}
    if args.checkpoint:
        import transformers

        hf = transformers.AutoModelForCausalLM.from_pretrained(args.checkpoint)
        return llama_from_hf(hf, device=args.device, **overrides)
    if args.model == "tinyllama-1.1b":
        cfg = tinyllama_1_1b_config(
            compute_dtype=torch.bfloat16 if args.bf16 else torch.float32)
    else:
        cfg = demo_config(args.seq_len, **overrides)
    return GPTModel(cfg, device=args.device, seed=args.seed)


class LlamaFinetune:
    """The fine-tuning loop's state: the model, its ZeRO-2 Adam state at
    dp = 1, and one fixed (batch, seq_len) batch of random tokens from
    ``seed`` whose labels are the tokens shifted left by one."""

    def __init__(self, model: GPTModel, batch: int, seq_len: int,
                 lr: float = 1e-3, clip: Optional[float] = 1.0,
                 seed: int = 0):
        self.model = model
        self.params = dict(model.named_parameters())
        self.opt = distributed_fused_adam(lr=lr, max_grad_norm=clip)
        self.state = self.opt.init(
            {n: p.detach() for n, p in self.params.items()})
        rs = np.random.RandomState(seed)
        tokens = rs.randint(0, model.config.vocab_size, (batch, seq_len))
        self.tokens = torch.as_tensor(tokens, device=model.device)
        self.labels = torch.roll(self.tokens, -1, dims=1)

    def checkpoint_state(self):
        """``(parameters, ZeRO state)``: the tree a checkpoint holds and a
        restore copies into (the JAX example's ``(params, opt_state)``)."""
        return self.params, self.state

    def step(self, check_grads: bool = False):
        """One step; returns the loss before the update and, with
        ``check_grads``, the names of parameters whose gradient is
        missing or not finite (a host sync)."""
        loss = gpt_loss_fn(self.model(self.tokens, labels=self.labels))
        loss.backward()
        grads = {n: p.grad for n, p in self.params.items()}
        bad: List[str] = []
        if check_grads:
            bad = [n for n, g in grads.items()
                   if g is None or not bool(torch.isfinite(g).all())]
        updates, self.state = self.opt.update(
            grads, self.state, {n: p.detach() for n, p in self.params.items()})
        with torch.no_grad():
            for n, p in self.params.items():
                p.add_(updates[n])
                p.grad = None
        return float(loss.detach()), bad


#: the annotated steps --profile-analyze captures (the JAX script's)
PROFILE_ANALYZE_STEPS = 3


def _audit_target(run: "LlamaFinetune"):
    """The fine-tuning step as an ``analysis.StepTarget`` over its
    parameters and ZeRO state (arguments 0 and 1, declared updated in
    place) and its batch, at dp = 1."""
    from apex_tpu_torch.analysis.passes import StepTarget

    def llama_train_step(params, opt_state, tokens, labels):
        run.state = opt_state
        loss, _ = run.step()
        return run.params, run.state, loss

    return StepTarget(
        "llama-finetune", llama_train_step,
        (run.params, run.state, run.tokens, run.labels),
        axes={"dp": 1, "pp": 1, "cp": 1, "tp": 1}, device=run.model.device,
        donate_argnums=(0, 1))


def _audits(args, run: "LlamaFinetune", router, step0):
    """``--audit-donation`` and ``--audit-comms`` on one recorded step,
    whose parameters and ZeRO state are put back after it; returns the
    recorded context, or None."""
    if not (args.audit_donation or args.audit_comms):
        return None
    from apex_tpu_torch.analysis import passes
    from apex_tpu_torch.resilience.rollback import RollbackBuffer

    keep = RollbackBuffer(capacity=1)
    keep.snapshot(0, run.checkpoint_state())
    state = run.state
    ctx = passes.StepContext(_audit_target(run))
    ctx.recording  # runs the step
    run.state = state
    keep.rollback(into=run.checkpoint_state())
    passes.audit_or_exit(ctx, [name for flag, name in (
        (args.audit_donation, "donation"), (args.audit_comms, "hlo-comms"))
        if flag], router, step0)
    return ctx


def _profile_analyze(args, run: "LlamaFinetune", audit, router):
    """Three annotated steps under ``utils.timers.trace``, then the
    timeline (joined to the audit's recorded step when one was made)."""
    import tempfile

    from apex_tpu_torch.monitor.xray import timeline
    from apex_tpu_torch.utils.timers import step_annotation, trace

    prof_dir = args.profile_dir or tempfile.mkdtemp(
        prefix="apex_tpu_torch_llama_prof_")
    sync = (torch.cuda.synchronize if run.model.device.type == "cuda"
            else (lambda: None))
    with trace(prof_dir):
        for s in range(PROFILE_ANALYZE_STEPS):
            with step_annotation(s):
                run.step()
                sync()
    report = timeline.analyze_logdir(
        prof_dir, module=audit.recording.module if audit else None,
        mesh=audit.mesh if audit else None,
        ledger=audit.recording.ledger if audit else None)
    print(f"profile timeline ({prof_dir}):")
    print(report.summary(top=10), flush=True)
    for rec in report.to_records():
        router.emit(rec)


class RunRecords(list):
    """The run's per-step records (``step``, ``loss``, ``step_ms``), the
    :class:`LlamaFinetune` that ran them (``finetune``: its model and
    optimizer state after the run) and the step the run began at
    (``step0``: the restored checkpoint's, else 0)."""

    finetune: Optional["LlamaFinetune"] = None
    step0 = 0


def _hbm_prediction(args, run: "LlamaFinetune"):
    """The JAX example's composed ledger: weights counted off the real
    parameter tree, one gradient a parameter, the ZeRO-2 state at dp = 1
    in closed form (the flat buffer's chunk padding included) and the
    batch (no closed form fits Llama's gated MLP and GQA)."""
    from apex_tpu_torch.monitor.xray import hbm as xhbm

    leaves = list(run.params.values())
    p_elems = sum(p.numel() for p in leaves)
    p_bytes = sum(p.numel() * p.element_size() for p in leaves)
    batch_bytes = 2 * run.tokens.numel() * run.tokens.element_size()
    return xhbm.HbmBreakdown(
        components=(
            xhbm.Component("weights", p_bytes,
                           detail=f"{p_elems} elements, real tree"),
            xhbm.Component("grads", p_bytes, transient=True,
                           detail="one grad per param, same dtypes"),
            xhbm.Component("optimizer_state",
                           xhbm.distributed_adam_state_bytes(p_elems, 1),
                           detail="ZeRO-2 shard over dp=1"),
            xhbm.Component(
                "batch_data", batch_bytes,
                detail=f"tokens+labels: {args.batch}x{args.seq_len} "
                       f"{str(run.tokens.dtype).replace('torch.', '')}"),
        ),
        label="llama-finetune",
        capacity_bytes=xhbm.device_memory_limit(run.model.device))


def _journal_config(args, cfg, given: bool) -> dict:
    """The journal header's config: the run's flags as the JAX header has
    them, and the model that ran, read off its config. A model passed to
    :func:`main` is described as it is, not as ``--model``, ``--bf16``
    and ``--checkpoint`` would have built it (those are then None)."""
    return {
        "steps": args.steps, "batch": args.batch, "seq_len": args.seq_len,
        "lr": args.lr, "clip": args.clip,
        "bf16": cfg.compute_dtype == torch.bfloat16,
        "checkpoint": None if given else args.checkpoint,
        "model": None if given else args.model, "seed": args.seed,
        "architecture": {
            "layers": cfg.num_layers, "hidden": cfg.hidden_size,
            "heads": cfg.num_attention_heads,
            "kv_heads": cfg.num_query_groups or cfg.num_attention_heads,
            "ffn": cfg.ffn_hidden_size, "vocab": cfg.vocab_size,
            "compute_dtype": str(cfg.compute_dtype).replace("torch.", ""),
            "params_dtype": str(cfg.params_dtype).replace("torch.", "")},
    }


def main(argv=None, model: Optional[GPTModel] = None) -> RunRecords:
    """Runs the loop; returns the per-step records it printed (a
    :class:`RunRecords`). ``model`` replaces the one ``--model`` and
    ``--checkpoint`` would build (another program's config)."""
    from apex_tpu_torch.resilience.replay.replayer import numerics_flags_kept

    args = parse_args(argv)
    # --journal pins the numerics flags for the run (determinism_guard)
    with numerics_flags_kept():
        return _run(args, model)


def _run(args, model) -> RunRecords:
    from apex_tpu_torch import monitor
    from apex_tpu_torch.monitor import goodput

    # the run-level goodput ledger: one router created before any real
    # setup, a kind="run" header (anchored on --save, so every restart of
    # the job joins one ledger), then phase spans around the lifecycle;
    # the window lets the closing summary account the run in-process
    sinks = [monitor.StdoutSink()]
    if args.metrics_jsonl:
        sinks.append(monitor.JsonlSink(args.metrics_jsonl))
    goodput_mem = monitor.MemorySink(kinds=("run", "span", "memory"))
    router = monitor.MetricRouter(sinks + [goodput_mem])
    run_id = goodput.derive_run_id(args.save)
    goodput.run_header(router, run_id, steps=args.steps)
    goodput.set_router(router)
    try:
        return _train(args, model, router, goodput_mem, run_id)
    finally:
        goodput.set_router(None)
        router.close()


def _train(args, model, router, goodput_mem, run_id) -> RunRecords:
    from apex_tpu_torch.monitor import goodput
    from apex_tpu_torch.monitor.xray import hbm as xhbm
    from apex_tpu_torch.monitor.xray.compile_watch import CompileWatcher

    init_span = goodput.begin_span("init")
    # flight-recorder journaling, on by default with --save; the numerics
    # flags are recorded BEFORE the model is built, and pinned only on an
    # explicit --journal, so merely adding --save never changes the run
    journal_on = (args.journal if args.journal is not None
                  else bool(args.save))
    guard_flags = {}
    if journal_on:
        from apex_tpu_torch.resilience.replay.replayer import (
            determinism_guard,
        )

        guard_flags = determinism_guard(
            pin=args.journal is True,
            device=model.device if model is not None else args.device)
    given = model is not None
    if not given:
        model = load_model(args)
    cuda = model.device.type == "cuda"
    if cuda:
        _kernels.build_all()  # every nvcc at once, not one per first launch
    cfg = model.config
    print(f"vocab={cfg.vocab_size} layers={cfg.num_layers} "
          f"hidden={cfg.hidden_size} device={model.device}", flush=True)
    run = LlamaFinetune(model, args.batch, args.seq_len, lr=args.lr,
                        clip=args.clip, seed=args.seed)
    hbm_predicted = None
    if args.xray_hbm:
        hbm_predicted = _hbm_prediction(args, run)
        print(hbm_predicted.format(), flush=True)
    step0 = 0
    ar = None
    if args.save:
        from apex_tpu_torch.utils.autoresume import AutoResume

        # interval=1: the run's one save, at its end, is unconditional
        ar = AutoResume(args.save, interval=1)
        step0, _ = ar.restore(run.checkpoint_state())
        if step0:
            print(f"resumed from step {step0}", flush=True)
    recorder = None
    crc = None
    if journal_on:
        from apex_tpu_torch.resilience.replay import (
            FlightRecorder,
            batch_crc,
            journal_path,
        )

        recorder = FlightRecorder(
            journal_path(args.save) if args.save else None, router=router)
        crc = batch_crc(run.tokens.cpu().numpy(), run.labels.cpu().numpy())
        recorder.header(
            run_id, "llama", config=_journal_config(args, cfg, given),
            corpus={"fixed_batch_crc": crc},
            devices=1, steps=args.steps, **guard_flags)
    audit = _audits(args, run, router, step0)
    watcher = CompileWatcher(router=router)
    records = RunRecords()
    records.finetune, records.step0 = run, step0
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    def train_step(i):
        step = step0 + i
        t0 = time.perf_counter()
        # step 0 builds and loads the kernels (below)
        with goodput.span("compile" if i == 0 else "step", step=step):
            loss, _ = run.step()
            sync()
        ms = (time.perf_counter() - t0) * 1e3
        watcher.on_step(step)
        records.append({"step": step, "loss": loss, "step_ms": ms})
        print(f"step {step:5d} loss {loss:.4f} step_ms {ms:.2f}", flush=True)
        if recorder is not None:
            recorder.step(step, loss=loss, batch_crc=crc)

    # the first step builds and loads the kernels: booked as compile,
    # nested in init (priority attribution), as the JAX example books its
    # scan's compile; with --xray-hbm it is measured by the allocator
    hbm_mon = None
    if args.steps > 0:
        if hbm_predicted is not None and cuda:
            report = xhbm.memory_report(train_step, 0, device=model.device)
            ratio = report.total_bytes / max(1, hbm_predicted.peak_bytes)
            print(f"hbm x-ray: predicted peak "
                  f"{hbm_predicted.peak_bytes / 2**20:.1f} MiB vs allocator "
                  f"peak {report.total_bytes / 2**20:.1f} MiB "
                  f"(x{ratio:.2f})", flush=True)
            router.event("memory", step0, scope="allocator",
                         predicted_peak_bytes=hbm_predicted.peak_bytes,
                         **report.fields())
        else:
            if hbm_predicted is not None:
                print("hbm x-ray: predicted peak "
                      f"{hbm_predicted.peak_bytes / 2**20:.1f} MiB vs "
                      f"allocator peak n/a (no allocator on the "
                      f"{model.device.type})", flush=True)
            train_step(0)
    if hbm_predicted is not None:
        hbm_mon = xhbm.HbmWatermarkMonitor(router, predicted=hbm_predicted,
                                           device=model.device)
    init_span.close()
    # remediation adoption: a supervisor-recorded incident exit (43)
    # becomes a case here, and the clean run below closes it with a
    # terminal verdict (the JAX example's cross-incarnation half of the
    # loop; no mid-run canary)
    controller = None
    if args.remediate:
        if not args.save:
            raise SystemExit("--remediate requires --save (the persisted "
                             "remediation plan lives there)")
        from apex_tpu_torch.resilience import remediation

        controller = remediation.RemediationController(
            policy=remediation.RemediationPolicy(probation_steps=1),
            router=router, save_dir=args.save, world_devices=1,
            run_id=run_id)
        controller.adopt_pending(step0)
    # the incident ladder over the run as a unit, as the JAX example
    # guards its one compiled scan: started once the compile step is
    # behind, beaten when the last step lands; no heartbeat within the
    # deadline means warn, a kind="incident" dump at 2x, exit 43 at 3x
    responder = None
    if args.run_deadline:
        from apex_tpu_torch.resilience.health import IncidentResponder

        responder = IncidentResponder(
            args.run_deadline, router=router, autoresume=ar,
            dump_after=2.0, terminate_after=3.0).start()
    t0 = time.perf_counter()
    guard = (xhbm.oom_guard(router, step0, breakdown=hbm_predicted)
             if hbm_mon is not None else contextlib.nullcontext())
    with guard:
        for i in range(1, args.steps):
            train_step(i)
    if responder is not None:
        responder.beat(step0 + args.steps)  # the run landed
        responder.stop()
    dt = time.perf_counter() - t0
    losses = [r["loss"] for r in records]
    if losses:
        print(f"final loss {losses[-1]:.4f}; {args.steps} steps "
              f"({dt:.2f}s after the first) on {model.device}", flush=True)
    if not all(math.isfinite(v) for v in losses):
        raise FloatingPointError(f"non-finite loss: {losses}")
    if hbm_mon is not None:
        # one kind="memory" watermark record after the run (the CPU
        # reports no stats: its fields land None, never a fake zero)
        hbm_mon.sample(step0 + args.steps)
        hs = hbm_mon.summary()
        achieved = ("n/a" if hs["achieved_peak_bytes"] is None
                    else f"{hs['achieved_peak_bytes'] / 2**20:.1f} MiB")
        util = ("n/a" if hs["utilization"] is None
                else f"{hs['utilization']:.2f}")
        print(f"hbm x-ray: predicted peak "
              f"{hs['predicted_peak_bytes'] / 2**20:.1f} MiB, achieved "
              f"{achieved}, utilization {util}, headroom breaches "
              f"{hs['breaches']}", flush=True)
    if controller is not None:
        # the run landed with finite losses: the adopted case's probation
        # is met by the run as a unit
        end = step0 + max(args.steps, 1) - 1
        controller.on_clean_step(end)
        left = controller.run_end(end)
        closed = controller.state.history
        if closed or left:
            print(f"[remediation] {len(closed)} case(s) closed "
                  f"({[(c['kind'], c['verdict']) for c in closed]}), "
                  f"{len(left)} open", flush=True)
    shutdown_span = goodput.begin_span("shutdown", step=step0 + args.steps)
    if ar is not None:
        # one verified save of the trained state (interval=1), the
        # journal's anchor, its sidecar flushed with the manifest commit
        ar.journal = recorder
        ar.step(step0 + args.steps, run.checkpoint_state())
        ar.close()
        print(f"checkpointed step {step0 + args.steps} to {args.save}",
              flush=True)
    if recorder is not None:
        recorder.close()
    if args.profile_analyze:
        _profile_analyze(args, run, audit, router)
    if args.profile_steps > 0:
        from apex_tpu_torch.utils.profiling import profile_device

        report = profile_device(lambda: [
            run.step() for _ in range(args.profile_steps)])
        print(json.dumps({"profile_steps": args.profile_steps,
                          "tokens_per_step": args.batch * args.seq_len,
                          **report}), flush=True)
    # the run-level goodput summary in the same stream: productive + the
    # badput phases + unattributed == wall, exactly, on the record
    shutdown_span.close()
    report = goodput.account(goodput_mem.records, run_id=run_id)
    print(report.summary(), flush=True)
    router.event("goodput", step0 + args.steps, **report.fields())
    return records


if __name__ == "__main__":
    main()
