"""Chaos campaigns: prove the policy table against fault COMBINATIONS
(counterpart of apex_tpu/resilience/remediation/campaign.py).

Single-fault drills prove each recovery path in isolation; production
faults arrive in sequences — a straggler while a silent bit flip is
still latent, a SIGTERM mid-probation. This module runs SEEDED
RANDOMIZED fault sequences against the real GPT target through the real
remediation controller, in-process:

- :func:`random_sequence` draws a fault set (distinct kinds from
  ``nan``/``slow``/``hang``/``bitflip``/``sigterm`` at distinct steps,
  seeded ``random.Random`` — the JAX package's draws, seed for seed);
- :func:`run_sequence` executes it: a miniature training loop (the GPT
  example's journaling/AutoResume/escalation wiring without its CLI
  shell) under an in-process supervisor that restarts incarnations on
  the controller's exit codes, rebuilding the training on the reduced
  topology through ``GPTTargetConfig.max_devices`` (``parallel_state``'s
  sub-world of the leading ranks: one spawned world of 4 runs a layout
  of 2, the others sitting out) and elastic-restoring through
  ``AutoResume``;
- :func:`check_invariants` judges the outcome: the goodput partition
  identity re-adds ``==`` across every incarnation, every fault maps to
  EXACTLY ONE terminal ``kind="remediation"`` verdict, no quarantine
  happened without verified evidence (the false-positive pin — the
  invariant a deliberately broken ``verify_before_quarantine=False``
  policy trips), and the final loss pins to an uninterrupted reference;
- :func:`minimize_failing` shrinks a failing sequence to a 1-minimal
  reproducer (drop-one-fault ddmin).

Every rank of the world calls :func:`run_sequence` together (a world of
one runs it alone). The ranks of an incarnation's layout run the loop,
each with its own controller fed the first rank's detector records (and
the canary's first-rank verdict), so all of them decide alike; the
first rank writes the checkpoints, the journal and the remediation
state, and its record stream is the result's. A sitting-out rank waits
for the incarnation's exit code.

The in-process hang is BOUNDED (``FaultPlan.hang_timeout_s``) and the
incarnation ends with the incident exit code after the watchdog's
forensic dump fires — the true ``os._exit(43)`` kill path is the
subprocess drills' (tests/test_torch_health.py).
"""

import dataclasses
import logging
import os
import random
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from apex_tpu_torch.resilience.exit_codes import (
    RESTARTABLE_EXIT_CODES,
    ExitCode,
)
from apex_tpu_torch.resilience.remediation.policy import RemediationPolicy
from apex_tpu_torch.resilience.remediation.state import RemediationState

logger = logging.getLogger("apex_tpu_torch.resilience.remediation")

__all__ = [
    "FAULT_KINDS",
    "FAULT_TERMINALS",
    "FaultEvent",
    "SequenceResult",
    "TrainingCache",
    "campaign_config",
    "campaign_corpus",
    "check_invariants",
    "minimize_failing",
    "random_sequence",
    "run_campaign",
    "run_sequence",
]

#: the fault vocabulary a campaign draws from
FAULT_KINDS = ("nan", "slow", "hang", "bitflip", "sigterm")

#: which terminal (finding, verdict) pairs may account for each fault
#: kind — the bipartite side of the one-terminal-verdict-per-fault
#: invariant (the JAX package's table)
FAULT_TERMINALS: Dict[str, frozenset] = {
    "nan": frozenset({("sentinel", "recovered")}),
    "slow": frozenset({
        ("stall", "cleared"), ("stall", "recovered"),
        ("straggler", "cleared"), ("straggler", "recovered"),
    }),
    "hang": frozenset({("incident", "recovered")}),
    "bitflip": frozenset({
        ("sdc", "readmitted"), ("sdc", "halted"),
        ("stall", "readmitted"), ("straggler", "readmitted"),
        ("corruption", "readmitted"),
    }),
    "sigterm": frozenset({("preemption", "recovered")}),
}

#: the campaign corpus's length (the JAX campaign's prefix)
CORPUS_TOKENS = 20_000


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault."""

    kind: str
    step: int


def random_sequence(seed: int, steps: int = 8,
                    kinds: Sequence[str] = FAULT_KINDS,
                    max_faults: int = 3) -> List[FaultEvent]:
    """A seeded fault sequence: 1..max_faults DISTINCT kinds at distinct
    steps in [1, steps-2]; a ``bitflip`` always takes the LARGEST drawn
    step, so the canary verifications that earlier faults trigger replay
    the pre-flip segments (the JAX package's function)."""
    rng = random.Random(seed)
    n = rng.randint(1, min(max_faults, len(kinds)))
    chosen = rng.sample(list(kinds), n)
    lo, hi = 1, max(steps - 2, 1)
    avail = list(range(lo, hi + 1))
    rng.shuffle(avail)
    picked = sorted(avail[:len(chosen)])
    events: List[FaultEvent] = []
    if "bitflip" in chosen:
        events.append(FaultEvent("bitflip", picked[-1]))
        picked = picked[:-1]
        chosen = [k for k in chosen if k != "bitflip"]
    for kind, step in zip(chosen, picked):
        events.append(FaultEvent(kind, step))
    return sorted(events, key=lambda e: e.step)


def campaign_config(**overrides):
    """The campaign target (the JAX campaign's): tiny enough that one
    step is sub-second on the CPU, real enough that every remediation
    surface (journal, anchors, sentinel, escalation, elastic reshard)
    is the production code path. global_batch=8 divides every dp in
    {4, 2, 1}."""
    from apex_tpu_torch.resilience.replay.targets import GPTTargetConfig

    base = dict(
        vocab=64, seq_len=16, layers=2, hidden=32, heads=4, tp=1,
        micro_batch=1, global_batch=8, spike_warmup=4,
        collect_layer_rms=True,
    )
    base.update(overrides)
    return GPTTargetConfig(**base)


def campaign_corpus(cfg, steps: int = 8, slack: int = 16):
    """``(lm, corpus)``: the seeded synthetic corpus, written as a token
    file (``synthetic_corpus``), as an ``LMDataset`` over it, and its
    journal-header entry (``{"prefix": ...}``, which a replay reads): the
    JAX campaign's 20,000 tokens, or as many as ``steps`` plus a
    probation's ``slack`` global batches need, whichever is more (the
    stream is prefix-stable)."""
    from apex_tpu_torch.data import IndexedTokenDataset, LMDataset
    from apex_tpu_torch.resilience.replay.targets import synthetic_corpus

    n_tokens = max(CORPUS_TOKENS,
                   (steps + slack) * cfg.global_batch * cfg.seq_len + 1)
    prefix = synthetic_corpus(cfg.vocab, n_tokens)
    return LMDataset(IndexedTokenDataset(prefix), cfg.seq_len), {
        "prefix": prefix}


class TrainingCache:
    """One built training per device count (the JAX campaign's): the
    built step is the expensive half of an incarnation, and fault
    sequences only vary host-side inputs, so a campaign pays for at most
    two builds (the full and the quarantined layout). :meth:`get` lays
    ``parallel_state`` out over the count's sub-world again (the world
    keeps its groups, so the cached step's groups are the live ones).
    Every rank calls it together; a sitting-out rank gets None as its
    training."""

    def __init__(self, base_cfg, device="cuda"):
        self.base_cfg = base_cfg
        self.device = device
        self._built: Dict[int, Tuple] = {}

    @property
    def builds(self) -> int:
        return len(self._built)

    def get(self, device_count: int):
        """(cfg, training) for ``device_count`` ranks."""
        from apex_tpu_torch.parallel import parallel_state as ps

        if device_count not in self._built:
            from apex_tpu_torch.resilience.replay.targets import (
                build_gpt_training,
            )

            cfg = dataclasses.replace(self.base_cfg,
                                      max_devices=device_count)
            logger.warning(
                "campaign: building the %d-device training (cached for the "
                "rest of the campaign)", device_count)
            self._built[device_count] = (
                cfg, build_gpt_training(cfg, device=self.device))
        else:
            ps.initialize_model_parallel(
                tensor_model_parallel_size=self.base_cfg.tp,
                devices=device_count)
        return self._built[device_count]


@dataclasses.dataclass
class SequenceResult:
    """One executed sequence's full evidence (the first rank's stream)."""

    faults: List[FaultEvent]
    run_id: str
    outcome: str                     # "completed"|"halted"|"failed..."|...
    incarnations: List[dict]
    records: List[dict]              # the whole record stream
    remediation: List[dict]          # the kind="remediation" slice
    losses: Dict[int, float]         # step -> loss (last execution wins)

    @property
    def terminals(self) -> List[dict]:
        return [r for r in self.remediation if r.get("terminal")]


def _run_incarnation(training, cfg, lm, corpus, workdir, run_id, plan,
                     policy, router, steps, save_interval, deadline_s,
                     world, flags) -> Tuple[int, Dict[int, float], dict]:
    """One incarnation of the miniature training loop on the layout's
    ranks (module docstring); returns (exit_code, losses, info)."""
    from apex_tpu_torch import monitor
    from apex_tpu_torch.monitor import goodput
    from apex_tpu_torch.parallel import parallel_state as ps
    from apex_tpu_torch.resilience.health import IncidentResponder
    from apex_tpu_torch.resilience.remediation.canary import GPTCanary
    from apex_tpu_torch.resilience.remediation.controller import (
        ControllerSink,
        RemediationController,
        after_step,
        sync_queue,
    )
    from apex_tpu_torch.resilience.replay.journal import (
        FlightRecorder,
        batch_crc,
        journal_path,
    )
    from apex_tpu_torch.resilience.rollback import (
        EscalationPolicy,
        ResilienceManager,
        RollbackBuffer,
    )
    from apex_tpu_torch.utils.autoresume import AutoResume
    from apex_tpu_torch.utils.pytree import tree_copy_

    n_active = ps.get_model_world_size()
    writer = ps.get_data_parallel_rank() == 0 and \
        ps.get_tensor_model_parallel_rank() == 0
    goodput.run_header(router, run_id, devices=n_active)
    init_span = goodput.begin_span("init")
    recorder = FlightRecorder(journal_path(workdir) if writer else None,
                              router=router)
    ar = AutoResume(workdir, interval=save_interval, journal=recorder)
    mgr = ResilienceManager(
        buffer=RollbackBuffer(capacity=2, interval=3),
        policy=EscalationPolicy(max_rollbacks=2),
        router=router,
    )
    state = training.init_state()
    step0, _ = ar.restore(state.as_tuple())
    recorder.header(
        run_id, "gpt", config=cfg.to_json(), corpus=corpus,
        devices=n_active, steps=steps, **flags,
    )
    recorder.anchor(step0, init=(step0 == 0))
    canary = GPTCanary(journal_path(workdir), workdir, training=training,
                       lm=lm, floor_step=step0)
    controller = RemediationController(
        policy=policy, router=router, save_dir=workdir,
        world_devices=world, canary_fn=canary, run_id=run_id,
        writer=writer,
    )
    router.add_sink(ControllerSink(controller))
    controller.adopt_pending(step0)
    window = monitor.MemorySink(max_records=256)
    router.add_sink(window)
    arm_responder = bool(plan.slow_steps or plan.hang_steps)
    responder = (IncidentResponder(
        deadline_s, router=router, window=window, autoresume=ar,
        dump_after=1.5,
    ) if arm_responder else None)
    bag = training.init_bag()
    mgr.buffer.snapshot(step0, state.as_tuple())
    init_span.close()
    losses: Dict[int, float] = {}
    rc: Optional[int] = None
    steps_run = 0
    step = step0
    slack = policy.probation_steps + save_interval + 2
    gb = cfg.global_batch
    try:
        while step < steps or (controller.in_probation
                               and step < steps + slack):
            ids = list(range(step * gb, (step + 1) * gb))
            x, y = lm.batch(ids)
            crc = batch_crc(x, y)
            xm, ym = training.reshape_batch(x, y)
            nan_armed = plan.take_nan(step)
            lr_scale = mgr.lr_scale
            with goodput.span("compile" if steps_run == 0 else "step",
                              step=step):
                _, loss, verdict, _, rms = training.train_step(
                    state, xm, ym, inject_nan=nan_armed, lr_scale=lr_scale,
                    bag=bag)
                if responder is not None and steps_run == 0:
                    responder.start()
                plan.maybe_slow(step)
                hang_fired = plan.maybe_hang(step)
            steps_run += 1
            if responder is not None:
                responder.beat(step)
            losses[step] = loss
            recorder.step(
                step, batch=[ids[0], ids[-1] + 1], batch_crc=crc,
                inject_nan=nan_armed, lr_scale=lr_scale, loss=loss,
                verdict=verdict, layer_rms=rms,
            )
            flipped, flip_info = plan.maybe_bitflip(step, state.params)
            if flip_info is not None:
                tree_copy_(state.params, flipped)
                recorder.event(step, "bitflip_injected", **flip_info)
            if hang_fired:
                # the bounded in-process stand-in for the responder's
                # os._exit(43): its forensic dump fired DURING the wedge
                # (watchdog thread); end the incarnation the way the
                # kill would — pending save tombstoned, sidecar flushed
                ar.prepare_incident_exit()
                recorder.flush()
                rc = int(ExitCode.INCIDENT)
                break
            action = mgr.resolve(step, verdict, loss=loss)
            if action == "halt":
                rc = int(ExitCode.FAILURE)
                break
            if action == "rollback":
                rolled_from = step
                step, _ = mgr.do_rollback(into=state.as_tuple())
                recorder.event(rolled_from, "rollback", to_step=step)
                continue
            if action != "skip":
                mgr.observe_good(step + 1, state.as_tuple())
            if verdict == 0:
                sync_queue(controller)
                controller.on_clean_step(step)
            plan.maybe_sigterm(step)
            if ar.step(step + 1, state.as_tuple()):
                decision = controller.on_preemption(step)
                recorder.flush()
                rc = decision.exit_code
                break
            decision = after_step(controller, ar, recorder, responder,
                                  save_interval, step)
            if decision is not None:
                rc = decision.exit_code
                break
            step += 1
    finally:
        if responder is not None:
            responder.stop()
    with goodput.span("shutdown", step=step):
        if rc is None:
            rc = int(ExitCode.OK)
            sync_queue(controller)
            controller.run_end(max(step - 1, step0))
        ar.close()
        recorder.close()
    return rc, losses, {"step0": step0, "steps_run": steps_run,
                        "devices": n_active}


def run_sequence(
    faults: Sequence[FaultEvent],
    workdir: str,
    cache: TrainingCache,
    lm,
    corpus: dict,
    policy: Optional[RemediationPolicy] = None,
    steps: int = 8,
    save_interval: int = 2,
    world: Optional[int] = None,
    slow_s: float = 5.0,
    deadline_s: float = 2.5,
    max_incarnations: int = 8,
    run_id: Optional[str] = None,
) -> SequenceResult:
    """Execute one fault sequence end to end (module docstring). Every
    rank of the world calls it; ``world`` (default: the world's size)
    is the full topology a readmit restores."""
    import torch.distributed as dist

    from apex_tpu_torch import monitor
    from apex_tpu_torch.monitor import goodput
    from apex_tpu_torch.parallel import parallel_state as ps
    from apex_tpu_torch.resilience import chaos
    from apex_tpu_torch.resilience.replay.replayer import (
        determinism_guard,
        numerics_flags_kept,
    )

    spread = dist.is_initialized() and dist.get_world_size() > 1
    rank = dist.get_rank() if spread else 0
    if world is None:
        world = dist.get_world_size() if spread else 1
    if rank == 0:
        os.makedirs(workdir, exist_ok=True)
    policy = policy if policy is not None else RemediationPolicy(
        probation_steps=3, clean_steps_to_close=2, max_restarts=6,
    )
    plan = chaos.FaultPlan(
        nan_steps={e.step for e in faults if e.kind == "nan"},
        slow_steps={e.step for e in faults if e.kind == "slow"},
        hang_steps={e.step for e in faults if e.kind == "hang"},
        bitflip_steps={e.step for e in faults if e.kind == "bitflip"},
        sigterm_steps={e.step for e in faults if e.kind == "sigterm"},
        slow_s=slow_s,
        hang_timeout_s=deadline_s * 4,
    )
    run_id = run_id or goodput.derive_run_id(workdir)
    mem = monitor.MemorySink()
    incarnations: List[dict] = []
    losses: Dict[int, float] = {}
    outcome = "exhausted"
    prev_router = goodput.get_router()
    try:
        with numerics_flags_kept():
            flags = determinism_guard(pin=False, device=cache.device)
            for index in range(max_incarnations):
                if spread:
                    dist.barrier()  # the previous incarnation's state is in
                n = RemediationState.load(workdir).device_count(world)
                cfg, training = cache.get(n)
                rc, inc_losses, info = None, {}, {}
                if training is not None:
                    router = monitor.MetricRouter([mem])
                    goodput.set_router(router)
                    try:
                        rc, inc_losses, info = _run_incarnation(
                            training, cfg, lm, corpus, workdir, run_id,
                            plan, policy, router, steps, save_interval,
                            deadline_s, world, flags,
                        )
                    finally:
                        goodput.set_router(None)
                        router.close()
                if spread:
                    # the first rank's outcome is the world's (a sitting-
                    # out rank ran nothing)
                    rc, inc_losses, info = ps.broadcast_object(
                        (rc, inc_losses, info), group=dist.group.WORLD)
                losses.update(inc_losses)
                incarnations.append({
                    "index": index, "exit_code": rc, "devices": n, **info,
                })
                logger.warning(
                    "campaign sequence incarnation %d: %d device(s) exit %d "
                    "(steps %s..+%s)", index, n, rc, info.get("step0"),
                    info.get("steps_run"),
                )
                if rc == int(ExitCode.OK):
                    outcome = "completed"
                    break
                if rc == int(ExitCode.REMEDIATION_HALT):
                    outcome = "halted"
                    break
                if rc not in RESTARTABLE_EXIT_CODES:
                    outcome = f"failed rc={rc}"
                    break
                if rc == int(ExitCode.INCIDENT) and rank == 0:
                    # the supervisor contract: write the adoption note
                    # for the next incarnation's controller
                    seq_state = RemediationState.load(workdir)
                    seq_state.pending = {"kind": "incident",
                                         "exit_code": rc,
                                         "incarnation": index}
                    seq_state.save()
    finally:
        goodput.set_router(prev_router)
    records = mem.snapshot()
    if spread:
        # the first rank's stream is the sequence's, on every rank, so the
        # ranks judge it alike (a rank that sat out an incarnation has no
        # records of it)
        records = ps.broadcast_object(records, group=dist.group.WORLD)
    return SequenceResult(
        faults=list(faults), run_id=run_id, outcome=outcome,
        incarnations=incarnations, records=records,
        remediation=[r for r in records if r.get("kind") == "remediation"],
        losses=losses,
    )


# -- invariants --------------------------------------------------------------


def _match_faults(faults: Sequence[FaultEvent],
                  terminals: Sequence[dict]) -> bool:
    """Exact bipartite match: every fault accounted by exactly one
    terminal record, every terminal accounted by exactly one fault."""
    if len(faults) != len(terminals):
        return False

    def ok(fault: FaultEvent, term: dict) -> bool:
        return ((term.get("finding"), term.get("verdict"))
                in FAULT_TERMINALS[fault.kind])

    def solve(i: int, used: frozenset) -> bool:
        if i == len(faults):
            return True
        for j, term in enumerate(terminals):
            if j not in used and ok(faults[i], term):
                if solve(i + 1, used | {j}):
                    return True
        return False

    return solve(0, frozenset())


def _quarantine_verified(result: SequenceResult, case_id: str) -> bool:
    """True when the case's quarantine rests on VERIFIED evidence: a
    canary-confirmed verify record, or an ``sdc`` finding whose
    detection evidence IS a canary/bisector re-execution."""
    case_records = [r for r in result.remediation
                    if r.get("case") == case_id]
    if any(r.get("action") == "verify" and r.get("verdict") == "confirmed"
           for r in case_records):
        return True
    if case_records and case_records[0].get("finding") == "sdc":
        for r in case_records:
            for ev in r.get("evidence") or []:
                if isinstance(ev, dict) and (
                        ev.get("kind") == "canary" or ev.get("found")):
                    return True
    return False


def check_invariants(
    result: SequenceResult,
    reference_losses: Optional[Dict[int, float]] = None,
    final_step: Optional[int] = None,
    loss_tol: float = 5e-2,
) -> List[str]:
    """The campaign's pass/fail judgment (module docstring); returns the
    violations (empty = the sequence healed correctly)."""
    from apex_tpu_torch.monitor.goodput.accountant import (
        BADPUT_PHASES,
        account,
    )

    violations: List[str] = []
    if result.outcome != "completed":
        violations.append(f"sequence did not complete: {result.outcome}")

    # 1. goodput partition identity, digit for digit, across EVERY
    # incarnation of the run id
    rep = account(result.records, run_id=result.run_id)
    fields = rep.fields()
    total = fields["productive_s"]
    for phase in BADPUT_PHASES:
        total = total + fields[f"badput_{phase}_s"]
    total = total + fields["unattributed_s"]
    if total != fields["wall_s"]:
        violations.append(
            f"goodput partition identity broken: re-added {total!r} != "
            f"wall {fields['wall_s']!r}"
        )
    n_headers = len([
        r for r in result.records
        if r.get("kind") == "run" and r.get("run_id") == result.run_id
    ])
    if rep.incarnations != n_headers:
        violations.append(
            f"accountant saw {rep.incarnations} incarnation(s), stream "
            f"has {n_headers} run header(s)"
        )

    # 2. one terminal verdict per fault, exactly
    terminals = result.terminals
    if not _match_faults(result.faults, terminals):
        violations.append(
            f"fault/terminal mismatch: faults="
            f"{[(f.kind, f.step) for f in result.faults]} terminals="
            f"{[(t.get('finding'), t.get('verdict')) for t in terminals]}"
        )

    # 3. no quarantine without verified evidence
    for rec in result.remediation:
        if rec.get("action") != "quarantine":
            continue
        if not _quarantine_verified(result, rec.get("case")):
            violations.append(
                f"case {rec.get('case')} quarantined WITHOUT canary "
                f"verification (finding={rec.get('finding')}) — the "
                f"policy table is broken"
            )

    # 4. post-recovery loss trajectory pins to the uninterrupted reference
    if reference_losses is not None:
        step = (final_step if final_step is not None
                else max(reference_losses))
        got = result.losses.get(step)
        want = reference_losses.get(step)
        if got is None:
            violations.append(f"no loss recorded at final step {step}")
        elif want is not None and abs(got - want) > loss_tol:
            violations.append(
                f"final loss diverged from the uninterrupted reference: "
                f"|{got:.4f} - {want:.4f}| > {loss_tol}"
            )
    return violations


def minimize_failing(
    faults: Sequence[FaultEvent],
    run_and_check: Callable[[Sequence[FaultEvent]], List[str]],
) -> Tuple[List[FaultEvent], List[str]]:
    """Drop-one-fault ddmin: shrink a failing sequence to a 1-minimal
    reproducer. ``run_and_check`` re-runs a candidate (fresh workdir!)
    and returns its violations."""
    current = list(faults)
    violations = run_and_check(current)
    if not violations:
        return current, []
    changed = True
    while changed and len(current) > 1:
        changed = False
        for i in range(len(current)):
            candidate = current[:i] + current[i + 1:]
            cand_violations = run_and_check(candidate)
            if cand_violations:
                current, violations = candidate, cand_violations
                changed = True
                break
    return current, violations


def run_campaign(
    workroot: str,
    n_sequences: int = 20,
    seed: int = 0,
    steps: int = 8,
    policy: Optional[RemediationPolicy] = None,
    minimize: bool = False,
    cache: Optional[TrainingCache] = None,
    device="cuda",
) -> dict:
    """Run ``n_sequences`` seeded sequences + the clean reference (every
    rank of the world together); returns ``{"passed", "failed",
    "sequences": [...]}`` where each entry carries the faults, outcome,
    violations, and (when ``minimize`` and failing) the minimized
    reproducer."""
    cfg = campaign_config()
    cache = cache if cache is not None else TrainingCache(cfg, device)
    lm, corpus = campaign_corpus(cfg, steps)

    def run(faults, workdir):
        return run_sequence(faults, workdir, cache, lm, corpus,
                            policy=policy, steps=steps)

    # the uninterrupted reference: same machinery, zero faults
    reference = run([], os.path.join(workroot, "reference"))
    entries: List[dict] = []
    failed = 0
    for i in range(n_sequences):
        faults = random_sequence(seed + i, steps=steps)
        result = run(faults, os.path.join(workroot, f"seq-{i:03d}"))
        violations = check_invariants(
            result, reference_losses=reference.losses,
            final_step=steps - 1,
        )
        entry = {
            "seed": seed + i,
            "faults": [(f.kind, f.step) for f in faults],
            "outcome": result.outcome,
            "incarnations": len(result.incarnations),
            "terminals": [(t.get("finding"), t.get("verdict"))
                          for t in result.terminals],
            "violations": violations,
        }
        if violations:
            failed += 1
            if minimize:
                attempt = [0]

                def rerun(candidate, _i=i, _attempt=attempt):
                    # a FRESH workdir per candidate
                    _attempt[0] += 1
                    r = run(candidate, os.path.join(
                        workroot, f"seq-{_i:03d}-min-{_attempt[0]:02d}"))
                    return check_invariants(
                        r, reference_losses=reference.losses,
                        final_step=steps - 1,
                    )

                minimal, min_violations = minimize_failing(faults, rerun)
                entry["minimal"] = [(f.kind, f.step) for f in minimal]
                entry["minimal_violations"] = min_violations
        entries.append(entry)
        logger.warning(
            "campaign %d/%d: faults=%s -> %s%s", i + 1, n_sequences,
            entry["faults"], result.outcome,
            f" VIOLATIONS={violations}" if violations else " ok",
        )
    return {
        "passed": n_sequences - failed,
        "failed": failed,
        "reference_losses": reference.losses,
        "sequences": entries,
    }
