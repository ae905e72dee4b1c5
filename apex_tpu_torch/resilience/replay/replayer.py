"""Checkpoint-anchored re-execution with fingerprint comparison
(counterpart of apex_tpu/resilience/replay/replayer.py).

The consumer of the flight recorder (journal.py): restore the nearest
*verified* checkpoint at or before the segment of interest, re-execute
the journaled steps with the journaled inputs (batch sample ids, chaos
arms, lr_scale), and compare what comes out against what the journal
recorded — bitwise on the recording device, tolerance-banded otherwise.

What "bitwise" rests on, in order:

1. **the same computation** — the step is rebuilt from the journal
   header's :class:`~apex_tpu_torch.resilience.replay.targets.GPTTargetConfig`
   through the SAME function the recording run used
   (``targets.build_gpt_training``);
2. **the same numerics flags** — :func:`determinism_guard` applies the
   header's recorded torch flags (TF32 for matmuls and cuDNN, cuDNN's
   benchmark and deterministic switches, the deterministic-algorithms
   switch) before the step is built;
3. **the same inputs** — batches are re-fetched by journaled sample-id
   range and every batch is crc32-verified against the journaled
   ``batch_crc`` before it is fed; chaos arms and ``lr_scale`` come from
   the journal;
4. **the same state** — the anchor restore is manifest-verified
   (``integrity``) and copied into the rebuilt model's own parameters
   and optimizer state, and at every anchor the segment crosses, the
   replayed state's per-leaf crc32 is compared against the manifest
   fingerprint the original save committed;
5. **bit-stable kernels** — the hand-written kernels the step runs use
   no floating-point atomics, and the torch ops around them (cuBLAS at
   its default workspace, the embeddings' index backward, which sorts)
   give the same bits for the same inputs on one card.

Across devices (the card against the CPU, or two card models) the same
step legitimately produces different bits, so ``mode="auto"``
downgrades to tolerance comparison when the journal's recorded platform
or device name differs from the live one.

The replayer books its own wall time through the goodput span ledger
(``ckpt_restore`` for the anchor restore, ``step`` spans with a
``replay=True`` field for the re-executed steps).

Segment limits: a journaled ``rollback`` rewinds state through the
in-memory snapshot ring, which the journal cannot reconstruct — a
segment spanning one raises ``ReplayError``.
"""

import contextlib
import dataclasses
import logging
import math
import os
from typing import Dict, List, Optional

import torch

from apex_tpu_torch._kernels import resolve_device
from apex_tpu_torch.monitor.goodput.spans import span as _goodput_span
from apex_tpu_torch.resilience.replay.journal import Journal, batch_crc
from apex_tpu_torch.resilience.replay.targets import (
    GPTTargetConfig,
    build_gpt_training,
    synthetic_corpus,
)

logger = logging.getLogger("apex_tpu_torch.resilience.replay")

#: the cuBLAS workspace setting, read when cuBLAS starts on the card
CUBLAS_WORKSPACE_ENV = "CUBLAS_WORKSPACE_CONFIG"

__all__ = [
    "ReplayError",
    "ReplayReport",
    "GPTReplayContext",
    "build_context",
    "determinism_guard",
    "numerics_flags_kept",
    "verified_anchor_steps",
    "replay_segment",
    "compare_journals",
]


class ReplayError(RuntimeError):
    """Replay could not be performed honestly (missing anchor, corpus
    mismatch, rollback in the segment, unbuildable target) — distinct
    from a DIVERGENCE, which is a successful replay with a different
    answer."""


def _platform(device) -> dict:
    dev = resolve_device(device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    return {"platform": dev.type, "device_name": name}


def determinism_guard(header: Optional[dict] = None, pin: bool = True,
                      device="cpu") -> dict:
    """The one home of the numerics flags bitwise replay depends on.

    Three modes, all returning the EFFECTIVE flag dict the recorder
    stores in the journal header (the flags, ``torch_version``, and the
    ``platform`` and ``device_name`` of ``device``):

    - RECORDING, ``pin=True`` (the selftest and the cross-process
      determinism tests): pin TF32 off for matmuls and cuDNN, cuDNN's
      benchmark off and its deterministic switch on, and
      ``CUBLAS_WORKSPACE_CONFIG`` to ``:4096:8`` where it is unset (it
      takes effect only if cuBLAS has not started yet).
    - RECORDING, ``pin=False`` (the examples' journaling-on-by-default
      mode): RECORD the process's current flags without changing them —
      merely passing ``--save`` must never alter a run's numerics;
      same-device bitwise replay only needs the flags to MATCH. An
      explicit ``--journal`` opts into pinning.
    - REPLAYING (``header`` given): apply the header's recorded flags,
      whatever they were, so the replayer runs the step the recorder ran.

    ``deterministic_algorithms`` (``torch.use_deterministic_algorithms``)
    is recorded and, when replaying, applied; pinning leaves it as it is:
    the step's ops are bit-stable without it (module docstring).

    What it sets is process-wide and stays set: a caller that must hand
    the process back as it found it runs under
    :func:`numerics_flags_kept` (the replay context, the CLI and the
    GPT example do).
    """
    cudnn = torch.backends.cudnn
    if header is not None:
        torch.backends.cuda.matmul.allow_tf32 = bool(
            header.get("matmul_tf32", False))
        cudnn.allow_tf32 = bool(header.get("cudnn_tf32", True))
        cudnn.benchmark = bool(header.get("cudnn_benchmark", False))
        cudnn.deterministic = bool(header.get("cudnn_deterministic", False))
        torch.use_deterministic_algorithms(
            bool(header.get("deterministic_algorithms", False)))
        want = header.get("cublas_workspace_config")
        if want is not None and os.environ.get(CUBLAS_WORKSPACE_ENV) is None:
            os.environ[CUBLAS_WORKSPACE_ENV] = want
    elif pin:
        torch.backends.cuda.matmul.allow_tf32 = False
        cudnn.allow_tf32 = False
        cudnn.benchmark = False
        cudnn.deterministic = True
        os.environ.setdefault(CUBLAS_WORKSPACE_ENV, ":4096:8")
    return {
        "matmul_tf32": bool(torch.backends.cuda.matmul.allow_tf32),
        "cudnn_tf32": bool(cudnn.allow_tf32),
        "cudnn_benchmark": bool(cudnn.benchmark),
        "cudnn_deterministic": bool(cudnn.deterministic),
        "deterministic_algorithms": bool(
            torch.are_deterministic_algorithms_enabled()),
        "cublas_workspace_config": os.environ.get(CUBLAS_WORKSPACE_ENV),
        "torch_version": torch.__version__,
        **_platform(device),
    }


@contextlib.contextmanager
def numerics_flags_kept():
    """Put back, when the block ends, every flag :func:`determinism_guard`
    may set: TF32 for matmuls and cuDNN, cuDNN's benchmark and
    deterministic switches, the deterministic-algorithms switch and
    ``CUBLAS_WORKSPACE_CONFIG``."""
    cuda, cudnn = torch.backends.cuda, torch.backends.cudnn
    saved = (cuda.matmul.allow_tf32, cudnn.allow_tf32, cudnn.benchmark,
             cudnn.deterministic,
             torch.are_deterministic_algorithms_enabled(),
             os.environ.get(CUBLAS_WORKSPACE_ENV))
    try:
        yield
    finally:
        (cuda.matmul.allow_tf32, cudnn.allow_tf32, cudnn.benchmark,
         cudnn.deterministic) = saved[:4]
        torch.use_deterministic_algorithms(saved[4])
        if saved[5] is None:
            os.environ.pop(CUBLAS_WORKSPACE_ENV, None)
        else:
            os.environ[CUBLAS_WORKSPACE_ENV] = saved[5]


def _same_scalar(a, b) -> bool:
    """Bitwise-equality predicate with NaN == NaN (a journaled NaN loss
    replaying as NaN is agreement, not divergence)."""
    if a is None or b is None:
        return a is b
    fa, fb = float(a), float(b)
    if math.isnan(fa) and math.isnan(fb):
        return True
    return fa == fb


def _close_scalar(a, b, rtol: float, atol: float) -> bool:
    if a is None or b is None:
        return a is b
    fa, fb = float(a), float(b)
    if math.isnan(fa) and math.isnan(fb):
        return True
    return math.isclose(fa, fb, rel_tol=rtol, abs_tol=atol)


@dataclasses.dataclass
class ReplayReport:
    """One replayed segment's comparison outcome."""

    start: int                      # anchor step restored (state entering it)
    stop: int                       # last journal step executed
    mode: str                       # "bitwise" | "tolerance"
    steps_replayed: int = 0
    compared: Dict[str, int] = dataclasses.field(default_factory=dict)
    divergences: List[dict] = dataclasses.field(default_factory=list)
    anchors_checked: List[int] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.divergences

    @property
    def first_divergent_step(self) -> Optional[int]:
        if not self.divergences:
            return None
        return min(int(d["step"]) for d in self.divergences)

    def summary(self) -> str:
        head = (
            f"replay [{self.start}..{self.stop}] {self.mode}: "
            f"{self.steps_replayed} step(s), "
            f"{sum(self.compared.values())} comparison(s) "
            f"({', '.join(f'{k}={v}' for k, v in sorted(self.compared.items()))}), "
            f"anchors checked {self.anchors_checked or 'none'}"
        )
        if self.ok:
            return head + " — consistent, zero divergence"
        lines = [head + f" — {len(self.divergences)} DIVERGENCE(S), "
                        f"first at step {self.first_divergent_step}"]
        for d in self.divergences[:8]:
            lines.append(f"  step {d['step']} {d['field']}: "
                         f"recorded={d.get('recorded')!r} "
                         f"replayed={d.get('replayed')!r}"
                         + (f" leaves={d['leaves'][:3]}" if d.get("leaves")
                            else ""))
        if len(self.divergences) > 8:
            lines.append(f"  ... {len(self.divergences) - 8} more")
        return "\n".join(lines)

    def to_records(self) -> List[dict]:
        from apex_tpu_torch.monitor.router import make_record

        return [make_record(
            "replay", self.stop, start=self.start, mode=self.mode,
            steps_replayed=self.steps_replayed, compared=self.compared,
            anchors_checked=self.anchors_checked, ok=self.ok,
            n_divergences=len(self.divergences),
            first_divergent_step=self.first_divergent_step,
            divergences=self.divergences[:32],
        )]


class GPTReplayContext:
    """The reusable expensive half of a replay: the rebuilt training
    step, its live state (the model's own parameters, which every anchor
    restore writes into) and the corpus. The bisector reuses ONE context
    across all its probes.

    ``training=``/``lm=`` hand in a PREBUILT :class:`GPTTraining` and
    dataset instead of rebuilding from the journal header: an
    in-process caller that already holds the recording run's exact step
    replays through the very object that recorded, so the rebuild and
    the numerics-flag re-application are skipped. The caller vouches the
    objects match the journal; a cross-process replay (the CLI) rebuilds
    from the header. ``device`` is where a rebuilt step runs (CUDA
    unless the caller names another). A rebuilt context applies the
    header's numerics flags to the process until :meth:`close` (or the
    end of its ``with`` block) puts the caller's back."""

    target_kind = "gpt"

    def __init__(self, journal: Journal, training=None, lm=None,
                 device="cuda"):
        self.journal = journal
        self._flags_kept = None
        header = journal.header
        if header.get("target") != self.target_kind:
            raise ReplayError(
                f"journal target {header.get('target')!r} is not "
                f"re-executable by this replayer (only {self.target_kind!r} "
                f"targets rebuild from their config; use compare_journals "
                f"for fingerprint-level cross-run diffs)"
            )
        if training is not None:
            self.flags = None  # same process as the recorder: flags match
            self.cfg = training.cfg
            self.training = training
        else:
            device = resolve_device(device)
            self.cfg = GPTTargetConfig.from_json(header.get("config") or {})
            # the live layout's size: the recorded max_devices' sub-world
            # of a larger spawned world, else the whole world
            world = (torch.distributed.get_world_size()
                     if torch.distributed.is_initialized() else 1)
            if self.cfg.max_devices is not None:
                world = min(world, int(self.cfg.max_devices))
            want = header.get("devices")
            if want is not None and world != int(want):
                raise ReplayError(
                    f"journal was recorded on {want} device(s), this process "
                    f"has a world of {world} — the data-parallel split (and "
                    f"therefore the computation) would differ; re-run with "
                    f"the recorded topology"
                )
            self._flags_kept = numerics_flags_kept()
            self._flags_kept.__enter__()
        try:
            if training is None:
                self.flags = determinism_guard(header, device=device)
                self.training = build_gpt_training(self.cfg, device=device)
            self._state = None
            self.lm = (lm if lm is not None
                       else self._build_corpus(header.get("corpus") or {}))
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        """Put back the numerics flags this context's rebuild applied."""
        kept, self._flags_kept = self._flags_kept, None
        if kept is not None:
            kept.__exit__(None, None, None)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _build_corpus(self, corpus: dict):
        from apex_tpu_torch.data import IndexedTokenDataset, LMDataset

        prefix = corpus.get("prefix")
        if prefix and os.path.exists(prefix + ".bin"):
            return LMDataset(IndexedTokenDataset(prefix), self.cfg.seq_len)
        synth = corpus.get("synthetic")
        if synth:
            # regenerate the seeded synthetic stream; every batch is
            # crc-verified against the journal, so a generator drift
            # fails loudly instead of mis-attributing a divergence
            prefix = synthetic_corpus(
                int(synth.get("vocab", self.cfg.vocab)),
                int(synth.get("n_tokens", 200_000)),
            )
            return LMDataset(IndexedTokenDataset(prefix), self.cfg.seq_len)
        raise ReplayError(
            f"journal corpus unavailable: prefix={prefix!r} missing and "
            f"no synthetic recipe recorded"
        )

    @property
    def state(self):
        """The live state every anchor restore writes into."""
        if self._state is None:
            self._state = self.training.init_state()
        return self._state

    # -- anchors -----------------------------------------------------------

    def restore_anchor(self, ckpt_dir: Optional[str], step: int):
        """The state ENTERING ``step``: the seeded init state for an
        ``init``-marked step-0 anchor, else the verified checkpoint
        copied into the live state (and returned)."""
        from apex_tpu_torch.utils.pytree import tree_copy_

        anchor = self.journal.anchors.get(step)
        with _goodput_span("ckpt_restore", step=step, replay=True):
            if anchor is not None and anchor.get("init"):
                self._state = self.training.init_state()
                return self._state
            if ckpt_dir is None:
                raise ReplayError(
                    f"anchor step {step} needs a checkpoint dir"
                )
            from apex_tpu_torch.resilience import integrity

            step_dir = os.path.join(os.path.abspath(ckpt_dir),
                                    f"step_{step}")
            ok, reason = integrity.verify_checkpoint(step_dir, deep=True)
            if not ok:
                raise ReplayError(
                    f"anchor checkpoint step_{step} failed verification "
                    f"({reason}) — replay refuses an unvouched-for start "
                    f"state"
                )
            live = self.state
            if (integrity.read_manifest(step_dir) or {}).get("topology"):
                # every layout (world > 1, or a step saved on another
                # one) restores through the resharder, collectively (its
                # files just verified deep above)
                from apex_tpu_torch.resilience.elastic import (
                    restore_resharded,
                )

                _, loaded = restore_resharded(ckpt_dir, live.as_tuple(),
                                              step=step, deep=False)
            else:
                from apex_tpu_torch.utils.checkpoint import load_checkpoint

                loaded = load_checkpoint(ckpt_dir, step,
                                         target=live.as_tuple())
            tree_copy_(live.as_tuple(), loaded)
            return live

    def batch_for(self, rec: dict):
        """Re-fetch the journaled batch and verify its content crc."""
        ids = rec.get("batch_ids")
        if ids is None:
            span = rec.get("batch")
            if span is None:
                raise ReplayError(
                    f"journal step {rec['step']} carries no batch ids — "
                    f"recorded by a pre-journal-data-path run?"
                )
            ids = list(range(int(span[0]), int(span[1])))
        x, y = self.lm.batch(ids)
        crc = batch_crc(x, y)
        want = rec.get("batch_crc")
        if want is not None and int(want) != crc:
            raise ReplayError(
                f"batch content mismatch at step {rec['step']}: journal "
                f"crc {want}, re-fetched {crc} — the corpus differs from "
                f"the recording run's (a regenerated synthetic stream "
                f"drifted); this is a data problem, not a compute "
                f"divergence"
            )
        return self.training.reshape_batch(x, y)


def build_context(journal: Journal, device="cuda") -> GPTReplayContext:
    """Context for the journal's target kind (only ``gpt`` re-executes;
    other journals diff via :func:`compare_journals`)."""
    return GPTReplayContext(journal, device=device)


def verified_anchor_steps(journal: Journal,
                          ckpt_dir: Optional[str]) -> List[int]:
    """Ascending journal anchors that are actually restorable: the
    ``init``-marked seed anchor, plus every anchor whose checkpoint
    verifies (shallow here; the restore re-verifies deep)."""
    from apex_tpu_torch.resilience import integrity

    out = []
    for step, rec in sorted(journal.anchors.items()):
        if rec.get("init"):
            out.append(step)
            continue
        if ckpt_dir is None:
            continue
        step_dir = os.path.join(os.path.abspath(ckpt_dir), f"step_{step}")
        if integrity.verify_checkpoint(step_dir, deep=False)[0]:
            out.append(step)
    return out


def _resolve_mode(mode: str, ctx: GPTReplayContext) -> str:
    if mode in ("bitwise", "tolerance"):
        return mode
    if mode != "auto":
        raise ValueError(f"unknown replay mode {mode!r}")
    header = ctx.journal.header
    live = _platform(ctx.training.device)
    same = all(header.get(k) in (None, live[k]) for k in live)
    return "bitwise" if same else "tolerance"


def replay_segment(
    ctx: GPTReplayContext,
    ckpt_dir: Optional[str],
    start: Optional[int] = None,
    stop: Optional[int] = None,
    mode: str = "auto",
    rtol: float = 1e-5,
    atol: float = 1e-8,
    until: str = "first",
) -> ReplayReport:
    """Re-execute journal steps (start, stop] from the anchor at
    ``start`` and compare fingerprints.

    ``start`` must be a restorable anchor (default: the newest one at or
    before the first journaled step... i.e. the earliest restorable
    anchor when not given); ``stop`` defaults to the newest journaled
    step. ``until`` controls how much divergence is collected:
    ``"first"`` stops at the first divergent step, ``"anchor"`` keeps
    replaying until the first anchor AFTER a divergence (the bisector's
    leaf-localization phase needs the state comparison there),
    ``"end"`` replays the whole segment regardless.
    """
    journal = ctx.journal
    lo, hi = journal.step_range()
    stop = hi if stop is None else int(stop)
    anchors = verified_anchor_steps(journal, ckpt_dir)
    if start is None:
        candidates = [a for a in anchors if a <= stop]
        if not candidates:
            raise ReplayError(
                f"no restorable anchor at or before step {stop} "
                f"(anchors: {anchors or 'none'})"
            )
        start = candidates[0]
    elif start not in anchors:
        raise ReplayError(
            f"step {start} is not a restorable anchor (have {anchors})"
        )
    breaks = journal.breaks_in(start, stop)
    if breaks:
        raise ReplayError(
            f"segment ({start}..{stop}] crosses non-replayable event(s) "
            f"{[(e['event'], e['step']) for e in breaks]}: a rollback "
            f"rewinds through the in-memory snapshot ring the journal "
            f"cannot reconstruct — replay up to it, or from a later "
            f"anchor"
        )
    mode = _resolve_mode(mode, ctx)
    same = (_same_scalar if mode == "bitwise"
            else lambda a, b: _close_scalar(a, b, rtol, atol))
    report = ReplayReport(start=start, stop=stop, mode=mode)
    state = ctx.restore_anchor(ckpt_dir, start)
    train_step = ctx.training.train_step
    collect_rms = ctx.cfg.collect_layer_rms
    diverged = False

    def compare(step, field, recorded, replayed, **extra):
        nonlocal diverged
        report.compared[field] = report.compared.get(field, 0) + 1
        if not same(recorded, replayed):
            diverged = True
            report.divergences.append(dict(
                step=int(step), field=field, recorded=recorded,
                replayed=replayed, **extra,
            ))

    def check_anchor(step, state):
        """Replayed state entering ``step`` vs the manifest fingerprint
        the original save committed (per-leaf crc32, the integrity
        convention)."""
        nonlocal diverged
        from apex_tpu_torch.resilience import integrity

        anchor = journal.anchors.get(step)
        if anchor is None or anchor.get("init") or ckpt_dir is None:
            return
        manifest = integrity.read_manifest(
            os.path.join(os.path.abspath(ckpt_dir), f"step_{step}")
        )
        fp = (manifest or {}).get("fingerprint")
        if not fp:
            return
        # the global state's fingerprint (collective at world > 1)
        got = integrity.global_fingerprint(state.as_tuple())
        report.anchors_checked.append(int(step))
        report.compared["anchor"] = report.compared.get("anchor", 0) + 1
        if got["structure_hash"] != fp["structure_hash"]:
            diverged = True
            report.divergences.append(dict(
                step=int(step), field="anchor_structure",
                recorded=fp["structure_hash"], replayed=got["structure_hash"],
            ))
            return
        want = {l["path"]: l["crc32"] for l in fp["leaves"]}
        bad = [l["path"] for l in got["leaves"]
               if want.get(l["path"]) != l["crc32"]]
        if bad:
            diverged = True
            report.divergences.append(dict(
                step=int(step), field="anchor_leaves", recorded=None,
                replayed=None, leaves=bad,
            ))

    for step in range(start, stop + 1):
        last_step = False
        if step > start and step in journal.anchors:
            was_diverged = diverged
            check_anchor(step, state)
            if diverged and until == "anchor":
                if was_diverged:
                    # step-level divergence earlier in the segment, and
                    # we just reached the next anchor's state diff: done
                    break
                # the divergence entered the state AT this anchor
                # boundary — execute this one step too so its loss /
                # layer_rms comparison (the layer-localization signal)
                # lands in the report before stopping
                last_step = True
        rec = journal.steps.get(step)
        if rec is None:
            if step == start and start not in journal.steps:
                continue  # the anchor step itself may predate the journal
            if step > hi:
                # past the newest journaled step: a run-end checkpoint
                # anchors one step beyond the last executed one (the
                # ar.step(N, state) convention), so there is nothing
                # left to execute — the anchor comparison above was the
                # segment's final check (the bisector's fine phase ends
                # here when the corruption entered at the LAST anchor)
                break
            raise ReplayError(
                f"journal has no step record for {step} inside the "
                f"segment ({start}..{stop}] — torn journal?"
            )
        x, y = ctx.batch_for(rec)
        with _goodput_span("step", step=step, replay=True):
            out = train_step(state, x, y,
                             inject_nan=float(rec.get("inject_nan", 0.0)),
                             lr_scale=float(rec.get("lr_scale", 1.0)))
        state, loss, verdict = out[0], out[1], out[2]
        layer_rms = out[4] if collect_rms else None
        report.steps_replayed += 1
        compare(step, "loss", rec.get("loss"), float(loss))
        if rec.get("verdict") is not None:
            compare(step, "verdict", int(rec["verdict"]), int(verdict))
        if layer_rms is not None and rec.get("layer_rms") is not None:
            replayed = [float(v) for v in layer_rms]
            recorded = [float(v) for v in rec["layer_rms"]]
            if len(recorded) == len(replayed):
                bad_layers = [i for i, (a, b)
                              in enumerate(zip(recorded, replayed))
                              if not same(a, b)]
                report.compared["layer_rms"] = (
                    report.compared.get("layer_rms", 0) + 1)
                if bad_layers:
                    diverged = True
                    report.divergences.append(dict(
                        step=int(step), field="layer_rms",
                        recorded=recorded[bad_layers[0]],
                        replayed=replayed[bad_layers[0]],
                        first_divergent_layer=bad_layers[0],
                        divergent_layers=bad_layers,
                    ))
            else:
                compare(step, "layer_rms_len", len(recorded), len(replayed))
        if diverged and until == "first":
            break
        if last_step:
            break
    else:
        # ran to stop without break: the anchor AT stop+1 (a checkpoint
        # saved right after the last journaled step) still validates the
        # final state
        if (stop + 1) in journal.anchors:
            check_anchor(stop + 1, state)
    return report


def compare_journals(a: Journal, b: Journal, mode: str = "bitwise",
                     rtol: float = 1e-5, atol: float = 1e-8) -> ReplayReport:
    """Fingerprint-level diff of two journals — no re-execution.

    The cross-run determinism check, also for targets that cannot
    rebuild from a config: two runs of the same job should
    journal identical per-step fingerprints; the first step where they
    disagree is the divergence onset. Steps present in only one journal
    are skipped (different run lengths are a length note, not a
    divergence).
    """
    same = (_same_scalar if mode == "bitwise"
            else lambda x, y: _close_scalar(x, y, rtol, atol))
    steps = sorted(set(a.steps) & set(b.steps))
    if not steps:
        raise ReplayError("journals share no step records")
    report = ReplayReport(start=steps[0], stop=steps[-1], mode=mode)
    for s in steps:
        ra, rb = a.steps[s], b.steps[s]
        report.steps_replayed += 1
        for field in ("loss", "verdict", "loss_scale", "batch_crc"):
            if field in ra or field in rb:
                report.compared[field] = report.compared.get(field, 0) + 1
                if not same(ra.get(field), rb.get(field)):
                    report.divergences.append(dict(
                        step=int(s), field=field, recorded=ra.get(field),
                        replayed=rb.get(field),
                    ))
        la, lb = ra.get("layer_rms"), rb.get("layer_rms")
        if la is not None and lb is not None and len(la) == len(lb):
            report.compared["layer_rms"] = (
                report.compared.get("layer_rms", 0) + 1)
            bad = [i for i, (x, y) in enumerate(zip(la, lb))
                   if not same(x, y)]
            if bad:
                report.divergences.append(dict(
                    step=int(s), field="layer_rms", recorded=la[bad[0]],
                    replayed=lb[bad[0]], first_divergent_layer=bad[0],
                    divergent_layers=bad,
                ))
    return report
