"""Preemption-safe training: signal-triggered checkpoint + resume
(counterpart of apex_tpu/utils/autoresume.py).

Reference parity: the reference's only failure-recovery hook is the ADLR
cluster auto-resume object surfaced through
``testing/global_vars.get_adlr_autoresume`` (ref global_vars.py:75),
polled for ``termination_requested()`` / ``request_resume()``. Here it
is first-class:

- ``AutoResume`` installs a signal handler that only flips a host-local
  flag (async-signal-safe; no IO in the handler).
- In a ``torch.distributed`` world the flag becomes a CONSENSUS (one
  MAX all-reduce a poll, over the ``parallel_state`` layout's ranks)
  before anyone saves: ranks receive SIGTERM at different times, and a
  rank that checkpoints at step N while others continue to N+3 produces
  a torn checkpoint.
- At world > 1 a save is collective: the global tree is gathered to the
  layout's first rank, which writes, fingerprints and commits it
  (``utils.checkpoint``), and every finalize point ends with the
  layout's ranks waiting for one another, so no rank reads a step
  whose manifest is not in yet. A restore across a change of layout
  (another world, dp or tp) goes through
  ``resilience.elastic.restore_resharded``.
- ``step()`` combines the periodic-interval save (ref
  ``--adlr-autoresume-interval`` semantics) with the termination save;
  ``restore()`` resumes from the newest verified step directory.

Deadline-budgeted termination saves: preemption grace windows are FIXED
(the scheduler kills the process ``grace_s`` seconds after SIGTERM,
saved or not), so ``AutoResume`` measures its own recent save durations
(EMAs, persisted in the integrity manifest so a restarted job inherits
them) and, with a grace budget (``grace_s=`` or
``APEX_TPU_PREEMPTION_GRACE_S``), picks the most durable action that
provably fits the remaining budget (``_emergency_decision``):

- ``save``      — full durable save of the CURRENT step;
- ``finalize``  — commit only the pending async interval save;
- ``skip``      — abandon even the pending save's manifest commit and
  rely on the last already-verified checkpoint (a tombstone manifest
  marks the abandoned directory).

The decision is emitted as a ``kind="span"`` ckpt_save slice (with a
``decision`` field) plus a ``kind="preemption"`` event.

Async VERIFIED checkpointing: an interval save's synchronous slice is
the device->host copy and the write's issuance
(``utils.checkpoint.AsyncCheckpointWriter``); the per-leaf crc32
fingerprint (over the writer's host snapshot, the bytes the file holds)
and the per-file sha256 of the manifest run on the writer's background
finalize thread, after the write is on disk and before the commit
marker lands. A crash mid-fingerprint leaves a step dir with no
manifest, which every verified restore walk skips. Durable saves
(termination, first-save calibration) keep the blocking finalize.

Incident exit: ``prepare_incident_exit()`` is the bounded hook the
hung-job responder (``resilience.health``) calls from its watchdog
thread before self-terminating: it abandons the un-committed pending
save (tombstone manifest) without ever blocking on the writer.

``GRACE_ENV``, ``_env_grace`` and :class:`TerminationNotice` are copied
as they are in the JAX package (plain Python).
"""

import functools
import logging
import os
import signal as _signal
import threading
import time
from typing import Any, Optional, Sequence, Tuple

import torch

from apex_tpu_torch.monitor.goodput.spans import get_router as _goodput_router
from apex_tpu_torch.monitor.goodput.spans import span as _goodput_span
from apex_tpu_torch.utils.checkpoint import AsyncCheckpointWriter

__all__ = ["AutoResume", "GRACE_ENV", "TerminationNotice"]

logger = logging.getLogger("apex_tpu_torch.utils.autoresume")

#: environment default for the preemption grace budget (seconds between
#: SIGTERM and the scheduler's kill); unset or empty means "no budget"
GRACE_ENV = "APEX_TPU_PREEMPTION_GRACE_S"


def _is_rank0() -> bool:
    return (not torch.distributed.is_initialized()
            or torch.distributed.get_rank() == 0)


def _ema(old: Optional[float], x: float, alpha: float = 0.5) -> float:
    """Recent-weighted EMA; seeds from the first sample."""
    return x if old is None else (1.0 - alpha) * old + alpha * x


def _env_grace() -> Optional[float]:
    raw = os.environ.get(GRACE_ENV, "").strip()
    if not raw:
        return None
    try:
        return float(raw)
    except ValueError:
        logger.warning("ignoring unparseable %s=%r", GRACE_ENV, raw)
        return None


class TerminationNotice:
    """Flag-only SIGTERM latch for consumers that only need to KNOW a
    termination arrived, such as the serving engine's graceful drain.

    The handler stores one bool and one monotonic float (async-signal
    safe, no IO) and then CHAINS to the flag-style handler installed
    before it, so stacking loses neither. The one handler it does not
    chain is the router module's SIGTERM teardown hook (marked
    ``_apex_tpu_router_teardown``), which flushes and re-raises the
    signal to die by it: with a notice installed the signal means "drain
    gracefully", not "die". Installed after a notice, that hook stands
    aside by itself (it installs only over the default disposition), so
    the notice wins in either order.

    ``grace_s`` defaults to ``APEX_TPU_PREEMPTION_GRACE_S``;
    :meth:`grace_deadline` is the monotonic instant by which a drain must
    be done.
    """

    def __init__(self, signals: Sequence[int] = (_signal.SIGTERM,),
                 install_handlers: bool = True,
                 grace_s: Optional[float] = None):
        self.grace_s = grace_s if grace_s is not None else _env_grace()
        self._signaled = False
        self._signal_t: Optional[float] = None
        self._prev_handlers = {}
        if install_handlers:
            for sig in signals:
                self._prev_handlers[sig] = _signal.signal(
                    sig, self._on_signal)

    def _on_signal(self, signum, frame):
        self._signaled = True
        if self._signal_t is None:
            self._signal_t = time.monotonic()
        prev = self._prev_handlers.get(signum)
        if (callable(prev)
                and not getattr(prev, "_apex_tpu_router_teardown", False)):
            prev(signum, frame)

    @property
    def signaled(self) -> bool:
        """True once a termination signal arrived (host-local)."""
        return self._signaled

    def request(self) -> None:
        """Arm the latch programmatically (tests; in-process drills)."""
        self._signaled = True
        if self._signal_t is None:
            self._signal_t = time.monotonic()

    def grace_deadline(self) -> Optional[float]:
        """Monotonic deadline for post-signal work (arrival +
        ``grace_s``); None while un-signaled or with no budget."""
        if self._signal_t is None or self.grace_s is None:
            return None
        return self._signal_t + self.grace_s

    def close(self) -> None:
        """Restore the previous handlers (idempotent)."""
        for sig, h in self._prev_handlers.items():
            try:
                _signal.signal(sig, h)
            except (ValueError, OSError):  # non-main thread teardown
                pass
        self._prev_handlers = {}


class AutoResume:
    """Poll-based preemption handling for training loops.

    Usage::

        ar = AutoResume(save_dir, interval=1000)
        step0, state = ar.restore(init_state)          # 0, init on fresh start
        for step in range(step0, total_steps):
            state = train_step(state)
            if ar.step(step + 1, state):               # saved-for-termination
                break                                  # exit; scheduler restarts

    ``state`` may be any checkpointable tree of tensors (state classes of
    them included). The object implements ``termination_requested()``
    and ``request_resume()`` with the reference's polling contract.

    Durability & integrity (resilience.integrity wiring):

    - interval saves are ASYNC (the next train step overlaps the write)
      and VERIFY in the background: the checksum-manifest fingerprint +
      commit + optional ``keep_last_n`` retention run on the writer's
      finalize thread once the write is durable, so issuance is the only
      blocking slice; :meth:`finalize` / :meth:`close` (and the next
      save) are the join points;
    - a TERMINATION save is finalized before ``step()`` returns True, so
      "saved, you may exit" is never claimed for bytes still in flight —
      unless a configured grace budget (``grace_s`` /
      ``APEX_TPU_PREEMPTION_GRACE_S``) provably cannot fit it, in which
      case the deadline decision (module docstring) downgrades to
      finalize-pending-only or skip-and-rely-on-last-verified;
    - ``restore()`` skips torn or corrupt step directories (manifest
      verification), falls back to the newest verified checkpoint, and
      copies it INTO the live state it is given (``copy_``, so a model
      keeps training its own parameters); when the saved topology
      disagrees with the live layout (``mesh=``, default the
      ``parallel_state`` of the process) the restore is resharded
      (``resilience.elastic.restore_resharded``: the ZeRO flat buffers
      regrouped, every leaf's crc32 verified), and what it cannot prove
      safe raises ``resilience.elastic.ElasticRestoreError``.

    Deadline-decision caveat (multi-host): the decision inputs — signal
    arrival time and save-duration EMAs — are host-local, so hosts could
    in principle pick different actions. In practice the EMAs track the
    same collective saves and the grace budget is a cluster constant;
    deployments that need hard agreement should pin ``grace_s`` and rely
    on the consensus flag making every host decide at the same step.
    """

    #: headroom multiplier on the measured EMAs before an action is
    #: considered to fit the remaining grace budget
    safety_factor = 1.25

    def __init__(
        self,
        directory: str,
        interval: Optional[int] = None,
        signals: Sequence[int] = (_signal.SIGTERM,),
        install_handlers: bool = True,
        keep_last_n: Optional[int] = None,
        save_retries: int = 3,
        save_backoff: float = 0.1,
        grace_s: Optional[float] = None,
        mesh=None,
        background_finalize: bool = True,
        journal=None,
    ):
        self.directory = os.path.abspath(directory)
        self.interval = interval
        self.keep_last_n = keep_last_n
        self.save_retries = save_retries
        self.save_backoff = save_backoff
        self.grace_s = grace_s if grace_s is not None else _env_grace()
        self.mesh = mesh
        # optional flight recorder (resilience.replay.FlightRecorder, or
        # anything with .anchor/.event/.flush): every save becomes a
        # replay ANCHOR, and the sidecar is flushed wherever a manifest
        # commits — the journal is durable exactly when the checkpoint
        # is, including the termination-save and incident-exit paths
        self.journal = journal
        # async VERIFIED checkpointing (module docstring): overlapped
        # interval saves verify + commit their manifest on the writer's
        # background finalize thread. False restores the pre-incident
        # blocking behavior (manifest committed at the NEXT finalize
        # point on the training thread) — a debugging/compat knob and the
        # deterministic mode the deadline-decision tests pin.
        self.background_finalize = background_finalize
        self._requested = False
        self._saved_for_termination = False
        #: the deadline decision taken on termination ("save" /
        #: "finalize" / "skip"; None until then) — callers print it so a
        #: skipped save is never reported as a checkpoint
        self.termination_decision: Optional[str] = None
        self._prev_handlers = {}
        self._writer: Optional[AsyncCheckpointWriter] = None
        # async save whose manifest is not yet committed — finalized
        # before the next save / restore / close, and IMMEDIATELY for a
        # termination save (durability claim). Keys: step, host_state
        # (the writer's host snapshot taken at issuance: the caller may
        # update the live tensors the moment step() returns), fingerprint (computed
        # from it at finalize — background thread for overlapped saves),
        # topology, issue_s (the synchronous issuance cost, folded into
        # the save EMA at finalize), fold_full. The abandon paths swap
        # self._pending to None (a GIL-atomic store) so _commit's
        # identity check refuses the marker for a disowned save.
        self._pending: Optional[dict] = None
        # a save issued since the layout's ranks last met (world > 1):
        # the next finalize ends with a barrier (module docstring)
        self._unsynced = False
        self._bg_thread: Optional[threading.Thread] = None
        self._abandoned_step: Optional[int] = None
        # monotonic arrival time of the first termination signal — the
        # grace budget counts down from HERE, not from the poll that
        # noticed it (polls can lag the signal by most of a train step)
        self._sigterm_t: Optional[float] = None
        # measured durable-save cost EMAs (seconds): full save and
        # finalize-only. Persisted in the manifest ("autoresume" block)
        # and re-seeded by restore(), so a freshly restarted job can make
        # a deadline decision before its own first save completes.
        self._save_ema: Optional[float] = None
        self._finalize_ema: Optional[float] = None
        if install_handlers:
            for sig in signals:
                self._prev_handlers[sig] = _signal.signal(sig, self._on_signal)

    # -- checkpoint IO -----------------------------------------------------

    def _integrity(self):
        # lazy: apex_tpu_torch.resilience imports this module's package
        from apex_tpu_torch.resilience import integrity

        return integrity

    def _manifest_extra(self) -> dict:
        return {"autoresume": {
            "save_ema_s": self._save_ema,
            "finalize_ema_s": self._finalize_ema,
        }}

    def _retry(self, fn, what: str, deadline_s: Optional[float] = None):
        """Shared bounded-retry policy (resilience/retry.py), imported
        lazily — the resilience package init must not run during this
        module's import. Jittered so multi-host retries de-stampede."""
        from apex_tpu_torch.resilience.retry import retry_with_backoff

        return retry_with_backoff(
            fn, retries=self.save_retries, backoff=self.save_backoff,
            jitter=0.25, deadline_s=deadline_s, what=what,
        )

    def _fingerprint_pending(self, pending: dict) -> None:
        """Compute the per-leaf crc32 fingerprint from the issuance-time
        host snapshot (background thread for overlapped saves) and free
        the snapshot."""
        if (pending["fingerprint"] is None
                and pending["host_state"] is not None):
            pending["fingerprint"] = self._integrity().tree_fingerprint(
                pending["host_state"]
            )
        pending["host_state"] = None

    def _commit(self, pending: dict) -> None:
        """Land the manifest commit marker + retention for ``pending``.

        Refuses when ``self._pending`` no longer IS ``pending`` — the
        abandon paths (deadline ``skip`` arm, incident exit) swap it to
        None, and a commit marker for a save the job disowned is exactly
        the torn-but-plausible state the tombstone exists to prevent.
        The residual race (abandon landing between this check and the
        marker write) resolves to whichever ``os.replace`` runs last;
        both outcomes are safe — a tombstoned dir restores from the
        previous verified step, a committed dir is genuinely durable
        because the write AND fingerprint completed before the marker.
        """
        if self._pending is not pending:
            return
        if _is_rank0():
            integrity = self._integrity()
            # retried, and _pending is only cleared on success: a
            # transient manifest-write failure is re-attempted at the
            # next finalize point instead of silently losing the
            # commit marker
            self._retry(
                lambda: integrity.write_manifest(
                    os.path.join(self.directory, f"step_{pending['step']}"),
                    fingerprint=pending["fingerprint"],
                    topology=pending["topology"],
                    extra=self._manifest_extra(),
                ),
                what="manifest commit",
            )
            if self.keep_last_n is not None:
                integrity.apply_retention(self.directory, self.keep_last_n)
        if self.journal is not None:
            # the checkpoint is now durable — make its journal anchor
            # durable too (sidecar fsync; may run on the background
            # finalize thread, FlightRecorder is thread-safe)
            self.journal.flush()
        if self._pending is pending:
            self._pending = None

    def _finalize_pending_background(self, pending: dict) -> None:
        """The background-finalize body: runs on the writer's finalize
        thread AFTER the write is durable. Fingerprint + commit marker,
        entirely off the training thread — the ckpt_save badput of an
        overlapped save collapses to its issuance slice."""
        self._fingerprint_pending(pending)
        self._commit(pending)

    def _bg_finalize_failed(self, pending: dict, error: BaseException) -> None:
        logger.warning(
            "background finalize of step_%d failed (%s); the manifest "
            "commit will be re-attempted synchronously at the next "
            "finalize point", pending["step"], error,
        )

    def finalize(self) -> None:
        """Block until every issued save is durable AND committed.

        ``AsyncCheckpointWriter.wait()``-style finalization plus the
        integrity manifest (the commit marker) and retention sweep. A
        save is only as durable as this call — ``step()`` performs it
        before reporting a termination save, and interval saves commit in
        the background (module docstring) with this as the join point.

        Emits a blocking ``ckpt_save`` span ONLY when it actually blocks:
        joining an already-finished background finalize is free, which is
        what lets the accountant book an overlapped save at
        issuance-only. At world > 1 the layout's ranks then wait for one
        another, so every rank sees the committed manifest.
        """
        self._finalize_local()
        if self._unsynced:
            self._unsynced = False
            from apex_tpu_torch.utils.checkpoint import layout_barrier

            layout_barrier()

    def _finalize_local(self) -> None:
        thread = self._bg_thread
        if thread is not None:
            if thread.is_alive():
                pend = self._pending
                t0 = time.monotonic()
                # goodput span: host wall time BLOCKED on the background
                # finalize — the piece the async overlap did NOT hide
                with _goodput_span(
                        "ckpt_save",
                        step=pend["step"] if pend else -1):
                    thread.join()
                # the blocked-join cost is the real "finalize the pending
                # save" sample the deadline decision's finalize arm needs
                self._finalize_ema = _ema(
                    self._finalize_ema, time.monotonic() - t0)
            else:
                thread.join()
            self._bg_thread = None
        if self._pending is None:
            return
        # synchronous commit: durable saves, the first-save calibration,
        # and the fallback when a background finalize failed
        pending = self._pending
        step = pending["step"]
        t0 = time.monotonic()
        # goodput span: host wall time BLOCKED on checkpoint durability
        # (the wait + fingerprint + manifest commit + retention sweep)
        with _goodput_span("ckpt_save", step=step):
            self._writer.wait()
            self._fingerprint_pending(pending)
            # EMAs folded BEFORE the manifest write so THIS save's cost
            # is already in the persisted block (a restarted job inherits
            # it from its very first checkpoint). The manifest write +
            # retention sweep are excluded from the sample.
            #
            # The FULL-save EMA only folds UNOVERLAPPED samples
            # (fold_full: durable saves and the first-save calibration,
            # where finalize immediately follows issuance). An interval
            # save finalized after overlap observes wait ~ 0 because
            # training HID the write — folding that would converge the
            # EMA to the issuance cost alone, and the deadline decision
            # would pick "save" for grace budgets a fresh (nothing to
            # hide behind) termination save cannot fit.
            wait_s = time.monotonic() - t0
            self._finalize_ema = _ema(self._finalize_ema, wait_s)
            if pending["fold_full"]:
                self._save_ema = _ema(
                    self._save_ema, pending["issue_s"] + wait_s)
            self._commit(pending)

    def _topology(self, state) -> Optional[dict]:
        from apex_tpu_torch.resilience.elastic import topology_block

        try:
            return topology_block(state, self.mesh)
        except Exception as e:  # noqa: BLE001 - durability outranks metadata
            logger.warning("topology block skipped: %s", e)
            return None

    def _save(self, step: int, state: Any, durable: bool) -> None:
        if self.journal is not None:
            # replay-anchor convention: the checkpoint labeled ``step``
            # holds the state ENTERING step ``step`` (the caller passes
            # the post-step state as step+1). The replayer re-verifies
            # the manifest before trusting the anchor, so recording at
            # issuance (before the async commit lands) is safe.
            self.journal.anchor(step)
        self.finalize()  # previous pending save first (ordering + bounded lag)
        if self._writer is None:
            self._writer = AsyncCheckpointWriter()
        t0 = time.monotonic()
        # goodput span: the synchronous slice of an async save — the
        # device->host snapshot and the write ISSUANCE. The fingerprint
        # crc32s and the manifest's per-file sha256 run OFF this slice
        # in the background finalize (module docstring); only the
        # snapshot stays, because the caller updates the live tensors in
        # place the moment step() returns.
        self._unsynced = True
        with _goodput_span("ckpt_save", step=step):
            topology = self._topology(state)
            # the retry covers save ISSUANCE (snapshot-to-host + handoff);
            # an error in the background write itself surfaces at the
            # finalize, when the live tensors have moved on
            self._retry(
                lambda: self._writer.save(self.directory, step, state),
                what="checkpoint save issuance",
            )
            # the per-leaf crc32 fingerprint is taken (on the background
            # finalize for overlapped saves) over this host snapshot, the
            # very bytes the file holds
            host_state = self._writer.snapshot
        # first-save calibration: with no full-cost sample yet, finalize
        # immediately so the EMA's seed measures a REAL durable save
        # (issuance + the whole write, nothing overlapped) — one blocking
        # save, paid when the run is cheapest to pause
        calibrate = self._save_ema is None
        self._pending = {
            "step": step, "host_state": host_state, "fingerprint": None,
            "topology": topology,
            "issue_s": time.monotonic() - t0,
            "fold_full": durable or calibrate,
        }
        if durable or calibrate:
            self.finalize()
        elif self.background_finalize:
            pending = self._pending
            self._bg_thread = self._writer.finalize_async(
                functools.partial(self._finalize_pending_background,
                                  pending),
                on_error=functools.partial(self._bg_finalize_failed,
                                           pending),
            )

    def _abandon_pending(self) -> None:
        """Drop the pending save WITHOUT committing its manifest.

        The deadline decision's ``skip`` arm (and the incident exit's
        only arm): the background write may still land its bytes, but
        with no manifest the step dir is uncommitted and every verified
        restore skips it — torn, but cleanly so. The last verified
        checkpoint stays the durable one. The ``self._pending = None``
        store is the (GIL-atomic) handshake with the background
        finalize's ``_commit`` identity check; never blocks on the
        writer, so it is safe from the watchdog thread against a wedged
        save.
        """
        if self._pending is None:
            return
        self._abandoned_step = self._pending["step"]
        logger.warning(
            "abandoning un-finalized async save of step_%d (grace budget): "
            "no manifest will be committed; restore uses the last verified "
            "step", self._abandoned_step,
        )
        self._pending = None
        # tombstone manifest: the background write may still complete the
        # dir, and without this a legacy-tolerant restore would accept
        # the un-vouched-for state (integrity.write_abandoned_marker)
        if _is_rank0():
            try:
                self._integrity().write_abandoned_marker(
                    os.path.join(self.directory,
                                 f"step_{self._abandoned_step}")
                )
            except OSError as e:
                logger.warning("abandoned-marker write failed: %s", e)
        if self.journal is not None:
            # the anchor recorded at issuance now points at a tombstoned
            # dir (the replayer's verification rejects it anyway) — note
            # the abandonment for forensics and make the journal durable
            self.journal.event(self._abandoned_step, "anchor_abandoned")
            self.journal.flush()

    def prepare_incident_exit(self) -> Optional[int]:
        """Bounded preparation for an incident self-termination.

        Called by the hung-job responder (``resilience.health``) from its
        WATCHDOG thread just before ``os._exit``: abandon the
        un-committed pending async save — tombstone manifest included —
        so the next incarnation restores the last VERIFIED step instead
        of a maybe-torn one. Deliberately never waits on the writer or
        joins the background finalize (either may be part of the wedge);
        a save whose background finalize already committed is left
        durable (nothing pending, nothing to abandon). Returns the
        abandoned step, or None when nothing was pending.
        """
        if self._pending is None:
            if self.journal is not None:
                # even with nothing pending, the incident post-mortem
                # needs the journal durable (the wedged main thread may
                # never reach the recorder's own close)
                self.journal.flush()
            return None
        self._abandon_pending()
        return self._abandoned_step

    # -- signal plumbing ---------------------------------------------------

    def _on_signal(self, signum, frame):
        # flag only: checkpoint IO from inside a signal handler could fire
        # mid-step; the training loop polls at a safe boundary.
        # The timestamp is one float store — async-signal-safe — and
        # anchors the grace-budget countdown at signal ARRIVAL.
        if self._sigterm_t is None:
            self._sigterm_t = time.monotonic()
        self._requested = True

    def close(self):
        """Finalize pending saves and restore previous signal handlers."""
        self.finalize()
        if self._writer is not None:
            self._writer.close()
            self._writer = None
        for sig, h in self._prev_handlers.items():
            _signal.signal(sig, h)
        self._prev_handlers = {}

    def request_resume(self):
        """Programmatic preemption request (ref ADLR ``request_resume``)."""
        if self._sigterm_t is None:
            self._sigterm_t = time.monotonic()
        self._requested = True

    @property
    def termination_signaled(self) -> bool:
        """Host-LOCAL signal hint: True once THIS process saw a
        termination signal or ``request_resume``. No consensus collective
        (unlike :meth:`termination_requested`), so it is free to poll —
        callers use it to stand down machinery that must not misread the
        upcoming blocking termination save as a fault (the GPT example
        stops its incident responder on it: a minutes-long durable save
        is not a wedged step)."""
        return self._requested

    # -- consensus ---------------------------------------------------------

    def termination_requested(self) -> bool:
        """True once ANY rank has received a termination signal.

        In a ``torch.distributed`` world each rank contributes its local
        flag to one MAX all-reduce, so every rank reaches the same answer
        at the same poll and they all checkpoint the same step (the
        reference's polling contract, pipeline_parallel/utils.
        get_autoresume, made distributed-safe). A world of one reads its
        own flag.
        """
        from apex_tpu_torch.parallel import parallel_state as ps

        dist = torch.distributed
        if not dist.is_initialized() or dist.get_world_size() == 1:
            return self._requested
        # the layout's ranks (a sub-world's, when the layout spans one)
        group = ps.get_model_world_group() or dist.group.WORLD
        device = ("cuda" if dist.get_backend(group) == "nccl"
                  else "cpu")
        flag = torch.tensor([float(self._requested)], device=device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
        return bool(flag.item() > 0)

    # -- deadline budget ---------------------------------------------------

    def _emergency_decision(self, now: Optional[float] = None
                            ) -> Tuple[str, dict]:
        """(action, info) for the termination save: ``save`` /
        ``finalize`` / ``skip`` (module docstring). Pure function of the
        grace budget, signal arrival time, EMAs, and pending state —
        seedable and unit-testable.
        """
        now = time.monotonic() if now is None else now
        info = {
            "grace_s": self.grace_s,
            "save_ema_s": self._save_ema,
            "finalize_ema_s": self._finalize_ema,
            "pending_step": (self._pending["step"]
                             if self._pending else None),
            "remaining_s": None,
        }
        if self.grace_s is None:
            return "save", info  # no budget: durability wins
        anchor = self._sigterm_t if self._sigterm_t is not None else now
        remaining = (anchor + self.grace_s) - now
        info["remaining_s"] = remaining
        if self._save_ema is None:
            # no measured history to reason from: attempt the save (the
            # conservative-for-durability default; a first-save job has
            # nothing pending to finalize anyway)
            return "save", info
        if remaining >= self.safety_factor * self._save_ema:
            return "save", info
        est_fin = (self._finalize_ema
                   if self._finalize_ema is not None else self._save_ema)
        if self._pending is not None and remaining >= (
                self.safety_factor * est_fin):
            return "finalize", info
        return "skip", info

    # -- loop API ----------------------------------------------------------

    def step(self, step: int, state: Any) -> bool:
        """Call after each training step with the POST-step state.

        Saves on the periodic interval and on termination request; returns
        True when the caller should exit. On termination the deadline
        decision (module docstring) picks save / finalize-pending /
        skip-and-rely-on-last-verified so the manifest commit always
        lands inside the grace budget; the decision is emitted as a
        ckpt_save span slice plus a ``kind="preemption"`` event.
        """
        terminating = self.termination_requested()
        if terminating and not self._saved_for_termination:
            decision, info = self._emergency_decision()
            self.termination_decision = decision
            # durable semantics per arm: "save" waits for the write AND
            # commits the manifest BEFORE telling the caller it may exit
            # — an exit on an un-finalized async save is exactly the torn
            # checkpoint this machinery exists to prevent; "finalize"
            # commits only the in-flight interval save; "skip" abandons
            # even that commit (a marker racing the kill is worse than a
            # clean fallback to the last verified step)
            with _goodput_span("ckpt_save", step=step, decision=decision):
                if decision == "save":
                    self._save(step, state, durable=True)
                    saved_step = step
                elif decision == "finalize":
                    saved_step = info["pending_step"]
                    self.finalize()
                else:
                    self._abandon_pending()
                    saved_step = None
            router = _goodput_router()
            if router is not None:
                router.event(
                    "preemption", step, decision=decision,
                    saved_step=saved_step, **info,
                )
            logger.info(
                "termination at step %d: decision=%s saved_step=%s "
                "(grace_s=%s save_ema_s=%s remaining_s=%s)",
                step, decision, saved_step, info["grace_s"],
                info["save_ema_s"], info["remaining_s"],
            )
            self._saved_for_termination = True
            return True
        if terminating:
            return True
        if self.interval and step % self.interval == 0:
            self._save(step, state, durable=False)
        return False

    def _seed_emas(self, step: int) -> None:
        """Inherit persisted save-duration EMAs from the restored step's
        manifest (only when this process has no measurements yet)."""
        manifest = self._integrity().read_manifest(
            os.path.join(self.directory, f"step_{step}")
        ) or {}
        block = manifest.get("autoresume") or {}
        if self._save_ema is None and block.get("save_ema_s") is not None:
            self._save_ema = float(block["save_ema_s"])
        if (self._finalize_ema is None
                and block.get("finalize_ema_s") is not None):
            self._finalize_ema = float(block["finalize_ema_s"])

    def restore(self, init_state: Any) -> Tuple[int, Any]:
        """(step, state): newest RESTORABLE checkpoint, else (0, init).

        ``init_state`` is the live state: the restore target (structure,
        dtypes, devices) and where the restored values are copied
        (``copy_``), so the state returned IS ``init_state``, its tensors
        holding the checkpoint's values. A checkpoint that does not load
        (another structure) leaves it untouched.

        Restoration walks step dirs newest-first, checks each integrity manifest, and falls back past
        torn / bit-flipped / uncommitted checkpoints to the newest step
        that verifies (pre-manifest legacy checkpoints are accepted, as
        their corruption is undetectable). At world > 1, or when the
        newest verified manifest's topology block disagrees with the live
        layout (``mesh=``, default ``parallel_state``'s), the restore is
        resharded (collective), and a layout it cannot prove safe raises
        ``ElasticRestoreError`` rather than misloading.
        """
        from apex_tpu_torch.utils.pytree import tree_copy_

        self.finalize()
        # goodput span: restart recovery cost (badput phase ckpt_restore)
        with _goodput_span("ckpt_restore"):
            try:
                step, state = self._integrity().load_checkpoint_verified(
                    self.directory, target=init_state,
                    allow_unverified=True, mesh=self.mesh,
                )
            except FileNotFoundError:
                return 0, init_state
            self._seed_emas(step)
            return step, tree_copy_(init_state, state)
