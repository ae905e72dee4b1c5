"""The canary: replayer-backed verification for the controller
(counterpart of apex_tpu/resilience/remediation/canary.py).

"Verify before you act" is the controller's core discipline, and this
module is the verifier: a callable that re-executes the newest
journaled segment(s) through the replayer and reports whether
the recorded trajectory is reproducible —

- **ok** (the trajectory replays clean): a straggler/stall/SDC-suspect
  finding is a TRANSIENT — the computation is sound, only the wall
  clock wobbled — and the case closes ``cleared`` with zero restarts.
- **not ok** (the clean re-execution disagrees with the journal):
  confirmed corruption, with the evidence the quarantine needs already
  in hand — the clean anchor to restart from, the first divergent
  step, and (when the corruption entered the state at an anchor
  boundary, the bit-flip shape) the EXACT leaf from the per-leaf crc32
  comparison against the dirty anchor's manifest.

:class:`GPTCanary` audits segments INCREMENTALLY: each call replays
only the verified-anchor segments not yet audited (from ``floor_step``
— this incarnation's restore point — forward), so the periodic
``policy.canary_audit`` costs each segment one re-execution, not a
quadratic re-replay of history. Segments the replayer refuses
(a rollback rewound through the in-memory snapshot ring) are skipped
with a note — a canary that cannot verify must say so, never guess.

The replay runs through the SAME :class:`~apex_tpu_torch.resilience.
replay.replayer.GPTReplayContext` machinery as the CLI, handed the live
``training``/``lm`` objects when the caller has them (the GPT example
passes its own — the canary then replays through the very step that
recorded, with its kernels already loaded). The controller wraps each
call in a ``phase="remediation"`` goodput span, so this cost books as
recovery badput.

At world > 1 every rank of the layout calls the canary together (the
replay is the distributed step, its anchor restores and fingerprints
collective), and every rank returns the first rank's verdict, so the
ranks' controllers stay in step. A journal recorded on N ranks is
replayed on N: ``floor_step`` keeps each incarnation to the segments it
recorded itself.
"""

import logging
import os
from typing import List, Optional

import torch

from apex_tpu_torch.parallel import parallel_state as ps
from apex_tpu_torch.resilience.replay.journal import load_journal

logger = logging.getLogger("apex_tpu_torch.resilience.remediation")

__all__ = ["GPTCanary"]


class GPTCanary:
    """Incremental segment re-verification over a journal sidecar
    (module docstring).

    ``journal_file`` may be the sidecar path or the checkpoint dir
    holding it; ``ckpt_dir`` the anchors' checkpoint directory;
    ``training``/``lm`` the prebuilt step + dataset (None rebuilds from
    the journal header, the CLI path); ``floor_step`` the first anchor
    this incarnation may audit from (its own restore point — segments
    recorded by earlier incarnations on a different topology are not
    re-executable here and belong to the incarnation that wrote them).
    """

    def __init__(self, journal_file: str, ckpt_dir: str, training=None,
                 lm=None, floor_step: int = 0,
                 max_segments_per_call: Optional[int] = None):
        self.journal_file = journal_file
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        self.training = training
        self.lm = lm
        self.floor_step = int(floor_step)
        self.max_segments_per_call = max_segments_per_call
        self._audited_upto = int(floor_step)
        self._ctx = None
        self.notes: List[str] = []

    def __call__(self) -> dict:
        # a replay through the live training writes the model's own
        # parameters (its anchor restores and steps): the live values are
        # kept aside and put back, so the run goes on from where it was
        kept = None
        if self.training is not None:
            kept = [p.detach().clone()
                    for p in self.training.model.parameters()]
        try:
            verdict = self._audit()
        finally:
            if kept is not None:
                with torch.no_grad():
                    for p, k in zip(self.training.model.parameters(), kept):
                        p.copy_(k)
        # every rank replays; the first rank's verdict is everyone's
        return ps.broadcast_object(verdict)

    def _audit(self) -> dict:
        from apex_tpu_torch.resilience.replay.replayer import (
            GPTReplayContext,
            ReplayError,
            replay_segment,
            verified_anchor_steps,
        )

        try:
            journal = load_journal(self.journal_file)
        except (OSError, ValueError) as e:
            # nothing journaled yet (a fresh run's first audit): nothing
            # to verify is not a verdict either way
            return {"ok": True, "skipped": True, "reason": repr(e)}
        try:
            if self._ctx is None:
                self._ctx = GPTReplayContext(journal, training=self.training,
                                             lm=self.lm)
            else:
                # the context's expensive halves (state template, metric
                # bag — each an init compile) persist across audits; the
                # journal is just data and refreshes per call
                self._ctx.journal = journal
            ctx = self._ctx
        except ReplayError as e:
            return {"ok": True, "skipped": True, "reason": str(e)}
        anchors = [a for a in verified_anchor_steps(journal, self.ckpt_dir)
                   if a >= self.floor_step]
        pairs = [
            (anchors[i], anchors[i + 1])
            for i in range(len(anchors) - 1)
            if anchors[i] >= self._audited_upto
        ]
        if self.max_segments_per_call is not None:
            pairs = pairs[: self.max_segments_per_call]
        if not pairs:
            return {"ok": True, "skipped": True,
                    "reason": "no unaudited verified segment"}
        audited: List[List[int]] = []
        for lo, hi in pairs:
            try:
                # stop at hi-1 so the final anchor comparison (the
                # exact-leaf signal for boundary corruption) lands via
                # the run-to-completion path; until="anchor" keeps
                # replaying past a step divergence so that comparison
                # still happens
                report = replay_segment(
                    ctx, self.ckpt_dir, start=lo, stop=hi - 1,
                    until="anchor",
                )
            except ReplayError as e:
                # a rollback inside the segment (or a data gap): not
                # re-executable — skip it honestly, keep auditing later
                # segments (they start from their own verified anchor)
                note = f"segment ({lo}..{hi}] unverifiable: {e}"
                self.notes.append(note)
                logger.warning("remediation canary: %s", note)
                self._audited_upto = hi
                continue
            if not report.ok:
                leaves: List[str] = []
                for d in report.divergences:
                    if d.get("field") == "anchor_leaves":
                        leaves = list(d.get("leaves") or [])
                        break
                evidence = {
                    "kind": "canary", "clean_anchor": lo,
                    "dirty_anchor": hi,
                    "first_divergent_step": report.first_divergent_step,
                    "steps_replayed": report.steps_replayed,
                    "mode": report.mode,
                    "leaves": leaves[:8],
                    "divergences": report.divergences[:8],
                    "summary": report.summary(),
                }
                logger.warning(
                    "remediation canary: segment (%d..%d] DIVERGED — %s",
                    lo, hi, report.summary().splitlines()[0],
                )
                return {"ok": False, "clean_anchor": lo,
                        "dirty_anchor": hi, "evidence": evidence}
            self._audited_upto = hi
            audited.append([lo, hi])
        return {
            "ok": True,
            "audited": audited,
            "evidence": {"kind": "canary", "audited": audited,
                         "notes": self.notes[-4:]},
        }
