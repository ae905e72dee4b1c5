"""Divergence bisector: from "the replay disagrees" to "this step, this
leaf, this layer" (counterpart of apex_tpu/resilience/replay/bisect.py).

The search exploits one property of deterministic replay: a corruption
event (an in-memory bit flip, a silent host fault) is INVISIBLE to
replays that start after it — the corrupted state was checkpointed, and
replaying a corrupted checkpoint faithfully reproduces the corrupted
trajectory — and VISIBLE to every replay that starts before it (the
clean restart diverges from the journaled trajectory at the event).
"Replay from anchor a_i matches the journal" is therefore monotone in
i: False, False, ..., False, True, True, ... with the corruption inside
the last False anchor's segment. Binary search over the verified
anchors finds that segment in O(log anchors) probes; a final
fine-grained replay of the segment pins:

- **the step** — the first journaled per-step fingerprint (loss /
  verdict / layer_rms) the clean replay disagrees with;
- **the leaf** — the replayed state's per-leaf crc32 vs the NEXT
  anchor's manifest fingerprint. When every per-step fingerprint up to
  that anchor matched (the corruption entered the state at the anchor
  boundary itself — e.g. a bit flip landing between a step and its
  save), the differing leaf set is EXACT: one flipped leaf reads as one
  differing crc. When steps diverged before the anchor, the intervening
  optimizer updates have touched every leaf, and the set is reported as
  ``exact=False`` candidates;
- **the layer** — the first index of the journaled per-layer
  ``layer_out_rms`` vector that disagrees at the first divergent step
  (the layers' ``layer_out_rms`` taps): parameters feed their own
  layer's activations first, so the first divergent layer is where the
  corruption lives (embedding corruption reads as layer 0 + a note).

The outcome is ONE ``kind="divergence"`` forensic record (the
incident-bundle idiom: everything a post-mortem needs in a single
record — probes, divergence details, leaf/layer verdicts), emitted
through the router when one is wired and returned either way.
"""

import logging
from typing import List, Optional

from apex_tpu_torch.resilience.replay.journal import Journal
from apex_tpu_torch.resilience.replay.replayer import (
    GPTReplayContext,
    ReplayError,
    ReplayReport,
    build_context,
    replay_segment,
    verified_anchor_steps,
)

logger = logging.getLogger("apex_tpu_torch.resilience.replay")

__all__ = ["bisect_divergence", "format_divergence"]

#: divergence fields that are per-step OUTPUT fingerprints (vs anchor
#: state comparisons) — the step-localization signal
_STEP_FIELDS = frozenset({"loss", "verdict", "layer_rms",
                          "layer_rms_len", "loss_scale"})


def bisect_divergence(
    journal: Journal,
    ckpt_dir: Optional[str],
    stop: Optional[int] = None,
    mode: str = "auto",
    rtol: float = 1e-5,
    atol: float = 1e-8,
    router=None,
    ctx: Optional[GPTReplayContext] = None,
    device="cuda",
) -> dict:
    """Locate the first divergence (module docstring); returns the
    ``kind="divergence"`` record (``found=False`` when the whole journal
    replays clean). Without ``ctx`` the step is rebuilt on ``device``,
    and the process's numerics flags are put back when it returns."""
    if ctx is None:
        with build_context(journal, device=device) as own:
            return bisect_divergence(journal, ckpt_dir, stop=stop, mode=mode,
                                     rtol=rtol, atol=atol, router=router,
                                     ctx=own)
    anchors = verified_anchor_steps(journal, ckpt_dir)
    if not anchors:
        raise ReplayError(
            "no restorable anchor (init-marked or verified checkpoint) — "
            "nothing to bisect from"
        )
    if stop is None:
        stop = journal.step_range()[1]
    probes: List[dict] = []
    reports: dict = {}

    def probe(i: int) -> ReplayReport:
        if i not in reports:
            rep = replay_segment(ctx, ckpt_dir, start=anchors[i],
                                 stop=stop, mode=mode, rtol=rtol,
                                 atol=atol, until="first")
            reports[i] = rep
            probes.append(dict(anchor=anchors[i], ok=rep.ok,
                               steps_replayed=rep.steps_replayed))
            logger.info("bisect probe from anchor %d: %s", anchors[i],
                        "consistent" if rep.ok else
                        f"divergent at step {rep.first_divergent_step}")
        return reports[i]

    # binary search the first anchor whose suffix replay is CONSISTENT
    # (monotone — module docstring); everything before it is divergent
    if probe(0).ok:
        record = _emit(router, journal, found=False, probes=probes,
                       anchors=anchors, mode=reports[0].mode, stop=stop)
        return record
    first_ok: Optional[int] = None
    if len(anchors) > 1 and probe(len(anchors) - 1).ok:
        # invariant: probe(lo) divergent, probe(hi) consistent
        lo, hi = 0, len(anchors) - 1
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if probe(mid).ok:
                hi = mid
            else:
                lo = mid
        first_ok = hi
    bad = (first_ok - 1) if first_ok is not None else len(anchors) - 1
    # fine phase: replay the bad segment PAST the first divergence to
    # the next anchor, so the per-leaf state comparison there lands
    fine_stop = anchors[first_ok] if first_ok is not None else stop
    fine = replay_segment(ctx, ckpt_dir, start=anchors[bad],
                          stop=fine_stop, mode=mode, rtol=rtol, atol=atol,
                          until="anchor")
    step_divs = [d for d in fine.divergences if d["field"] in _STEP_FIELDS]
    anchor_divs = [d for d in fine.divergences
                   if d["field"] in ("anchor_leaves", "anchor_structure")]
    first_step = (min(int(d["step"]) for d in step_divs)
                  if step_divs else None)
    leaves: List[str] = []
    dirty_anchor = None
    exact = False
    if anchor_divs:
        dirty_anchor = int(anchor_divs[0]["step"])
        leaves = list(anchor_divs[0].get("leaves") or [])
        # exact iff no replayed step OUTPUT diverged before the anchor
        # whose state differs: the corruption entered the state at that
        # boundary with no intervening update to smear it across leaves
        exact = first_step is None or first_step >= dirty_anchor
    divergent_step = (min(v for v in (first_step, dirty_anchor)
                          if v is not None)
                      if (first_step is not None or dirty_anchor is not None)
                      else None)
    layer = None
    for d in step_divs:
        if d.get("first_divergent_layer") is not None:
            layer = int(d["first_divergent_layer"])
            break
    record = _emit(
        router, journal, found=True, probes=probes, anchors=anchors,
        mode=fine.mode, stop=stop,
        step=divergent_step, clean_anchor=anchors[bad],
        dirty_anchor=dirty_anchor, leaves=leaves[:64], exact_leaves=exact,
        layer=layer, divergences=fine.divergences[:32],
    )
    return record


def _emit(router, journal: Journal, **fields) -> dict:
    from apex_tpu_torch.monitor.router import make_record

    # the divergent step IS the record's step field (the shared schema's
    # join key); -1 marks the no-divergence outcome
    step = fields.pop("step", None)
    record = make_record(
        "divergence", -1 if step is None else int(step),
        run_id=journal.header.get("run_id"), **fields,
    )
    if router is not None:
        router.emit(record)
    return record


def format_divergence(record: dict) -> str:
    """Human one-screen rendering of a ``kind="divergence"`` record."""
    if not record.get("found"):
        return (f"no divergence: the journal replays clean from anchor(s) "
                f"{[p['anchor'] for p in record.get('probes', [])]} "
                f"({record.get('mode')})")
    lines = [
        f"DIVERGENCE at step {record.get('step')} "
        f"(mode {record.get('mode')}):",
        f"  clean anchor {record.get('clean_anchor')} replays consistent "
        f"up to the corruption; dirty anchor "
        f"{record.get('dirty_anchor')} carries it",
    ]
    leaves = record.get("leaves") or []
    if leaves:
        kind = ("exact" if record.get("exact_leaves")
                else "candidates (intervening updates smeared the diff)")
        lines.append(f"  leaf(s), {kind}: {leaves[:8]}")
    if record.get("layer") is not None:
        lines.append(f"  first divergent layer_out_rms depth: "
                     f"layer {record['layer']}")
    lines.append(f"  probes: " + ", ".join(
        f"a{p['anchor']}={'ok' if p['ok'] else 'DIV'}"
        for p in record.get("probes", [])))
    return "\n".join(lines)
