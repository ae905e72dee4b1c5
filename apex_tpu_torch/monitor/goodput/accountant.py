"""Goodput accountant: replay span streams into a wall-clock partition.

Input: one or more record streams (jsonl files or record lists) carrying
the ``kind="run"`` / ``kind="span"`` records of one job — possibly many
INCARNATIONS of it (a crashed/restarted run appends a fresh run header
plus its spans to the same stream, or writes a second file), possibly
many HOSTS (records carry the ``host`` field). Output: a
:class:`GoodputReport` partitioning total occupancy the TorchTitan way
(arXiv:2410.06511):

    productive + Σ badput[phase] + unattributed == wall     (exactly)

Accounting rules (the timeline analyzer's union-not-sum discipline,
applied to host wall clock):

- Monotonic clocks are PER INCARNATION: ``start`` values from different
  incarnations are not comparable, so each incarnation is re-anchored at
  its own earliest timestamp (the run header's ``mono``, or the first
  span) and walls ADD across incarnations. Incarnations are delimited by
  run headers in stream order; records before the first header form a
  legacy headerless incarnation.
- Hosts are independent wall clocks too: the partition is computed per
  host and summed, so an 8-host job's wall is 8x its duration — goodput
  fraction is occupancy-weighted, exactly what a fleet bill measures.
- Overlapping spans never double-count: a second of wall time belongs to
  the FIRST covering phase in :data:`~apex_tpu_torch.monitor.goodput.spans.
  PHASE_PRIORITY`. An async checkpoint save fully overlapped by steps
  contributes ZERO badput (off the critical path, the design goal); only
  its exposed remainder is charged.
- ``unattributed`` is the wall not covered by any span (interpreter
  startup, code between spans). It is a first-class category, not an
  error — but a large value means the producer's span coverage is poor.

The identity is pinned digit-for-digit: ``wall_s`` is DEFINED as the
left-to-right float sum of the categories in canonical order (see
:meth:`GoodputReport.fields`), so consumers can re-add the jsonl record's
fields and compare with ``==``, never ``approx``.

Copied from apex_tpu/monitor/goodput/accountant.py (stdlib only): the
port's streams and the JAX package's read alike.
"""

import dataclasses
import json
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from apex_tpu_torch.monitor.goodput.spans import PHASE_PRIORITY, PRODUCTIVE_PHASES

__all__ = ["GoodputReport", "account", "read_records"]

#: badput categories in canonical (priority) order — every phase except
#: the productive ones (training's ``step`` plus the serving work
#: phases ``prefill``/``decode``; spans.PRODUCTIVE_PHASES)
BADPUT_PHASES = tuple(p for p in PHASE_PRIORITY if p not in PRODUCTIVE_PHASES)


def read_records(paths: Sequence[str]) -> List[dict]:
    """Records from jsonl files, in file-then-line order; unparseable
    lines are skipped (a torn final line from a killed run must not make
    the whole stream unreadable)."""
    records: List[dict] = []
    for path in paths:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict):
                    records.append(rec)
    return records


# -- interval algebra (sorted, half-open [start, end)) ----------------------


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(i for i in intervals if i[1] > i[0]):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _subtract(
    intervals: List[Tuple[float, float]],
    covered: List[Tuple[float, float]],
) -> List[Tuple[float, float]]:
    """``intervals`` minus ``covered`` (both already unions)."""
    out: List[Tuple[float, float]] = []
    for s, e in intervals:
        cur = s
        for cs, ce in covered:
            if ce <= cur:
                continue
            if cs >= e:
                break
            if cs > cur:
                out.append((cur, cs))
            cur = max(cur, ce)
            if cur >= e:
                break
        if cur < e:
            out.append((cur, e))
    return out


def _total(intervals: Iterable[Tuple[float, float]]) -> float:
    return sum(e - s for s, e in intervals)


@dataclasses.dataclass
class GoodputReport:
    """The partition (seconds) plus its provenance counters."""

    productive_s: float
    badput_s: Dict[str, float]      # every BADPUT_PHASES key present
    unattributed_s: float
    wall_s: float                   # == canonical sum, by construction
    incarnations: int
    hosts: Tuple[int, ...]
    n_spans: int
    n_interrupted: int
    run_id: Optional[str] = None

    @property
    def goodput_fraction(self) -> Optional[float]:
        """productive / wall — None (not a fake number) on an empty wall."""
        if self.wall_s <= 0.0:
            return None
        return self.productive_s / self.wall_s

    def fields(self) -> dict:
        """Flat fields for the ``kind="goodput"`` record.

        The identity contract: ``wall_s`` equals the left-to-right float
        sum of ``productive_s``, each ``badput_<phase>_s`` in
        BADPUT_PHASES order, then ``unattributed_s`` — digit-for-digit,
        and json round-trips floats exactly, so a consumer may assert
        it with ``==`` on the record.
        """
        out = {
            "run_id": self.run_id,
            "wall_s": self.wall_s,
            "productive_s": self.productive_s,
        }
        for phase in BADPUT_PHASES:
            out[f"badput_{phase}_s"] = self.badput_s[phase]
        out["unattributed_s"] = self.unattributed_s
        out["goodput_fraction"] = self.goodput_fraction
        out["incarnations"] = self.incarnations
        out["n_hosts"] = len(self.hosts)
        out["n_spans"] = self.n_spans
        out["n_interrupted"] = self.n_interrupted
        return out

    def summary(self) -> str:
        frac = self.goodput_fraction
        lines = [
            f"goodput: {self.productive_s:.3f}s productive of "
            f"{self.wall_s:.3f}s wall"
            + (f" ({100.0 * frac:.1f}%)" if frac is not None else "")
            + f" | incarnations: {self.incarnations}"
            + f" | hosts: {len(self.hosts)}"
            + (f" | run_id: {self.run_id}" if self.run_id else ""),
        ]
        for phase in BADPUT_PHASES:
            secs = self.badput_s[phase]
            if secs > 0.0:
                lines.append(f"  badput {phase:13s} {secs:10.3f}s")
        lines.append(f"  unattributed      {self.unattributed_s:10.3f}s")
        if self.n_interrupted:
            lines.append(
                f"  ({self.n_interrupted} interrupted span(s) counted at "
                f"their partial duration)"
            )
        return "\n".join(lines)


def _split_incarnations(records: Sequence[dict]) -> List[dict]:
    """Split one host's record sequence on ``kind="run"`` headers.

    Returns incarnation dicts {"run_id", "anchor", "spans"} in stream
    order; records preceding any header become a headerless incarnation
    (run_id None) so legacy streams still account.
    """
    incarnations: List[dict] = []
    current: Optional[dict] = None
    for rec in records:
        kind = rec.get("kind")
        if kind == "run":
            current = {
                "run_id": rec.get("run_id"),
                "anchor": rec.get("mono"),
                "spans": [],
            }
            incarnations.append(current)
        elif kind == "span":
            if current is None:
                current = {"run_id": None, "anchor": None, "spans": []}
                incarnations.append(current)
            current["spans"].append(rec)
    return incarnations


def account(
    records: Iterable[dict],
    run_id: Optional[str] = None,
) -> GoodputReport:
    """Partition ``records`` (any kinds; only run/span are read) into a
    :class:`GoodputReport`. With ``run_id`` given, only incarnations
    whose header carries that id are counted (a shared stream may hold
    several jobs); headerless incarnations are kept only when no id
    filter is given.
    """
    by_host: Dict[int, List[dict]] = {}
    for rec in records:
        if rec.get("kind") in ("run", "span"):
            by_host.setdefault(int(rec.get("host", 0)), []).append(rec)

    productive = 0.0
    badput = {phase: 0.0 for phase in BADPUT_PHASES}
    wall_raw = 0.0
    n_incarnations = 0
    n_spans = 0
    n_interrupted = 0
    for host in sorted(by_host):
        for inc in _split_incarnations(by_host[host]):
            if run_id is not None and inc["run_id"] != run_id:
                continue
            phase_ivs: Dict[str, List[Tuple[float, float]]] = {}
            starts: List[float] = []
            ends: List[float] = []
            if inc["anchor"] is not None:
                starts.append(float(inc["anchor"]))
            for rec in inc["spans"]:
                phase = rec.get("phase")
                if phase not in PHASE_PRIORITY:
                    continue  # future phases: skip, never mis-bucket
                try:
                    s = float(rec["start"])
                    d = float(rec["dur_s"])
                except (KeyError, TypeError, ValueError):
                    continue
                if not (math.isfinite(s) and math.isfinite(d)):
                    continue
                e = s + max(d, 0.0)
                phase_ivs.setdefault(phase, []).append((s, e))
                starts.append(s)
                ends.append(e)
                n_spans += 1
                if rec.get("interrupted"):
                    n_interrupted += 1
            n_incarnations += 1
            if not ends:
                continue  # header-only incarnation: zero wall, zero spans
            anchor, end = min(starts), max(ends)
            wall_raw += end - anchor
            covered: List[Tuple[float, float]] = []
            for phase in PHASE_PRIORITY:
                ivs = phase_ivs.get(phase)
                if not ivs:
                    continue
                u = _union([(max(s, anchor), min(e, end)) for s, e in ivs])
                exposed = _total(_subtract(u, covered))
                if phase in PRODUCTIVE_PHASES:
                    productive += exposed
                else:
                    badput[phase] += exposed
                covered = _union(covered + u)

    # the identity, by construction: wall_s IS the canonical left-to-right
    # sum. `partial` accumulates it; unattributed is the raw remainder
    # (clamped — float noise must not report negative idle time), and the
    # stored wall absorbs any final-ulp disagreement with wall_raw so
    # consumers can re-add fields() with ==.
    partial = productive
    for phase in BADPUT_PHASES:
        partial = partial + badput[phase]
    unattributed = max(wall_raw - partial, 0.0)
    wall = partial + unattributed
    return GoodputReport(
        productive_s=productive,
        badput_s=badput,
        unattributed_s=unattributed,
        wall_s=wall,
        incarnations=n_incarnations,
        hosts=tuple(sorted(by_host)),
        n_spans=n_spans,
        n_interrupted=n_interrupted,
        run_id=run_id,
    )
