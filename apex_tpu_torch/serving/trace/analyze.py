"""Offline critical-path analyzer for request trace trees.

Rebuilds each request's span tree from a ``kind="trace"`` record stream
(:mod:`apex_tpu_torch.serving.trace.emit`), checks it is COMPLETE, computes an
exclusive-time decomposition per request with a partition identity —
the goodput identity idiom (monitor/goodput/accountant.py) at request
granularity:

    submit->terminal wall == queue + prefill + handoff + decode
                             + recovery + exposed overhead

digit-for-digit through the json round trip: ``wall_s`` is DEFINED as
the left-to-right float sum of the phase fields in
:data:`REQUEST_PHASES` order plus ``overhead_s``, so a consumer can
re-add a decomposition record's fields and compare with ``==``, never
``approx`` (:func:`check_identity` does exactly that).

Accounting rules (the accountant's union-not-sum discipline):

- A second of a request's wall belongs to the FIRST covering phase in
  :data:`ATTRIBUTION_PRIORITY` — recovery over handoff over prefill
  over decode over queue, so the failover envelope swallows the queue
  wait it contains instead of double-billing it.
- Spans are clipped to the root interval (the client-visible wall);
  a pre-recovery span from an earlier attempt that leaks past a
  re-anchored root cannot corrupt the partition.
- ``overhead_s`` is the wall no phase span covers: scheduler gaps,
  detection latency on a dead replica (the orphaned decode segment is
  never closed — honest lost work), hang exposure. First-class, not an
  error; ``phase=None`` markers (dispatch, stall) explain it.

Fleet aggregation: p50/p99 TTFT with the decomposition OF the p99
request itself ("p99 TTFT = X queue + Y recovery + Z handoff"), mean
per-phase seconds, and per-token decode time. Reconciliation: the
recovery/handoff spans carry goodput-twin fields copied verbatim from
the closed ``failover``/``handoff`` goodput spans, so the per-request
view re-derives the accountant's badput for those phases EXACTLY
(same interval algebra, same floats) — failover/handoff badput must
match from both sides or the stream is lying to one of them. A twinless
badput second (a failover with zero in-flight requests cannot appear in
any tree) fails reconciliation BY DESIGN: badput no request observed is
itself a finding.

Copied from apex_tpu/serving/trace/analyze.py (stdlib only): any box
can analyze a stream, the port's or the JAX package's.
"""

import dataclasses
import json
import math
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from apex_tpu_torch.monitor.goodput.accountant import (
    _subtract, _total, _union, account, read_records,
)
from apex_tpu_torch.serving.trace.emit import ROOT_SPAN

__all__ = [
    "ATTRIBUTION_PRIORITY", "REQUEST_PHASES", "RequestTrace",
    "TraceReport", "analyze", "build_traces", "check_identity",
    "decompose", "read_records",
]

#: the per-request partition, in canonical SUM order — the identity adds
#: these left-to-right, then ``overhead_s``
REQUEST_PHASES = ("queue", "prefill", "handoff", "decode", "recovery")

#: overlap attribution order — a second belongs to the FIRST covering
#: phase (recovery swallows the re-queue wait inside its envelope;
#: handoff swallows the decode-segment tails it straddles)
ATTRIBUTION_PRIORITY = ("recovery", "handoff", "prefill", "decode",
                        "queue")

#: reconciliation pairs: trace phase -> the goodput badput phase whose
#: accountant total the gp twins must reproduce exactly
GP_TWIN_PHASES = {"recovery": "failover", "handoff": "handoff"}


@dataclasses.dataclass
class RequestTrace:
    """One rebuilt tree: the root span, its children, and any
    completeness violations (empty ``problems`` == complete)."""

    trace: int
    root: Optional[dict]
    children: List[dict]
    problems: List[str]

    @property
    def complete(self) -> bool:
        return not self.problems


def build_traces(records: Iterable[dict]) -> Dict[int, RequestTrace]:
    """Group ``kind="trace"`` records into per-request trees and check
    completeness: exactly one root, unique span ids, every parent link
    resolving inside the tree."""
    by_trace: Dict[int, List[dict]] = {}
    for rec in records:
        if rec.get("kind") == "trace":
            try:
                rid = int(rec["trace"])
            except (KeyError, TypeError, ValueError):
                continue
            by_trace.setdefault(rid, []).append(rec)
    out: Dict[int, RequestTrace] = {}
    for rid, recs in by_trace.items():
        roots = [r for r in recs if r.get("parent") is None]
        children = [r for r in recs if r.get("parent") is not None]
        problems: List[str] = []
        if not roots:
            problems.append("no root span (request never reached a "
                            "terminal state in this stream)")
        elif len(roots) > 1:
            problems.append(f"{len(roots)} root spans (terminal emitted "
                            "more than once)")
        ids: Set[str] = set()
        for r in recs:
            sid = r.get("span")
            if not isinstance(sid, str):
                problems.append(f"span without an id: {r.get('name')}")
            elif sid in ids:
                problems.append(f"duplicate span id {sid!r}")
            else:
                ids.add(sid)
        for r in children:
            if r.get("parent") not in ids:
                problems.append(
                    f"span {r.get('span')!r} has dangling parent "
                    f"{r.get('parent')!r}")
        out[rid] = RequestTrace(
            trace=rid, root=roots[0] if len(roots) == 1 else None,
            children=children, problems=problems)
    return out


def _clipped(children: Sequence[dict], lo: float,
             hi: float) -> Dict[str, List[Tuple[float, float]]]:
    """Per-phase intervals clipped to [lo, hi); unknown phases are
    skipped, never mis-bucketed (the accountant's rule)."""
    ivs: Dict[str, List[Tuple[float, float]]] = {}
    for rec in children:
        phase = rec.get("phase")
        if phase not in ATTRIBUTION_PRIORITY:
            continue
        try:
            s = float(rec["start"])
            d = float(rec["dur_s"])
        except (KeyError, TypeError, ValueError):
            continue
        if not (math.isfinite(s) and math.isfinite(d)):
            continue
        e = s + max(d, 0.0)
        ivs.setdefault(phase, []).append((max(s, lo), min(e, hi)))
    return ivs


def _partition(children: Sequence[dict], lo: float,
               wall_raw: float) -> Dict[str, float]:
    """Exclusive per-phase seconds over [lo, lo+wall_raw) plus the
    identity-closing ``overhead_s``/``wall_s`` (module docstring)."""
    ivs = _clipped(children, lo, lo + max(wall_raw, 0.0))
    exposed: Dict[str, float] = {}
    covered: List[Tuple[float, float]] = []
    for phase in ATTRIBUTION_PRIORITY:
        u = _union(ivs.get(phase, []))
        exposed[phase] = _total(_subtract(u, covered))
        covered = _union(covered + u)
    out = {f"{phase}_s": exposed[phase] for phase in REQUEST_PHASES}
    # the identity, by construction: wall_s IS the canonical
    # left-to-right sum (accountant.py's closing move, per request)
    partial = out["queue_s"]
    for phase in REQUEST_PHASES[1:]:
        partial = partial + out[f"{phase}_s"]
    out["overhead_s"] = max(max(wall_raw, 0.0) - partial, 0.0)
    out["wall_s"] = partial + out["overhead_s"]
    return out


def decompose(tr: RequestTrace) -> Optional[dict]:
    """One request's decomposition record (None without a root): the
    wall partition, the same partition restricted to the TTFT window,
    and the root's identity fields for aggregation."""
    if tr.root is None:
        return None
    try:
        r0 = float(tr.root["start"])
        wall_raw = float(tr.root["dur_s"])
    except (KeyError, TypeError, ValueError):
        return None
    out = {"trace": tr.trace, "state": tr.root.get("state"),
           "attempt": tr.root.get("attempt"),
           "tokens_out": tr.root.get("tokens_out")}
    out.update(_partition(tr.children, r0, wall_raw))
    ttft = tr.root.get("ttft_s")
    out["ttft_s"] = ttft
    if ttft is not None:
        out["ttft_parts"] = _partition(tr.children, r0, float(ttft))
    return out


def check_identity(fields: dict) -> bool:
    """Re-add a decomposition's phase fields exactly as
    :func:`_partition` did and compare with ``==`` — the digit-for-digit
    contract a json round trip must preserve."""
    try:
        partial = fields["queue_s"]
        for phase in REQUEST_PHASES[1:]:
            partial = partial + fields[f"{phase}_s"]
        return partial + fields["overhead_s"] == fields["wall_s"]
    except (KeyError, TypeError):
        return False


def _percentile(sorted_vals: Sequence[float], q: float) -> int:
    """Index of the q-quantile element (nearest-rank on the sorted
    list) — returns the INDEX so callers can fetch the whole record of
    the p99 request, not an interpolated fiction."""
    return min(int(q * (len(sorted_vals) - 1) + 0.5),
               len(sorted_vals) - 1)


@dataclasses.dataclass
class TraceReport:
    """The fleet-wide analysis: per-request decompositions, tree
    completeness, identity status, TTFT aggregates, reconciliation."""

    n_traces: int
    n_complete: int
    problems: Dict[int, List[str]]          # rid -> completeness issues
    decompositions: List[dict]
    identity_violations: List[int]          # rids failing check_identity
    untraced_terminals: List[int]           # terminal rids with no tree
    ttft: Optional[dict]                    # p50/p99 + decompositions
    reconcile: Optional[dict]               # per gp phase, both views

    @property
    def ok(self) -> bool:
        return (self.n_traces > 0
                and self.n_complete == self.n_traces
                and not self.identity_violations
                and not self.untraced_terminals
                and (self.reconcile is None
                     or all(v["match"]
                            for v in self.reconcile.values())))

    def summary(self) -> str:
        lines = [
            f"trace: {self.n_traces} request tree(s), "
            f"{self.n_complete} complete, "
            f"{len(self.identity_violations)} identity violation(s), "
            f"{len(self.untraced_terminals)} untraced terminal(s)"
        ]
        for rid, probs in sorted(self.problems.items()):
            for p in probs:
                lines.append(f"  INCOMPLETE {rid}: {p}")
        for rid in self.identity_violations:
            lines.append(f"  IDENTITY {rid}: partition does not re-add "
                         f"to wall_s")
        for rid in self.untraced_terminals:
            lines.append(f"  UNTRACED {rid}: terminal request record "
                         f"with no trace tree")
        if self.ttft is not None:
            lines.append(
                f"  ttft p50 {self.ttft['p50_s']:.6f}s  "
                f"p99 {self.ttft['p99_s']:.6f}s  "
                f"(n={self.ttft['n']})")
            parts = self.ttft.get("p99_parts")
            if parts:
                decomp = " + ".join(
                    f"{parts[f'{ph}_s']:.6f} {ph}"
                    for ph in REQUEST_PHASES
                    if ph != "decode")
                lines.append(f"  p99 ttft = {decomp} + "
                             f"{parts['overhead_s']:.6f} overhead")
            tok = self.ttft.get("decode_s_per_token")
            if tok is not None:
                lines.append(
                    f"  decode {tok:.6f} s/token over "
                    f"{self.ttft['tokens_out']} token(s)")
        if self.reconcile is not None:
            for phase, v in sorted(self.reconcile.items()):
                op = "==" if v["match"] else "!="
                lines.append(
                    f"  reconcile {phase}: trace {v['trace_s']:.6f}s "
                    f"{op} goodput {v['goodput_s']:.6f}s")
        return "\n".join(lines)


def _aggregate_ttft(decomps: Sequence[dict]) -> Optional[dict]:
    with_ttft = sorted(
        (d for d in decomps if d.get("ttft_s") is not None),
        key=lambda d: d["ttft_s"])
    if not with_ttft:
        return None
    p50 = with_ttft[_percentile([d["ttft_s"] for d in with_ttft], 0.50)]
    p99 = with_ttft[_percentile([d["ttft_s"] for d in with_ttft], 0.99)]
    out = {
        "n": len(with_ttft),
        "p50_s": p50["ttft_s"],
        "p99_s": p99["ttft_s"],
        "p99_trace": p99["trace"],
        "p99_parts": p99.get("ttft_parts"),
    }
    tokens = sum(int(d.get("tokens_out") or 0) for d in decomps)
    decode = sum(d.get("decode_s", 0.0) for d in decomps)
    out["tokens_out"] = tokens
    out["decode_s_per_token"] = (decode / tokens) if tokens else None
    return out


def _reconcile(records: Sequence[dict]) -> Optional[dict]:
    """Both views of failover/handoff badput (module docstring) — None
    when the stream carries no goodput spans to reconcile against."""
    if not any(r.get("kind") in ("run", "span") for r in records):
        return None
    twins: Dict[str, Dict[int, Set[Tuple[float, float]]]] = {
        gp: {} for gp in GP_TWIN_PHASES.values()}
    for rec in records:
        if rec.get("kind") != "trace":
            continue
        gp_phase = rec.get("gp_phase")
        if gp_phase not in twins:
            continue
        try:
            pair = (float(rec["gp_start"]), float(rec["gp_dur_s"]))
        except (KeyError, TypeError, ValueError):
            continue
        host = int(rec.get("host", 0))
        twins[gp_phase].setdefault(host, set()).add(pair)
    report = account(records)
    out = {}
    for trace_phase, gp_phase in GP_TWIN_PHASES.items():
        # mirror the accountant: per-host union totals, summed in host
        # order onto 0.0 — identical float ops, identical digits
        total = 0.0
        for host in sorted(twins[gp_phase]):
            ivs = [(s, s + max(d, 0.0))
                   for s, d in twins[gp_phase][host]]
            total += _total(_union(ivs))
        goodput = report.badput_s[gp_phase]
        out[trace_phase] = {
            "gp_phase": gp_phase,
            "trace_s": total,
            "goodput_s": goodput,
            "match": total == goodput,
        }
    return out


def analyze(records: Sequence[dict]) -> TraceReport:
    """The full pass: trees, completeness, per-request identity checked
    THROUGH a json round trip (what the gate actually promises),
    fleet-wide TTFT aggregation, goodput reconciliation."""
    records = list(records)
    traces = build_traces(records)
    problems = {rid: tr.problems for rid, tr in traces.items()
                if tr.problems}
    decomps: List[dict] = []
    identity_violations: List[int] = []
    for rid in sorted(traces):
        d = decompose(traces[rid])
        if d is None:
            continue
        round_tripped = json.loads(json.dumps(d))
        if not check_identity(round_tripped):
            identity_violations.append(rid)
        decomps.append(d)
    untraced = sorted({
        int(r["id"]) for r in records
        if r.get("kind") == "request" and r.get("terminal")
        and "id" in r and int(r["id"]) not in traces})
    return TraceReport(
        n_traces=len(traces),
        n_complete=sum(1 for tr in traces.values() if tr.complete),
        problems=problems,
        decompositions=decomps,
        identity_violations=identity_violations,
        untraced_terminals=untraced,
        ttft=_aggregate_ttft(decomps),
        reconcile=_reconcile(records),
    )
