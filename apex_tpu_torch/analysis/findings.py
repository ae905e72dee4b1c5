"""Structured findings + reason-carrying allowlist for static analysis.

Counterpart of apex_tpu/analysis/findings.py. Every auditor in
``apex_tpu_torch.analysis`` — the trace passes (precision,
collective-safety, host-sync) and the AST/token lint rules —
reports through the same :class:`Finding` record, so one consumer (the
CLI, a test, a jsonl tailer) handles them all uniformly:

    Finding(rule="precision.promotion",
            site="apex_tpu_torch/ops/layer_norm.py:36",
            message="bfloat16 -> float32", ...)

``rule`` is a dotted id (``<pass>.<check>``); ``site`` is a repo-relative
``file.py:line`` (trace findings resolve it from the recorded op's
Python stack, lint findings from the scanned file); ``target`` names
the audited step for trace findings ("" for lint).

Suppression is by :class:`Allowlist` only, and every entry CARRIES ITS
REASON — a bare "this is fine" entry is a constructor error. The repo's
own entries live in ``apex_tpu_torch/analysis/allowlist.py``; an entry that no
longer suppresses anything is reported stale (``require_hit=True``), the
same no-rot contract as the registered-taps lint.

Findings export to the shared telemetry schema as ``kind="analysis"``
records (:func:`to_records` -> ``monitor.MetricRouter``), so analysis
results can join the metrics/anomaly/comms stream in one jsonl.
"""

import dataclasses
import fnmatch
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

SEV_ERROR = "error"
SEV_WARNING = "warning"
SEV_INFO = "info"
_SEVERITIES = (SEV_ERROR, SEV_WARNING, SEV_INFO)

__all__ = [
    "Finding",
    "AllowlistEntry",
    "Allowlist",
    "AnalysisResult",
    "SEV_ERROR",
    "SEV_WARNING",
    "SEV_INFO",
]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One defect (or intentional-but-flagged construct) an auditor found.

    ``data`` carries rule-specific structured fields (dtypes, argument
    paths, permutation edges) so tests can assert exact values instead of
    parsing messages. ``count`` folds repeated occurrences of the same
    (rule, site, data) — e.g. one cast line traced once per layer.
    """

    rule: str
    message: str
    site: str = ""
    severity: str = SEV_ERROR
    target: str = ""
    count: int = 1
    data: dict = dataclasses.field(default_factory=dict)
    #: a machine-applicable prescription attached to the finding (the
    #: autofix Patch serialized: kind, argnum/leaf, spec, site, reason,
    #: predicted wire-byte delta). None for plain diagnostics; consumers
    #: that only read ``data`` are unaffected.
    fix: Optional[dict] = None

    def __post_init__(self):
        if self.severity not in _SEVERITIES:
            raise ValueError(
                f"severity must be one of {_SEVERITIES}, got {self.severity!r}"
            )

    @property
    def key(self) -> Tuple:
        """Aggregation identity: same rule at the same site with the same
        structured data (and fix payload) is the same finding (counts
        add)."""
        return (
            self.rule, self.site, self.target,
            tuple(sorted((k, str(v)) for k, v in self.data.items())),
            str(self.fix) if self.fix else "",
        )

    def format(self) -> str:
        mult = f" x{self.count}" if self.count > 1 else ""
        tgt = f" [{self.target}]" if self.target else ""
        return (
            f"{self.severity:7s} {self.rule:28s} {self.site}{tgt}: "
            f"{self.message}{mult}"
        )


def merge_findings(findings: Iterable[Finding]) -> List[Finding]:
    """Fold findings with the same :attr:`Finding.key`, summing counts."""
    merged: Dict[Tuple, Finding] = {}
    for f in findings:
        prev = merged.get(f.key)
        if prev is None:
            merged[f.key] = f
        else:
            merged[f.key] = dataclasses.replace(
                prev, count=prev.count + f.count
            )
    return list(merged.values())


@dataclasses.dataclass(frozen=True)
class AllowlistEntry:
    """One documented suppression.

    - ``rule``: exact rule id, or a ``"prefix.*"`` glob.
    - ``match``: glob matched against the finding's ``site`` (a plain
      substring also works — it is wrapped in ``*...*``).
    - ``reason``: REQUIRED human explanation of why the flagged construct
      is intentional. Empty/whitespace reasons are a constructor error —
      the allowlist is documentation, not a mute button.
    - ``require_hit``: entries guarding a complete scan (the AST lint
      rules see every file every run) must keep suppressing something;
      when they stop, the entry is stale and reported. Trace-pass entries
      default False: whether they fire depends on which step was traced.
    - ``data``: items the finding's ``data`` must also hold (the port's
      addition: a host-sync entry names the ``method`` of its one wait),
      so an entry covers one construct and not another at its site.
    """

    rule: str
    match: str
    reason: str
    require_hit: bool = False
    data: Optional[Dict[str, Any]] = dataclasses.field(default=None,
                                                       hash=False)

    def __post_init__(self):
        if not self.rule.strip():
            raise ValueError("allowlist entry needs a rule id")
        if not self.match.strip():
            raise ValueError(f"allowlist entry for {self.rule!r} needs a match")
        if not self.reason.strip():
            raise ValueError(
                f"allowlist entry {self.rule!r}/{self.match!r} has no reason "
                f"— bare entries are not allowed; say WHY it is intentional"
            )

    def matches(self, finding: Finding) -> bool:
        if self.rule.endswith(".*"):
            if not finding.rule.startswith(self.rule[:-1]):
                return False
        elif finding.rule != self.rule:
            return False
        pat = self.match if any(c in self.match for c in "*?[") else (
            f"*{self.match}*"
        )
        if self.data and any(finding.data.get(k) != v
                             for k, v in self.data.items()):
            return False
        return fnmatch.fnmatch(finding.site, pat)


@dataclasses.dataclass
class AnalysisResult:
    """The outcome of applying an :class:`Allowlist` to raw findings."""

    findings: List[Finding]  # NOT allowlisted — these fail the run
    suppressed: List[Tuple[Finding, AllowlistEntry]]
    stale_entries: List[AllowlistEntry]

    @property
    def ok(self) -> bool:
        """Clean = no error/warning findings and no stale entries. Info
        findings (e.g. a donation audit that could not map parameters)
        are advisory: printed, never failing."""
        return not self.stale_entries and not any(
            f.severity != SEV_INFO for f in self.findings
        )

    def format(self, verbose: bool = False) -> str:
        lines = []
        for f in sorted(self.findings, key=lambda f: (f.rule, f.site)):
            lines.append(f.format())
        if verbose:
            for f, entry in sorted(
                self.suppressed, key=lambda p: (p[0].rule, p[0].site)
            ):
                lines.append(f"allowed {f.rule:28s} {f.site}: {entry.reason}")
        for entry in self.stale_entries:
            lines.append(
                f"stale   allowlist entry {entry.rule!r} / {entry.match!r} "
                f"suppressed nothing — remove it or restore the construct"
            )
        n_err = sum(1 for f in self.findings)
        lines.append(
            f"analysis: {n_err} finding(s), {len(self.suppressed)} "
            f"allowlisted, {len(self.stale_entries)} stale entr"
            f"{'y' if len(self.stale_entries) == 1 else 'ies'}"
        )
        return "\n".join(lines)

    def to_records(self, step: int = 0) -> List[dict]:
        """``kind="analysis"`` records in the shared MetricRouter schema
        (router.py module docstring) — one per finding, suppressed ones
        flagged with their reason."""
        from apex_tpu_torch.monitor.router import make_record

        records = []
        for f in self.findings:
            extra = {f"data_{k}": v for k, v in f.data.items()}
            if f.fix is not None:
                extra["fix"] = f.fix
            records.append(make_record(
                "analysis", step, rule=f.rule, site=f.site, target=f.target,
                severity=f.severity, message=f.message, count=f.count,
                allowed=False, **extra,
            ))
        for f, entry in self.suppressed:
            extra = {"fix": f.fix} if f.fix is not None else {}
            records.append(make_record(
                "analysis", step, rule=f.rule, site=f.site, target=f.target,
                severity=f.severity, message=f.message, count=f.count,
                allowed=True, reason=entry.reason, **extra,
            ))
        return records


class Allowlist:
    """An ordered set of :class:`AllowlistEntry` applied to findings."""

    def __init__(self, entries: Sequence[AllowlistEntry] = ()):
        self.entries = list(entries)

    def __len__(self) -> int:
        return len(self.entries)

    def extended(self, entries: Sequence[AllowlistEntry]) -> "Allowlist":
        return Allowlist(self.entries + list(entries))

    def match(self, finding: Finding) -> Optional[AllowlistEntry]:
        for entry in self.entries:
            if entry.matches(finding):
                return entry
        return None

    def apply(
        self, findings: Iterable[Finding], check_stale: bool = True
    ) -> AnalysisResult:
        """Partition findings into kept/suppressed and detect stale
        ``require_hit`` entries. ``check_stale=False`` when the findings
        come from a partial run (a single pass or target) where an entry
        legitimately has nothing to suppress."""
        kept: List[Finding] = []
        suppressed: List[Tuple[Finding, AllowlistEntry]] = []
        hits = {id(e): 0 for e in self.entries}
        for f in merge_findings(findings):
            entry = self.match(f)
            if entry is None:
                kept.append(f)
            else:
                suppressed.append((f, entry))
                hits[id(entry)] += 1
        stale = [
            e for e in self.entries
            if check_stale and e.require_hit and hits[id(e)] == 0
        ]
        return AnalysisResult(kept, suppressed, stale)
