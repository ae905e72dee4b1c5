"""The autofix applier: rebuild, re-audit, repeat until clean
(counterpart of apex_tpu/analysis/autofix/apply.py).

Library ``StepTarget``s are fixable because their specs are data: the
step builders in ``targets.py`` take an injected shard spec and in-place
declaration, so applying a :class:`~.patches.Patch` is a builder call
with merged keywords, never a source edit. Each round:

1. run the pass suite over the current target (one ``StepContext``, one
   recorded step, feeds the passes, the derivation and the ledger),
2. derive prescriptions from the unsuppressed findings,
3. apply every applicable patch (one with a builder slot) by rebuilding
   the target with merged overrides,

until a round derives no applicable patch (the fixpoint, which is also
the idempotence proof: applying the final set again changes no
override) or :data:`MAX_ROUNDS` is hit, where the applier refuses rather
than loops (conflicting specs for one slot refuse at once). Prescriptions
for user code render as a unified diff (:func:`render_user_diff`) and
are left to the user.

In the port every round runs one step on every rank of the layout (the
passes' recording is a real step): call :func:`apply_fixes` on every
rank, as ``python -m apex_tpu_torch.analysis --fix`` does. The
:class:`FixReport` carries the ledger's per-axis numbers before and
after on the weight-update axis.
"""

import dataclasses
import difflib
import os
from typing import Dict, List, Optional, Sequence

from apex_tpu_torch.analysis.autofix.derive import derive_patches, update_axis
from apex_tpu_torch.analysis.autofix.patches import KIND_DONATE, KIND_SPEC, Patch
from apex_tpu_torch.analysis.findings import Allowlist, Finding, merge_findings
from apex_tpu_torch.analysis.passes import TRACE_PASSES, StepContext

__all__ = ["MAX_ROUNDS", "FixReport", "apply_fixes", "render_user_diff"]

#: the fixpoint bound: a prescription set not converged after this many
#: rebuild-and-reaudit rounds is refused, not looped (a healthy fix lands
#: in round 1 and proves itself in round 2)
MAX_ROUNDS = 4

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))


@dataclasses.dataclass
class FixReport:
    """What one ``apply_fixes`` run did to one target."""

    target: str
    applied: List[Patch] = dataclasses.field(default_factory=list)
    #: prescriptions the applier may not touch (user code / no slot)
    manual: List[Patch] = dataclasses.field(default_factory=list)
    findings_before: List[Finding] = dataclasses.field(default_factory=list)
    findings_after: List[Finding] = dataclasses.field(default_factory=list)
    #: the ledger's ``per_axis()[axis]`` before and after, on the
    #: weight-update axis
    axis: str = ""
    ledger_before: Dict = dataclasses.field(default_factory=dict)
    ledger_after: Dict = dataclasses.field(default_factory=dict)
    rounds: int = 0
    #: the fixpoint proof: the final round derived no applicable patch
    idempotent: bool = False
    refused: bool = False
    reason: str = ""
    final_target: object = None

    @property
    def clean(self) -> bool:
        """No non-info finding survives on the fixed target."""
        return all(f.severity == "info" for f in self.findings_after)

    @property
    def ok(self) -> bool:
        """Every pass clean, nothing applicable left undone, and the apply
        proven idempotent. Manual prescriptions do not fail a library
        target: they are advice, printed as diffs."""
        return self.clean and self.idempotent and not self.refused

    def describe(self) -> List[str]:
        lines = [
            f"[autofix] {self.target}: {len(self.applied)} patch(es) "
            f"applied over {self.rounds} round(s); "
            f"{len(self.manual)} manual prescription(s); "
            + ("idempotent" if self.idempotent else "NOT idempotent")
            + (f"; REFUSED: {self.reason}" if self.refused else "")
        ]
        for p in self.applied:
            lines.append(f"  applied: {p.describe()}")
        for p in self.manual:
            lines.append(f"  manual:  {p.describe()}")
        if self.axis and self.ledger_before:
            b, a = self.ledger_before, self.ledger_after or {}
            lines.append(
                f"  predicted {self.axis!r}-axis wire bytes/step: "
                f"{b.get('ici_bytes', 0)} -> {a.get('ici_bytes', 0)} "
                f"(payload {b.get('bytes', 0)} -> {a.get('bytes', 0)})")
        n_err = sum(1 for f in self.findings_after if f.severity != "info")
        lines.append(f"  residual non-info findings: {n_err} "
                     f"({'clean' if self.clean else 'NOT clean'})")
        return lines


def _run_suite(target, passes: Optional[Sequence[str]],
               allowlist: Optional[Allowlist]):
    """One audit round over one recorded step: ``(kept findings, ctx,
    ledger)``."""
    names = list(passes) if passes is not None else sorted(TRACE_PASSES)
    ctx = StepContext(target)
    raw: List[Finding] = []
    for name in names:
        raw.extend(TRACE_PASSES[name](ctx))
    merged = merge_findings(raw)
    kept = (allowlist.apply(merged, check_stale=False).findings
            if allowlist is not None else merged)
    return kept, ctx, ctx.recording.ledger


def _axis_totals(ledger, axis: str) -> Dict:
    if ledger is None or not axis:
        return {}
    return dict(ledger.per_axis().get(axis, {}))


def _merge_overrides(target, patches: Sequence[Patch]):
    """Fold applicable patches into the builder keywords: ``(overrides,
    applied, conflict reason)``; ``applied`` holds only the patches that
    change an override, and two specs for one slot conflict."""
    overrides = dict(target.build_overrides)
    applied: List[Patch] = []
    want_spec: Dict[str, Patch] = {}
    for p in patches:
        if p.kind == KIND_SPEC and p.slot:
            prev = want_spec.get(p.slot)
            if prev is not None and tuple(prev.spec) != tuple(p.spec):
                return overrides, [], (
                    f"conflicting specs for builder slot {p.slot!r}: "
                    f"{prev.spec} vs {p.spec}")
            want_spec[p.slot] = p
    for slot, p in want_spec.items():
        cur = overrides.get(slot)
        if cur is None or tuple(cur) != tuple(p.spec):
            overrides[slot] = p.spec
            applied.append(p)
    donate_adds = [p for p in patches if p.kind == KIND_DONATE and p.slot]
    if donate_adds:
        slot = donate_adds[0].slot
        cur = tuple(overrides.get(slot) or ())
        new = tuple(sorted(set(cur) | {p.argnum for p in donate_adds}))
        if new != cur:
            overrides[slot] = new
            applied.extend(p for p in donate_adds if p.argnum not in cur)
    return overrides, applied, ""


def apply_fixes(target, *, passes: Optional[Sequence[str]] = None,
                allowlist: Optional[Allowlist] = None,
                max_rounds: int = MAX_ROUNDS) -> FixReport:
    """Drive one target to its audit fixpoint (module docstring). A
    target without a ``builder`` gets every patch in ``report.manual``."""
    report = FixReport(target=target.name)
    kept, ctx, ledger = _run_suite(target, passes, allowlist)
    report.findings_before = list(kept)
    report.axis = update_axis(target.mesh, ledger) or ""
    report.ledger_before = _axis_totals(ledger, report.axis)
    report.findings_after = list(kept)
    report.ledger_after = dict(report.ledger_before)
    report.final_target = target

    for round_no in range(1, max_rounds + 1):
        patches = derive_patches(target, kept, module=ctx.recording.module,
                                 mesh=target.mesh, ledger=ledger)
        auto = [p for p in patches if p.auto and target.builder is not None]
        _merge_manual(report, [p for p in patches
                               if not (p.auto and target.builder)])
        if not auto:
            # the fixpoint: nothing applicable derives from the current
            # target, so a second apply is a no-op
            report.idempotent = True
            break
        report.rounds = round_no
        overrides, applied, conflict = _merge_overrides(target, auto)
        if conflict:
            report.refused, report.reason = True, conflict
            break
        if not applied:
            report.refused, report.reason = True, (
                f"{len(auto)} applicable prescription(s) change no builder "
                f"override — the flagged defect survives its own fix")
            break
        target = target.builder(target.device, **overrides)
        report.applied.extend(applied)
        report.final_target = target
        kept, ctx, ledger = _run_suite(target, passes, allowlist)
        report.findings_after = list(kept)
        report.ledger_after = _axis_totals(ledger, report.axis)
    else:
        report.refused = True
        report.reason = (f"no fixpoint within {max_rounds} rounds — "
                         f"prescriptions keep deriving after every rebuild")
    return report


def _merge_manual(report: FixReport, manual: Sequence[Patch]):
    seen = {(p.kind, p.argnum, p.site, str(p.spec)) for p in report.manual}
    for p in manual:
        key = (p.kind, p.argnum, p.site, str(p.spec))
        if key not in seen:
            seen.add(key)
            report.manual.append(p)


def p_site_line(p: Patch) -> int:
    _, _, line = p.site.rpartition(":")
    return int(line) if line.isdigit() else 1


def render_user_diff(patches: Sequence[Patch],
                     root: Optional[str] = None) -> str:
    """A unified diff inserting each user-code prescription at its site
    (``file.py:line``) as a comment block: printed for the user, never
    written back. A patch whose site is no source location prints as a
    one-line prescription."""
    root = root or _REPO_ROOT
    out: List[str] = []
    by_file: Dict[str, List[Patch]] = {}
    for p in patches:
        if p.slot is not None:
            continue  # applied through the builder, no diff
        path, _, line = p.site.rpartition(":")
        if path and line.isdigit() and os.path.isfile(
                os.path.join(root, path)):
            by_file.setdefault(path, []).append(p)
        else:
            out.append(f"# unapplied prescription (no source site): "
                       f"{p.describe()}")
    for path, plist in sorted(by_file.items()):
        with open(os.path.join(root, path)) as f:
            src = f.readlines()
        patched = list(src)
        # bottom-up, so earlier insertion points stay where they were
        for p in sorted(plist, key=lambda q: -p_site_line(q)):
            line_no = min(p_site_line(p), len(patched))
            indent = ""
            if 1 <= line_no <= len(patched):
                ref = patched[line_no - 1]
                indent = ref[: len(ref) - len(ref.lstrip())]
            spec = p.payload()["spec"] or "()"
            patched.insert(line_no - 1, (
                f"{indent}# autofix: {p.reason}\n"
                f"{indent}# shard x as {spec}: keep this rank's slice along "
                f"{p.axis!r},\n"
                f"{indent}# reduce-scatter its gradient and all-gather the "
                f"update (parallel_state)\n"))
        out.extend(difflib.unified_diff(src, patched, fromfile=f"a/{path}",
                                        tofile=f"b/{path}"))
    return "".join(ln if ln.endswith("\n") else ln + "\n" for ln in out)
