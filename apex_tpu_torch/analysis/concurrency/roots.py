"""Thread-root inventory + best-effort call graph (pass 1 of 4).

Every way host code leaves the main thread is a **concurrency root**:
``threading.Thread``/``Timer`` constructions, executor ``.submit``,
``signal.signal`` handlers, ``atexit.register`` hooks, and callback
escapes (an internal function reference handed to a deferred-execution
API — see model.py's DEFERRED_CALL_NAMES). Rooted files additionally
carry an implicit **main root** over their public surface, because
"the training loop calls ``beat()`` while ``_run`` polls" is exactly
the two-root interleaving the shared-state audit must see.

From each root this pass walks the resolved internal call graph. The
honesty contract of the whole x-ray lives here: any call the resolver
could NOT follow (a ``fn()`` on a local callable, an ambiguous
attribute like this repo's many ``emit``/``event`` methods, a restored
handler variable) is reported as ``concurrency.unresolved`` **info**
rather than silently dropped — the gate's jsonl stays an explicit
record of where the static story has holes, and each hole carries an
allowlist reason (see allowlist.py ``_CONCURRENCY``).
"""

from __future__ import annotations

from typing import Dict, FrozenSet, Iterable, List, Optional, Set

from apex_tpu_torch.analysis.findings import Finding, SEV_INFO
from apex_tpu_torch.analysis.concurrency.model import Model, Root

#: max call-graph depth walked from a root (cycle-safe via visited set;
#: the cap only bounds pathological synthetic inputs)
_MAX_DEPTH = 64


def reachable(model: Model, root: Root) -> Set[str]:
    """Qualnames of every function reachable from ``root`` through
    resolved internal edges (the root targets themselves included)."""
    seen: Set[str] = set()
    work = [(t, 0) for t in root.targets if t in model.functions]
    while work:
        qual, depth = work.pop()
        if qual in seen or depth > _MAX_DEPTH:
            continue
        seen.add(qual)
        fi = model.functions.get(qual)
        if fi is None:
            continue
        for cs in fi.calls:
            if cs.kind == "internal" and cs.resolved in model.functions:
                work.append((cs.resolved, depth + 1))
    return seen


def must_hold(model: Model, root: Root) -> Dict[str, FrozenSet[str]]:
    """Per-function entry lock set that is held on EVERY path from
    ``root`` (intersection over call sites — the guard the shared-state
    audit checks writes against). Worklist fixpoint; monotone down."""
    entry: Dict[str, FrozenSet[str]] = {
        t: frozenset() for t in root.targets if t in model.functions}
    work = [t for t in entry]
    while work:
        qual = work.pop()
        fi = model.functions.get(qual)
        if fi is None:
            continue
        here = entry[qual]
        for cs in fi.calls:
            if cs.kind != "internal" or cs.resolved not in model.functions:
                continue
            new = here | cs.locks
            old = entry.get(cs.resolved)
            upd = new if old is None else (old & new)
            if old is None or upd != old:
                entry[cs.resolved] = upd
                work.append(cs.resolved)
    return entry


def concurrency_roots(model: Model,
                      kinds: Optional[Iterable[str]] = None) -> List[Root]:
    """The inventory, optionally filtered by kind; ``main`` roots last
    so per-root walks process real concurrency first."""
    roots = [r for r in model.roots
             if kinds is None or r.kind in kinds]
    return sorted(roots, key=lambda r: (r.kind == "main", r.label))


def unresolved_findings(model: Model) -> List[Finding]:
    """``concurrency.unresolved`` info for every dynamic call reachable
    from a NON-main root, plus every registration whose handler/target
    expression could not be resolved."""
    findings: List[Finding] = []
    seen_sites: Set[str] = set()
    for root in concurrency_roots(model):
        if root.kind == "main":
            continue
        for qual in sorted(reachable(model, root)):
            fi = model.functions[qual]
            for cs in fi.calls:
                if cs.kind != "dynamic":
                    continue
                site = f"{fi.rel}:{cs.lineno}"
                if site in seen_sites:
                    continue
                seen_sites.add(site)
                findings.append(Finding(
                    rule="concurrency.unresolved",
                    message=(
                        f"call '{cs.text}(...)' reachable from "
                        f"{root.label} could not be statically resolved "
                        f"— the concurrency audit cannot follow it"
                    ),
                    site=site, severity=SEV_INFO,
                    target=root.label,
                    data={"callee": cs.text},
                ))
    for rel, lineno, text in model.unresolved_roots:
        site = f"{rel}:{lineno}"
        if site in seen_sites:
            continue
        seen_sites.add(site)
        findings.append(Finding(
            rule="concurrency.unresolved",
            message=(
                f"concurrency-root registration with unresolvable "
                f"target: {text}"
            ),
            site=site, severity=SEV_INFO,
            data={"callee": text},
        ))
    return sorted(findings, key=lambda f: f.site)
