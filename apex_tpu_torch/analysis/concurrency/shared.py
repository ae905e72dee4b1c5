"""Shared-state audit (pass 2 of 4): unguarded cross-root writes.

For every module global and ``self.*`` attribute in a rooted file, join
the root inventory against the write/read sites the model extracted:

- written from **≥2 distinct roots** with no single lock common to
  every write path → ``concurrency.unguarded-write`` (error). The
  guard check is the *must-hold* set: a lock counts only when it is
  held on every static path from the root to the write (intersection
  semantics — a lock taken on one branch proves nothing).
- one writing root with other roots reading → info, pattern named
  ``single-writer-many-reader`` (a GIL-atomic store handshake — legal,
  but it must be *deliberate*, so it surfaces for an allowlist reason);
- no writer outside construction, ≥2 reading roots → info,
  ``reads-only``.

``__init__``'s own-attribute stores are exempt (construction
happens-before the thread exists); everything else — aug-assigns,
subscript stores, in-place mutators like ``deque.append`` — counts.
The repo's two documented lock-free handshakes (autoresume's
``_pending`` identity swap, the remediation controller's GIL-atomic
deque) show up here as errors and carry ``require_hit`` allowlist
entries quoting exactly those hand-proofs — change the code, the entry
goes stale, the gate asks for a fresh proof.
"""

from __future__ import annotations

from typing import Dict, List, Set, Tuple

from apex_tpu_torch.analysis.findings import Finding, SEV_ERROR, SEV_INFO
from apex_tpu_torch.analysis.concurrency.model import Model
from apex_tpu_torch.analysis.concurrency import roots as roots_mod


def shared_state_findings(model: Model) -> List[Finding]:
    # state id -> root label -> list of (site, effective lock frozenset)
    writes: Dict[str, Dict[str, List[Tuple[str, frozenset]]]] = {}
    reads: Dict[str, Set[str]] = {}

    for root in roots_mod.concurrency_roots(model):
        # every file's implicit main root is the SAME thread — two
        # main-surface writers cannot race each other, so they collapse
        # into one logical root for the distinctness count
        label = "main" if root.kind == "main" else root.label
        entry = roots_mod.must_hold(model, root)
        for qual in roots_mod.reachable(model, root):
            fi = model.functions[qual]
            held_entry = entry.get(qual, frozenset())
            for w in fi.writes:
                if w.in_init:
                    continue
                eff = held_entry | w.locks
                writes.setdefault(w.state, {}).setdefault(
                    label, []).append(
                        (f"{fi.rel}:{w.lineno}", eff))
            for r in fi.reads:
                reads.setdefault(r.state, set()).add(label)

    findings: List[Finding] = []
    for state in sorted(set(writes) | set(reads)):
        by_root = writes.get(state, {})
        writer_roots = sorted(by_root)
        reader_roots = reads.get(state, set())
        if len(writer_roots) >= 2:
            all_sites = sorted(
                (site, locks)
                for sites in by_root.values() for site, locks in sites)
            common = None
            for _, locks in all_sites:
                common = locks if common is None else (common & locks)
            if common:
                continue            # every write path shares a lock
            first_site = all_sites[0][0]
            findings.append(Finding(
                rule="concurrency.unguarded-write",
                message=(
                    f"shared state '{state}' is written from "
                    f"{len(writer_roots)} concurrency roots with no "
                    f"common lock on every write path"
                ),
                site=first_site, severity=SEV_ERROR, target=state,
                data={"state": state,
                      "roots": ",".join(writer_roots),
                      "writes": len(all_sites)},
            ))
        elif len(writer_roots) == 1 and (reader_roots - set(writer_roots)):
            sites = by_root[writer_roots[0]]
            findings.append(Finding(
                rule="concurrency.shared-state",
                message=(
                    f"'{state}': single-writer-many-reader — written "
                    f"only from {writer_roots[0]}, read from "
                    f"{len(reader_roots - set(writer_roots))} other "
                    f"root(s); relies on GIL-atomic stores"
                ),
                site=sorted(s for s, _ in sites)[0],
                severity=SEV_INFO, target=state,
                data={"state": state,
                      "pattern": "single-writer-many-reader",
                      "writer": writer_roots[0]},
            ))
        elif not writer_roots and len(reader_roots) >= 2:
            findings.append(Finding(
                rule="concurrency.shared-state",
                message=(
                    f"'{state}': reads-only — no post-construction "
                    f"writer, read from {len(reader_roots)} roots"
                ),
                site=state.split("::")[0], severity=SEV_INFO,
                target=state,
                data={"state": state, "pattern": "reads-only"},
            ))
    return findings
