"""Lock-order graph + blocking-under-lock (pass 3 of 4).

Two hazards, both **root-independent** (any function may be entered
from any thread; the hazards are structural properties of the lock
discipline, not of one interleaving):

- ``concurrency.lock-cycle`` (error): build the directed graph
  *lock A → lock B* for every acquisition of B while A may be held
  (locally, or inherited from any caller — a may-hold union fixpoint
  over the internal call graph). Any cycle is an ordering inversion
  two threads can deadlock on; a self-edge on a non-reentrant lock is
  the single-thread variant. Reentrant self-edges (RLock) are legal
  and skipped — that's the router's SIGTERM-reentrancy design.
- ``concurrency.blocking-under-lock`` (warning): a call that can block
  indefinitely — unbounded ``.join()``/``.wait()``, orbax
  ``wait_until_finished``, ``time.sleep``, file/subprocess I/O, a
  router/sink emit fan-out, an ``import`` statement (the interpreter
  import lock) — executed while any lock may be held. This is the
  PR-9 responder-stall shape: the lock's critical section inherits the
  latency (and, for the import lock, the deadlock potential) of the
  slow operation.

Plus ``concurrency.unbounded-wait`` (warning, lock-independent): a
``.wait()`` with no timeout on an unresolvable receiver, or ANY wait on
an inline-constructed ``threading.Event()`` — an event nobody else
holds a reference to, so nobody can ever ``set()`` it (the chaos
``wedge`` is exactly this, deliberately, and carries the allowlist
entry saying so).
"""

from __future__ import annotations

from typing import Dict, FrozenSet, List, Set, Tuple

from apex_tpu_torch.analysis.findings import Finding, SEV_ERROR, SEV_WARNING
from apex_tpu_torch.analysis.concurrency.model import CallSite, Model

#: dotted external calls that can block indefinitely (or for I/O time)
_BLOCKING_DOTTED = frozenset({
    "time.sleep", "subprocess.run", "subprocess.call",
    "subprocess.check_call", "subprocess.check_output",
    "subprocess.Popen", "os.makedirs", "os.replace", "os.rename",
    "os.remove", "os.unlink", "shutil.rmtree", "socket.create_connection",
})

#: attribute names that mark a router/metrics fan-out when the receiver
#: text names a router or sink — the emit path serializes arbitrary
#: sink I/O, so calling it under an unrelated lock extends that lock's
#: critical section by the slowest sink
_EMIT_ATTRS = frozenset({"emit", "event", "metrics"})


def _blocking_op(cs: CallSite) -> str:
    """Non-empty label when the call site can block; '' otherwise.
    Internal calls never match — their bodies are walked directly, so
    transitive blocking is found at the real blocking site with the
    caller's locks folded in by the may-hold propagation."""
    if cs.kind == "internal":
        return ""
    if cs.dotted in _BLOCKING_DOTTED:
        return cs.dotted
    if cs.dotted == "open" or cs.text == "open":
        return "open"
    if cs.attr == "join" and cs.nargs == 0:
        return f"{cs.text}() [unbounded join]"
    if cs.attr == "wait" and cs.nargs == 0:
        return f"{cs.text}() [unbounded wait]"
    if cs.attr == "wait_until_finished":
        return f"{cs.text}() [checkpoint wait]"
    if cs.attr in _EMIT_ATTRS and any(
            t in cs.recv_text.lower() for t in ("router", "sink")):
        return f"{cs.text}(...) [router fan-out]"
    return ""


def _may_hold_entry(model: Model) -> Dict[str, FrozenSet[str]]:
    """Union-over-callers fixpoint: the lock set that MAY be held at
    each function's entry, seeding every function as a potential thread
    entry point with nothing held."""
    entry: Dict[str, Set[str]] = {q: set() for q in model.functions}
    changed = True
    while changed:
        changed = False
        for qual, fi in model.functions.items():
            src = entry[qual]
            for cs in fi.calls:
                if cs.kind != "internal" or \
                        cs.resolved not in model.functions:
                    continue
                add = src | cs.locks
                tgt = entry[cs.resolved]
                if not add <= tgt:
                    tgt |= add
                    changed = True
    return {q: frozenset(s) for q, s in entry.items()}


def lock_order_findings(model: Model) -> List[Finding]:
    entry = _may_hold_entry(model)
    # lock digraph: held -> acquired, with one witness site per edge
    edges: Dict[Tuple[str, str], str] = {}
    findings: List[Finding] = []
    for qual in sorted(model.functions):
        fi = model.functions[qual]
        for lock_id, lineno, local_held in fi.acquires:
            held = entry[qual] | local_held
            site = f"{fi.rel}:{lineno}"
            for h in sorted(held):
                if h == lock_id:
                    if not model.locks[lock_id].reentrant:
                        findings.append(Finding(
                            rule="concurrency.lock-cycle",
                            message=(
                                f"re-acquisition of non-reentrant lock "
                                f"'{lock_id}' while it may already be "
                                f"held — single-thread self-deadlock"
                            ),
                            site=site, severity=SEV_ERROR,
                            target=lock_id,
                            data={"cycle": f"{lock_id} -> {lock_id}"},
                        ))
                    continue
                edges.setdefault((h, lock_id), site)

    findings.extend(_cycles(edges))
    return findings


def _cycles(edges: Dict[Tuple[str, str], str]) -> List[Finding]:
    """One finding per elementary cycle in the (tiny) lock digraph,
    canonicalized by rotating the cycle to start at its smallest lock
    id so the same cycle never reports twice."""
    graph: Dict[str, List[str]] = {}
    for (a, b) in edges:
        graph.setdefault(a, []).append(b)
    seen_cycles: Set[Tuple[str, ...]] = set()
    findings: List[Finding] = []

    def dfs(start: str, node: str, path: List[str],
            on_path: Set[str]) -> None:
        for nxt in sorted(graph.get(node, ())):
            if nxt == start:
                cyc = path[:]
                i = cyc.index(min(cyc))
                canon = tuple(cyc[i:] + cyc[:i])
                if canon in seen_cycles:
                    continue
                seen_cycles.add(canon)
                chain = " -> ".join(canon + (canon[0],))
                witness = edges.get((path[-1], start)) or \
                    edges.get((canon[-1], canon[0]), "")
                findings.append(Finding(
                    rule="concurrency.lock-cycle",
                    message=(
                        f"lock-order cycle {chain}: two threads taking "
                        f"these locks in opposite order deadlock"
                    ),
                    site=witness, severity=SEV_ERROR,
                    target=canon[0],
                    data={"cycle": chain},
                ))
            elif nxt not in on_path:
                dfs(start, nxt, path + [nxt], on_path | {nxt})

    for start in sorted(graph):
        dfs(start, start, [start], {start})
    return findings


def blocking_findings(model: Model) -> List[Finding]:
    entry = _may_hold_entry(model)
    findings: List[Finding] = []
    seen: Set[Tuple[str, str]] = set()
    for qual in sorted(model.functions):
        fi = model.functions[qual]
        may = entry[qual]
        for cs in fi.calls:
            held = may | cs.locks
            site = f"{fi.rel}:{cs.lineno}"
            if held:
                op = _blocking_op(cs)
                if op and (site, op) not in seen:
                    seen.add((site, op))
                    findings.append(Finding(
                        rule="concurrency.blocking-under-lock",
                        message=(
                            f"{op} while holding "
                            f"{{{', '.join(sorted(held))}}} — the "
                            f"critical section inherits this call's "
                            f"worst-case latency"
                        ),
                        site=site, severity=SEV_WARNING,
                        target=sorted(held)[0],
                        data={"op": op,
                              "locks": ",".join(sorted(held))},
                    ))
            # unbounded wait: unsettable inline Event, or a no-timeout
            # wait on an unresolved receiver (lock-independent)
            if cs.attr == "wait" and cs.kind != "internal" and (
                    cs.inline_event or cs.nargs == 0):
                key = (site, "unbounded-wait")
                if key in seen:
                    continue
                seen.add(key)
                why = ("wait on an inline-constructed threading.Event() "
                       "that nothing can ever set()"
                       if cs.inline_event else
                       "wait() with no timeout")
                findings.append(Finding(
                    rule="concurrency.unbounded-wait",
                    message=f"{cs.text}(...): {why}",
                    site=site, severity=SEV_WARNING,
                    data={"op": ("Event.wait" if cs.inline_event
                                 else "wait")},
                ))
        for imp in fi.imports_under_lock:
            held = may | imp.locks
            if not held:
                continue
            site = f"{fi.rel}:{imp.lineno}"
            if (site, "import") in seen:
                continue
            seen.add((site, "import"))
            findings.append(Finding(
                rule="concurrency.blocking-under-lock",
                message=(
                    f"import of '{imp.module}' while holding "
                    f"{{{', '.join(sorted(held))}}} — first import "
                    f"runs arbitrary module code under BOTH this lock "
                    f"and the interpreter import lock"
                ),
                site=site, severity=SEV_WARNING,
                target=sorted(held)[0],
                data={"op": f"import {imp.module}",
                      "locks": ",".join(sorted(held))},
            ))
    return findings
