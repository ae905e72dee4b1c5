"""Handler-safety (pass 4 of 4): signal handlers and atexit hooks.

A signal handler preempts whatever the main thread was doing — possibly
mid-critical-section — and an atexit hook runs during interpreter
teardown while daemon threads still hold locks. Both are therefore
restricted to an **async-signal-safe vocabulary**: flag stores,
timestamping (``time.monotonic``/``time.time``), ``os._exit``/
``os.kill``/``os.getpid``, and handler re-registration
(``signal.signal``). Anything that can re-enter a lock another thread
holds — an explicit acquisition, a blocking call, logging (which takes
the logging module lock), or a call the resolver cannot follow at all —
is ``concurrency.handler-unsafe`` (error).

The repo's two registrants are exactly the interesting cases: the
autoresume flag-only handler *chains the previous handler* (a dynamic
call — safe only because the chain is coordinated to flag-style
handlers, which is the allowlist entry's documented reason), and the
router teardown flushes sinks under its own RLock (safe only because
that lock is reentrant and every flush path tolerates partial state —
again, the entry quotes the proof). Change either body and the
``require_hit`` entry goes stale, forcing the proof to be re-made.
"""

from __future__ import annotations

from typing import List, Set, Tuple

from apex_tpu_torch.analysis.findings import Finding, SEV_ERROR
from apex_tpu_torch.analysis.concurrency.model import CallSite, Model
from apex_tpu_torch.analysis.concurrency import roots as roots_mod
from apex_tpu_torch.analysis.concurrency.lockgraph import _blocking_op

#: external dotted calls a handler may make
_SAFE_DOTTED = frozenset({
    "time.monotonic", "time.time", "time.perf_counter",
    "time.monotonic_ns", "time.time_ns",
    "os._exit", "os.kill", "os.getpid",
    "signal.signal", "signal.getsignal", "signal.Signals",
    "sys.stderr.write", "sys.stdout.write",
})

#: benign receiver methods (pure reads / GIL-atomic container ops)
_SAFE_ATTRS = frozenset({
    "get", "items", "keys", "values", "copy", "append", "add",
    "discard", "pop", "popleft", "clear", "set", "is_set", "monotonic",
    "startswith", "endswith", "strip", "split", "join", "format",
    "getsignal", "signal",
})


def _violation(cs: CallSite) -> Tuple[str, str]:
    """(cause, detail) when the call is outside the safe vocabulary;
    ("", "") when it is fine. Internal calls are fine here — their
    bodies are walked by the same reach."""
    if cs.kind == "internal":
        return "", ""
    op = _blocking_op(cs)
    if op:
        return "blocking", op
    if cs.attr and cs.attr in _SAFE_ATTRS:
        return "", ""    # benign receiver method, resolvable or not
    if cs.kind == "dynamic":
        return "dynamic-call", f"{cs.text}(...)"
    if cs.dotted in _SAFE_DOTTED or cs.text in _SAFE_DOTTED:
        return "", ""
    if cs.dotted and (cs.dotted.split(".")[0] in ("logging",)
                      or cs.dotted.startswith("logger.")
                      or cs.recv_text == "logger"):
        return "unsafe-call", f"{cs.dotted} (logging takes a module lock)"
    if cs.attr and cs.attr in _SAFE_ATTRS:
        return "", ""
    if cs.dotted and "." not in cs.dotted:
        return "", ""                    # bare builtins (len, sorted, ...)
    return "unsafe-call", cs.dotted or cs.text


def handler_findings(model: Model) -> List[Finding]:
    findings: List[Finding] = []
    seen: Set[Tuple[str, str, str]] = set()
    for root in roots_mod.concurrency_roots(model, kinds=("signal",
                                                          "atexit")):
        for qual in sorted(roots_mod.reachable(model, root)):
            fi = model.functions[qual]
            for lock_id, lineno, _held in fi.acquires:
                key = (root.label, f"{fi.rel}:{lineno}", "lock")
                if key in seen:
                    continue
                seen.add(key)
                findings.append(Finding(
                    rule="concurrency.handler-unsafe",
                    message=(
                        f"{root.kind} handler reach acquires lock "
                        f"'{lock_id}' — deadlocks if the interrupted "
                        f"thread holds it"
                    ),
                    site=f"{fi.rel}:{lineno}", severity=SEV_ERROR,
                    target=root.label,
                    data={"handler": root.targets[0] if root.targets
                          else "", "cause": "lock", "detail": lock_id},
                ))
            for cs in fi.calls:
                cause, detail = _violation(cs)
                if not cause:
                    continue
                key = (root.label, f"{fi.rel}:{cs.lineno}", cause)
                if key in seen:
                    continue
                seen.add(key)
                findings.append(Finding(
                    rule="concurrency.handler-unsafe",
                    message=(
                        f"{root.kind} handler reach: {detail} is "
                        f"outside the async-signal-safe vocabulary "
                        f"({cause})"
                    ),
                    site=f"{fi.rel}:{cs.lineno}", severity=SEV_ERROR,
                    target=root.label,
                    data={"handler": root.targets[0] if root.targets
                          else "", "cause": cause, "detail": detail},
                ))
    return findings
