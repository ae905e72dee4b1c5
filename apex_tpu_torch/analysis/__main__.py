"""``python -m apex_tpu_torch.analysis`` — the port's static-analysis gate
(counterpart of apex_tpu/analysis/__main__.py).

Runs the AST lint rules over ``apex_tpu_torch/`` (its examples
included), the concurrency passes (the static race/deadlock analyzer
over the threaded host runtime; pure AST), the trace passes (precision,
host-sync, collective, donation, and the recorded-step audits
``hlo-comms``, ``hlo-sharding`` and ``hlo-memory``) over the four tiny
step targets (``targets.py``: GPT at dp 2 x tp 2, its int8 twin, BERT at
dp 2 x tp 2 and GPT at dp 2 x pp 2 with the zero-bubble schedule), each
run for one step on every rank of a spawned gloo world of 4 — on the
card by default (4 ranks on ``cuda:0``), on the CPU with ``--device
cpu``; the trace half raises without a card unless given ``--device
cpu``, as the port's other entry points do — and the profiler
trace-schema smoke (``trace_smoke.py``: a two-step capture through the
timeline analyzer, on the same device). A finding's count is the largest
any rank saw. Then it applies the documented allowlist
(``allowlist.py``). Exit status:

- 0 — clean: every finding suppressed by a reason-carrying entry and no
  entry gone stale;
- 1 — unallowlisted findings or stale allowlist entries, each listed
  with rule, site and message.

``--fix`` runs the autofix mode instead (``analysis/autofix``): for every
builder in ``targets.FIXABLE_TARGETS`` (library steps whose specs are
data; not part of the default gate, which the seeded one would fail) it
derives prescriptions from the pass findings, applies the applicable
ones by rebuilding the target with an injected shard spec and in-place
declaration, and re-audits to a bounded fixpoint, on every rank of a
spawned world of 4. User-code prescriptions print as unified diffs,
never edits. Exit 0 only when every fixed target audits clean, nothing
remains unapplied, and the apply is proven idempotent (the last round
derives no patch). With ``--json`` each prescription is appended as a
``kind="analysis"`` record carrying the ``fix=`` payload, plus a
``kind="bench"`` twin of the fixed target's predicted dp-axis wire bytes
(``_bytes``: lower is better for ``python -m
apex_tpu_torch.monitor.goodput --check``), to the file the caller names.

Flags, as JAX's: ``--verbose`` also prints suppressed findings with their
reasons; ``--json PATH`` appends every finding as a ``kind="analysis"``
record to a jsonl; ``--skip-lint`` / ``--skip-concurrency`` /
``--skip-jaxpr`` (the trace half, under JAX's name) / ``--skip-timeline``
run part of the gate; ``--target gpt|gpt-compressed|bert|gpt-pp``
restricts the trace half; ``--device`` picks its device.
"""

import argparse
import importlib
import sys

WORLD = 4


def audit_worker(rank: int, world_size: int, names, device: str):
    """One rank's findings over the targets ``names`` (in order: every
    rank builds and runs the same targets, whose collectives pair up)."""
    from apex_tpu_torch.analysis import passes as passes_mod
    from apex_tpu_torch.analysis import targets as targets_mod
    from apex_tpu_torch.parallel import parallel_state as ps

    findings = []
    for name in names:
        target = targets_mod.TARGETS[name](device)
        if rank == 0:
            print(f"auditing step target {target.name!r} (axes "
                  f"{target.axes}, {target.device})", flush=True)
        findings.extend(passes_mod.run_passes(target))
        ps.destroy_model_parallel()
    return findings


def fix_worker(rank: int, world_size: int, device: str):
    """One rank's autofix of every ``FIXABLE_TARGETS`` builder (every rank
    runs the same rounds, whose steps' collectives pair up): each
    target's report as plain data."""
    from apex_tpu_torch.analysis import allowlist as allowlist_mod
    from apex_tpu_torch.analysis import targets as targets_mod
    from apex_tpu_torch.analysis.autofix import apply_fixes, render_user_diff
    from apex_tpu_torch.parallel import parallel_state as ps

    allow = allowlist_mod.repo_allowlist()
    out = []
    for name, builder in targets_mod.FIXABLE_TARGETS.items():
        target = builder(device)
        if rank == 0:
            print(f"autofixing step target {target.name!r} (axes "
                  f"{target.axes}, {target.device})", flush=True)
        report = apply_fixes(target, allowlist=allow)
        out.append({
            "name": name, "target": target.name, "ok": report.ok,
            "lines": report.describe(),
            "diff": render_user_diff(report.manual),
            "manual": len(report.manual), "idempotent": report.idempotent,
            "reason": report.reason, "axis": report.axis,
            "ledger_before": report.ledger_before,
            "ledger_after": report.ledger_after,
            "prescriptions": [p.to_finding()
                              for p in report.applied + report.manual],
        })
        ps.destroy_model_parallel()
    return out


def fix_reports(device: str, timeout: float = 600.0):
    """:func:`fix_worker` on a spawned gloo world of :data:`WORLD` ranks:
    rank 0's reports, each ``ok`` only when every rank's is."""
    from apex_tpu_torch.transformer.testing.distributed_test_base import (
        spawn,
    )

    me = importlib.import_module("apex_tpu_torch.analysis.__main__")
    ranks = spawn(me.fix_worker, WORLD, args=(device,), timeout=timeout)
    return merge_fix_ranks(ranks)


def merge_fix_ranks(ranks):
    """Rank 0's reports, each ``ok`` only when every rank's is, and
    ``manual`` the most any rank left."""
    out = []
    for i, rep in enumerate(ranks[0]):
        out.append(dict(rep, ok=all(r[i]["ok"] for r in ranks),
                        manual=max(r[i]["manual"] for r in ranks)))
    return out


def run_fix(device: str, json_path=None) -> int:
    """The ``--fix`` leg: exit 0 iff every fixed target ends clean, with no
    prescription unapplied, and idempotent."""
    from apex_tpu_torch.analysis import allowlist as allowlist_mod

    allow = allowlist_mod.repo_allowlist()
    ok = True
    records = []
    for rep in fix_reports(device):
        for line in rep["lines"]:
            print(line, flush=True)
        if rep["diff"]:
            print(rep["diff"], flush=True)
        if not rep["ok"] or rep["manual"]:
            ok = False
            why = rep["reason"] or (
                f"{rep['manual']} prescription(s) remain unapplied"
                if rep["manual"] else
                ("apply did not reach a clean fixpoint"
                 if not rep["idempotent"] else "residual findings"))
            print(f"[autofix] {rep['name']}: FAILED — {why}", flush=True)
        if json_path:
            records.extend(allow.apply(rep["prescriptions"],
                                       check_stale=False).to_records())
            if rep["axis"] and rep["ledger_after"]:
                from apex_tpu_torch.monitor.router import make_record

                records.append(make_record(
                    "bench", 0,
                    metric=(f"autofix_{rep['target'].replace('-', '_')}_"
                            f"{rep['axis']}_ici_bytes"),
                    value=float(rep["ledger_after"].get("ici_bytes", 0)),
                    unit="B",
                    platform="gpu" if device.startswith("cuda") else "cpu"))
    if json_path and records:
        from apex_tpu_torch.monitor.router import JsonlSink

        sink = JsonlSink(json_path)
        for rec in records:
            sink.emit(rec)
        sink.close()
    return 0 if ok else 1


def merge_ranks(by_rank):
    """Every rank's findings as one list: each finding once, its count
    the largest of any rank's."""
    merged = {}
    for findings in by_rank:
        for f in findings:
            prev = merged.get(f.key)
            if prev is None or f.count > prev.count:
                merged[f.key] = f
    return list(merged.values())


def trace_findings(names, device: str, timeout: float = 600.0):
    """The trace passes over ``names`` on a spawned gloo world of
    :data:`WORLD` ranks (:func:`audit_worker`, :func:`merge_ranks`)."""
    from apex_tpu_torch.transformer.testing.distributed_test_base import (
        spawn,
    )

    # a spawned child does not re-import a package's __main__
    me = importlib.import_module("apex_tpu_torch.analysis.__main__")
    return merge_ranks(spawn(me.audit_worker, WORLD,
                             args=(list(names), device), timeout=timeout))


def ast_findings(lint: bool = True, concurrency: bool = True):
    """The AST halves' findings: the lint rules and the concurrency passes
    over the whole package (pure AST, no device)."""
    findings = []
    if lint:
        from apex_tpu_torch.analysis import lint as lint_mod

        findings.extend(lint_mod.run_lint())
    if concurrency:
        from apex_tpu_torch.analysis.concurrency import run_concurrency

        findings.extend(run_concurrency())
    return findings


def gate(trace=(), lint: bool = True, concurrency: bool = True,
         verbose: bool = False, json_path=None, ast=None):
    """The AST halves (unless skipped; ``ast``: their findings, already
    made by :func:`ast_findings`) with the ``trace`` findings, through the
    repo allowlist: ``(exit status, the report's text)``. A stale entry
    counts only when both whole-package scans ran (a ``require_hit``
    entry trivially suppresses nothing when its rule did not)."""
    from apex_tpu_torch.analysis import allowlist as allowlist_mod

    findings = list(trace) + list(
        ast if ast is not None else ast_findings(lint, concurrency))
    result = allowlist_mod.repo_allowlist().apply(
        findings, check_stale=lint and concurrency)
    if json_path:
        from apex_tpu_torch.monitor.router import JsonlSink

        sink = JsonlSink(json_path)
        for rec in result.to_records():
            sink.emit(rec)
        sink.close()
    return (0 if result.ok else 1), result.format(verbose=verbose)


def main(argv=None) -> int:
    from apex_tpu_torch.analysis.targets import TARGETS

    parser = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.analysis",
        description="static analysis: trace passes + AST lint",
    )
    parser.add_argument("--verbose", "-v", action="store_true",
                        help="also print allowlisted findings with reasons")
    parser.add_argument("--json", default=None,
                        help="append kind='analysis' records to this jsonl")
    parser.add_argument("--skip-lint", action="store_true",
                        help="skip the AST lint rules")
    parser.add_argument("--skip-jaxpr", action="store_true",
                        help="skip the trace passes over the step targets")
    parser.add_argument("--skip-timeline", action="store_true",
                        help="skip the profiler trace-schema smoke check")
    parser.add_argument("--skip-concurrency", action="store_true",
                        help="skip the static race/deadlock passes over "
                             "the threaded host runtime")
    parser.add_argument("--target", choices=tuple(TARGETS), default=None,
                        help="audit only one step target")
    parser.add_argument("--device", default="cuda",
                        help="the trace half's device (default cuda)")
    parser.add_argument("--fix", action="store_true",
                        help="autofix mode: derive and apply prescriptions "
                             "for the fixable step builders to a bounded "
                             "fixpoint (see module docstring)")
    args = parser.parse_args(argv)

    from apex_tpu_torch._kernels import resolve_device

    if args.fix:
        return run_fix(str(resolve_device(args.device)), args.json)

    trace = []
    if not args.skip_jaxpr:
        device = str(resolve_device(args.device))
        names = [args.target] if args.target else list(TARGETS)
        trace = trace_findings(names, device)
    if not args.skip_timeline:
        from apex_tpu_torch.analysis.trace_smoke import (
            timeline_smoke_findings,
        )

        print("timeline trace-schema smoke (2-step capture)", flush=True)
        trace = list(trace) + timeline_smoke_findings(
            str(resolve_device(args.device)))
    rc, report = gate(trace, lint=not args.skip_lint,
                      concurrency=not args.skip_concurrency,
                      verbose=args.verbose, json_path=args.json)
    print(report, flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
