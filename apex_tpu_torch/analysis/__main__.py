"""``python -m apex_tpu_torch.analysis`` — the port's static-analysis gate
(counterpart of apex_tpu/analysis/__main__.py).

Runs the AST lint rules over ``apex_tpu_torch/`` (its examples
included), the concurrency passes (the static race/deadlock analyzer
over the threaded host runtime; pure AST), and the trace passes
(precision, host-sync, collective) over the four tiny step targets
(``targets.py``: GPT at dp 2 x tp 2, its int8 twin, BERT at dp 2 x tp 2
and GPT at dp 2 x pp 2 with the zero-bubble schedule), each run for one
step on every rank of a spawned gloo world of 4 — on the card by
default (4 ranks on ``cuda:0``), on the CPU with ``--device cpu``; the
trace half raises without a card unless given ``--device cpu``, as the
port's other entry points do. A finding's count is the largest any rank
saw. Then it applies the documented allowlist (``allowlist.py``). Exit
status:

- 0 — clean: every finding suppressed by a reason-carrying entry and no
  entry gone stale;
- 1 — unallowlisted findings or stale allowlist entries, each listed
  with rule, site and message;
- 2 — ``--fix``, which waits for autofix (ROADMAP item 9c).

Flags, as JAX's: ``--verbose`` also prints suppressed findings with their
reasons; ``--json PATH`` appends every finding as a ``kind="analysis"``
record to a jsonl; ``--skip-lint`` / ``--skip-concurrency`` /
``--skip-jaxpr`` (the trace half, under JAX's name) run part of the
gate; ``--skip-timeline`` is accepted and does nothing until the
timeline smoke is ported (item 9c); ``--target gpt|gpt-compressed|bert|
gpt-pp`` restricts the trace half; ``--device`` picks its device.
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
                        help="accepted; the timeline smoke waits for "
                             "ROADMAP item 9c")
    parser.add_argument("--skip-concurrency", action="store_true",
                        help="skip the static race/deadlock passes over "
                             "the threaded host runtime")
    parser.add_argument("--target", choices=tuple(TARGETS), default=None,
                        help="audit only one step target")
    parser.add_argument("--device", default="cuda",
                        help="the trace half's device (default cuda)")
    parser.add_argument("--fix", action="store_true",
                        help="autofix mode (not ported: ROADMAP item 9c)")
    args = parser.parse_args(argv)

    if args.fix:
        print("--fix: autofix is not ported yet (ROADMAP.md Queue 1, "
              "item 9c: analysis/autofix waits for analysis/hlo)",
              file=sys.stderr)
        return 2

    trace = []
    if not args.skip_jaxpr:
        from apex_tpu_torch._kernels import resolve_device

        device = str(resolve_device(args.device))
        names = [args.target] if args.target else list(TARGETS)
        trace = trace_findings(names, device)
    rc, report = gate(trace, lint=not args.skip_lint,
                      concurrency=not args.skip_concurrency,
                      verbose=args.verbose, json_path=args.json)
    print(report, flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
