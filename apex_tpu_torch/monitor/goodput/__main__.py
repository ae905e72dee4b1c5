"""``python -m apex_tpu_torch.monitor.goodput`` — goodput ledger + perf
gate CLI (counterpart of apex_tpu/monitor/goodput/__main__.py).

Three modes, all host-only (a stream is accountable on any box):

- **account** (default) — replay record stream(s) into the goodput/
  badput partition::

      python -m apex_tpu.monitor.goodput run.jsonl [more.jsonl ...]

  Streams may hold multiple incarnations (run headers delimit) and
  multiple hosts (the ``host`` field). Exit 1 when no span records were
  found (an unwired producer is a bug, not a 100%-unattributed run).

- **--fleet** — divergence detection over the same streams: straggler
  hosts and silent-corruption suspects. Exit 1 on any flag.

- **--check** — the perf-regression sentinel (exit-nonzero gate, the
  ``python -m apex_tpu_torch.analysis`` discipline). With no streams, the
  NEWEST recorded BENCH round is checked against the prior rounds'
  noise-aware thresholds — the self-test that the recorded trajectory
  itself passes its own gate. With streams, their ``kind="bench"`` /
  ``"metrics"`` / ``"goodput"`` measurements are the fresh side, checked
  against the full recorded history plus an optional ``--baseline``
  recording of a comparable run. Intentional regressions go through the
  reason-carrying allowlist (goodput/sentinel.py), never through
  silence. Only same-platform values compare: the port's ``gpu`` records
  have no recorded round, so they gate against ``--baseline`` alone
  (sentinel.py).
"""

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.monitor.goodput",
        description="run-level goodput ledger, fleet health, perf gate",
    )
    parser.add_argument(
        "streams", nargs="*",
        help="record jsonl file(s): the stream(s) to account / check")
    parser.add_argument("--run-id", default=None,
                        help="account only incarnations with this run id")
    parser.add_argument("--fleet", action="store_true",
                        help="fleet-health divergence detection; exit 1 on "
                             "stragglers or corruption suspects")
    parser.add_argument("--check", action="store_true",
                        help="perf-regression gate vs the recorded BENCH "
                             "trajectory; exit 1 on unallowlisted "
                             "regressions")
    parser.add_argument("--baseline", default=None,
                        help="--check: baseline record jsonl for run-kind "
                             "measurements (tokens/s, MFU, goodput)")
    parser.add_argument("--floor", type=float, default=0.05,
                        help="--check: regression tolerance floor "
                             "(default 0.05)")
    parser.add_argument("--z-threshold", type=float, default=4.0,
                        help="--fleet: straggler robust-z threshold")
    parser.add_argument("--rtol", type=float, default=1e-5,
                        help="--fleet: replicated-value relative tolerance")
    parser.add_argument("--json", default=None,
                        help="append the result record(s) to this jsonl")
    parser.add_argument("--verbose", "-v", action="store_true",
                        help="--check: also print allowlisted findings")
    args = parser.parse_args(argv)

    from apex_tpu_torch.monitor.goodput import accountant

    records = accountant.read_records(args.streams) if args.streams else []

    json_records = []
    if args.check:
        from apex_tpu_torch.monitor.goodput import sentinel

        history = sentinel.load_bench_history()
        if args.streams:
            fresh = sentinel.measurements_from_records(
                records, source=",".join(args.streams))
            if args.baseline:
                history = history + sentinel.measurements_from_records(
                    accountant.read_records([args.baseline]),
                    source=args.baseline,
                )
        else:
            # self-test: the newest recorded round vs the prior rounds
            if not history:
                print("perf check: no recorded BENCH_r*.json history")
                return 1
            newest_source = history[-1]["source"]
            fresh = [m for m in history if m["source"] == newest_source]
            history = [m for m in history if m["source"] != newest_source]
            print(f"perf check: newest recorded round {newest_source} vs "
                  f"{len(history)} prior measurement(s)")
        findings = sentinel.check_regression(
            fresh, history, floor=args.floor)
        # check_stale=False: whether a perf entry fires depends on which
        # measurements this invocation saw (the jaxpr-pass convention)
        result = sentinel.goodput_allowlist().apply(
            findings, check_stale=False)
        for m in fresh:
            print(f"  {m['metric']} [{m['platform']}] = {m['value']:.6g}")
        print(result.format(verbose=args.verbose), flush=True)
        json_records.extend(result.to_records())
        rc = 0 if result.ok else 1
    elif args.fleet:
        from apex_tpu_torch.monitor.goodput import fleet

        if not args.streams:
            parser.error("--fleet needs at least one record stream")
        report = fleet.detect_divergence(
            records, z_threshold=args.z_threshold, rtol=args.rtol)
        print(report.summary(), flush=True)
        json_records.extend(report.to_records())
        rc = 0 if report.ok else 1
    else:
        if not args.streams:
            parser.error("give at least one record stream (or --check)")
        report = accountant.account(records, run_id=args.run_id)
        if report.n_spans == 0:
            print("goodput: no span records found — is the producer wired "
                  "(goodput.set_router + span phases)? Nothing to account.")
            return 1
        print(report.summary(), flush=True)
        from apex_tpu_torch.monitor.router import make_record

        json_records.append(make_record("goodput", 0, **report.fields()))
        rc = 0
    if args.json and json_records:
        from apex_tpu_torch.monitor.router import JsonlSink

        sink = JsonlSink(args.json)
        for rec in json_records:
            sink.emit(rec)
        sink.close()
    return rc


if __name__ == "__main__":
    sys.exit(main())
