"""``python -m apex_tpu_torch.serving.trace`` — request x-ray CLI + gate.

Replay serving record stream(s) (jsonl) through the critical-path
analyzer (:mod:`apex_tpu_torch.serving.trace.analyze`): rebuild every
request's span tree, print the fleet-wide TTFT picture and the goodput
reconciliation, and GATE — exit nonzero when the stream cannot prove
itself:

- no ``kind="trace"`` records at all (an unwired producer is a bug,
  not a zero-request fleet — the goodput CLI's no-spans rule);
- any incomplete span tree (missing/duplicate root, dangling parent,
  duplicate span id);
- any terminal ``kind="request"`` record whose id has no trace tree
  (a request the lifecycle closed but the x-ray never saw);
- any per-request partition identity that fails to re-add with ``==``
  through the json round trip;
- a failover/handoff badput total that the goodput accountant and the
  per-request gp twins disagree on.

Copied from apex_tpu/serving/trace/__main__.py (stdlib only): any box
can audit a stream, the port's or the JAX package's.
"""

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.serving.trace",
        description="per-request critical-path analyzer + trace gate",
    )
    parser.add_argument(
        "streams", nargs="+",
        help="record jsonl file(s): the serving stream(s) to analyze")
    parser.add_argument(
        "--json", default=None,
        help="append per-request decomposition records to this jsonl")
    parser.add_argument(
        "--verbose", "-v", action="store_true",
        help="also print every request's decomposition")
    args = parser.parse_args(argv)

    from apex_tpu_torch.serving.trace import analyze as az

    records = az.read_records(args.streams)
    report = az.analyze(records)
    if report.n_traces == 0:
        print("trace: no trace records found — is the producer wired "
              "(a MetricRouter on the engine/fleet)? Nothing to x-ray.")
        return 1
    print(report.summary(), flush=True)
    if args.verbose:
        for d in report.decompositions:
            parts = "  ".join(
                f"{ph}={d[f'{ph}_s']:.6f}"
                for ph in az.REQUEST_PHASES)
            print(f"  {d['trace']:>8} [{d.get('state')}] "
                  f"wall={d['wall_s']:.6f} {parts} "
                  f"overhead={d['overhead_s']:.6f}")
    if args.json and report.decompositions:
        from apex_tpu_torch.monitor.router import JsonlSink, make_record

        sink = JsonlSink(args.json)
        for d in report.decompositions:
            sink.emit(make_record("trace_decomp", 0, **d))
        sink.close()
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
