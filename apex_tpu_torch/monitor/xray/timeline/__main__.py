"""``python -m apex_tpu_torch.monitor.xray.timeline <logdir>``: analyze a
capture (counterpart of apex_tpu/monitor/xray/timeline/__main__.py).

The device-time breakdown of any ``torch.profiler`` capture in the
Chrome trace format (a ``utils.timers.trace`` block's ``trace.json``, a
``ProfilerTrigger`` window): per-step compute / collective / exposed /
idle partition, overlap and bubble fractions, and the device ops that
took the most time. Exit status: 0 on an analysis with at least one
step, 1 when no trace file or no device op was found.

The bandwidth join needs the step's recorded collectives and the
layout, which a bare directory does not carry: the examples'
``--profile-analyze`` prints the joined report, or call
``timeline.analyze_logdir(logdir, module=..., mesh=..., ledger=...)``.

Flags: ``--json PATH`` appends the ``kind="profile"`` records to a jsonl
(the MetricRouter schema); ``--top N`` lists the N longest device ops;
``--schedule NAME --pp P --microbatches M [--chunks V]`` joins the
pipeline schedule algebra's predicted bubble fraction
(``parallel/pipeline/algebra.py``) onto every per-step record.
"""

import argparse
import sys

#: the registered schedule names (parallel.pipeline.algebra.SCHEDULES),
#: spelled out so that the parser needs no torch to offer them; the
#: tests hold the two lists equal
_SCHEDULE_CHOICES = ("1f1b", "interleaved", "no_pipelining", "zero_bubble")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.monitor.xray.timeline",
        description="device-time breakdown of a torch.profiler capture",
    )
    p.add_argument("logdir", help="the directory given to "
                   "utils.timers.trace or ProfilerTrigger")
    p.add_argument("--json", default=None,
                   help="append kind='profile' records to this jsonl")
    p.add_argument("--top", type=int, default=10,
                   help="list the N device ops that took the most time")
    p.add_argument("--schedule", default=None, choices=_SCHEDULE_CHOICES,
                   help="pipeline schedule name for the predicted-bubble "
                   "join")
    p.add_argument("--pp", type=int, default=None,
                   help="pipeline size P for the join")
    p.add_argument("--microbatches", type=int, default=None,
                   help="microbatch count M for the join")
    p.add_argument("--chunks", type=int, default=1,
                   help="virtual-PP model chunks V for the join")
    args = p.parse_args(argv)

    predicted = None
    if args.schedule is not None:
        if args.pp is None or args.microbatches is None:
            p.error("--schedule needs --pp and --microbatches")
        from apex_tpu_torch.parallel.pipeline.algebra import schedule_cost

        try:
            predicted = schedule_cost(args.schedule, args.pp,
                                      args.microbatches,
                                      args.chunks).bubble_fraction
        except ValueError as e:
            p.error(str(e))

    from apex_tpu_torch.monitor.xray.timeline.analyzer import analyze_logdir

    try:
        report = analyze_logdir(args.logdir,
                                predicted_bubble_fraction=predicted,
                                schedule=args.schedule)
    except (FileNotFoundError, ValueError) as e:
        print(f"timeline: {e}", file=sys.stderr)
        return 1
    for path in report.files:
        print(f"trace: {path}", flush=True)
    print(report.summary(top=args.top), flush=True)
    if args.json:
        from apex_tpu_torch.monitor.router import JsonlSink

        sink = JsonlSink(args.json)
        for rec in report.to_records():
            sink.emit(rec)
        sink.close()
    return 0 if report.steps else 1


if __name__ == "__main__":
    sys.exit(main())
