"""apex_tpu_torch.monitor.xray.timeline against the JAX package's timeline.

The same synthetic events are written twice: in XProf's form (device ops
on a ``/device:`` process's ``XLA Ops`` lane, ``StepTraceAnnotation``
spans with a stringified ``step_num``, async collectives as
``-start``/``-done`` pairs), read by the JAX package's parser, and in
torch.profiler's Chrome form (``kernel``/``gpu_memcpy`` events on the
card's lane, NCCL's kernels and gloo's host ranges as collectives,
``ProfilerStep#N`` ranges, one event a collective), read by the port's.
Both analyzers must give equal per-step breakdowns (every field, exact
to 1e-6 us: the same intervals, unioned by the same arithmetic), equal
interval algebra and records with the same keys. One real CPU capture of
a tiny step is parsed and partitioned at the end, and the CLI runs on it.
"""

import json
import math

import numpy as np
import pytest

from apex_tpu.monitor.xray.timeline import analyze as jax_analyze
from apex_tpu.monitor.xray.timeline import analyzer as jax_an
from apex_tpu.monitor.xray.timeline import parse_trace as jax_parse
from apex_tpu_torch.monitor.xray import timeline
from apex_tpu_torch.monitor.xray.timeline import analyzer as an

TIME_TOL = 1e-6  # microseconds


def _events(seed, steps=3):
    """Abstract events: (class, ts, dur) with class compute / collective
    / async (a collective XProf splits in two) / memcpy, and the step
    spans, over ``steps`` steps with gaps, overlaps and ops straddling a
    step's edge."""
    rs = np.random.RandomState(seed)
    spans, ops = [], []
    t = 100.0
    for s in range(steps):
        span = (s, t, float(rs.uniform(800, 1200)))
        spans.append(span)
        cur = t - 20.0  # the first op straddles the step's start
        while cur < t + span[2]:
            cls = rs.choice(["compute", "compute", "collective", "async",
                             "memcpy"])
            dur = float(rs.uniform(5, 120))
            ops.append((cls, cur, dur))
            cur += float(rs.uniform(-30, 150))  # overlaps and gaps
        t += span[2] + float(rs.uniform(10, 60))
    return spans, ops


def _xprof(spans, ops):
    ev = [{"ph": "M", "name": "process_name", "pid": 2,
           "args": {"name": "/device:TPU:0"}},
          {"ph": "M", "name": "thread_name", "pid": 2, "tid": 1,
           "args": {"name": "XLA Ops"}}]
    for i, (cls, ts, dur) in enumerate(ops):
        if cls == "async":  # start ... done, fused back into one interval
            ev.append({"ph": "X", "name": f"all-gather-start.{i}", "pid": 2,
                       "tid": 1, "ts": ts, "dur": 1.0})
            ev.append({"ph": "X", "name": f"all-gather-done.{i + 1000}",
                       "pid": 2, "tid": 1, "ts": ts + dur - 1.0,
                       "dur": 1.0})
            continue
        name = {"compute": "fusion", "collective": "all-reduce",
                "memcpy": "copy"}[cls]
        ev.append({"ph": "X", "name": f"{name}.{i}", "pid": 2, "tid": 1,
                   "ts": ts, "dur": dur})
    for step, ts, dur in spans:
        ev.append({"ph": "X", "name": "train", "pid": 1, "tid": 0, "ts": ts,
                   "dur": dur, "args": {"step_num": str(step)}})
    return {"traceEvents": ev, "displayTimeUnit": "ns"}


def _chrome(spans, ops):
    ev = [{"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
           "args": {"name": "python"}},
          {"ph": "M", "name": "thread_name", "pid": 0, "tid": 7,
           "args": {"name": "stream 7"}},
          {"ph": "M", "name": "process_name", "pid": 4242, "tid": 0,
           "args": {"name": "python"}},
          {"ph": "M", "name": "process_sort_index", "pid": "Spans",
           "tid": 0, "args": {"sort_index": 1}}]
    for i, (cls, ts, dur) in enumerate(ops):
        if cls == "compute":
            e = {"cat": "kernel", "name": f"void gemm_kernel_{i}<float>()",
                 "pid": 0, "tid": 7}
        elif cls == "memcpy":
            e = {"cat": "gpu_memcpy", "name": "Memcpy DtoD (Device -> "
                 "Device)", "pid": 0, "tid": 7}
        elif cls == "async":
            e = {"cat": "kernel", "name": "ncclDevKernel_AllGather_RING_LL("
                 "ncclDevComm*, unsigned long, ncclWork*)", "pid": 0,
                 "tid": 8}
        else:  # gloo's range on its own host thread
            e = {"cat": "user_annotation", "name": "gloo:all_reduce",
                 "pid": 4242, "tid": 4250}
        ev.append({"ph": "X", "ts": ts, "dur": dur, "args": {}, **e})
        # the host's own ops are noise: never device ops on the card
        ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::mm",
                   "pid": 4242, "tid": 4242, "ts": ts, "dur": dur / 2})
    for step, ts, dur in spans:
        ev.append({"ph": "X", "cat": "user_annotation",
                   "name": f"ProfilerStep#{step}", "pid": 4242,
                   "tid": 4242, "ts": ts, "dur": dur, "args": {}})
        # the range's projection onto the card's lane: no step marker
        ev.append({"ph": "X", "cat": "gpu_user_annotation",
                   "name": f"ProfilerStep#{step}", "pid": 0, "tid": 7,
                   "ts": ts + 5.0, "dur": dur - 10.0, "args": {}})
    return {"schemaVersion": 1, "traceEvents": ev}


FIELDS = ("step", "ts", "end", "compute_us", "collective_us", "memcpy_us",
          "exposed_collective_us", "exposed_memcpy_us", "busy_us", "n_ops",
          "span_us", "idle_us", "bubble_fraction")


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_breakdowns_equal_jax(seed):
    spans, ops = _events(seed)
    ref = jax_analyze(jax_parse(_xprof(spans, ops)))
    got = timeline.analyze(timeline.parse_trace(_chrome(spans, ops)))
    assert len(got.steps) == len(ref.steps) == len(spans)
    assert got.n_device_ops == len(ops)
    for g, r in zip(got.steps, ref.steps):
        for f in FIELDS:
            assert getattr(g, f) == pytest.approx(getattr(r, f),
                                                  abs=TIME_TOL), f
        assert (g.overlap_fraction is None) == (r.overlap_fraction is None)
        if r.overlap_fraction is not None:
            assert g.overlap_fraction == pytest.approx(r.overlap_fraction,
                                                       abs=1e-9)
        resid = (g.compute_us + g.exposed_collective_us
                 + g.exposed_memcpy_us + g.idle_us - g.span_us)
        assert abs(resid) <= TIME_TOL
    gk = [sorted(r) for r in got.to_records()]
    rk = [sorted(r) for r in ref.to_records()]
    assert gk == rk


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_interval_algebra_equals_jax(seed):
    rs = np.random.RandomState(seed)

    def raw(n):
        lo = rs.uniform(0, 1000, n)
        return [(float(a), float(a + d)) for a, d in
                zip(lo, rs.uniform(-5, 80, n))]

    a, b = raw(40), raw(30)
    for fn in ("merge_intervals",):
        assert getattr(an, fn)(a) == getattr(jax_an, fn)(a)
    ma, mb = an.merge_intervals(a), an.merge_intervals(b)
    assert an.total_us(ma) == jax_an.total_us(ma)
    assert an.intersect_intervals(ma, mb) == jax_an.intersect_intervals(
        ma, mb)
    assert an.subtract_intervals(ma, mb) == jax_an.subtract_intervals(ma, mb)
    assert an.clip_intervals(a, 200.0, 700.0) == jax_an.clip_intervals(
        a, 200.0, 700.0)


@pytest.mark.parametrize("name", [
    "fusion.3", "all-reduce.17", "all-gather-start.2", "all-gather-done.9",
    "reduce-scatter", "collective-permute-start.1", "copy.4", "copy-start",
    "send.3", "recv-done.1", "reduce.8", "all-to-all.5", "%transpose.2",
])
def test_xprof_names_classify_as_in_jax(name):
    assert an.classify_op(name) == jax_an.classify_op(name)
    assert an.op_base(name) == jax_an.op_base(name)


@pytest.mark.parametrize("name,cls", [
    ("void (anonymous namespace)::flash_fwd_mma<64, 4>(...)", "compute"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevComm*)", "collective"),
    ("gloo:all_gather", "collective"),
    ("c10d::allreduce_", "collective"),
    ("Memcpy HtoD (Pinned -> Device)", "memcpy"),
    ("Memset (Device)", "memcpy"),
    ("aten::mm", "compute"),
])
def test_torch_names_classify(name, cls):
    assert an.classify_op(name) == cls


def test_bandwidth_join_by_dispatch_order():
    """Each step's transport collectives, in start order, take the
    recorded c10d ops of their kind in dispatch order; the measured
    per-axis time divides the ledger's per-axis wire bytes, and the
    utilization stays None (no link roofline)."""
    from apex_tpu_torch.analysis.hlo import parser as hp
    from apex_tpu_torch.analysis.hlo.attribution import layout_mesh
    from apex_tpu_torch.monitor.xray.ledger import CollectiveEntry, CommsLedger

    def coll(kind, ranks, i):
        return hp.HloCollective(
            kind=kind, name=f"c10d.{kind}#{i}", computation="step",
            result=hp.HloShape("float32", (4,)),
            operands=(hp.HloOperand(hp.HloShape("float32", (4,))),),
            replica_groups=(ranks,), op_name="",
            source_file="", source_line=0, line=i)

    module = hp.HloModule("m", [coll("allreduce_", (0, 1), 0),
                                coll("allreduce_", (0, 2), 1)], [], [], {})
    mesh = layout_mesh({"dp": 2, "tp": 2})  # ranks (d, t): d * 2 + t
    led = CommsLedger()
    for axis in ("tp", "dp"):
        led.entries.append(CollectiveEntry(
            op="psum", axis=axis, axis_size=2, shape=(4,), dtype="float32",
            bytes=16, ici_bytes=16))
    ev = [{"ph": "X", "cat": "user_annotation", "name": "ProfilerStep#0",
           "pid": 1, "tid": 1, "ts": 0.0, "dur": 100.0}]
    for ts, dur in ((10.0, 8.0), (40.0, 16.0)):
        ev.append({"ph": "X", "cat": "user_annotation",
                   "name": "gloo:all_reduce", "pid": 1, "tid": 2, "ts": ts,
                   "dur": dur})
    rep = timeline.analyze(timeline.parse_trace({"traceEvents": ev}),
                           module=module, mesh=mesh, ledger=led)
    by = {a.axis: a for a in rep.axes}
    assert by["tp"].measured_us_per_step == 8.0
    assert by["dp"].measured_us_per_step == 16.0
    assert by["tp"].achieved_bytes_per_s == pytest.approx(16 / 8e-6)
    assert all(a.utilization is None for a in rep.axes)
    assert rep.n_unattributed_collectives == 0


def test_cli_schedule_choices_equal_the_algebra():
    from apex_tpu_torch.monitor.xray.timeline.__main__ import (
        _SCHEDULE_CHOICES,
    )
    from apex_tpu_torch.parallel.pipeline.algebra import SCHEDULES

    assert set(_SCHEDULE_CHOICES) == set(SCHEDULES)


def test_real_cpu_capture_parsed_and_partitioned(tmp_path, capsys):
    """A capture of two tiny steps under utils.timers.trace: the aten-op
    lane read, two steps segmented, each partition summing to its span;
    the CLI exits 0 on it and writes kind="profile" records."""
    import torch

    from apex_tpu_torch.monitor.xray.timeline.__main__ import main
    from apex_tpu_torch.utils.timers import step_annotation, trace

    x = torch.ones(32, 32)
    with trace(str(tmp_path)):
        for i in range(2):
            with step_annotation(i):
                (x @ x).sum()
    tl, files = timeline.parse_logdir(str(tmp_path))
    assert [s.step for s in tl.step_spans()] == [0, 1]
    rep = timeline.analyze(tl)
    assert len(rep.steps) == 2 and rep.n_device_ops > 0
    for s in rep.steps:
        assert s.compute_us > 0
        assert math.isclose(s.compute_us + s.exposed_collective_us
                            + s.exposed_memcpy_us + s.idle_us, s.span_us,
                            abs_tol=TIME_TOL)
    out = tmp_path / "p.jsonl"
    assert main([str(tmp_path), "--json", str(out)]) == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["kind"] for r in recs] == ["profile", "profile"]
    assert "timeline: 2 step(s)" in capsys.readouterr().out


def test_trace_smoke_clean_on_the_cpu():
    from apex_tpu_torch.analysis.trace_smoke import timeline_smoke_findings

    assert timeline_smoke_findings("cpu") == []
