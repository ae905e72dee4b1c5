"""The incident ladder, the SIGTERM latch and the fleet-health checks of
apex_tpu_torch against the JAX package's.

The incident bundle keeps JAX's schema: the same keys, and the same
record tail and verdicts from the same window. The ladder runs in
process with an injected ``exit_fn``. The SIGTERM latch's install orders
against the router's die-by-signal hook run in subprocesses, with real
signals; the in-process case restores the handlers it replaced. The
fleet checks are plain Python: equal to JAX's on the same records.
"""

import dataclasses
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from apex_tpu import monitor as jmon
from apex_tpu.monitor.goodput import fleet as jfleet
from apex_tpu.monitor.goodput import live as jlive
from apex_tpu.resilience.health import incident as jincident
from apex_tpu_torch import monitor
from apex_tpu_torch.monitor import router as port_router
from apex_tpu_torch.monitor.goodput import LiveFleetMonitor, detect_divergence
from apex_tpu_torch.monitor.goodput import spans as port_spans
from apex_tpu_torch.resilience import ExitCode
from apex_tpu_torch.resilience.health import (
    INCIDENT_EXIT_CODE,
    VERDICT_KINDS,
    IncidentResponder,
    capture_incident,
)
from apex_tpu_torch.utils.autoresume import GRACE_ENV, TerminationNotice


@pytest.fixture(autouse=True)
def _restore_process_state():
    """Routers install a SIGTERM flush and register flush hooks on first
    use: put the handler back and drop the hooks after each test, so no
    handler or sink outlives it."""
    handler = signal.getsignal(signal.SIGTERM)
    hooks = list(port_router._FLUSH_HOOKS)
    yield
    signal.signal(signal.SIGTERM, handler)
    port_router._FLUSH_HOOKS[:] = hooks
    port_spans.set_router(None)


ROOT = Path(__file__).resolve().parent.parent


def _window(cls, n=40):
    mem = cls(max_records=256)
    kinds = ["metrics", "span", "rollback", "stall", "journal", "incident"]
    for i in range(n):
        mem.emit({"kind": kinds[i % len(kinds)], "step": i, "t": float(i)})
    return mem


def test_incident_bundle_keys_and_tail_equal_jax():
    got = capture_incident(None, 12, stage="dump", overdue_s=2.0,
                           deadline_s=1.0, window=_window(monitor.MemorySink),
                           tail=16, queued=3)
    want = jincident.capture_incident(
        None, 12, stage="dump", overdue_s=2.0, deadline_s=1.0,
        window=_window(jmon.MemorySink), tail=16, queued=3)
    assert set(got) == set(want)
    for key in ("stage", "overdue_s", "deadline_s", "record_tail",
                "verdicts", "journal_tail", "profile_requested", "queued",
                "kind", "step"):
        assert got[key] == want[key], key
    assert VERDICT_KINDS == jincident.VERDICT_KINDS
    assert len(got["record_tail"]) == 16
    assert all(r["kind"] != "incident" for r in got["record_tail"])
    assert "capture_incident" in got["stacks"]


def test_incident_bundle_arms_the_profiler_and_lands_in_the_stream(tmp_path):
    mem = monitor.MemorySink()
    router = monitor.MetricRouter([mem])
    trigger = monitor.ProfilerTrigger(str(tmp_path))
    trigger.request(step=50)
    rec = capture_incident(router, None, trigger=trigger, window=mem)
    assert rec["profile_requested"] and rec["step"] == -1
    assert trigger._requested == {"step": None, "reason": "incident"}
    assert [r["kind"] for r in mem.records] == ["incident"]
    router.close()


def _wait(pred, timeout=10.0):
    t0 = time.monotonic()
    while not pred() and time.monotonic() - t0 < timeout:
        time.sleep(0.01)
    return pred()


def test_warn_dump_terminate_in_process():
    mem = monitor.MemorySink()
    router = monitor.MetricRouter([mem])
    codes = []

    class Pending:
        def prepare_incident_exit(self):
            return 12

    responder = IncidentResponder(
        0.05, router=router, window=mem, poll_s=0.01, autoresume=Pending(),
        dump_after=2.0, terminate_after=4.0, exit_fn=codes.append,
        bundle_extra=lambda: {"requests": [{"id": 3}]},
    ).start()
    try:
        responder.beat(9)
        assert _wait(lambda: codes)
    finally:
        responder.stop()
    assert codes == [INCIDENT_EXIT_CODE] == [int(ExitCode.INCIDENT)] == [43]
    incidents = [r for r in mem.records if r["kind"] == "incident"]
    assert [r["stage"] for r in incidents] == ["dump", "terminate"]
    dump, term = incidents
    assert dump["requests"] == [{"id": 3}] and dump["step"] == 9
    assert term["abandoned_step"] == 12 and term["exit_code"] == 43
    (span,) = [r for r in mem.records
               if r["kind"] == "span" and r["phase"] == "incident"]
    assert span["dur_s"] >= 4 * 0.05
    assert [r["kind"] for r in mem.records].index("stall") < \
        [r["kind"] for r in mem.records].index("incident")
    assert responder.stalls and responder.incidents[0]["stacks"]
    assert router._closed  # the exit teardown ran by hand


def test_dump_only_ladder_never_exits_and_beats_rearm():
    codes = []
    responder = IncidentResponder(0.05, poll_s=0.01, dump_after=1.5,
                                  exit_fn=codes.append,
                                  bundle_extra=lambda: 1 / 0).start()
    try:
        assert _wait(lambda: responder.incidents)
        time.sleep(0.2)
        assert len(responder.incidents) == 1  # once per episode
        responder.beat(1)
        assert _wait(lambda: len(responder.incidents) == 2)
    finally:
        responder.stop()
    assert codes == []


def test_a_wedged_teardown_still_exits_within_its_bound():
    class HungSink(monitor.Sink):
        def __init__(self):
            self.hang = False
            self.release = threading.Event()

        def emit(self, record):
            if self.hang:
                self.release.wait(30)

    sink = HungSink()
    router = monitor.MetricRouter([sink])
    codes = []
    responder = IncidentResponder(0.05, router=router, poll_s=0.01,
                                  dump_after=1.5, terminate_after=3.0,
                                  exit_fn=codes.append,
                                  teardown_timeout_s=0.2)
    sink.hang = True  # every record blocks, the dump's too
    t0 = time.monotonic()
    responder.start()
    try:
        assert _wait(lambda: codes)
    finally:
        responder.stop()
        sink.release.set()  # free the blocked emits before the next test
    assert codes == [43] and time.monotonic() - t0 < 5.0
    router.close()


@pytest.mark.parametrize("kw,match", [
    (dict(dump_after=0.5), "dump_after"),
    (dict(dump_after=2.0, terminate_after=1.5), "terminate_after"),
    (dict(dump_after=2.0, terminate_after=2.0), "terminate_after"),
])
def test_ladder_parameter_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        IncidentResponder(1.0, **kw)


def test_notice_chains_a_flag_handler_and_restores_it(monkeypatch):
    monkeypatch.setenv(GRACE_ENV, "7.5")
    hits = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: hits.append(s))
    try:
        notice = TerminationNotice()
        try:
            assert notice.grace_s == 7.5 and notice.grace_deadline() is None
            os.kill(os.getpid(), signal.SIGTERM)
            assert _wait(lambda: notice.signaled)
            assert hits == [signal.SIGTERM]  # chained: neither is lost
            assert notice.grace_deadline() is not None
        finally:
            notice.close()
        assert signal.getsignal(signal.SIGTERM) is not notice._on_signal
        os.kill(os.getpid(), signal.SIGTERM)
        assert _wait(lambda: len(hits) == 2)  # the flag handler is back
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_notice_skips_a_marked_teardown_hook_and_reads_the_env(monkeypatch):
    def hook(signum, frame):
        raise AssertionError("the die-by-signal hook must not be chained")

    hook._apex_tpu_router_teardown = True
    prev = signal.signal(signal.SIGTERM, hook)
    try:
        monkeypatch.setenv(GRACE_ENV, "not a number")
        notice = TerminationNotice(grace_s=None)
        try:
            assert notice.grace_s is None
            os.kill(os.getpid(), signal.SIGTERM)
            assert _wait(lambda: notice.signaled)
        finally:
            notice.close()
        assert signal.getsignal(signal.SIGTERM) is hook
        quiet = TerminationNotice(install_handlers=False, grace_s=1.0)
        quiet.request()
        assert quiet.signaled and quiet.grace_deadline() is not None
        quiet.close()
    finally:
        signal.signal(signal.SIGTERM, prev)


_ORDER_SCRIPT = textwrap.dedent("""
    import os, signal, sys, time
    from apex_tpu_torch.monitor import MemorySink, MetricRouter
    from apex_tpu_torch.utils.autoresume import TerminationNotice
    order = sys.argv[1]
    if order == "router_first":
        router = MetricRouter([MemorySink()])
        h = signal.getsignal(signal.SIGTERM)
        assert getattr(h, "_apex_tpu_router_teardown", False), h
        notice = TerminationNotice()
    else:
        notice = TerminationNotice()
        router = MetricRouter([MemorySink()])
        # the hook installs over the default disposition only
        assert signal.getsignal(signal.SIGTERM) == notice._on_signal
    os.kill(os.getpid(), signal.SIGTERM)
    t0 = time.monotonic()
    while not notice.signaled and time.monotonic() - t0 < 10:
        time.sleep(0.01)
    print("signaled", notice.signaled, flush=True)
    notice.close()
    router.close()
""")


@pytest.mark.parametrize("order", ["router_first", "notice_first"])
def test_notice_supersedes_the_router_hook_in_either_order(order):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", _ORDER_SCRIPT, order],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    # the process survived its SIGTERM (rc 0, not -15) and saw it
    assert res.returncode == 0, res.stderr
    assert "signaled True" in res.stdout


def _fleet_records(seed=0):
    rs = np.random.RandomState(seed)
    recs = []
    for host in range(5):
        slow = 3.0 if host == 3 else 1.0
        for step in range(6):
            recs.append({"kind": "span", "phase": "step", "host": host,
                         "step": step, "t": 0.0,
                         "dur_s": slow * (0.1 + 0.001 * rs.rand())})
            loss = 2.0 - 0.1 * step
            if host == 1 and step == 4:
                loss += 0.01  # a corrupted replica
            recs.append({"kind": "metrics", "host": host, "step": step,
                         "t": 0.0, "loss": loss,
                         "grad_norm": float("nan") if (host, step) == (2, 5)
                         else 1.0})
    recs.append({"kind": "span", "phase": "step", "host": 0, "t": 0.0,
                 "dur_s": "bad"})
    return recs


def _no_t(records):
    return [{k: v for k, v in r.items() if k != "t"} for r in records]


def test_detect_divergence_equals_jax():
    recs = _fleet_records()
    got = detect_divergence(recs, z_threshold=3.0)
    want = jfleet.detect_divergence(recs, z_threshold=3.0)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [s["host"] for s in got.stragglers] == [3]
    assert {(s["host"], s["step"]) for s in got.suspects} == {(1, 4), (2, 5)}
    assert got.summary() == want.summary()
    assert _no_t(got.to_records(step=9)) == _no_t(want.to_records(step=9))
    assert detect_divergence(recs[:12]).ok  # one host: nothing to judge


def test_live_fleet_monitor_equals_jax():
    outs, recs = [], _fleet_records(1)  # one NaN object for both
    for mon_pkg, live_cls in ((monitor, LiveFleetMonitor),
                              (jmon, jlive.LiveFleetMonitor)):
        mem = mon_pkg.MemorySink()
        router = mon_pkg.MetricRouter([mem])
        window = mon_pkg.MemorySink(max_records=4096,
                                    kinds=("span", "metrics"))
        for r in recs:
            window.emit(r)
        live = live_cls(router, window, interval_steps=2, z_threshold=3.0)
        reports = [live.maybe_check(s) for s in range(5)]
        router.close()
        outs.append((reports, _no_t(mem.records)))
    (got, got_recs), (want, want_recs) = outs
    assert [r is None for r in got] == [True, True, False, True, False]
    assert [dataclasses.asdict(r) for r in got if r] == \
        [dataclasses.asdict(r) for r in want if r]
    assert got_recs == want_recs
    assert got_recs[0]["check"] == "summary" and not got_recs[0]["ok"]
    with pytest.raises(ValueError, match="interval_steps"):
        LiveFleetMonitor(None, None, interval_steps=0)
