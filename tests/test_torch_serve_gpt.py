"""The port's serving example and the GPT example's telemetry, on the CPU.

``python -m apex_tpu_torch.examples.serving.serve_gpt --device cpu`` runs
the JAX package's overload drill (tests/test_serving.py, the same argv):
Poisson load above what the engine sustains, chaos faults, and a SIGTERM
mid-load. The stream is audited as JAX's is: exactly one terminal record
per request, shedding with reasons, p99 TTFT of the admitted within the
budget, the drain inside the grace budget, the goodput identity with
``==`` and no steady-state kernel load. The wedge drill hangs the loop
and the incident ladder ends the process with exit code 43 after its
dump, terminate record and incident span, with the accountant's identity
still exact on the stream. Each drill runs in a subprocess, so its
signals and its ``os._exit`` never touch the test process.
"""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from apex_tpu_torch.examples.gpt import pretrain_gpt
from apex_tpu_torch.monitor import router as port_router
from apex_tpu_torch.monitor.goodput import BADPUT_PHASES, account
from apex_tpu_torch.monitor.goodput import spans as port_spans
from apex_tpu_torch.serving import TERMINAL_STATES, percentile


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
GRACE = 60.0
TTFT_BUDGET = 2.0


def _env(**extra):
    # one intra-op thread: the drill's tiny model needs no more, and the
    # test workers beside it keep their cores
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    env.pop("APEX_TPU_PEAK_FLOPS", None)
    env.update(extra)
    return env


def _serve(args, **kw):
    return subprocess.Popen(
        [sys.executable, "-m", "apex_tpu_torch.examples.serving.serve_gpt",
         "--device", "cpu", *args], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, **kw)


def _stream(path):
    records = []
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    records.append(json.loads(line))
                except ValueError:
                    pass  # a line being written
    return records


def _identity(records):
    g = [r for r in records if r.get("kind") == "goodput"]
    rep = account(records)
    total = rep.productive_s
    for phase in BADPUT_PHASES:
        total = total + rep.badput_s.get(phase, 0.0)
    return g, total + rep.unattributed_s == rep.wall_s, rep


def _one_terminal_each(req_records):
    seen = {r["id"] for r in req_records}
    terminal = {}
    for r in req_records:
        if r.get("terminal"):
            terminal.setdefault(r["id"], []).append(r["state"])
    assert set(terminal) == seen
    assert all(len(v) == 1 for v in terminal.values())
    assert {v[0] for v in terminal.values()} <= TERMINAL_STATES


BURST_STEP = 40


def test_serve_gpt_sigterm_overload_drill(tmp_path):
    jsonl = str(tmp_path / "serving.jsonl")
    proc = _serve([
        "--requests", "600", "--rate", "100",
        "--ttft-budget", str(TTFT_BUDGET), "--queue-depth", "8",
        "--deadline", "30", "--metrics-jsonl", jsonl,
        "--chaos-slow-decode-steps", "30,60", "--chaos-slow-decode-s",
        "0.3", "--chaos-abandon", "5,15,25",
        "--chaos-malformed", "10,20", "--chaos-burst-steps", str(BURST_STEP),
        "--chaos-burst-n", "12",
    ], env=_env(APEX_TPU_PREEMPTION_GRACE_S=str(GRACE)))
    try:
        t0 = time.monotonic()
        while time.monotonic() - t0 < 120:
            time.sleep(0.2)
            req = [r for r in _stream(jsonl) if r.get("kind") == "request"]
            # mid-load, once the burst's overload has been served: a
            # SIGTERM before the burst's tick (a fast host's first 60
            # records) leaves nothing to shed
            if (len(req) > 60 and max(r["step"] for r in req) > BURST_STEP
                    or proc.poll() is not None):
                break
        assert proc.poll() is None, "the drill ended before the SIGTERM"
        proc.send_signal(signal.SIGTERM)  # mid-load
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, out[-3000:]
    assert "termination notice: draining" in out

    records = _stream(jsonl)
    req = [r for r in records if r.get("kind") == "request"]
    _one_terminal_each(req)
    reasons = {}
    for r in req:
        if r.get("terminal") and r.get("reason"):
            reasons[r["reason"]] = reasons.get(r["reason"], 0) + 1
    assert reasons.get("ttft_budget", 0) + reasons.get("queue_full", 0) > 0
    assert reasons.get("malformed", 0) >= 1
    assert reasons.get("client_cancel", 0) >= 1
    ttfts = [r["ttft_s"] for r in req if r.get("terminal") and "ttft_s" in r]
    assert ttfts and percentile(ttfts, 99.0) <= TTFT_BUDGET

    (line,) = [x for x in out.splitlines() if x.startswith("serving drain:")]
    assert float(line.split()[2].rstrip("s,")) < GRACE
    good, identity, rep = _identity(records)
    assert good and identity and rep.productive_s > 0.0
    g = good[-1]
    total = g["productive_s"]
    for phase in BADPUT_PHASES:
        total = total + g[f"badput_{phase}_s"]
    assert total + g["unattributed_s"] == g["wall_s"]
    assert "steady-state compiles 0" in out
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary["device"] == "cpu" and summary["steady_state_compiles"] == 0
    assert summary["submitted"] == len({r["id"] for r in req})
    assert summary["drain"]["drain_s"] < GRACE
    assert all(n == 0 for n in summary["launch_counts"].values())


def test_serve_gpt_wedge_ends_with_the_incident_exit(tmp_path):
    jsonl = str(tmp_path / "wedge.jsonl")
    proc = _serve([
        "--requests", "24", "--rate", "50", "--metrics-jsonl", jsonl,
        "--chaos-hang-step", "20", "--stall-deadline", "0.5",
        "--stall-dump-after", "1.5", "--stall-terminate-after", "3",
    ], env=_env())
    try:
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 43, out[-3000:]
    assert "chaos: wedging this thread forever" in out
    assert "self-terminating with exit code 43" in out
    records = _stream(jsonl)
    kinds = [(r["kind"], r.get("stage") or r.get("phase")) for r in records]
    dump = kinds.index(("incident", "dump"))
    term = kinds.index(("incident", "terminate"))
    span = kinds.index(("span", "incident"))
    assert kinds.index(("stall", None)) < dump < term and dump < span
    bundle = records[dump]
    assert "wedge" in bundle["stacks"] and bundle["record_tail"]
    assert bundle["tick"] == 20 and bundle["step"] == 19
    assert records[term]["exit_code"] == 43
    assert records[span]["dur_s"] >= 3 * 0.5
    # the terminate teardown closed the stream: the accountant's
    # partition identity holds over it, the wedge booked as incident
    _, identity, rep = _identity(records)
    assert identity and rep.badput_s["incident"] >= 1.5


def test_gpt_example_telemetry_flags_on_the_cpu(tmp_path):
    jsonl = tmp_path / "m.jsonl"
    csv_path = tmp_path / "m.csv"
    prof = tmp_path / "profiles"
    os.environ.pop("APEX_TPU_PEAK_FLOPS", None)
    records = pretrain_gpt.main([
        "--device", "cpu", "--steps", "5", "--layers", "2", "--hidden", "64",
        "--heads", "2", "--seq-len", "32", "--micro-batch", "2",
        "--global-batch", "4", "--vocab", "128", "--log-interval", "2",
        "--metrics-jsonl", str(jsonl), "--metrics-csv", str(csv_path),
        "--profile-step", "2", "--profile-dir", str(prof), "--xray-hbm",
        "--stall-deadline", "60"])
    assert len(records) == 5
    recs = [json.loads(x) for x in jsonl.read_text().splitlines()]
    metrics = [r for r in recs if r["kind"] == "metrics"]
    assert [r["step"] for r in metrics] == [1, 3, 4]
    for r in metrics:
        assert r["mfu"] is None  # no peak on the CPU, never a guessed one
        assert r["tokens_per_s"] > 0 and r["loss"] > 0 and r["grad_norm"] > 0
        assert r["loss_scale"] == 65536.0 and r["skipped"] == 0.0
    # the interval means are the step lines' means
    assert metrics[0]["loss"] == pytest.approx(
        (records[0]["loss"] + records[1]["loss"]) / 2, rel=1e-6)
    (summary,) = [r for r in recs if r["kind"] == "summary"]
    assert summary["host_fetches"] == summary["intervals"] == 3
    assert summary["profiles"] == 1 and summary["stalls"] == 0
    memory = [r for r in recs if r["kind"] == "memory"]
    assert len(memory) == 3 and memory[0]["peak_bytes_in_use"] is None
    (profile,) = [r for r in recs if r["kind"] == "profile"]
    assert (profile["step"], profile["end_step"]) == (2, 3)
    assert (Path(profile["path"]) / "trace.json").is_file()
    assert not [r for r in recs if r["kind"] in ("stall", "incident")]
    spans = {r["phase"] for r in recs if r["kind"] == "span"}
    assert {"init", "compile", "step"} <= spans
    assert csv_path.read_text().splitlines()[0].startswith("t,step,kind")
