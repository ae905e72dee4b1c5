"""apex_tpu_torch.monitor against the JAX package's apex_tpu.monitor: the
record router and its sinks, the goodput spans and accountant, and the
serving engine's KV-pool record.

The same events go through both routers; the records agree apart from
``t`` (the wall clock of the emit) and ``host``. Each accountant reads
the other's stream to the same partition, compared with ``==``.
"""

import csv
import io
import json
import signal
import time

import numpy as np
import pytest
import torch

import apex_tpu.monitor.goodput.accountant as jax_accountant
import apex_tpu.monitor.goodput.spans as jax_spans
import apex_tpu.monitor.router as jax_router
from apex_tpu.monitor.xray.hbm.live import kv_pool_fields as jax_kv_pool_fields
from apex_tpu_torch.models import GPTModel
from apex_tpu_torch.monitor import goodput
from apex_tpu_torch.monitor import router as port_router
from apex_tpu_torch.monitor.goodput import accountant as port_accountant
from apex_tpu_torch.monitor.goodput import spans as port_spans
from apex_tpu_torch.monitor.xray.hbm.live import kv_pool_fields
from apex_tpu_torch.serving import ServingConfig, ServingEngine
from apex_tpu_torch.transformer import TransformerConfig

SIDES = {"jax": (jax_router, jax_spans, jax_accountant),
         "port": (port_router, port_spans, port_accountant)}


@pytest.fixture(autouse=True)
def _restore_process_state():
    """The routers install a SIGTERM flush and register flush hooks on
    first use: put the handler back and drop the hooks after each test,
    so no handler or sink outlives it."""
    handler = signal.getsignal(signal.SIGTERM)
    hooks = {m: list(m._FLUSH_HOOKS) for m in (jax_router, port_router)}
    yield
    signal.signal(signal.SIGTERM, handler)
    for m, saved in hooks.items():
        m._FLUSH_HOOKS[:] = saved
    jax_spans.set_router(None)
    port_spans.set_router(None)


def _drive(router_mod, sink):
    """A fixed mixed stream through one router of ``router_mod``."""
    r = router_mod.MetricRouter([sink])
    r.metrics(1, loss=2.5, lr=1e-3, tokens_per_s=1234.5)
    r.event("request", 3, id=7, state="queued", reason=None, prompt_len=5,
            max_new=6, tokens_out=0)
    r.metrics(2, loss=None, grad_norm=0.75)
    r.event("fleet", 4, check="replica", replica="r0", action="detected",
            state="detected", incarnation=0)
    r.timer_write_fn("forward", 0.125, 5)
    r.event("span", 6, phase="decode", start=1.5, dur_s=0.25)
    r.metrics(7, loss=1.25, lr=5e-4, tokens_per_s=99.0)
    r.close()
    r.metrics(8, loss=0.0)  # after close: dropped
    return r


def _strip(rec):
    return {k: v for k, v in rec.items() if k not in ("t", "host")}


def _sink_output(side, kind, tmp_path):
    mod = SIDES[side][0]
    if kind == "memory":
        sink = mod.MemorySink(max_records=4, kinds=("metrics", "timer"))
        _drive(mod, sink)
        return [_strip(r) for r in sink.snapshot()]
    if kind == "jsonl":
        path = tmp_path / f"{side}.jsonl"
        _drive(mod, mod.JsonlSink(str(path)))
        return [_strip(json.loads(line))
                for line in path.read_text().splitlines()]
    if kind == "csv":
        path = tmp_path / f"{side}.csv"
        _drive(mod, mod.CsvSink(str(path)))
        rows = list(csv.DictReader(io.StringIO(path.read_text())))
        return [_strip(r) for r in rows]
    stream = io.StringIO()
    _drive(mod, mod.StdoutSink(stream=stream))
    return stream.getvalue()


@pytest.mark.parametrize("kind", ["memory", "jsonl", "csv", "stdout"])
def test_same_events_give_same_records(kind, tmp_path):
    want = _sink_output("jax", kind, tmp_path)
    got = _sink_output("port", kind, tmp_path)
    assert want and got == want


def test_failing_sink_is_isolated_like_jax():
    """A sink that raises loses its records, the others keep theirs, and
    a second close is a no-op, in both routers."""
    out = {}
    for side, (mod, _, _) in SIDES.items():
        class Broken(mod.Sink):
            def emit(self, record):
                raise OSError("disk full")

            def close(self):
                raise OSError("still full")

        mem = mod.MemorySink()
        r = mod.MetricRouter([Broken(), mem])
        r.metrics(1, loss=1.0)
        r.close()
        r.close()
        r.metrics(2, loss=2.0)
        out[side] = [_strip(x) for x in mem.snapshot()]
    assert out["port"] == out["jax"] == [
        {"step": 1, "kind": "metrics", "loss": 1.0}]


def test_host_field(monkeypatch):
    """0 without a process group, the rank with one, and
    ``APEX_TPU_HOST`` over both."""
    assert port_router.make_record("metrics", 0)["host"] == 0
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 3)
    assert port_router.make_record("metrics", 0)["host"] == 3
    monkeypatch.setenv("APEX_TPU_HOST", "5")
    assert port_router.make_record("metrics", 0)["host"] == 5
    assert jax_router.make_record("metrics", 0)["host"] == 5


def test_phase_taxonomy_matches_jax():
    for name in ("PHASES", "PHASE_PRIORITY", "PRODUCTIVE_PHASE",
                 "PRODUCTIVE_PHASES"):
        assert getattr(port_spans, name) == getattr(jax_spans, name)
    assert port_accountant.BADPUT_PHASES == jax_accountant.BADPUT_PHASES
    with pytest.raises(ValueError, match="taxonomy is closed"):
        goodput.begin_span("lunch")


def _span_stream(side):
    """Two incarnations of spans (nested, overlapping, one interrupted)
    through one side's span API."""
    mod, spans, _ = SIDES[side]
    mem = mod.MemorySink()
    r = mod.MetricRouter([mem])
    for inc in range(2):
        spans.run_header(r, "run-x", step=inc)
        with spans.span("init", router=r):
            time.sleep(0.002)
            with spans.span("compile", router=r, step=-1):
                time.sleep(0.002)
        for t in range(3):
            with spans.span("prefill", router=r, step=t):
                time.sleep(0.001)
            with spans.span("decode", router=r, step=t):
                h = spans.begin_span("handoff", router=r, step=t)
                time.sleep(0.001)
                h.close()
        spans.set_router(r)
        spans.begin_span("drain", step=3)
        time.sleep(0.001)
        assert spans.flush_open_spans() == 1
        spans.set_router(None)
    r.close()
    return mem.snapshot()


def _serving_stream():
    cfg = TransformerConfig(num_layers=1, hidden_size=32,
                            num_attention_heads=2, vocab_size=61,
                            max_position_embeddings=32, hidden_dropout=0.0,
                            attention_dropout=0.0,
                            compute_dtype=torch.float32)
    mem = port_router.MemorySink()
    r = port_router.MetricRouter([mem])
    port_spans.run_header(r, "serving")
    eng = ServingEngine(GPTModel(cfg, device="cpu", seed=0),
                        ServingConfig(lanes=2, block_size=8, num_blocks=8,
                                      max_seq_len=32),
                        device="cpu", router=r)
    rs = np.random.RandomState(0)
    for n in (5, 9, 3):
        eng.submit(rs.randint(0, 61, size=n), max_new_tokens=4)
    while not eng.idle:
        eng.tick()
    eng.drain()
    r.close()
    return mem.snapshot()


@pytest.mark.parametrize("stream", ["port", "jax", "port_serving"])
def test_accountants_read_each_others_streams(stream):
    records = (_serving_stream() if stream == "port_serving"
               else _span_stream(stream))
    records = [json.loads(json.dumps(r)) for r in records]
    rep_p = port_accountant.account(records)
    rep_j = jax_accountant.account(records)
    assert rep_p.fields() == rep_j.fields()
    assert (rep_p.incarnations, rep_p.n_spans, rep_p.n_interrupted) == \
        (rep_j.incarnations, rep_j.n_spans, rep_j.n_interrupted)
    lhs = rep_p.productive_s
    for phase in port_accountant.BADPUT_PHASES:
        lhs = lhs + rep_p.badput_s[phase]
    assert lhs + rep_p.unattributed_s == rep_p.wall_s
    assert rep_p.productive_s > 0.0


@pytest.mark.parametrize("kw", [
    dict(num_blocks=64, free_blocks=64, block_size=16, live_tokens=0),
    dict(num_blocks=64, free_blocks=10, block_size=16, live_tokens=700,
         peak_used_blocks=60),
    dict(num_blocks=4, free_blocks=0, block_size=8, live_tokens=31,
         peak_used_blocks=4),
    dict(num_blocks=4, free_blocks=5, block_size=8, live_tokens=0),
])
def test_kv_pool_fields_match_jax(kw):
    try:
        want = jax_kv_pool_fields(**kw)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            kv_pool_fields(**kw)
        return
    assert kv_pool_fields(**kw) == want
