"""apex_tpu_torch.monitor's instruments against the JAX package's.

FLOPs and MFU are closed forms: equal to JAX's exactly, on parametrised
configs. The metric bag folds the same seeded value sequence (NaN and Inf
included) in both packages; the fp32 aggregates are the same operations
in the same order, so ``read_bag`` is equal exactly. The grad norms take
the same seeded tensors (1e-6 relative: fp32 sums of squares in another
order). The stall watchdog's ladder and the profiler trigger run in
process on the CPU.
"""

import json
import math
import os
import signal
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import monitor as jmon
from apex_tpu.transformer import TransformerConfig as JaxConfig
from apex_tpu_torch import monitor
from apex_tpu_torch.models import GPTModel
from apex_tpu_torch.monitor import flops
from apex_tpu_torch.monitor import router as port_router
from apex_tpu_torch.monitor.goodput import spans as port_spans
from apex_tpu_torch.resilience.sentinel import VERDICT_ROLLBACK, VERDICT_SKIP
from apex_tpu_torch.transformer import TransformerConfig


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


BASE = dict(num_layers=3, hidden_size=64, num_attention_heads=4,
            vocab_size=1000, max_position_embeddings=128)
CONFIGS = {
    "gpt": {},
    "gqa": {"num_query_groups": 2},
    "gated": {"activation": "swiglu", "ffn_hidden_size": 96},
    "moe": {"num_moe_experts": 4, "moe_top_k": 2},
    "kv_channels": {"kv_channels": 32},
}


@pytest.mark.parametrize("extra", list(CONFIGS.values()), ids=list(CONFIGS))
@pytest.mark.parametrize("seq_len", [None, 96])
def test_flops_equal_jax(extra, seq_len):
    j = JaxConfig(**BASE, **extra)
    t = TransformerConfig(**BASE, **extra)
    s = seq_len or BASE["max_position_embeddings"]
    assert (flops.transformer_layer_flops_per_token(t, s)
            == jmon.transformer_layer_flops_per_token(j, s))
    assert (flops.gpt_flops_per_token(t, seq_len)
            == jmon.gpt_flops_per_token(j, seq_len))
    assert (flops.bert_flops_per_token(t, seq_len)
            == jmon.bert_flops_per_token(j, seq_len))
    per_step = flops.training_flops_per_step(
        flops.gpt_flops_per_token(t, seq_len), 16 * s)
    assert per_step == jmon.training_flops_per_step(
        jmon.gpt_flops_per_token(j, seq_len), 16 * s)
    for secs, n, peak in ((0.25, 1, 989e12), (1.5, 4, 756e12)):
        assert flops.mfu(per_step, secs, n, peak) == jmon.mfu(
            per_step, secs, n, peak)
    assert flops.tokens_per_second(4096, 0.5) == jmon.tokens_per_second(
        4096, 0.5)


def test_gpt2_small_flops_are_the_hand_count():
    cfg = TransformerConfig(num_layers=12, hidden_size=768,
                            num_attention_heads=12, vocab_size=50257,
                            max_position_embeddings=1024)
    h, s = 768, 1024
    layer = 2 * h * 3 * h + 4 * s * h + 2 * h * h + 2 * 2 * h * 4 * h
    assert flops.gpt_flops_per_token(cfg) == 12 * layer + 2 * h * 50257


@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3", 989e12),
    ("NVIDIA H100 PCIe", 756e12),
    ("NVIDIA A100-SXM4-80GB", None),
    ("NVIDIA H100 NVL", None),
])
def test_peak_table_reads_the_card_name(monkeypatch, name, peak):
    monkeypatch.delenv("APEX_TPU_PEAK_FLOPS", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: name)
    assert flops.peak_flops_per_device() == peak
    assert flops.peak_flops_per_device(torch.device("cuda", 0)) == peak
    # a CPU device never has a peak, whatever card sits beside it
    assert flops.peak_flops_per_device(torch.device("cpu")) is None
    if peak is None:
        assert flops.mfu(1e12, 1.0, 1) is None


def test_peak_is_none_without_a_card_and_the_env_overrides(monkeypatch):
    monkeypatch.delenv("APEX_TPU_PEAK_FLOPS", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert flops.peak_flops_per_device() is None
    assert flops.mfu(1e12, 1.0, 1) is None
    monkeypatch.setenv("APEX_TPU_PEAK_FLOPS", "2e12")
    assert flops.peak_flops_per_device() == 2e12
    assert flops.mfu(1e12, 1.0, 1) == 0.5
    assert flops.mfu(1e12, 0.0, 1) is None


SPEC = {"loss": "mean", "events": "sum", "scale": "last", "peak": "max",
        "never": "mean"}


def _sequence(seed=0, n=9):
    rs = np.random.RandomState(seed)
    seq = []
    for i in range(n):
        step = {"loss": float(rs.randn()), "events": float(rs.randint(0, 3)),
                "scale": float(2.0 ** rs.randint(8, 16)),
                "peak": float(rs.randn() * 5)}
        if i == 2:
            step["loss"] = math.nan
        if i == 4:
            step["peak"] = math.inf
            step["scale"] = -math.inf
        if i == 6:
            del step["events"]
        seq.append(step)
    return seq


def _fold_both(seq):
    jbag = jmon.metric_bag(SPEC)
    bag = monitor.metric_bag(SPEC, device="cpu")
    for step in seq:
        jbag = jbag.add(**{k: jnp.float32(v) for k, v in step.items()})
        bag.add(**{k: torch.tensor(v) for k, v in step.items()})
    return jbag, bag


def test_read_bag_equals_jax():
    jbag, bag = _fold_both(_sequence())
    got, want = monitor.read_bag(bag), jmon.read_bag(jbag)
    assert got == want
    assert got["never"] is None and got["loss"] is not None
    assert int(bag.count) == int(jbag.count) == 9
    for name in SPEC:
        assert int(bag.counts[name]) == int(jbag.counts[name])


def test_bag_modes_and_non_finite_exclusion():
    bag = monitor.metric_bag(SPEC, device="cpu")
    bag.add(loss=1.0, events=2.0, scale=4.0, peak=-3.0)
    bag.add(loss=math.nan, events=1.0, scale=math.inf, peak=math.nan)
    bag.add(loss=3.0, peak=-1.0)
    out = monitor.read_bag(bag)
    assert out == {"loss": 2.0, "events": 3.0, "scale": 4.0, "peak": -1.0,
                   "never": None}
    with pytest.raises(KeyError, match="typo"):
        bag.add(typo=1.0)
    with pytest.raises(ValueError, match="scalar"):
        bag.add(loss=torch.ones(2))
    with pytest.raises(ValueError, match="unknown metric modes"):
        monitor.metric_bag({"x": "median"}, device="cpu")


def test_reset_and_merge_equal_jax():
    seq = _sequence(seed=1)
    ja, a = _fold_both(seq[:5])
    jb, b = _fold_both(seq[5:])
    assert monitor.read_bag(a.merge(b)) == jmon.read_bag(ja.merge(jb))
    assert monitor.read_bag(b.merge(a)) == jmon.read_bag(jb.merge(ja))
    storage = a.values["loss"].data_ptr()
    monitor.reset_bag(a)
    assert a.values["loss"].data_ptr() == storage  # zeroed in place
    assert monitor.read_bag(a) == jmon.read_bag(jmon.reset_bag(ja))
    assert int(a.count) == 0
    with pytest.raises(ValueError, match="different specs"):
        a.merge(monitor.metric_bag({"x": "sum"}, device="cpu"))


@pytest.mark.parametrize("steps,interval", [(12, 3), (10, 5), (7, 7)])
def test_one_host_fetch_per_interval(steps, interval):
    bag = monitor.metric_bag(SPEC, device="cpu")
    before = monitor.host_fetch_count()
    reads = []
    for i in range(steps):
        bag.add(loss=torch.tensor(float(i)), events=1.0)
        assert monitor.host_fetch_count() - before == len(reads)
        if (i + 1) % interval == 0:
            reads.append(monitor.read_bag(bag))
            monitor.reset_bag(bag)
    assert monitor.host_fetch_count() - before == steps // interval
    assert reads[0]["events"] == float(interval)


def _grads(seed=0):
    rs = np.random.RandomState(seed)
    return {"params": {
        "embedding": {"word": rs.randn(50, 16).astype(np.float32)},
        "layer_0": {"qkv": rs.randn(16, 48).astype(np.float32),
                    "bias": rs.randn(48).astype(np.float32)},
        "layer_1": {"dense": rs.randn(16, 16).astype(np.float32) * 3},
    }}


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(tree)


def test_grad_norms_equal_jax():
    g = _grads()
    tg = _torch_tree(g)
    np.testing.assert_allclose(float(monitor.global_grad_norm(tg)),
                               float(jmon.global_grad_norm(g)), rtol=1e-6)
    want = {k: float(v) for k, v in jmon.per_layer_grad_norms(g).items()}
    got = {k: float(v) for k, v in monitor.per_layer_grad_norms(tg).items()}
    assert set(got) == set(want) == {"grad_norm/embedding",
                                     "grad_norm/layer_0", "grad_norm/layer_1"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
    # dotted names (dict(model.named_parameters())) group by their first
    # component, as the nested dicts they stand for
    flat = {f"{top}.{leaf}": t for top, sub in tg["params"].items()
            for leaf, t in sub.items()}
    dotted = {k: float(v) for k, v in monitor.per_layer_grad_norms(
        flat).items()}
    assert dotted == got
    lone = monitor.per_layer_grad_norms(torch.ones(4))
    assert list(lone) == ["grad_norm/all"] and float(lone[
        "grad_norm/all"]) == 2.0
    assert float(monitor.global_grad_norm({})) == 0.0


def test_taps_from_intermediates_equal_jax_and_read_the_layers():
    rs = np.random.RandomState(3)
    inter = {"intermediates": {
        "transformer": {
            "layer_0": {"layer_out_rms": (rs.rand(),)},
            "layer_1": {"layer_out_rms": (rs.rand(),),
                        "moe_aux_loss": (rs.rand(), rs.rand())},
        }}}
    want = {k: float(v) for k, v in jmon.taps_from_intermediates(
        inter).items()}
    got = {k: float(v) for k, v in monitor.taps_from_intermediates(
        inter).items()}
    assert set(got) == set(want) == {"layer_out_rms", "moe_aux_loss"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
    cfg = TransformerConfig(num_layers=2, hidden_size=32,
                            num_attention_heads=4, vocab_size=64,
                            max_position_embeddings=16,
                            compute_dtype=torch.float32,
                            collect_layer_metrics=True)
    model = GPTModel(cfg, device="cpu", seed=0)
    with torch.no_grad():
        model(torch.arange(16)[None])
    rms = [getattr(model.transformer, f"layer_{i}").layer_out_rms
           for i in range(2)]
    taps = monitor.taps_from_intermediates(model)
    assert set(taps) == {"layer_out_rms"}
    assert torch.equal(taps["layer_out_rms"], torch.stack(rms).mean())
    assert set(monitor.REGISTERED_TAPS) == set(jmon.REGISTERED_TAPS)


def _wait(pred, timeout=10.0):
    t0 = time.monotonic()
    while not pred() and time.monotonic() - t0 < timeout:
        time.sleep(0.01)
    return pred()


def test_stall_watchdog_ladder_order_and_once_per_episode():
    mem = monitor.MemorySink()
    router = monitor.MetricRouter([mem])
    order, lock = [], threading.Lock()

    def level(name):
        def cb(info):
            with lock:
                order.append((name, info["step"]))
        return cb

    dog = monitor.StallWatchdog(
        0.05, poll_s=0.01, router=router,
        on_stall=lambda info: order.append(("warn", info["step"])),
        escalations=[(3.0, level("third")), (2.0, level("second"))])
    dog.start()
    try:
        dog.beat(7)
        assert _wait(lambda: len(order) >= 3)
        time.sleep(0.3)  # a dead loop does not fire again
        assert order == [("warn", 7), ("second", 7), ("third", 7)]
        dog.beat(8)  # re-arms every level
        assert _wait(lambda: len(order) >= 6)
        assert order[3:] == [("warn", 8), ("second", 8), ("third", 8)]
    finally:
        dog.stop()
        router.close()
    stalls = [r for r in mem.records if r["kind"] == "stall"]
    spans = [r for r in mem.records
             if r["kind"] == "span" and r["phase"] == "stall"]
    assert [r["step"] for r in stalls] == [7, 8] and len(spans) == 2
    assert all(r["dur_s"] > 0.05 for r in spans)
    with pytest.raises(ValueError, match="multipliers"):
        monitor.StallWatchdog(1.0, escalations=[(0.5, print)])
    with pytest.raises(ValueError, match="deadline_s"):
        monitor.StallWatchdog(0.0)


def test_watchdog_outlives_a_raising_escalation():
    fired = []

    def boom(info):
        raise RuntimeError("handler bug")

    dog = monitor.StallWatchdog(
        0.05, poll_s=0.01,
        escalations=[(1.5, boom), (2.0, lambda i: fired.append(i))])
    with dog:
        assert _wait(lambda: fired)
    assert len(dog.stalls) == 1


def test_profiler_trigger_writes_a_chrome_trace_on_the_cpu(tmp_path):
    mem = monitor.MemorySink()
    router = monitor.MetricRouter([mem])
    trigger = monitor.ProfilerTrigger(str(tmp_path), window_steps=2,
                                      router=router)
    with pytest.raises(ValueError, match="window_steps"):
        monitor.ProfilerTrigger(str(tmp_path), window_steps=0)
    trigger.request(step=5)
    trigger.on_verdict(0, VERDICT_SKIP)  # below ROLLBACK: no anomaly
    assert trigger._requested == {"step": 5, "reason": "requested"}
    trigger.on_verdict(0, VERDICT_ROLLBACK)  # the anomaly outranks step 5
    assert trigger._requested["step"] is None
    x = torch.randn(64, 64)
    for step in range(1, 4):
        started = trigger.maybe_start(step)
        assert started == (step == 1)
        if step == 1:
            # one capture at a time: a request while it rolls is refused
            trigger.request(step=None, reason="late")
            assert trigger._requested is None
        (x @ x).sum()
        info = trigger.maybe_stop(step)
        assert (info is not None) == (step == 2)
    cap = trigger.captures[0]
    assert cap["reason"] == f"verdict={VERDICT_ROLLBACK}"
    assert (cap["start_step"], cap["end_step"]) == (1, 2)
    assert os.path.basename(cap["path"]) == (
        f"verdict{VERDICT_ROLLBACK}-step000001")
    with open(cap["trace"]) as f:
        trace = json.load(f)
    assert trace["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in trace["traceEvents"])
    (rec,) = [r for r in mem.records if r["kind"] == "profile"]
    assert rec["step"] == 1 and rec["end_step"] == 2
    # the scheduled request fires later; close() aborts it unwritten
    trigger.request(step=4)
    assert trigger.maybe_start(4)
    trigger.close()
    assert len(trigger.captures) == 1
    assert not os.path.exists(os.path.join(str(tmp_path),
                                           "requested-step000004",
                                           "trace.json"))
    router.close()
