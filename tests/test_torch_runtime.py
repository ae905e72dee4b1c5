"""The host runtime's instruments against the JAX package's: slope timing
(``utils.benchmarking``) on an injected timer, the recompile sentinel
(``monitor.xray.compile_watch``) on an injected counter, the
collective-traffic ledger's accounting (``monitor.xray.ledger``; its
bytes for a real step are held to JAX's ``predict_comms`` in
``test_torch_parallel_training.py``'s world), and the goodput ``init``
span around ``AmpOptimizer.init``.

No assertion reads the wall clock: every time here is a scripted one.
"""

import numpy as np
import pytest
import torch

from apex_tpu.monitor import MemorySink as JaxMemorySink
from apex_tpu.monitor import MetricRouter as JaxRouter
from apex_tpu.monitor.goodput import spans as jax_spans
from apex_tpu.monitor.xray import compile_watch as jax_cw
from apex_tpu.monitor.xray import ledger as jax_ledger
from apex_tpu.utils import benchmarking as jax_bench
from apex_tpu_torch.monitor import MemorySink, MetricRouter
from apex_tpu_torch.monitor.goodput import spans as port_spans
from apex_tpu_torch.monitor.xray import compile_watch, ledger
from apex_tpu_torch.utils import benchmarking


# -- slope timing -------------------------------------------------------------

class _Chains:
    """A scripted device: a chain of k iterations takes ``t(k)`` seconds;
    records the chain lengths asked for."""

    def __init__(self, t):
        self.t, self.ks = t, []

    def build(self, k):
        def run(*args):
            return np.float32(k)

        run.k = k
        return run

    def best_of(self, fn, args, reps):
        k = getattr(fn, "__wrapped__", fn).k  # JAX jits the chain
        self.ks.append(k)
        return self.t(k), [np.float32(k)]


SLOPES = {
    # fast body: 0.1 ms an iteration over 2 ms a call; the span grows
    # until the signal passes target_signal
    "fast": lambda k: 2e-3 + 1e-4 * k,
    # slow body: the first span's signal is already enough
    "slow": lambda k: 0.01 + 0.05 * k,
    # jittery: a noisy but positive line
    "jitter": lambda k: 0.2 + 3e-3 * k + (1e-3 if k % 2 else 0.0),
}


@pytest.mark.parametrize("case", sorted(SLOPES))
@pytest.mark.parametrize("max_span", [8, 1024])
def test_slope_arithmetic_and_spans_equal_jax(monkeypatch, case, max_span):
    """The same scripted times give the same chain lengths and the same
    seconds an iteration as the JAX function, except that a first span
    above ``max_span`` starts at ``max_span`` (JAX's starts at 32)."""
    port, jax_ = _Chains(SLOPES[case]), _Chains(SLOPES[case])
    monkeypatch.setattr(benchmarking, "_best_of", port.best_of)
    monkeypatch.setattr(jax_bench, "_best_of", jax_.best_of)
    got = benchmarking.chained_seconds_per_iter(
        port.build, (), max_span=max_span, return_output=True)
    want = jax_bench.chained_seconds_per_iter(
        jax_.build, (), max_span=max_span, return_output=True)
    if max_span >= 32:
        assert port.ks == jax_.ks
        assert got[0] == want[0]
    else:
        assert port.ks == [1, 1 + max_span]
        assert got[0] == pytest.approx(
            (SLOPES[case](1 + max_span) - SLOPES[case](1)) / max_span,
            rel=1e-12)
    assert got[1] == [np.float32(port.ks[-1])]


@pytest.mark.parametrize("t", [lambda k: 1.0, lambda k: 1.0 - 1e-3 * k])
def test_a_non_positive_slope_is_refused_as_in_jax(monkeypatch, t):
    for mod in (benchmarking, jax_bench):
        chains = _Chains(t)
        monkeypatch.setattr(mod, "_best_of", chains.best_of)
        with pytest.raises(RuntimeError, match="non-positive slope"):
            mod.chained_seconds_per_iter(chains.build, (), max_span=64)


def test_a_passed_deadline_refuses_the_next_chain(monkeypatch):
    for mod in (benchmarking, jax_bench):
        chains = _Chains(SLOPES["fast"])
        monkeypatch.setattr(mod, "_best_of", chains.best_of)
        with pytest.raises(RuntimeError, match="budget exhausted"):
            mod.chained_seconds_per_iter(chains.build, (), deadline=0.0)
        assert chains.ks == []


def test_best_of_reads_the_injected_timer(monkeypatch):
    """``_best_of`` runs the chain once untimed, then ``reps`` timed runs
    on the timer, and keeps the fastest; the output is the fetched numpy
    of the first run."""
    clock = iter([0.0, 0.5, 1.0, 1.2, 5.0, 5.9])  # runs of 0.5, 0.2, 0.9 s
    monkeypatch.setattr(benchmarking, "_timer", lambda: next(clock))
    calls = []

    def chain(x):
        calls.append(1)
        return {"loss": torch.tensor([1.5]), "n": 3}

    best, out = benchmarking._best_of(chain, (None,), reps=3)
    assert best == pytest.approx(0.2) and len(calls) == 4
    assert [a.tolist() for a in out] == [[1.5], 3]


def test_seconds_per_iter_chains_the_step_from_the_carry(monkeypatch):
    """``seconds_per_iter`` chains ``step`` k times from the carry and
    reduces it (``full_reduce``): a clock that ticks once per step call
    gives one tick an iteration."""
    ticks = [0.0]

    def step(c):
        ticks[0] += 1e-3
        return {"w": c["w"] * 2.0}

    monkeypatch.setattr(benchmarking, "_timer", lambda: ticks[0])
    carry = {"w": torch.ones(3)}
    assert benchmarking.seconds_per_iter(step, carry, reps=2) == \
        pytest.approx(1e-3)
    assert float(benchmarking.full_reduce({"a": torch.ones(2, 2),
                                           "b": [torch.ones(3)]})) == 7.0


# -- the recompile sentinel -------------------------------------------------

class _Counter:
    """JAX's process-global counter's surface, scripted."""

    def __init__(self):
        self.count, self.seconds, self.available = 0, 0.0, True

    def snapshot(self):
        return self.count, self.seconds


BURSTS = [(2, 1.5), (0, 0.0), (1, 0.25), (0, 0.0), (3, 2.0)]


def test_compile_watcher_records_equal_jax(monkeypatch):
    """The same bursts after each step give the same ``kind="compile"``
    records (the schema and every field but the wall time), the first
    step's burst the warm-up and every later one ``recompile=True``."""
    counter = _Counter()
    monkeypatch.setattr(jax_cw, "_global_counter", lambda: counter)
    monkeypatch.setattr(compile_watch, "compile_counter",
                        lambda: counter.snapshot())
    jmem, pmem = JaxMemorySink(), MemorySink()
    jw = jax_cw.CompileWatcher(router=JaxRouter([jmem]), warn=False)
    pw = compile_watch.CompileWatcher(router=MetricRouter([pmem]),
                                      warn=False)
    assert pw.available
    for step, (n, secs) in enumerate(BURSTS):
        counter.count += n
        counter.seconds += secs
        jr, pr = jw.on_step(step), pw.on_step(step)
        assert (jr is None) == (pr is None) == (n == 0)
    # a booked burst swallowed by both
    counter.count += 5
    jw.rebaseline()
    pw.rebaseline()
    assert jw.on_step(9) is None and pw.on_step(9) is None

    def strip(recs):
        return [{k: v for k, v in r.items() if k != "t"} for r in recs]

    assert strip(pmem.records) == strip(jmem.records)
    assert [r["recompile"] for r in pmem.records] == [False, True, True]
    assert pmem.records[-1]["total_compiles"] == 6
    assert strip(pw.records) == strip(jw.records)


def test_compile_counter_counts_kernel_loads(monkeypatch):
    from apex_tpu_torch import _kernels

    monkeypatch.setattr(_kernels, "_LIBRARY_LOADS", [4, 1.25])
    assert compile_watch.compile_counter() == (4, 1.25)


def test_the_engine_counts_steady_state_loads_through_the_watcher(
        monkeypatch):
    """The serving engine's ``steady_state_compiles`` is a CompileWatcher:
    a kernel load after ``start()`` counts, one a fleet acknowledges
    (``acknowledge_compiles``) does not."""
    from apex_tpu_torch.models import GPTModel
    from apex_tpu_torch.serving import ServingConfig, ServingEngine
    from apex_tpu_torch.serving.__main__ import tiny_config

    loads = [0, 0.0]
    monkeypatch.setattr(compile_watch, "compile_counter",
                        lambda: tuple(loads))
    mem = MemorySink(kinds=("compile",))
    eng = ServingEngine(GPTModel(tiny_config(), device="cpu", seed=0),
                        ServingConfig(lanes=1, block_size=8, num_blocks=4,
                                      max_seq_len=32),
                        device="cpu", router=MetricRouter([mem]))
    eng.start()
    eng.submit(np.arange(5), max_new_tokens=3)
    eng.tick()
    loads[0] += 1
    eng.tick()
    assert eng.steady_state_compiles == 1
    loads[0] += 2
    eng.acknowledge_compiles()
    eng.tick()
    assert eng.steady_state_compiles == 1
    assert [(r["compiles"], r["recompile"]) for r in mem.records] == [
        (1, True)]


# -- the collective-traffic ledger -------------------------------------------

@pytest.mark.parametrize("op", ["psum", "pmax", "all_gather",
                                "psum_scatter", "all_to_all", "ppermute"])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("nbytes", [0, 4, 1000, 1 << 20])
def test_ring_bytes_equal_jax(op, n, nbytes):
    for nonempty in (True, False):
        assert ledger._ici_bytes(op, nbytes, n, nonempty) == \
            jax_ledger._ici_bytes(op, nbytes, n, nonempty)


ENTRIES = [("psum", "dp", 2, (128, 192), "float32", 1),
           ("psum", "tp", 2, (2, 64), "float32", 2),
           ("all_gather", "tp", 2, (32, 2, 128), "bfloat16", 2),
           ("psum_scatter", "dp", 4, (262144,), "float32", 1),
           ("ppermute", "pp", 2, (4, 1024, 768), "bfloat16", 3),
           ("all_to_all", "cp", 4, (4, 8, 2048, 64), "bfloat16", 1)]


def _entries(mod, torch_dtypes):
    out = []
    for op, axis, n, shape, dtype, count in ENTRIES:
        itemsize = np.dtype(np.float32).itemsize if dtype == "float32" else 2
        nbytes = int(np.prod(shape)) * itemsize
        out.append(mod.CollectiveEntry(
            op=op, axis=axis, axis_size=n, shape=shape, dtype=dtype,
            bytes=nbytes, ici_bytes=mod._ici_bytes(op, nbytes, n),
            count=count))
    return out


def test_ledger_aggregates_equal_jax(monkeypatch):
    """Aggregates, records and the banner equal JAX's, ``ici_seconds``
    included: with no link known on either side (the CPU, no override)
    both records carry None."""
    monkeypatch.delenv("APEX_TPU_ICI_BANDWIDTH", raising=False)
    monkeypatch.delenv(ledger.LINK_BANDWIDTH_ENV, raising=False)
    ours, theirs = ledger.CommsLedger(), jax_ledger.CommsLedger()
    ours.entries, theirs.entries = _entries(ledger, True), _entries(
        jax_ledger, False)
    assert ours.per_axis() == theirs.per_axis()
    for axis in (None, "tp", "dp"):
        assert ours.per_op(axis) == theirs.per_op(axis)
    for op, axis in ((None, None), ("psum", None), (None, "tp")):
        assert ours.total_bytes(op, axis) == theirs.total_bytes(op, axis)
        assert ours.total_ici_bytes(op, axis) == \
            theirs.total_ici_bytes(op, axis)

    def strip(recs, drop=()):
        return [{k: v for k, v in r.items()
                 if k not in ("t", "host") + drop} for r in recs]

    assert strip(ours.to_records(7)) == strip(theirs.to_records(7))
    ours_lines = ours.summary().splitlines()
    theirs_lines = theirs.summary().splitlines()
    assert len(ours_lines) == len(theirs_lines)
    for a, b in zip(ours_lines, theirs_lines):
        assert a == b.split(" ici=?")[0]


def test_recording_needs_an_active_ledger_and_multiplies_by_scaled(
        monkeypatch):
    """``record`` is a no-op with no ledger active or inside ``muted``;
    ``scaled`` multiplies ``count``; nested ledgers each record; a group
    of one rank records nothing."""
    from apex_tpu_torch.parallel import parallel_state as ps

    sizes = {"g2": 2, "g1": 1}
    monkeypatch.setattr(ps, "group_size", lambda g: sizes[g])
    monkeypatch.setattr(ledger, "axis_of", lambda g: "dp")
    x = torch.zeros(3, 5, dtype=torch.bfloat16)
    ledger.record("psum", x, "g2")  # nothing active: dropped
    with ledger.comms_ledger() as outer:
        ledger.record("psum", x, "g2")
        ledger.record("psum", x, "g1")
        with ledger.muted():
            ledger.record("psum", x, "g2")
        with ledger.comms_ledger() as inner, ledger.scaled(3):
            with ledger.scaled(2):
                ledger.record("all_gather", [x, x], "g2")
    assert [(e.op, e.count, e.bytes, e.dtype, e.shape)
            for e in outer.entries] == [
        ("psum", 1, 30, "bfloat16", (3, 5)),
        ("all_gather", 6, 30, "bfloat16", (3, 5)),
        ("all_gather", 6, 30, "bfloat16", (3, 5))]
    assert len(inner) == 2
    assert outer.per_axis()["dp"] == {"bytes": 30 + 2 * 6 * 30,
                                      "ici_bytes": 30 + 2 * 6 * 30,
                                      "calls": 13, "axis_size": 2}
    with pytest.raises(ValueError):
        with ledger.scaled(-1):
            pass


def test_predict_comms_runs_the_function_once_under_a_fresh_ledger(
        monkeypatch):
    from apex_tpu_torch.parallel import parallel_state as ps

    monkeypatch.setattr(ps, "group_size", lambda g: 4)
    monkeypatch.setattr(ledger, "axis_of", lambda g: "tp")
    runs = []

    def step(x):
        runs.append(1)
        ledger.record("psum_scatter", x, object())

    led = ledger.predict_comms(step, torch.zeros(16))
    assert len(runs) == 1 and led.per_op("tp") == {
        "psum_scatter": {"bytes": 64, "ici_bytes": 48, "calls": 1}}


# -- the goodput init span around AmpOptimizer.init ---------------------------

def test_amp_optimizer_init_books_an_init_span_as_jax():
    import jax.numpy as jnp

    from apex_tpu import amp as jax_amp
    from apex_tpu.optimizers import fused_adam as jax_fused_adam
    from apex_tpu_torch import amp
    from apex_tpu_torch.optimizers import fused_adam

    jmem, pmem = JaxMemorySink(kinds=("span",)), MemorySink(kinds=("span",))
    jax_spans.set_router(JaxRouter([jmem]))
    port_spans.set_router(MetricRouter([pmem]))
    try:
        jopt = jax_amp.AmpOptimizer(jax_fused_adam(lr=1e-3),
                                    jax_amp.O2())
        jopt.init({"w": jnp.ones((4, 4), jnp.bfloat16)})
        popt = amp.AmpOptimizer(fused_adam(lr=1e-3), amp.O2())
        state = popt.init({"w": torch.ones(4, 4, dtype=torch.bfloat16)})
    finally:
        jax_spans.set_router(None)
        port_spans.set_router(None)
    assert state.master["w"].dtype == torch.float32
    assert [r["phase"] for r in pmem.records] == \
        [r["phase"] for r in jmem.records] == ["init"]
    assert pmem.records[0]["dur_s"] >= 0.0
