"""apex_tpu_torch.serving's records, drain, handoff and kernel-load watch
against the JAX engine's on the same inputs.

The model is the JAX serving gate's tiny GPT (2 layers, hidden 32, 4
heads, vocab 61, rotary positions, fp32), initialised by the JAX package
from ``PRNGKey(0)`` and carried over with ``models.convert``. Both
engines run the gate's staggered scenario (block 8, a 4-block pool,
prompts of 5/9/12 tokens with 6/5/4 new: both reserve 2 blocks a request,
so the third waits in both) on a clock the test sets by hand, so every
latency field of every record is the same number in both streams.
"""

import ctypes
import signal
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _ctypes
import apex_tpu.monitor.router as jax_router
from apex_tpu.models import GPTModel as JaxGPT
from apex_tpu.monitor import MemorySink as JaxMemorySink
from apex_tpu.monitor import MetricRouter as JaxRouter
from apex_tpu.serving.engine import ServingConfig as JaxServingConfig
from apex_tpu.serving.engine import ServingEngine as JaxServingEngine
from apex_tpu.serving.trace.analyze import analyze as jax_analyze
from apex_tpu.transformer import TransformerConfig as JaxConfig
from apex_tpu_torch import _kernels
from apex_tpu_torch.models import GPTModel, generate, gpt_params_from_jax
from apex_tpu_torch.monitor import MemorySink, MetricRouter
from apex_tpu_torch.monitor import router as port_router
from apex_tpu_torch.serving import ServingConfig, ServingEngine
from apex_tpu_torch.serving.trace.analyze import analyze
from apex_tpu_torch.transformer import TransformerConfig

TINY = dict(num_layers=2, hidden_size=32, num_attention_heads=4,
            vocab_size=61, max_position_embeddings=64, hidden_dropout=0.0,
            attention_dropout=0.0, position_embedding_type="rope")
LOGITS_TOL = 1e-5
KINDS = ("request", "run", "span", "trace", "memory")


@pytest.fixture(autouse=True)
def _restore_process_state():
    """Both packages' routers install a SIGTERM flush and register flush
    hooks on first use: put the handler back and drop the hooks after
    each test, so none outlives it."""
    handler = signal.getsignal(signal.SIGTERM)
    hooks = {m: list(m._FLUSH_HOOKS) for m in (jax_router, port_router)}
    yield
    signal.signal(signal.SIGTERM, handler)
    for m, saved in hooks.items():
        m._FLUSH_HOOKS[:] = saved


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


class Clock:
    """A clock the test sets by hand; ``step`` > 0 advances it on every
    read (for the zero-grace drain, whose deadline must pass)."""

    def __init__(self, step=0.0):
        self.t, self.step = 100.0, step

    def __call__(self):
        self.t += self.step
        return self.t


@pytest.fixture(scope="module")
def models():
    jmodel = JaxGPT(config=JaxConfig(compute_dtype=jnp.float32, **TINY))
    variables = jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 4), jnp.int32))
    model = GPTModel(TransformerConfig(compute_dtype=torch.float32, **TINY),
                     device="cpu")
    model.load_state_dict(gpt_params_from_jax(_np(variables["params"])),
                          strict=True)
    return jmodel, variables, model


def _prompts():
    rng = np.random.RandomState(0)
    return [rng.randint(0, 61, size=n).astype(np.int32) for n in (5, 9, 12)]


def _make(models, side, cfg_kw, clock):
    """One engine of ``side`` ("jax" or "port") with a MemorySink router."""
    jmodel, variables, model = models
    if side == "jax":
        mem = JaxMemorySink(kinds=KINDS)
        router = JaxRouter([mem])
        eng = JaxServingEngine(jmodel, variables, JaxServingConfig(**cfg_kw),
                               router=router, time_fn=clock)
    else:
        mem = MemorySink(kinds=KINDS)
        router = MetricRouter([mem])
        eng = ServingEngine(model, ServingConfig(**cfg_kw), device="cpu",
                            router=router, time_fn=clock)
    eng.start()
    return types.SimpleNamespace(eng=eng, mem=mem, router=router,
                                 clock=clock)


GATE = dict(lanes=3, block_size=8, num_blocks=4, max_seq_len=32,
            max_queue_depth=4, seed=0, collect_logits=True,
            memory_interval_ticks=2)


def _scenario(run):
    """The gate's staggered three requests, then the block-reservation
    pin (a 17-token prompt with 1 new token), then two more requests and
    a drain with a 60 s grace, the clock moving 10 ms a tick."""
    eng, clock = run.eng, run.clock
    out = types.SimpleNamespace()
    out.reqs = [eng.submit(p, max_new_tokens=m)
                for p, m in zip(_prompts(), (6, 5, 4))]
    out.zero = [eng.submit(_prompts()[0], max_new_tokens=n) for n in (0, -3)]
    out.waited = 0
    while not eng.idle:
        clock.t += 0.01
        eng.tick()
        out.waited += out.reqs[2].state == "queued"
    out.pin = eng.submit(np.arange(17, dtype=np.int32) % 61,
                         max_new_tokens=1)
    while not eng.idle:
        clock.t += 0.01
        eng.tick()
    d = [eng.submit(p, max_new_tokens=6) for p in _prompts()[:2]]
    clock.t += 0.01
    eng.tick()
    out.drain = eng.drain(grace_s=60.0)
    out.redundant = eng.drain()
    out.post = eng.submit(_prompts()[0], max_new_tokens=2)
    out.reqs += out.zero + [out.pin] + d + [out.post]
    run.router.close()
    out.records = run.mem.snapshot()
    return out


@pytest.fixture(scope="module")
def staggered(models):
    return {side: _scenario(_make(models, side, GATE, Clock()))
            for side in ("jax", "port")}


def _by_rid(records, kind="request"):
    out = {}
    for r in records:
        if r.get("kind") == kind:
            key = r["id"] if kind == "request" else r["trace"]
            out.setdefault(key, []).append(
                {k: v for k, v in r.items() if k not in ("t", "host")})
    return out


def test_terminal_records_per_rid_match_jax(staggered):
    """Per rid: the terminal state, the reason, the tokens and the number
    of records are JAX's; on the hand-set clock so is every field of
    every request record."""
    j, p = staggered["jax"], staggered["port"]
    assert j.waited > 0 and p.waited > 0
    for rj, rp in zip(j.reqs, p.reqs):
        assert (rp.rid, rp.state, rp.reason, rp.tokens_out) == \
            (rj.rid, rj.state, rj.reason, rj.tokens_out)
    jrec, prec = _by_rid(j.records), _by_rid(p.records)
    assert set(jrec) == set(prec) == {r.rid for r in p.reqs}
    for rid in jrec:
        assert len(prec[rid]) == len(jrec[rid])
        assert [r["state"] for r in prec[rid]] == \
            [r["state"] for r in jrec[rid]]
        assert sum(bool(r.get("terminal")) for r in prec[rid]) == 1
        assert prec[rid] == jrec[rid]


def test_trace_spans_per_rid_match_jax(staggered):
    jspans = _by_rid(staggered["jax"].records, "trace")
    pspans = _by_rid(staggered["port"].records, "trace")
    assert jspans and pspans == jspans


def test_decode_logits_match_jax(staggered):
    for rj, rp in zip(staggered["jax"].reqs[:3], staggered["port"].reqs[:3]):
        assert len(rp.logits) == len(rj.logits) == rp.max_new_tokens
        for a, b in zip(rp.logits, rj.logits):
            np.testing.assert_allclose(a, np.asarray(b), atol=LOGITS_TOL,
                                       rtol=0)


def test_drain_report_matches_jax(staggered):
    j, p = staggered["jax"], staggered["port"]
    assert p.drain == j.drain and p.drain["finished"] >= 1
    assert p.redundant == j.redundant and p.redundant["redundant"] is True
    assert (p.post.state, p.post.reason) == (j.post.state, j.post.reason) \
        == ("rejected", "draining")


def test_zero_grace_drain_matches_jax(models):
    """A drain whose deadline has passed evicts the in-flight request as
    ``drain_deadline`` in both engines."""
    cfg = dict(lanes=1, block_size=8, num_blocks=2, max_seq_len=16, seed=1)
    reports = {}
    for side in ("jax", "port"):
        run = _make(models, side, cfg, Clock(step=1e-3))
        r = run.eng.submit(_prompts()[0], max_new_tokens=11)
        run.eng.tick()
        rep = run.eng.drain(grace_s=0.0)
        run.router.close()
        reports[side] = (r.state, r.reason, rep["finished"], rep["evicted"],
                         rep["timed_out"], run.eng.allocator.free_blocks)
    assert reports["port"] == reports["jax"] == (
        "timed_out", "drain_deadline", 0, 1, 0, 2)


def test_jax_xray_passes_on_the_port_stream(staggered):
    """The streams are interchangeable: each analyzer passes on the
    other's stream and decomposes it to the same numbers."""
    p, j = staggered["port"].records, staggered["jax"].records
    rep_j, rep_p = jax_analyze(p), analyze(j)
    assert rep_j.ok and rep_p.ok and rep_j.n_traces == rep_p.n_traces > 0
    assert rep_j.decompositions == analyze(p).decompositions
    assert rep_p.decompositions == jax_analyze(j).decompositions


def test_memory_records_match_jax(staggered):
    mems = [[{k: v for k, v in r.items() if k not in ("t", "host")}
             for r in staggered[s].records if r.get("kind") == "memory"]
            for s in ("jax", "port")]
    assert mems[0] and mems[1] == mems[0]


def test_block_reservation_diverges_from_jax(staggered):
    """A 17-token prompt with 1 new token at block 8: the port reserves
    blocks_needed(18) = 3 blocks, the JAX engine its 32-token prefill
    bucket's 4. The tokens agree."""
    j, p = staggered["jax"].pin, staggered["port"].pin
    assert (len(p.blocks), len(j.blocks)) == (3, 4)
    assert j.bucket == 32
    assert p.tokens_out == j.tokens_out and p.state == "completed"


def test_max_new_floor_matches_jax(staggered):
    """``max(n_new, 1)``: a submission of 0 or -3 new tokens is rejected
    malformed and its record says max_new 1, as JAX's does."""
    for side in ("jax", "port"):
        recs = _by_rid(staggered[side].records)
        for r in staggered[side].zero:
            assert (r.state, r.reason, r.max_new_tokens) == \
                ("rejected", "malformed", 1)
            assert recs[r.rid][-1]["max_new"] == 1


def test_extract_adopt_resumes_bit_identically(models):
    """A request extracted mid-decode and adopted by another engine
    finishes with generate's greedy tokens; the payload's bytes follow
    the pool geometry and the adopter's pool keeps its storage."""
    *_, model = models
    cfg = ServingConfig(lanes=2, block_size=8, num_blocks=8, max_seq_len=32)
    src = ServingEngine(model, cfg, device="cpu").start()
    dst = ServingEngine(model, cfg, device="cpu").start()
    ptrs = (dst.k_pool.data_ptr(), dst.v_pool.data_ptr())
    prompt = _prompts()[2]
    req = src.submit(prompt, max_new_tokens=10)
    for _ in range(3):
        src.tick()
    payload = src.extract(req.rid)
    assert payload is not None and src.idle
    assert src.allocator.free_blocks == 8
    mc = model.config
    assert payload["n_blocks"] == 3
    assert payload["bytes"] == (3 * mc.num_layers * 2 * mc.num_attention_heads
                                * 8 * mc.kv_channels * 4)
    assert src.extract(req.rid) is None
    assert dst.adopt(payload) and not dst.adopt(payload)
    while not dst.idle:
        dst.tick()
    want = generate(model, prompt[None], 10, device="cpu")[0, 12:].tolist()
    assert req.state == "completed" and req.tokens_out == want
    assert (dst.k_pool.data_ptr(), dst.v_pool.data_ptr()) == ptrs
    assert dst.allocator.free_blocks == 8


def test_adopt_refuses_another_geometry(models):
    *_, model = models
    src = ServingEngine(model, ServingConfig(lanes=1, block_size=8,
                                             num_blocks=8, max_seq_len=32),
                        device="cpu")
    other = ServingEngine(model, ServingConfig(lanes=1, block_size=16,
                                               num_blocks=4, max_seq_len=32),
                          device="cpu")
    req = src.submit(_prompts()[1], max_new_tokens=5)
    src.tick()
    payload = src.extract(req.rid)
    assert not other.adopt(payload) and other.allocator.free_blocks == 4
    assert req.state == "decode"


def test_kernel_load_after_start_counts_once(models, monkeypatch):
    """``steady_state_compiles`` counts a kernel library loaded after
    ``start()``: here a real shared library (this interpreter's _ctypes
    extension) stands in for a kernel's, loaded once mid-run."""
    *_, model = models
    eng = ServingEngine(model, ServingConfig(lanes=1, block_size=8,
                                             num_blocks=4, max_seq_len=32),
                        device="cpu").start()
    eng.submit(_prompts()[0], max_new_tokens=4)
    eng.tick()
    assert eng.steady_state_compiles == 0
    lib = Path(_ctypes.__file__)
    monkeypatch.setattr(_kernels, "_library_path", lambda source: lib)
    late = _kernels.Kernel("stand_in", "PyInit__ctypes", [])
    late._load()
    assert isinstance(late._fn, ctypes._CFuncPtr)
    eng.tick()
    assert eng.steady_state_compiles == 1
    eng.acknowledge_compiles()
    eng.tick()
    assert eng.steady_state_compiles == 1
    assert eng.stats()["steady_state_compiles"] == 1
