"""apex_tpu_torch.monitor.xray.hbm against the JAX package's HBM x-ray.

The ledger is pure arithmetic: every prediction equals JAX's exactly
(``to_dict()`` equal) over a grid of models, schedules, ZeRO sizes,
remainders and dtypes, with torch dtypes on the port's side and names on
JAX's. The element count and the KV pool are held against the port's own
model and engine. OOM records are equal up to their timestamp, and each
package reads the other's. Off CUDA the live and report halves return
None or raise, as JAX's do off the accelerator.
"""

import dataclasses
import itertools
import json
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import GPTModel as JaxGPT
from apex_tpu.monitor import router as jrouter
from apex_tpu.monitor.xray.hbm import model as jm
from apex_tpu.monitor.xray.hbm import oom as joom
from apex_tpu.transformer import TransformerConfig as JaxConfig
from apex_tpu_torch import monitor
from apex_tpu_torch.models import GPTModel
from apex_tpu_torch.monitor import router as port_router
from apex_tpu_torch.monitor.goodput import spans as port_spans
from apex_tpu_torch.monitor.xray import hbm
from apex_tpu_torch.monitor.xray.hbm import model as tm
from apex_tpu_torch.ops.multi_tensor import CHUNK_SIZE
from apex_tpu_torch.parallel.pipeline.algebra import SCHEDULES
from apex_tpu_torch.serving import ServingConfig, ServingEngine
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


DIMS = [
    dict(num_layers=12, hidden_size=768, num_attention_heads=12,
         vocab_size=50304, max_position_embeddings=1024),
    dict(num_layers=3, hidden_size=64, num_attention_heads=4,
         vocab_size=512, max_position_embeddings=128, ffn_hidden_size=96),
]
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16, "int32": torch.int32,
                "int8": torch.int8, "float8_e4m3fn": torch.float8_e4m3fn}
SCHEDULE_GEOMETRY = [("no_pipelining", 1, 1, 1), ("1f1b", 2, 4, 1),
                     ("interleaved", 2, 4, 2), ("zero_bubble", 4, 8, 1)]


def _pair_dims(d):
    return tm.TransformerDims(**d), jm.TransformerDims(**d)


def test_constants_match_the_port_and_jax():
    assert tm.ZERO_FLAT_CHUNK == jm.ZERO_FLAT_CHUNK == CHUNK_SIZE
    assert tm.STASH_SCHEDULES == jm.STASH_SCHEDULES
    assert set(tm.STASH_SCHEDULES) == set(SCHEDULES)
    assert tm.DTYPE_BYTES == jm.DTYPE_BYTES
    for name, dt in TORCH_DTYPES.items():
        assert tm.dtype_bytes(dt) == jm.dtype_bytes(name) == dt.itemsize
    with pytest.raises(ValueError, match="unknown dtype"):
        tm.dtype_bytes(torch.complex64)


@pytest.mark.parametrize("geometry", SCHEDULE_GEOMETRY,
                         ids=[g[0] for g in SCHEDULE_GEOMETRY])
@pytest.mark.parametrize("remat", ["full", "selective", "none"])
@pytest.mark.parametrize("d", DIMS, ids=["gpt2", "tiny"])
def test_activation_stash_equals_jax(d, remat, geometry):
    t, j = _pair_dims(d)
    sched, p, m, v = geometry
    assert (dataclasses.asdict(tm.stash_depth(sched, p, m, v))
            == dataclasses.asdict(jm.stash_depth(sched, p, m, v)))
    kw = dict(remat=remat, schedule=sched, num_stages=p,
              num_microbatches=m, num_model_chunks=v)
    assert (tm.activation_stash_bytes(t, 2048, compute_dtype=torch.bfloat16,
                                      **kw)
            == jm.activation_stash_bytes(j, 2048, compute_dtype="bfloat16",
                                         **kw))


@pytest.mark.parametrize("bad", [("gpipe", 2, 4, 1), ("interleaved", 2, 4, 1),
                                 ("interleaved", 3, 4, 2), ("1f1b", 0, 4, 1)])
def test_stash_depth_refuses_what_jax_refuses(bad):
    with pytest.raises(ValueError) as te:
        tm.stash_depth(*bad)
    with pytest.raises(ValueError) as je:
        jm.stash_depth(*bad)
    assert str(te.value) == str(je.value)


TRAIN_GRID = list(itertools.product(
    [1, 2],                                  # tp
    [("fused_adam", None), ("distributed_fused_adam", 2),
     ("distributed_fused_adam", 8)],         # optimizer, zero size
    [False, True],                           # remainders
    [None, "int8", "float8_e4m3fn"],         # compression wire dtype
))


@pytest.mark.parametrize("tp,opt,remainders,wire", TRAIN_GRID)
@pytest.mark.parametrize("d", DIMS, ids=["gpt2", "tiny"])
def test_predict_train_memory_equals_jax(d, tp, opt, remainders, wire):
    t, j = _pair_dims(d)
    optimizer, zero = opt
    kw = dict(tp=tp, microbatch_size=4, seq_len=128, optimizer=optimizer,
              zero_axis_size=zero, store_param_remainders=remainders,
              error_feedback=wire is not None, grad_scaler=remainders,
              remat="none" if remainders else "full",
              schedule="1f1b" if tp == 2 else "no_pipelining",
              num_stages=2 if tp == 2 else 1, num_microbatches=4,
              label="grid", capacity_bytes=80 * 2**30)
    got = tm.predict_train_memory(
        t, params_dtype=torch.float32, compute_dtype=torch.bfloat16,
        grads_dtype=torch.bfloat16 if remainders else None,
        token_dtype=torch.int32,
        compression_wire_dtype=TORCH_DTYPES[wire] if wire else None, **kw)
    want = jm.predict_train_memory(
        j, params_dtype="float32", compute_dtype="bfloat16",
        grads_dtype="bfloat16" if remainders else None, token_dtype="int32",
        compression_wire_dtype=wire, **kw)
    assert got.to_dict() == want.to_dict()
    assert got.round_trip().peak_bytes == got.peak_bytes
    assert got.resident_bytes + got.transient_bytes == got.peak_bytes
    for cap, head in ((2**30, 0.0), (80 * 2**30, 0.1), (got.peak_bytes, 0.0)):
        assert (dataclasses.asdict(tm.predict_fits(got, cap, head))
                == dataclasses.asdict(jm.predict_fits(want, cap, head)))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8"])
def test_predict_serving_memory_equals_jax(dtype):
    kw = dict(num_layers=12, num_kv_heads=12, head_dim=64, num_blocks=512,
              block_size=16, weights_bytes=497_759_232, label="serve")
    got = tm.predict_serving_memory(cache_dtype=TORCH_DTYPES[dtype], **kw)
    want = jm.predict_serving_memory(cache_dtype=dtype, **kw)
    assert got.to_dict() == want.to_dict()
    assert got.component_bytes("kv_pool") == 512 * 589_824 * (
        TORCH_DTYPES[dtype].itemsize // 2 if dtype != "int8" else 0.5)


def test_zero_shards_and_fits_refusals_equal_jax():
    for total, axis in ((1, 1), (124_439_808, 4), (65_537, 3), (0, 8)):
        assert tm.zero_padded_total(total, axis) == jm.zero_padded_total(
            total, axis)
        assert tm.zero_shard_elements(total, axis) == jm.zero_shard_elements(
            total, axis)
        for rem, ef in itertools.product([False, True], repeat=2):
            assert tm.distributed_adam_state_bytes(total, axis, rem, ef) == \
                jm.distributed_adam_state_bytes(total, axis, rem, ef)
    b = tm.predict_serving_memory(num_layers=1, num_kv_heads=1, head_dim=8,
                                  num_blocks=2, block_size=4)
    for cap, head in ((0, 0.0), (100, 1.0), (100, -0.1)):
        with pytest.raises(ValueError):
            tm.predict_fits(b, cap, head)
    with pytest.raises(ValueError, match="partition identity"):
        tm.HbmBreakdown.from_dict({**b.to_dict(), "peak_bytes": 1})


TINY = dict(num_layers=2, hidden_size=32, num_attention_heads=4,
            vocab_size=64, max_position_embeddings=16)


def _jax_numel(**extra):
    variables = jax.eval_shape(
        JaxGPT(config=JaxConfig(**TINY, **extra)).init,
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    return sum(int(np.prod(x.shape))
               for x in jax.tree_util.tree_leaves(variables))


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_param_elements_equal_the_port_model(tied):
    extra = {} if tied else {"share_embeddings_and_output_weights": False}
    model = GPTModel(TransformerConfig(**TINY, **extra), device="cpu")
    numel = sum(p.numel() for p in model.parameters())
    # the port's parameters are the flax tree's, leaf for leaf
    assert numel == _jax_numel(**extra)
    ledger = tm.gpt_param_elements(tm.TransformerDims(**TINY))
    assert ledger == jm.gpt_param_elements(jm.TransformerDims(**TINY))
    # the ledger books a tied head (both packages): an untied model carries
    # one (vocab, hidden) output layer more
    head = 0 if tied else TINY["vocab_size"] * TINY["hidden_size"]
    assert numel == ledger + head


def test_kv_pool_bytes_equal_the_engine_pool():
    cfg = TransformerConfig(**TINY, num_query_groups=2,
                            compute_dtype=torch.bfloat16)
    model = GPTModel(cfg, device="cpu")
    eng = ServingEngine(model, ServingConfig(max_seq_len=16, block_size=4,
                                             num_blocks=12), device="cpu")
    want = tm.kv_pool_bytes(num_layers=2, num_kv_heads=2, head_dim=8,
                            num_blocks=12, block_size=4,
                            cache_dtype=cfg.compute_dtype)
    assert eng.k_pool.nbytes + eng.v_pool.nbytes == want


def _no_t(rec):
    return {k: v for k, v in rec.items() if k != "t"}


def test_oom_record_equals_jax_and_each_reads_the_other():
    kw = dict(num_layers=12, num_kv_heads=12, head_dim=64, num_blocks=64,
              block_size=16, weights_bytes=10**9)
    tb = tm.predict_serving_memory(**kw)
    jb = jm.predict_serving_memory(**kw)
    err = "CUDA out of memory. Tried to allocate 2.00 GiB"
    bufs = [{"name": "kv", "bytes": 123}]
    got = hbm.oom_record(7, RuntimeError(err), breakdown=tb,
                         largest_buffers=bufs, capacity_bytes=80 * 2**30)
    want = joom.oom_record(7, RuntimeError(err), breakdown=jb,
                           largest_buffers=bufs, capacity_bytes=80 * 2**30)
    assert _no_t(got) == _no_t(want)
    assert got["suggestions"][0]["component"] == "weights"
    assert hbm.suggest_knobs() == joom.suggest_knobs()
    lines = [json.dumps(got), "not json", json.dumps({"kind": "metrics"}),
             "", json.dumps(want)]
    mine = [dataclasses.asdict(x) for x in hbm.read_oom_records(lines)]
    theirs = [dataclasses.asdict(x) for x in joom.read_oom_records(lines)]
    assert mine == theirs and len(mine) == 2
    inc = hbm.read_oom_records([want])[0]
    assert inc.dominant_component == "weights"
    assert inc.suggested_knobs()[0] == "tensor_model_parallel_size"


def test_is_oom_error_reads_torch_and_xla():
    assert hbm.is_oom_error(torch.cuda.OutOfMemoryError("no room"))
    assert hbm.is_oom_error(RuntimeError("RESOURCE_EXHAUSTED: 2 GiB"))
    assert not hbm.is_oom_error(ValueError("bad shape"))
    assert joom.is_oom_error(RuntimeError(
        "CUDA out of memory. Tried to allocate 20.00 MiB"))


def test_oom_guard_emits_once_and_reraises():
    mem = monitor.MemorySink()
    router = monitor.MetricRouter([mem])
    b = tm.predict_serving_memory(num_layers=1, num_kv_heads=1, head_dim=8,
                                  num_blocks=2, block_size=4)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        with hbm.oom_guard(router, 3, breakdown=b):
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
    with pytest.raises(ValueError):
        with hbm.oom_guard(router, 4, breakdown=b):
            raise ValueError("not memory")
    with hbm.oom_guard(router, 5):
        pass
    (rec,) = [r for r in mem.records if r["kind"] == "oom"]
    assert rec["step"] == 3 and rec["components"] == {"kv_pool": 256}
    router.close()


def test_memory_report_raises_on_the_cpu():
    with pytest.raises(RuntimeError, match="CUDA card"):
        hbm.memory_report(lambda x: x * 2, torch.ones(4))
    with pytest.raises(RuntimeError, match="CUDA card"):
        monitor.xray.memory_report(lambda: None, device="cpu")
    r = hbm.MemoryReport(10, 20, 30, 0, device_memory_bytes=100)
    assert r.total_bytes == 60 and r.headroom_bytes == 40
    assert r.fields()["total_bytes"] == 60


def test_watermarks_are_none_off_cuda():
    assert hbm.device_watermarks(torch.device("cpu")) is None
    assert hbm.device_watermarks(None) is None
    if not torch.cuda.is_available():
        assert hbm.device_memory_limit() is None
    mem = monitor.MemorySink()
    router = monitor.MetricRouter([mem])
    pred = tm.predict_serving_memory(num_layers=1, num_kv_heads=1,
                                     head_dim=8, num_blocks=2, block_size=4)
    mon = hbm.HbmWatermarkMonitor(router, interval_steps=2, predicted=pred,
                                  device=torch.device("cpu"))
    assert mon.maybe_sample(0) is None  # anchors the cadence
    assert mon.maybe_sample(1) is None
    fields = mon.maybe_sample(2)
    assert fields["bytes_in_use"] is None and fields["utilization"] is None
    assert fields["predicted_peak_bytes"] == 256
    assert not fields["headroom_breach"]
    assert mon.metrics_fields() == {}
    assert mon.summary() == {"predicted_peak_bytes": 256,
                             "achieved_peak_bytes": None,
                             "utilization": None, "breaches": 0}
    assert [r["step"] for r in mem.records if r["kind"] == "memory"] == [2]
    with pytest.raises(ValueError, match="interval_steps"):
        hbm.HbmWatermarkMonitor(router, interval_steps=0)
    router.close()
    # the record shape is the JAX package's
    assert set(jrouter.make_record("memory", 0)) == set(
        monitor.make_record("memory", 0))
