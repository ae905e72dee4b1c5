"""ZeRO's bucketed parameter gather and the ledger's link roofline in
apex_tpu_torch, against the JAX package's functions.

- ``choose_overlap_buckets`` and ``bucket_grid`` equal JAX's on the same
  inputs (exact integers);
- on spawned worlds of 4 gloo ranks (dp 4), ``distributed_fused_adam``
  and ``distributed_fused_lamb`` through 3 steps at
  ``param_gather_buckets`` 1, 2, 3 (a padded grid), 8 and None (the
  rule's depth: 2, gloo stages through the host, so no link is known)
  give parameters and ZeRO state bit for bit equal
  to the whole-shard gather's, in fp32, with bf16 parameters and the
  master's remainders (Adam), and for LAMB; the first update's ledger
  holds ``nb``
  ``all_gather`` entries of ``bs`` elements each, ``(n - 1) bs`` itemsize
  wire bytes a rank (JAX's ``tests/test_distributed_optimizers.py``);
- the link table, its override and its None (JAX's
  ``tests/test_xray.py`` cases), None on a staged group, the records'
  ``ici_seconds`` and ``roofline_seconds`` against JAX's, and the
  timeline's ``utilization`` filled when a link is known.
"""

import importlib

import numpy as np
import pytest
import torch

from apex_tpu.monitor.xray import ledger as jax_ledger
from apex_tpu_torch.monitor.xray import ledger, timeline
from apex_tpu_torch.transformer.testing.distributed_test_base import spawn
from apex_tpu_torch.transformer.testing.parallel_workers import (
    zero_buckets_worker,
)

dfa = importlib.import_module(
    "apex_tpu_torch.optimizers.distributed_fused_adam")
jdfa = importlib.import_module("apex_tpu.optimizers.distributed_fused_adam")

WORLD = 4
BUCKETS = [1, 2, 3, 8, None]
# the optimizer runs: Adam in fp32, Adam over bf16 parameters with the
# master's remainders, LAMB in fp32
MODES = ["fp32", "bf16_remainders", "lamb"]


@pytest.mark.parametrize("shard_bytes,n,bw", [
    (10 * 2**20, 1, None), (10 * 2**20, 8, 0.0), (40 * 2**20, 8, 200e9),
    (1024, 8, 200e9), (2**31, 8, 200e9), (2**22, 4, 450e9),
    (123457, 2, 1e6)])
def test_choose_overlap_buckets_equals_jax(shard_bytes, n, bw):
    got = dfa.choose_overlap_buckets(shard_bytes, n, bandwidth=bw)
    want = jdfa.choose_overlap_buckets(shard_bytes, n, bandwidth=bw)
    assert got == want


def test_choose_overlap_buckets_unknown_link_double_buffers(monkeypatch):
    monkeypatch.delenv(ledger.LINK_BANDWIDTH_ENV, raising=False)
    monkeypatch.delenv("APEX_TPU_ICI_BANDWIDTH", raising=False)
    assert dfa.choose_overlap_buckets(40 * 2**20, 8) == 2 == \
        jdfa.choose_overlap_buckets(40 * 2**20, 8)


@pytest.mark.parametrize("shard,nb", [(12, 1), (12, 3), (13, 3), (1, 8),
                                      (65536, 7)])
def test_bucket_grid_equals_jax(shard, nb):
    assert dfa.bucket_grid(shard, nb) == jdfa.bucket_grid(shard, nb)


def _inputs(mode):
    rs = np.random.RandomState({"fp32": 2, "bf16_remainders": 3,
                                "lamb": 4}[mode])
    params = {"w": rs.randn(37, 11).astype(np.float32),
              "b": rs.randn(5).astype(np.float32),
              "emb": rs.randn(9, 4).astype(np.float32)}
    grads = [{n: rs.randn(WORLD, *v.shape).astype(np.float32)
              for n, v in params.items()} for _ in range(3)]
    return params, grads


@pytest.fixture(scope="module")
def runs():
    out = {}
    for mode in MODES:
        params, grads = _inputs(mode)
        out[mode] = spawn(
            zero_buckets_worker, WORLD,
            args=(params, grads, BUCKETS, "cpu", mode == "bf16_remainders",
                  mode == "lamb"),
            timeout=300.0)
    return out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("nb", BUCKETS[1:])
def test_bucketed_gather_is_bitwise_the_whole_shard(runs, mode, nb):
    """Tolerance: none, every parameter and state element's bits."""
    for rank_out in runs[mode]:
        base, got = rank_out[1], rank_out[nb]
        for key in ("master", "exp_avg", "exp_avg_sq"):
            np.testing.assert_array_equal(got[key], base[key], err_msg=key)
        for name, v in base["params"].items():
            np.testing.assert_array_equal(got["params"][name], v,
                                          err_msg=name)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("nb", BUCKETS)
def test_bucket_ledger_bytes_are_exact(runs, mode, nb):
    itemsize = 2 if mode == "bf16_remainders" else 4
    depth = nb if nb is not None else 2
    for rank_out in runs[mode]:
        gathers = rank_out[nb]["gathers"]
        shard = rank_out[1]["gathers"][0][0][0]
        bs = -(-shard // depth)
        assert len(gathers) == depth
        assert all(shape == (bs,) for shape, _, _ in gathers)
        assert sum(shape[0] for shape, _, _ in gathers) == bs * depth
        assert all(b == bs * itemsize and ici == (WORLD - 1) * bs * itemsize
                   for _, b, ici in gathers)


class _Dev:
    def __init__(self, kind):
        self.device_kind = kind


@pytest.mark.parametrize("name,want", [
    ("NVIDIA H100 80GB HBM3", 450e9), ("nvidia h100 sxm5", 450e9),
    ("NVIDIA A10G", None), ("cpu", None)])
def test_link_table(monkeypatch, name, want):
    monkeypatch.delenv(ledger.LINK_BANDWIDTH_ENV, raising=False)
    assert ledger.ici_bandwidth_per_device(name) == want
    # JAX's table (TPU kinds) knows no CUDA card
    assert jax_ledger.ici_bandwidth_per_device(_Dev(name)) is None


def test_link_override_and_cpu_none(monkeypatch):
    monkeypatch.delenv(ledger.LINK_BANDWIDTH_ENV, raising=False)
    if not torch.cuda.is_available():
        assert ledger.ici_bandwidth_per_device() is None
    monkeypatch.setenv(ledger.LINK_BANDWIDTH_ENV, "123.5e9")
    monkeypatch.setenv("APEX_TPU_ICI_BANDWIDTH", "123.5e9")
    assert ledger.ici_bandwidth_per_device("NVIDIA A10G") == 123.5e9 == \
        jax_ledger.ici_bandwidth_per_device(_Dev("cpu"))


def _entries(mod):
    return [mod.CollectiveEntry(op="psum", axis="tp", axis_size=2,
                                shape=(250,), dtype="float32", bytes=1000,
                                ici_bytes=1000)]


def test_roofline_and_records_equal_jax(monkeypatch):
    """JAX's ``test_to_records_schema_and_roofline`` on both ledgers."""
    ours, theirs = ledger.CommsLedger(), jax_ledger.CommsLedger()
    ours.entries, theirs.entries = _entries(ledger), _entries(jax_ledger)
    monkeypatch.setenv(ledger.LINK_BANDWIDTH_ENV, "1e6")
    monkeypatch.setenv("APEX_TPU_ICI_BANDWIDTH", "1e6")
    assert ours.roofline_seconds() == theirs.roofline_seconds() == {
        "tp": pytest.approx(1e-3)}
    (rec,), (jrec,) = ours.to_records(7), theirs.to_records(7)
    assert rec["ici_seconds"] == jrec["ici_seconds"] == pytest.approx(1e-3)
    # an axis gloo staged through the host crosses no link
    ours.staged_axes.add("tp")
    assert ours.roofline_seconds() == {"tp": None}
    assert ours.to_records()[0]["ici_seconds"] is None
    ours.staged_axes.clear()
    monkeypatch.delenv(ledger.LINK_BANDWIDTH_ENV)
    monkeypatch.delenv("APEX_TPU_ICI_BANDWIDTH")
    if not torch.cuda.is_available():
        assert ours.roofline_seconds() == theirs.roofline_seconds() == {
            "tp": None}


def test_staged_group_has_no_link(runs):
    """A gloo group stages through the host: no roofline, and the
    double-buffering depth, even where the variable pins a link (which
    holds without a group)."""
    for rank_out in runs["fp32"]:
        assert rank_out["staged"] == {"link": None, "depth": 2,
                                      "unstaged_link": 1e9}


def test_timeline_utilization_reads_the_link(monkeypatch):
    """The bandwidth join of ``tests/test_torch_timeline.py`` with a link
    known (the override): utilization = achieved / roofline; None for a
    staged axis."""
    from apex_tpu_torch.analysis.hlo import parser as hp
    from apex_tpu_torch.analysis.hlo.attribution import layout_mesh

    def coll(kind, ranks, i):
        return hp.HloCollective(
            kind=kind, name=f"c10d.{kind}#{i}", computation="step",
            result=hp.HloShape("float32", (4,)),
            operands=(hp.HloOperand(hp.HloShape("float32", (4,))),),
            replica_groups=(ranks,), op_name="",
            source_file="", source_line=0, line=i)

    module = hp.HloModule("m", [coll("allreduce_", (0, 1), 0),
                                coll("allreduce_", (0, 2), 1)], [], [], {})
    mesh = layout_mesh({"dp": 2, "tp": 2})
    led = ledger.CommsLedger()
    for axis in ("tp", "dp"):
        led.entries.append(ledger.CollectiveEntry(
            op="psum", axis=axis, axis_size=2, shape=(4,), dtype="float32",
            bytes=16, ici_bytes=16))
    led.staged_axes.add("dp")
    ev = [{"ph": "X", "cat": "user_annotation", "name": "ProfilerStep#0",
           "pid": 1, "tid": 1, "ts": 0.0, "dur": 100.0}]
    for ts, dur in ((10.0, 8.0), (40.0, 16.0)):
        ev.append({"ph": "X", "cat": "user_annotation",
                   "name": "gloo:all_reduce", "pid": 1, "tid": 2, "ts": ts,
                   "dur": dur})
    monkeypatch.setenv(ledger.LINK_BANDWIDTH_ENV, "4e6")
    rep = timeline.analyze(timeline.parse_trace({"traceEvents": ev}),
                           module=module, mesh=mesh, ledger=led)
    by = {a.axis: a for a in rep.axes}
    assert by["tp"].utilization == pytest.approx((16 / 8e-6) / 4e6)
    assert by["dp"].utilization is None
    assert "utilization 50.0%" in rep.summary()
