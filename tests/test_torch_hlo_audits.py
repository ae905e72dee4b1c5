"""apex_tpu_torch.analysis.hlo against the JAX package's analysis.hlo.

- ``classify_replica_groups`` and ``classify_source_target_pairs`` give
  JAX's labels on the same groups (every axis subset's partition, a
  singleton set, a shape no subset expresses, point-to-point edges) of a
  dp 2 x tp 2 and a dp 2 x pp 2 x tp 2 layout;
- the comms matcher (``diff_buckets``) gives JAX's findings (rule, count
  and bucket) on the same units and buckets;
- on a gloo world of 4 (CPU, one module-scoped spawn,
  ``transformer/testing/analysis_workers.py``): the tiny GPT at dp 2 x
  tp 2 is clean under ``hlo-comms`` (its dispatched collectives each a
  ledger record), a step with a bare ``dist.all_reduce`` gives
  ``comms.unpredicted`` at the bare call's line, the int8 target gives
  ``comms.quantized``, the naive ZeRO target gives
  ``sharding.replicated-param`` on m and v, and ``memory_diff``'s
  resident components equal the HBM model's bytes exactly.
"""

import collections
import inspect

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from apex_tpu.analysis.hlo import attribution as jax_attr
from apex_tpu.analysis.hlo import comms_diff as jax_diff
from apex_tpu.analysis.hlo import parser as jax_parser
from apex_tpu_torch.analysis.hlo import attribution, comms_diff
from apex_tpu_torch.analysis.hlo import parser as hp
from apex_tpu_torch.transformer.testing import analysis_workers
from apex_tpu_torch.transformer.testing.distributed_test_base import spawn

LAYOUTS = [(("dp", "tp"), (2, 2)), (("dp", "pp", "tp"), (2, 2, 2))]


def _meshes(names, sizes):
    n = int(np.prod(sizes))
    jmesh = Mesh(np.array(jax.devices()[:n]).reshape(sizes), names)
    return jmesh, attribution.layout_mesh(dict(zip(names, sizes)))


@pytest.mark.parametrize("names,sizes", LAYOUTS)
def test_replica_groups_classify_as_jax(names, sizes):
    jmesh, mesh = _meshes(names, sizes)
    n = int(np.prod(sizes))
    cases = [[list(g) for g in key] for key in
             jax_attr.mesh_axis_partitions(jmesh)]
    cases += [[[i] for i in range(n)], [], [[0, 3], [1, 2]] if n == 4
              else [[0, 7], [1, 6], [2, 5], [3, 4]]]
    for groups in cases:
        assert attribution.classify_replica_groups(mesh, groups) == \
            jax_attr.classify_replica_groups(jmesh, groups), groups
    assert attribution.mesh_axis_partitions(mesh) == \
        jax_attr.mesh_axis_partitions(jmesh)


@pytest.mark.parametrize("names,sizes", LAYOUTS)
def test_pairs_classify_as_jax(names, sizes):
    jmesh, mesh = _meshes(names, sizes)
    n = int(np.prod(sizes))
    cases = [[], [(0, 1)], [(0, 2)], [(0, 1), (2, 3)], [(0, n - 1)],
             [(0, 1), (1, 0)], [(0, 3)]]
    for pairs in cases:
        assert attribution.classify_source_target_pairs(mesh, pairs) == \
            jax_attr.classify_source_target_pairs(jmesh, pairs), pairs
    for key in (k for k in ("dp,tp", "tp", "pp,tp", "cp,tp", "dp")):
        assert attribution.canon_axis_key(mesh, key) == \
            jax_attr.canon_axis_key(jmesh, key)


def test_one_rank_view_classifies_by_its_group():
    """The port's view: a rank sees its own group only."""
    mesh = attribution.layout_mesh({"dp": 2, "tp": 2})
    assert attribution.classify_replica_groups(mesh, [(0, 1)]) == "tp"
    assert attribution.classify_replica_groups(mesh, [(1, 3)]) == "dp"
    assert attribution.classify_replica_groups(mesh, [(0, 1, 2, 3)]) == \
        "dp,tp"
    assert attribution.classify_replica_groups(mesh, [(0, 3)]) == "unknown"
    assert attribution.canon_axis_key(mesh, "world") == "dp,tp"


# -- the matcher on the same units and buckets ------------------------------

# (class, axis, elements, dtype, count of units); then predicted buckets
UNITS = [("all-reduce", "dp", 4096, "float32", 2),
         ("all-reduce", "tp", 512, "bfloat16", 3),
         ("all-gather", "tp", 256, "bfloat16", 1),
         ("all-to-all", "dp", 768, "int8", 2),
         ("reduce-scatter", "dp", 8192, "float32", 1)]
PRED = {("all-reduce", "dp", 4096): 2, ("all-reduce", "tp", 512): 4,
        ("all-gather", "tp", 256): 0, ("all-to-all", "dp", 768): 2,
        ("all-gather", "dp", 100): 3}


def _jax_units():
    out = []
    for i, (cls, axis, el, dtype, n) in enumerate(UNITS):
        dt = {"float32": "f32", "bfloat16": "bf16", "int8": "s8"}[dtype]
        for j in range(n):
            instr = jax_parser.HloCollective(
                kind=cls, name=f"%op.{i}.{j}", computation="main",
                result=jax_parser.HloShape(dt, (el,)), operands=(),
                replica_groups=((0, 1),), channel_id=None, op_name="jit",
                source_file="apex_tpu/monitor/xray/ledger.py",
                source_line=1, line=10 * i + j)
            out.append(jax_diff._Unit(
                kind=cls, axis=axis, elements=el,
                nbytes=el * {"f32": 4, "bf16": 2, "s8": 1}[dt], dtype=dt,
                dims=(el,), instr=instr))
    return out


def _port_units():
    out = []
    for i, (cls, axis, el, dtype, n) in enumerate(UNITS):
        for j in range(n):
            instr = hp.HloCollective(
                kind="allreduce_", name=f"c10d.allreduce_#{i}",
                computation="step", result=hp.HloShape(dtype, (el,)),
                operands=(hp.HloOperand(hp.HloShape(dtype, (el,))),),
                replica_groups=((0, 1),), op_name="",
                source_file="apex_tpu_torch/x.py", source_line=1,
                line=10 * i + j, via_helper=True)
            out.append(comms_diff._Unit(
                kind=cls, axis=axis, elements=el,
                nbytes=hp.HloShape(dtype, (el,)).nbytes, dtype=dtype,
                instr=instr))
    return out


def _key(f):
    return (f.rule, f.count, f.data.get("op"), f.data.get("axis"),
            f.data.get("elements"))


def test_matcher_gives_jax_s_findings(monkeypatch):
    monkeypatch.setattr(jax_diff, "_predicted_buckets",
                        lambda fn, args, mesh: dict(PRED))
    monkeypatch.setattr(jax_diff, "_emitted_units",
                        lambda module, mesh: _jax_units())
    module = jax_parser.HloModule("m", [], [], [], None, {}, "main")
    ref = jax_diff.audit_comms(lambda: None, mesh=object(), module=module,
                               target="t")
    got = comms_diff.diff_buckets(_port_units(), dict(PRED), target="t")
    assert collections.Counter(map(_key, got)) == \
        collections.Counter(map(_key, ref))
    assert {f.rule for f in got} == {"comms.unpredicted", "comms.folded",
                                     "comms.vanished", "comms.quantized"}


def test_rule_table_documents_jax_s_unraised_rules():
    assert set(comms_diff.RULES) >= {"comms.reshard", "comms.async",
                                     "comms.unpredicted", "comms.vanished",
                                     "comms.folded", "comms.unverifiable",
                                     "comms.quantized"}
    assert comms_diff.RULES["comms.reshard"].startswith("never")
    assert comms_diff.RULES["comms.async"].startswith("never")
    assert comms_diff.audit_comms(None, None, None)[0].rule == \
        "comms.unverifiable"


# -- the audits on a world of 4 ----------------------------------------------

@pytest.fixture(scope="module")
def world():
    return spawn(analysis_workers.hlo_audits_worker, 4, timeout=300.0)


def test_tiny_gpt_is_clean_under_hlo_comms(world):
    for r in world:
        assert r["gpt_comms"] == []
        kinds = {k for k, _, _ in r["gpt_collectives"]}
        assert "allreduce_" in kinds
        assert {a for _, a, _ in r["gpt_collectives"]} <= {"dp", "tp",
                                                          "none"}
        # on CPU tensors gloo stages nothing
        assert r["gpt_staged"] == 0


def test_bare_all_reduce_is_unpredicted_at_its_site(world):
    for r in world:
        rules = [(f.rule, f.site) for f in r["bare"]]
        site = (f"apex_tpu_torch/transformer/testing/analysis_workers.py:"
                f"{r['bare_line']}")
        assert rules == [("comms.unpredicted", site)]
        assert r["bare"][0].data["axis"] == "dp"
        assert r["bare"][0].data["c10d"] == "allreduce_"


def test_int8_target_confirms_the_quantized_pattern(world):
    for r in world:
        rules = collections.Counter(f.rule for f in r["int8"])
        assert rules == {"comms.quantized": 1}
        f = r["int8"][0]
        assert f.data["axis"] == "dp" and f.data["ops"] > 0


def test_naive_target_replicated_state_and_missed_donation(world):
    for r in world:
        got = collections.Counter((f.rule, f.data.get("param")
                                   or f.data.get("leaf"))
                                  for f in r["naive"])
        assert got[("sharding.replicated-param", "m")] == 1
        assert got[("sharding.replicated-param", "v")] == 1
        assert got[("donation.missed", "m")] == 1
        assert got[("donation.missed", "v")] == 1
        outs = [f for f in r["naive"]
                if f.rule == "sharding.replicated-output"]
        assert len(outs) == 2 and all(f.data["axes"] == ["dp"]
                                      for f in outs)


def test_memory_resident_components_equal_the_hbm_model(world):
    """The GPT step's state booked by component equals the analytic
    ledger's bytes exactly; the CPU has no allocator, so the peak and the
    temporaries are unverifiable."""
    for r in world:
        (f,) = r["gpt_memory"]
        assert f.rule == "memory.unverifiable"
        table = f.data["components"]
        assert set(table) == {"weights", "optimizer_state", "scaler_state",
                              "sentinel_state", "batch_data"}
        for comp, row in table.items():
            assert row["predicted"] == row["measured"], comp
        assert "reconciled exactly" in f.message


def test_worker_line_is_the_bare_call():
    lines, first = inspect.getsourcelines(analysis_workers._bare_all_reduce)
    assert any("dist.all_reduce(y, group=group)" in ln for ln in lines)
