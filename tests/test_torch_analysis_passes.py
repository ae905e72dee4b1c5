"""apex_tpu_torch's trace passes against the JAX package's jaxpr passes,
and the analysis CLI.

Small step functions written both ways give equal ``(rule, severity,
count)`` findings, one case per rule: a stray bf16 -> f32 promotion, an
f64 value, a host read (JAX: a ``device_put`` to host memory; torch:
``float(t)``), a reduce over a one-rank group (JAX: a size-1 mesh axis),
point-to-point edges with a duplicate source, and a pipeline chain with
a missing link. The JAX side runs its jaxpr passes alone
(``jax.make_jaxpr``, no ``.lower().compile()``); the port's steps run
once under the recorder, the collective cases on one module-scoped gloo
world of 4 ranks (``transformer/testing/analysis_workers.py``), which
also audits the CLI's four tiny targets once. Then: a backward op's site
is its forward op's line, the CLI's gate over those findings exits 0,
and the trace half and ``--fix`` ask for a card unless given ``--device
cpu``.
"""

import collections
import functools
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from apex_tpu.analysis.passes import StepTarget as JaxTarget
from apex_tpu.analysis.passes import run_passes as jax_passes
from apex_tpu.compat import shard_map
from apex_tpu_torch.analysis import passes
from apex_tpu_torch.analysis.__main__ import gate, main, merge_ranks
from apex_tpu_torch.analysis.allowlist import repo_allowlist
from apex_tpu_torch.analysis.findings import Finding
from apex_tpu_torch.transformer.testing import analysis_workers
from apex_tpu_torch.transformer.testing.analysis_workers import (
    collective_fixtures_worker,
    site_probe_worker,
)
from apex_tpu_torch.transformer.testing.distributed_test_base import spawn

TARGETS = ["gpt", "gpt-compressed", "bert", "gpt-pp"]


def _counts(findings):
    return collections.Counter((f.rule, f.severity, f.count)
                               for f in findings)


def _port(fn, *args, names=("precision", "host-sync")):
    return passes.run_passes(passes.StepTarget("t", fn, args),
                             passes=list(names))


def _jax(fn, *args, names=("precision", "host-sync"), mesh=None):
    return jax_passes(JaxTarget(name="t", fn=fn, args=args, mesh=mesh,
                                donate_argnums=None), passes=list(names))


def test_promotion_gives_jax_s_finding():
    x = np.random.RandomState(0).randn(4, 8).astype(np.float32)
    jax_f = _jax(lambda a: (a.astype(jnp.float32) * 2).astype(jnp.bfloat16),
                 jnp.asarray(x, jnp.bfloat16))
    port_f = _port(lambda a: (a.float() * 2).to(torch.bfloat16),
                   torch.from_numpy(x).to(torch.bfloat16))
    assert _counts(jax_f) == _counts(port_f) == {
        ("precision.promotion", "error", 1): 1}
    assert port_f[0].data == {"from": "bfloat16", "to": "float32"}


def test_f64_gives_jax_s_finding():
    x = np.random.RandomState(1).randn(4).astype(np.float32)
    with jax.enable_x64(True):
        jax_f = _jax(lambda a: a.astype(jnp.float64), jnp.asarray(x))
    port_f = _port(lambda a: a.double(), torch.from_numpy(x))
    assert _counts(jax_f) == _counts(port_f) == {
        ("precision.f64", "error", 1): 1}


def test_host_read_gives_jax_s_finding():
    x = np.random.RandomState(2).randn(4).astype(np.float32)
    dev = jax.devices()[0]
    host = jax.sharding.SingleDeviceSharding(dev, memory_kind="pinned_host")
    jax_f = _jax(lambda a: jax.device_put(a * 2, host), jnp.asarray(x))

    def step(a):
        y = a * 2
        return y, float(y.sum())

    port_f = _port(step, torch.from_numpy(x))
    assert _counts(jax_f) == _counts(port_f) == {
        ("host-sync.transfer", "error", 1): 1}
    assert port_f[0].data == {"method": "__float__"}


def test_backward_op_resolves_to_its_forward_line():
    """A backward promotion is reported at the forward cast it
    transposes (JAX: a transposed equation's source info)."""
    w = torch.ones(4, 4, requires_grad=True)

    def step(x):
        y = x @ w.to(torch.bfloat16)  # the master weight's cast
        y.float().sum().backward()

    found = _port(step, torch.ones(2, 4, dtype=torch.bfloat16),
                  names=("precision",))
    lines = sorted(int(f.site.rsplit(":", 1)[1]) for f in found)
    assert len(lines) == 2 and lines[1] == lines[0] + 1


# -- the collective cases and the tiny targets, on one world of 4 ----------

def _jax_collectives():
    devs = np.asarray(jax.devices()[:4])
    dead = Mesh(devs.reshape(4, 1), ("dp", "tp"))
    pp = Mesh(devs, ("pp",))
    x = jnp.ones((4, 4))

    def traced(mesh, body):
        return _jax(shard_map(body, mesh=mesh, in_specs=P(mesh.axis_names[0]),
                              out_specs=P(mesh.axis_names[0]),
                              check_vma=False),
                    x, names=("collective",), mesh=mesh)

    return {
        "dead": traced(dead, lambda a: lax.psum(a, "tp")),
        "duplicate_source": traced(pp, functools.partial(
            lax.ppermute, axis_name="pp", perm=[(0, 1), (0, 2)])),
        "broken_chain": traced(pp, functools.partial(
            lax.ppermute, axis_name="pp", perm=[(0, 1), (2, 3)])),
    }


@pytest.fixture(scope="module")
def world():
    """Every rank's findings: the three collective cases, and the CLI's
    trace half over its four tiny targets on the CPU."""
    return spawn(collective_fixtures_worker, 4, args=(TARGETS,),
                 timeout=300.0)


@pytest.mark.parametrize("case,rule", [
    ("dead", "collective.dead-traffic"),
    ("duplicate_source", "collective.non-permutation"),
    ("broken_chain", "collective.mismatched-edge")])
def test_collective_cases_give_jax_s_findings(world, case, rule):
    jax_f = _jax_collectives()[case]
    port_f = merge_ranks(r[case] for r in world)
    assert _counts(port_f) == _counts(jax_f)
    assert {f.rule for f in port_f} == {rule}
    if case == "broken_chain":
        assert port_f[0].data["gaps"] == jax_f[0].data["gaps"] == "[1]"
    # every rank sees the whole world's edges
    if case != "dead":
        assert all(len(r[case]) == 1 for r in world)


def test_tiny_targets_audit_clean(world):
    """The four targets' findings are all allowlisted with reasons; the
    GPT step's known host reads are among them, and no collective of the
    four is unsafe."""
    found = merge_ranks(r["targets"] for r in world)
    result = repo_allowlist().apply(found, check_stale=False)
    assert result.findings == [], result.format()
    reads = {(f.target, f.data.get("method")) for f in found
             if f.rule == "host-sync.transfer"}
    assert {("gpt-dp2tp2", "__bool__"), ("gpt-dp2tp2", "tolist"),
            ("gpt-dp2tp2-int8", "__bool__")} <= reads
    assert not [f for f in found if f.rule.startswith("collective.")]
    assert {f.target for f in found} >= {"gpt-dp2tp2", "bert-dp2tp2",
                                         "gpt-dp2pp2"}


@pytest.mark.parametrize("line,method,allowed", [
    (280, "__bool__", True), (315, "tolist", True), (245, "_to_copy", True),
    (280, "item", False), (281, "__bool__", False), (2800, "__bool__", False),
    (315, "__bool__", False)])
def test_host_sync_entries_hold_one_wait_each(line, method, allowed):
    """Each allowlisted wait of the GPT step matches its own line and
    method only: another wait in the step's file is a finding."""
    f = Finding(
        rule="host-sync.transfer", message="m", target="gpt",
        site=f"apex_tpu_torch/resilience/replay/targets.py:{line}",
        data={"method": method})
    assert (repo_allowlist().match(f) is not None) == allowed


def test_cli_gate_exits_zero(world):
    """``python -m apex_tpu_torch.analysis --device cpu``'s gate over the
    world's trace findings, the lint and the concurrency passes."""
    rc, report = gate(merge_ranks(r["targets"] for r in world))
    assert rc == 0, report
    assert report.splitlines()[-1].endswith("0 stale entries")


def test_sites_survive_a_sys_path_entry_with_dot_dots(monkeypatch):
    """The JAX examples insert ``<repo>/examples/long_context/../..`` at
    the head of sys.path when a test loads one; a rank spawned later in
    that process imports the package through it, and every frame's file
    keeps the ``..``. The sites must still name the repo's files. Before
    the repair they were all ``<unknown>``, which no allowlist entry
    matches: the tiny targets' audit and the CLI gate failed whenever a
    test loading a JAX example (the context-parallel and MHA files) ran
    earlier in the same pytest worker."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.syspath_prepend(
        os.path.join(repo, "examples", "long_context", "..", ".."))
    (found,) = spawn(site_probe_worker, 1, timeout=120.0)
    line = inspect.getsourcelines(analysis_workers._promote)[1] + 1
    assert [f.site for f in found] == [
        f"apex_tpu_torch/transformer/testing/analysis_workers.py:{line}"]
    path = os.path.join(passes._REPO_ROOT, "examples", "long_context", "..",
                        "..", "apex_tpu_torch", "resilience", "replay",
                        "targets.py")
    assert passes._frames_site([(path, 280)]) == \
        "apex_tpu_torch/resilience/replay/targets.py:280"


def test_cli_fix_waits_for_autofix(capsys):
    """``--fix`` is ported (tests/test_torch_autofix.py runs it): like the
    trace half, it asks for a card unless given ``--device cpu``."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--fix"])


def test_cli_trace_half_asks_for_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--skip-lint", "--skip-concurrency", "--skip-timeline"])
