"""apex_tpu_torch.analysis.autofix against the JAX package's autofix.

On the naive ZeRO target (``targets.gpt_zero_naive_step_target``: flat
fp32 Adam moments whole on every dp rank, updated there, nothing updated
in place), the same tiny config in both packages:

- the derived prescriptions equal JAX's leaf for leaf: a shard spec over
  ``dp`` for m and v through the ``state_spec`` slot, an in-place
  declaration for m and v through ``donate_argnums``, with JAX's wire and
  memory deltas;
- the dp-axis ledger totals before and after the fix equal JAX's
  ``predict_comms`` totals digit for digit (JAX's test pins 524,292 and
  262,148 wire bytes; here JAX's side is computed in the test);
- the fix lands in one round, is idempotent (a second apply derives and
  rebuilds nothing), leaves no non-info finding and refuses conflicting
  specs; a user-code prescription renders as a unified diff and the
  file is untouched; ``python -m apex_tpu_torch.analysis --fix --device
  cpu`` exits 0 as a subprocess.

The port's side runs on a gloo world of 4 (CPU, one module-scoped spawn,
``transformer/testing/analysis_workers.autofix_worker``).
"""

import os
import subprocess
import sys

import pytest

from apex_tpu_torch.analysis.autofix import (
    KIND_CONSTRAINT,
    Patch,
    render_user_diff,
)
from apex_tpu_torch.transformer.testing import analysis_workers
from apex_tpu_torch.transformer.testing.distributed_test_base import spawn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_side():
    """JAX's prescriptions on its seeded target and its dp-axis ledger
    totals before and after the fix."""
    from jax.sharding import PartitionSpec as P

    from apex_tpu.analysis.allowlist import repo_allowlist
    from apex_tpu.analysis.autofix import derive_patches
    from apex_tpu.analysis.autofix.apply import _run_suite
    from apex_tpu.analysis.targets import (
        dp2tp2_mesh,
        gpt_zero_naive_step_target,
    )
    from apex_tpu.monitor.xray.ledger import predict_comms
    from apex_tpu.parallel import parallel_state as jps

    mesh = dp2tp2_mesh()
    try:
        target = gpt_zero_naive_step_target(mesh)
        kept, _ctx, ledger = _run_suite(
            target, ["hlo-sharding", "donation"], repo_allowlist())
        patches = derive_patches(target, kept, mesh=target.mesh,
                                 ledger=ledger)
        fixed = gpt_zero_naive_step_target(mesh, state_spec=P("dp"),
                                           donate_argnums=(1, 2))
        dp = {name: predict_comms(t.fn, *t.args).per_axis()["dp"]
              for name, t in (("before", target), ("after", fixed))}
    finally:
        jps.destroy_model_parallel()
    return patches, dp


@pytest.fixture(scope="module")
def world():
    return spawn(analysis_workers.autofix_worker, 4, timeout=300.0)


def test_prescriptions_leaf_for_leaf_as_jax(world, jax_side):
    patches, _ = jax_side
    want = sorted((p.kind, p.argnum, p.leaf,
                   None if p.spec is None else tuple(p.spec), p.axis,
                   p.slot, p.wire_delta, p.hbm_delta) for p in patches)
    assert len(want) == 4
    for r in world:
        assert r["prescriptions"] == want


def test_dp_totals_equal_jax_predict_comms(world, jax_side):
    _, dp = jax_side
    assert dp["before"]["ici_bytes"] == 524292
    assert dp["after"]["ici_bytes"] == 262148
    for r in world:
        rep = r["report"]
        assert rep["axis"] == "dp"
        assert rep["before"] == dp["before"]
        assert rep["after"] == dp["after"]


def test_fix_is_one_round_clean_and_idempotent(world):
    for r in world:
        rep = r["report"]
        assert rep["rounds"] == 1 and rep["idempotent"] and rep["ok"]
        assert not rep["refused"] and rep["manual"] == 0
        assert rep["residual"] == []
        assert rep["overrides"] == {"state_spec": ("dp",),
                                    "donate_argnums": (1, 2)}
        assert r["again"] == {"applied": 0, "rounds": 0, "ok": True,
                              "same": True}


def test_conflicting_specs_refuse(world):
    for r in world:
        assert "conflicting specs" in r["conflict"]


def test_user_prescription_renders_a_diff(tmp_path):
    src = tmp_path / "user_step.py"
    src.write_text("def step(params, grads):\n"
                   "    grads = all_reduce(grads)\n"
                   "    return params - grads\n")
    p = Patch(kind=KIND_CONSTRAINT, target="user", argnum=None,
              leaf="(state)", spec=("dp",), site="user_step.py:2",
              axis="dp", reason="replicated update")
    diff = render_user_diff([p], root=str(tmp_path))
    assert "--- a/user_step.py" in diff and "+++ b/user_step.py" in diff
    assert "('dp',)" in diff
    assert "autofix" not in src.read_text()  # rendered, never written
    siteless = Patch(kind=KIND_CONSTRAINT, target="user", argnum=None,
                     leaf="x", spec=("dp",), site="<step:user>", axis="dp")
    assert "unapplied prescription" in render_user_diff([siteless])
    assert render_user_diff([Patch(kind="shard-spec", target="t", argnum=1,
                                   leaf="m", spec=("dp",),
                                   slot="state_spec")]) == ""


def test_patch_kind_validated_and_payload():
    with pytest.raises(ValueError, match="kind"):
        Patch(kind="rewrite", target="t", argnum=0, leaf="x")
    f = Patch(kind="shard-spec", target="t", argnum=1, leaf="m",
              spec=("dp",), slot="state_spec", wire_delta=131072
              ).to_finding()
    assert f.rule == "autofix.prescription" and f.severity == "info"
    assert f.fix["spec"] == "('dp',)" and f.fix["auto"] is True


def test_cli_fix_subprocess(tmp_path):
    out = tmp_path / "fix.jsonl"
    proc = subprocess.run(
        [sys.executable, "-m", "apex_tpu_torch.analysis", "--fix",
         "--device", "cpu", "--json", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "524292 -> 262148" in proc.stdout
    lines = out.read_text().splitlines()
    assert any('"kind": "bench"' in ln and "_ici_bytes" in ln
               for ln in lines)
    assert sum('"autofix.prescription"' in ln for ln in lines) == 3
