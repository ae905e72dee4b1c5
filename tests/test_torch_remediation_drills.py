"""The self-healing loop's slow tier (twins of the JAX package's
``test_remediation_selftest_gate``, ``test_remediation_campaign`` and
``test_gpt_remediation_acceptance_drill``), each in one spawned world of
4 gloo ranks on the CPU: the gate's command line; 20 seeded random fault
sequences through the invariant checker; and a SIGTERM, a hang and a
silent bit flip in one run, healed with zero human steps (quarantine 4
-> 2 and readmit 2 -> 4 under one run id, every fault one terminal
verdict, the final loss within 5e-2 of the uninterrupted reference).
"""

import pytest

from apex_tpu_torch.resilience.remediation.__main__ import (
    main as remediation_main,
)
from apex_tpu_torch.transformer.testing.distributed_test_base import spawn
from apex_tpu_torch.transformer.testing.elastic_workers import (
    acceptance_drill_worker,
    campaign_worker,
)


@pytest.mark.slow
def test_torch_remediation_gate_cli(tmp_path):
    assert remediation_main(["--selftest", "--dir", str(tmp_path),
                             "--device", "cpu"]) == 0


@pytest.mark.slow
def test_torch_remediation_campaign_twenty(tmp_path):
    report = spawn(campaign_worker, 4, args=(str(tmp_path), 20, 0, "cpu"),
                   timeout=3000.0)[0]
    failing = [e for e in report["sequences"] if e["violations"]]
    assert report["failed"] == 0, failing
    assert report["passed"] == 20


@pytest.mark.slow
def test_torch_gpt_remediation_acceptance_drill(tmp_path):
    out = spawn(acceptance_drill_worker, 4, args=(str(tmp_path), "cpu"),
                timeout=1200.0)[0]
    reference, result = out["reference"], out["result"]
    assert reference.outcome == "completed" and not reference.remediation
    assert result.outcome == "completed", result.incarnations
    assert out["violations"] == []
    devices = [i["devices"] for i in result.incarnations]
    assert 2 in devices and devices[0] == 4 and devices[-1] == 4
    assert {r.get("run_id") for r in result.records
            if r.get("kind") == "run"} == {result.run_id}
    assert len(result.terminals) == 3
