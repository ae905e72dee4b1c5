"""The elastic restart's slow tier (twins of the JAX package's
``test_elastic_selftest_gate`` and ``test_gpt_elastic_chaos_drill``):
the gate's command line, and the GPT example under
``torch.distributed.run`` on the CPU (gloo), SIGTERM'd at 4 ranks and
resumed resharded at 2, and the other way round, against an
uninterrupted run at 4: every step's loss within 5e-2 (the JAX drill's
tolerance; the global batch is the same at every dp) and the goodput
identity ``==`` over both incarnations.
"""

import json
import os
import subprocess
import sys

import pytest

from apex_tpu_torch.monitor.goodput.accountant import BADPUT_PHASES, account
from apex_tpu_torch.resilience.elastic.__main__ import main as elastic_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["--device", "cpu", "--dist-backend", "gloo", "--zero", "--layers",
        "2", "--hidden", "64", "--heads", "4", "--seq-len", "32",
        "--micro-batch", "1", "--global-batch", "16", "--log-interval", "1",
        "--vocab", "128"]


@pytest.mark.slow
def test_torch_elastic_gate_cli(tmp_path):
    assert elastic_main(["--dir", str(tmp_path), "--device", "cpu"]) == 0


def _run(args, ranks):
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={ranks}", "-m",
         "apex_tpu_torch.examples.gpt.pretrain_gpt", *BASE, *args],
        capture_output=True, text=True, cwd=REPO, timeout=600,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stdout[-1500:] + proc.stderr[-3000:]
    return proc.stdout


def _losses(path):
    return {r["step"]: r["loss"] for r in map(json.loads, open(path))
            if r.get("kind") == "metrics"}


@pytest.mark.slow
def test_torch_gpt_elastic_drill(tmp_path):
    steps = 8
    ref = tmp_path / "ref.jsonl"
    _run(["--steps", str(steps), "--metrics-jsonl", str(ref)], 4)
    want = _losses(ref)
    assert set(want) == set(range(steps))
    for first, second in ((4, 2), (2, 4)):
        save, jsonl = tmp_path / f"ck{first}", tmp_path / f"m{first}.jsonl"
        common = ["--steps", str(steps), "--save", str(save),
                  "--save-interval", "3", "--metrics-jsonl", str(jsonl)]
        out = _run(common + ["--chaos-sigterm-step", "4"], first)
        assert "termination checkpoint at step 5; exiting" in out
        out = _run(common, second)
        assert "resumed from step 5" in out, out
        got = _losses(jsonl)
        assert set(got) == set(range(steps))
        for s in range(steps):
            assert got[s] == pytest.approx(want[s], abs=5e-2), (first, s)
        records = [json.loads(line) for line in open(jsonl)]
        run_ids = {r["run_id"] for r in records if r.get("kind") == "run"}
        assert len(run_ids) == 1
        rep = account(records, run_id=run_ids.pop())
        fields = rep.fields()
        total = fields["productive_s"]
        for phase in BADPUT_PHASES:
            total = total + fields[f"badput_{phase}_s"]
        assert total + fields["unattributed_s"] == fields["wall_s"]
        assert rep.incarnations == 2
