"""The Llama example's runtime (``examples/llama/finetune_llama.py``)
against the JAX example's: ``--save`` with resume (3 + 3 steps bit-equal
to 6 uninterrupted at fp32, and that trajectory within
``test_torch_llama.py``'s bound of the JAX example's), the goodput
identity of its records and no recompile after the first step
(``--metrics-jsonl``), the composed HBM ledger (``--xray-hbm``), the
journal (``--journal``: a clean ``replay --diff`` of two runs), the
``--run-deadline`` wedge's exit 43 and ``--remediate``'s adoption of it.

The drills that end in ``os._exit(43)`` run in a subprocess, so the exit
never reaches pytest.
"""

import json
import os
import signal
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from apex_tpu.models import GPTModel as JaxGPT
from apex_tpu.models.hf_import import (
    config_from_hf_llama as jax_config_from_hf_llama,
)
from apex_tpu_torch.examples.llama import finetune_llama
from apex_tpu_torch.models import GPTModel, gpt_params_from_jax
from apex_tpu_torch.monitor import router as port_router
from apex_tpu_torch.monitor.goodput import spans as port_spans
from apex_tpu_torch.resilience import integrity
from apex_tpu_torch.resilience.replay import load_journal
from apex_tpu_torch.resilience.replay.__main__ import main as replay_main
from test_torch_llama import TRAJECTORY_RTOL, _jax_finetune_losses

ROOT = Path(__file__).resolve().parent.parent
DEMO = ["--device", "cpu", "--batch", "2", "--seq-len", "32"]


@pytest.fixture(autouse=True)
def _restore_process_state():
    """The example's router installs a SIGTERM flush and flush hooks, and
    its AutoResume a SIGTERM latch: put them back after each test."""
    handler = signal.getsignal(signal.SIGTERM)
    hooks = list(port_router._FLUSH_HOOKS)
    yield
    signal.signal(signal.SIGTERM, handler)
    port_router._FLUSH_HOOKS[:] = hooks
    port_spans.set_router(None)


@pytest.fixture(scope="module")
def jax_demo():
    """The JAX demo model's config and seeded weights."""
    hf = types.SimpleNamespace(
        vocab_size=256, hidden_size=64, intermediate_size=160,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=32, rms_norm_eps=1e-6, rope_theta=10000.0,
        tie_word_embeddings=False)
    jcfg = jax_config_from_hf_llama(hf)
    variables = jax.jit(JaxGPT(config=jcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    return jcfg, variables


def _model(variables):
    model = GPTModel(finetune_llama.demo_config(32), device="cpu")
    model.load_state_dict(gpt_params_from_jax(jax.tree_util.tree_map(
        np.asarray, variables["params"])), strict=True)
    return model


def _crcs(recs):
    fp = integrity.tree_fingerprint(recs.finetune.checkpoint_state())
    return [(leaf["path"], leaf["crc32"]) for leaf in fp["leaves"]]


def _jsonl(path):
    return [json.loads(line) for line in Path(path).read_text().splitlines()]


def test_save_and_resume_equal_the_uninterrupted_run_and_track_jax(
        jax_demo, tmp_path):
    """3 steps saved and 3 resumed give the 6 uninterrupted steps' losses
    and every leaf's crc32 of the parameters and the ZeRO state at fp32;
    the restore is verified and the manifest carries the topology block;
    the losses stay within the JAX example's trajectory bound; and the
    two runs' journals diff clean."""
    jcfg, variables = jax_demo
    save, whole_dir = str(tmp_path / "ck"), str(tmp_path / "whole")
    whole = finetune_llama.main(DEMO + ["--steps", "6", "--save", whole_dir],
                                model=_model(variables))
    first = finetune_llama.main(DEMO + ["--steps", "3", "--save", save],
                                model=_model(variables))
    rest = finetune_llama.main(DEMO + ["--steps", "3", "--save", save],
                               model=_model(variables))
    assert (first.step0, rest.step0) == (0, 3)
    got = [r["loss"] for r in list(first) + list(rest)]
    assert [r["step"] for r in list(first) + list(rest)] == list(range(6))
    assert got == [r["loss"] for r in whole]
    assert _crcs(rest) == _crcs(whole)
    assert integrity.verified_latest_step(save) == 6
    manifest = integrity.read_manifest(os.path.join(save, "step_6"))
    assert manifest["topology"]["mesh"]["devices"] == 1
    run = rest.finetune
    want = _jax_finetune_losses(jcfg, variables, run.tokens.numpy(),
                                run.labels.numpy(), 6, 1e-3, 1.0)
    np.testing.assert_allclose(got, want, rtol=TRAJECTORY_RTOL)
    # the resumed journal (both incarnations) against the whole run's
    journal = load_journal(save)
    assert sorted(journal.steps) == list(range(6))
    assert journal.header["corpus"]["fixed_batch_crc"] == \
        load_journal(whole_dir).header["corpus"]["fixed_batch_crc"]
    # a model passed in is described as it is, not as --model would be
    config = journal.header["config"]
    assert (config["model"], config["checkpoint"], config["bf16"]) == (
        None, None, False)
    assert config["architecture"] == {
        "layers": 2, "hidden": 64, "heads": 4, "kv_heads": 2, "ffn": 160,
        "vocab": 256, "compute_dtype": "float32",
        "params_dtype": "float32"}
    assert replay_main(["--diff", whole_dir, save]) == 0


def test_records_hold_the_goodput_identity_and_see_no_recompile(tmp_path):
    jsonl = tmp_path / "m.jsonl"
    finetune_llama.main(DEMO + ["--steps", "4", "--metrics-jsonl",
                                str(jsonl), "--journal"])
    records = _jsonl(jsonl)
    (run,) = [r for r in records if r["kind"] == "run"]
    assert run["steps"] == 4
    phases = [r["phase"] for r in records if r["kind"] == "span"]
    assert phases.count("step") == 3 and phases.count("compile") == 1
    assert {"init", "shutdown"} <= set(phases)
    (g,) = [r for r in records if r["kind"] == "goodput"]
    total = g["productive_s"]
    for key in sorted(k for k in g if k.startswith("badput_")):
        total = total + g[key]
    assert total + g["unattributed_s"] == g["wall_s"]  # ==, not approx
    assert g["productive_s"] > 0 and g["badput_compile_s"] > 0
    # the CPU loads no kernel: the sentinel stays silent
    assert not [r for r in records if r["kind"] == "compile"]
    journal = [r for r in records if r["kind"] == "journal"]
    assert [r["step"] for r in journal if r["event"] == "step"] == \
        [0, 1, 2, 3]
    (header,) = [r for r in journal if r["event"] == "header"]
    assert (header["config"]["model"], header["config"]["bf16"],
            header["config"]["architecture"]["layers"]) == ("demo", False, 2)


def test_the_recompile_sentinel_flags_a_load_after_the_first_step(
        monkeypatch, tmp_path):
    """A kernel load during step 2 is a ``recompile=True`` record; one
    during the first step is the warm-up."""
    from apex_tpu_torch import _kernels

    real = finetune_llama.LlamaFinetune.step
    n = [0]

    def step(self, check_grads=False):
        n[0] += 1
        if n[0] in (1, 3):
            _kernels._LIBRARY_LOADS[0] += 1
        return real(self, check_grads)

    monkeypatch.setattr(finetune_llama.LlamaFinetune, "step", step)
    monkeypatch.setattr(_kernels, "_LIBRARY_LOADS", [0, 0.0])
    jsonl = tmp_path / "m.jsonl"
    finetune_llama.main(DEMO + ["--steps", "4", "--metrics-jsonl",
                                str(jsonl)])
    assert [(r["step"], r["compiles"], r["recompile"])
            for r in _jsonl(jsonl) if r["kind"] == "compile"] == [
        (0, 1, False), (2, 1, True)]


def test_xray_hbm_composes_the_jax_ledger(tmp_path, capsys):
    """The weights, gradients and ZeRO state of the composed ledger are
    the JAX example's; on the CPU the allocator's half is n/a and the
    watermark record's fields are None, never 0."""
    from apex_tpu.monitor.xray import hbm as jax_hbm

    jsonl = tmp_path / "m.jsonl"
    recs = finetune_llama.main(DEMO + ["--steps", "2", "--xray-hbm",
                                       "--metrics-jsonl", str(jsonl)])
    out = capsys.readouterr().out
    assert "HBM ledger llama-finetune:" in out
    assert "allocator peak n/a" in out
    params = list(recs.finetune.params.values())
    n = sum(p.numel() for p in params)
    pred = finetune_llama._hbm_prediction(
        finetune_llama.parse_args(DEMO), recs.finetune)
    assert pred.component_bytes("weights") == \
        pred.component_bytes("grads") == 4 * n
    assert pred.component_bytes("optimizer_state") == \
        jax_hbm.distributed_adam_state_bytes(n, 1)
    assert pred.component_bytes("batch_data") == 2 * 2 * 32 * 8  # int64
    (mem,) = [r for r in _jsonl(jsonl) if r["kind"] == "memory"]
    assert mem["scope"] == "device" and mem["peak_bytes_in_use"] is None
    assert mem["predicted_peak_bytes"] == pred.peak_bytes


_WEDGE = [sys.executable, "-m", "apex_tpu_torch.examples.llama.finetune_llama",
          *DEMO, "--steps", "100000", "--run-deadline", "0.05"]


def test_run_deadline_wedge_exits_43_and_remediate_adopts_it(tmp_path):
    """A run under a deadline far shorter than itself is ended by the
    incident ladder with exit 43 (the dump, then the terminate record);
    the supervisor's adoption note for that exit becomes a case the next
    incarnation (``--remediate``) adopts and its clean run closes with
    one terminal verdict."""
    from apex_tpu_torch.resilience.remediation import RemediationState

    save, jsonl = str(tmp_path / "ck"), str(tmp_path / "w.jsonl")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run(_WEDGE + ["--save", save, "--remediate",
                                    "--metrics-jsonl", jsonl],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 43, proc.stderr[-3000:]
    stages = [r["stage"] for r in _jsonl(jsonl) if r["kind"] == "incident"]
    assert stages == ["dump", "terminate"]
    # what the supervisor writes on exit 43
    state = RemediationState.load(save)
    state.pending = {"kind": "incident", "exit_code": 43, "incarnation": 0}
    state.save()
    jsonl2 = tmp_path / "r.jsonl"
    finetune_llama.main(DEMO + ["--steps", "2", "--save", save,
                                "--remediate", "--metrics-jsonl",
                                str(jsonl2)])
    rem = [r for r in _jsonl(jsonl2) if r["kind"] == "remediation"]
    terminal = [r for r in rem if r.get("terminal")]
    assert [r["finding"] for r in terminal] == ["incident"], rem
    assert RemediationState.load(save).pending is None
    with pytest.raises(SystemExit, match="requires --save"):
        finetune_llama.main(DEMO + ["--steps", "1", "--remediate"])
