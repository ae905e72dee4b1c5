"""The reference's remaining training utilities in apex_tpu_torch against
the JAX package's functions: ``transformer/utils.py``'s four,
``transformer/testing/global_vars.py``'s globals, ``commons.py``'s
providers and ``IdentityLayer``, the package's logging, and the GPT
example's fleet, straggler, wedge and TensorBoard flags on the CPU.

Tolerances: the masks, position ids and loss masks exactly; the dp mean
of losses 1e-6 relative (fp32 sums in another order); the min/max/norm
table's numbers 1e-6 relative.
"""

import functools
import json
import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import apex_tpu
import apex_tpu_torch
from apex_tpu.compat import shard_map
from apex_tpu.parallel import parallel_state as jps
from apex_tpu.transformer import utils as jutils
from apex_tpu.transformer.testing import commons as jcommons
from apex_tpu.transformer.testing import global_vars as jgv
from apex_tpu_torch.transformer import utils as tutils
from apex_tpu_torch.transformer.testing import commons, global_vars
from apex_tpu_torch.transformer.testing.distributed_test_base import spawn
from apex_tpu_torch.transformer.testing.parallel_workers import (
    average_losses_worker,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_average_losses_across_dp_equals_jax():
    losses = np.random.RandomState(0).randn(4, 3).astype(np.float32)
    mesh = jps.initialize_model_parallel(devices=jax.devices()[:4])
    try:
        @functools.partial(shard_map, mesh=mesh, in_specs=P("dp"),
                           out_specs=P(), check_vma=False)
        def run(x):
            return jutils.average_losses_across_data_parallel_group(
                list(x[0]))

        want = np.asarray(run(jnp.asarray(losses)))
    finally:
        jps.destroy_model_parallel()
    got = spawn(average_losses_worker, 4, args=(losses,), timeout=120.0)
    for g in got:
        np.testing.assert_allclose(g, want, rtol=1e-6)


@pytest.mark.parametrize("reset_pos,reset_att,eod_loss", [
    (False, False, False), (False, False, True), (True, False, False),
    (False, True, False), (True, True, True)])
def test_ltor_masks_equal_jax(reset_pos, reset_att, eod_loss):
    """Tolerance: none (booleans, integers, 0/1 floats)."""
    rs = np.random.RandomState(int(reset_pos) + 2 * int(reset_att))
    data = rs.randint(0, 4, size=(3, 17))  # eod = 1, several a row
    data[0, 0] = data[1, -1] = 1
    want = jutils.get_ltor_masks_and_position_ids(
        jnp.asarray(data), eod_token=1, reset_position_ids=reset_pos,
        reset_attention_mask=reset_att, eod_mask_loss=eod_loss)
    got = tutils.get_ltor_masks_and_position_ids(
        torch.from_numpy(data), eod_token=1, reset_position_ids=reset_pos,
        reset_attention_mask=reset_att, eod_mask_loss=eod_loss)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_ltor_reset_case_of_the_jax_test():
    data = torch.tensor([[5, 1, 7, 8, 1, 9]])
    att, _, pos = tutils.get_ltor_masks_and_position_ids(
        data, eod_token=1, reset_position_ids=True,
        reset_attention_mask=True)
    assert pos[0].tolist() == [0, 1, 0, 1, 2, 0]
    assert bool(att[0, 0, 2, 0]) and not bool(att[0, 0, 3, 2])


def test_report_memory_and_min_max_norm_equal_jax(capsys):
    rs = np.random.RandomState(5)
    params = {"w": rs.randn(3, 4).astype(np.float32),
              "b": rs.randn(4).astype(np.float32)}
    want = jutils.print_params_min_max_norm(
        {k: jnp.asarray(v) for k, v in params.items()}, iteration=7)
    got = tutils.print_params_min_max_norm(
        {k: torch.from_numpy(v) for k, v in params.items()}, iteration=7)
    w_lines, g_lines = want.splitlines(), got.splitlines()
    assert g_lines[0] == w_lines[0] and len(g_lines) == len(w_lines)
    for g, w in zip(g_lines[1:], w_lines[1:]):
        gi, wi = g.split(", "), w.split(", ")
        assert gi[:2] == wi[:2]
        np.testing.assert_allclose([float(v) for v in gi[2:]],
                                   [float(v) for v in wi[2:]], rtol=1e-6)
    text = tutils.report_memory("test")
    assert text.startswith("test memory (MB) |")
    assert jutils.report_memory("test").startswith("test memory (MB) |")
    out = capsys.readouterr().out
    assert "iteration, index, min, max, norm" in out


BASE = ["--num-layers", "8", "--hidden-size", "64",
        "--num-attention-heads", "8", "--max-position-embeddings", "128",
        "--seq-length", "128", "--micro-batch-size", "2"]


@pytest.fixture
def clean_globals():
    jgv.destroy_global_variables()
    global_vars.destroy_global_variables()
    yield
    jgv.destroy_global_variables()
    global_vars.destroy_global_variables()


@pytest.mark.parametrize("mod", ["jax", "port"])
def test_global_vars_lifecycle_as_jax(clean_globals, monkeypatch, mod):
    """JAX's ``TestGlobalVars`` on either package."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    gv = jgv if mod == "jax" else global_vars
    gv.set_global_variables(args=BASE + ["--global-batch-size", "8"],
                            override_args={"world_size": 2})
    args = gv.get_args()
    assert args.micro_batch_size == 2 and args.data_parallel_size == 2
    assert gv.get_num_microbatches() == 8 // (2 * 2)
    assert gv.get_current_global_batch_size() == 8
    assert gv.get_timers() is not None
    assert gv.get_tensorboard_writer() is None
    assert gv.get_adlr_autoresume() is None
    with pytest.raises(AssertionError, match="already initialized"):
        gv.set_global_variables(args=BASE)
    gv.destroy_global_variables()
    with pytest.raises(AssertionError, match="not initialized"):
        gv.get_args()


def test_global_vars_rampup_equals_jax(clean_globals, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    argv = BASE + ["--global-batch-size", "16", "--rampup-batch-size", "4",
                   "4", "32", "--train-samples", "64"]
    over = {"world_size": 1, "data_parallel_size": 1}
    got, want = [], []
    for gv, out in ((global_vars, got), (jgv, want)):
        gv.set_global_variables(args=argv, override_args=over)
        for consumed in (0, 8, 16, 24, 32, 40):
            gv.update_num_microbatches(consumed, consistency_check=False)
            out.append((gv.get_current_global_batch_size(),
                        gv.get_num_microbatches()))
    assert got == want and got[0] == (4, 2) and got[-1][0] == 16


def test_tensorboard_writer_on_the_last_rank(clean_globals, monkeypatch,
                                             tmp_path):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    global_vars.set_global_variables(
        args=BASE + ["--tensorboard-dir", str(tmp_path)],
        override_args={"world_size": 1})
    writer = global_vars.get_tensorboard_writer()
    assert writer is not None  # torch.utils.tensorboard is importable here
    writer.add_scalar("x", 1.0, 0)
    global_vars.destroy_global_variables()
    assert any(f.startswith("events.") for f in os.listdir(tmp_path))


def test_mlp_provider_equals_jax_on_the_same_params():
    rs = np.random.RandomState(3)
    w, b = rs.randn(16, 16).astype(np.float32), rs.randn(16).astype(
        np.float32)
    x = rs.randn(5, 16).astype(np.float32)
    _, jstage = jcommons.mlp_provider_func(16)
    init, stage = commons.mlp_provider_func(16)
    got = stage({"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
                torch.from_numpy(x))
    want = jstage({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    p = init(0)
    jp = jcommons.mlp_provider_func(16)[0](jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        k: tuple(v.shape) for k, v in jp.items()}
    assert torch.equal(p["b"], torch.zeros(16))
    # the draw rule: N(0, 0.1^2) (the draws themselves cannot be repeated)
    assert abs(float(p["w"].std()) - 0.1) < 0.02


def test_model_provider_and_identity_layer_as_jax():
    from apex_tpu_torch.parallel.pipeline.schedules import build_model

    chunks = build_model(commons.model_provider_func, 0, 2,
                         virtual_pipeline_model_parallel_size=2,
                         hidden_size=8)
    from apex_tpu.parallel.pipeline.schedules import build_model as jbuild

    jchunks = jbuild(
        jcommons.model_provider_func, 0, 2,
        virtual_pipeline_model_parallel_size=2, hidden_size=8)
    assert [(c["pre_process"], c["post_process"]) for c in chunks] == [
        (c["pre_process"], c["post_process"]) for c in jchunks]
    layer = commons.IdentityLayer((300, 40), scale=2.0)
    jlayer = jcommons.IdentityLayer((300, 40), scale=2.0)
    assert tuple(layer().shape) == tuple(jlayer().shape)
    assert layer() is layer.weight and layer.weight.requires_grad
    assert abs(float(layer.weight.std()) - 2.0) < 0.05


def test_package_logging_as_jax(caplog):
    assert apex_tpu_torch.get_logger().name == "apex_tpu_torch"
    assert apex_tpu.get_logger().name == "apex_tpu"
    assert apex_tpu_torch.get_logger("x.y") is apex_tpu.get_logger("x.y")
    prev = apex_tpu_torch.get_logger().level
    try:
        apex_tpu_torch.set_logging_level("DEBUG")
        assert apex_tpu_torch.get_logger().level == 10
    finally:
        apex_tpu_torch.get_logger().setLevel(prev)
    for pkg in (apex_tpu, apex_tpu_torch):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            pkg.deprecated_warning("old")
        assert w[0].category is FutureWarning and str(w[0].message) == "old"
    import logging

    rec = logging.LogRecord("apex_tpu_torch", 20, __file__, 1, "m", (), None)
    text = apex_tpu_torch.RankInfoFormatter(
        "%(rank_info)s %(message)s").format(rec)
    assert text == "[process 0/1] m"


def _example(tmp_path, *flags):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-m", "apex_tpu_torch.examples.gpt.pretrain_gpt",
         "--device", "cpu", "--layers", "1", "--hidden", "32", "--heads",
         "2", "--seq-len", "16", "--micro-batch", "1", "--global-batch",
         "4", "--vocab", "128", "--log-interval", "1",
         "--metrics-jsonl", str(tmp_path / "m.jsonl"), *flags],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)


def test_example_fleet_slow_and_tensorboard_flags(tmp_path):
    run = _example(tmp_path, "--steps", "5", "--fleet-interval", "2",
                   "--chaos-slow-steps", "2", "--chaos-slow-s", "1.0",
                   "--stall-deadline", "0.5",
                   "--tensorboard-dir", str(tmp_path / "tb"))
    assert run.returncode == 0, run.stderr[-2000:]
    recs = [json.loads(line) for line in open(tmp_path / "m.jsonl")]
    kinds = [r["kind"] for r in recs]
    assert kinds.count("fleet") >= 2
    # the slow step's delay falls before its heartbeat: a stall after the
    # last beaten step, 1, overdue by about the delay over the deadline
    assert any(r["kind"] == "stall" and r["step"] == 1
               and r["overdue_s"] >= 0.4 for r in recs)
    assert any(f.startswith("events.") for f in os.listdir(tmp_path / "tb"))


def test_example_hang_step_ends_at_the_ladder(tmp_path):
    # a deadline no loaded host's tiny step reaches: only the wedge trips
    # the ladder (dump at 3 s, exit at 4 s without a heartbeat)
    run = _example(tmp_path, "--steps", "6", "--chaos-hang-step", "2",
                   "--stall-deadline", "2", "--stall-dump-after", "1.5",
                   "--stall-terminate-after", "2")
    assert run.returncode == 43, run.stderr[-2000:]
    recs = [json.loads(line) for line in open(tmp_path / "m.jsonl")]
    assert any(r["kind"] == "incident" for r in recs)
    assert max(r["step"] for r in recs if r["kind"] == "metrics") == 1
