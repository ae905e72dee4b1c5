"""The pipelined GPT of apex_tpu_torch against the JAX package:
``forward_backward_with_pre_post`` with ``build_gpt_pipeline``'s
functions, the params converter, and ``standalone_gpt``'s training.

At ``tests/test_pipeline_gpt.py``'s tiny size (4 layers, hidden 16, 4
heads, vocab 32, seq 8, micro batch 2, fp32). The JAX parameters are
initialized inside ``shard_map`` as ``run_gpt`` initializes them, each
device keeping its own stage (and tp shards) under a sharding that
claims replication, and port rank r loads device r's
(``gpt_pipeline_params_from_jax``). The port runs in spawned gloo worlds
on the CPU: one of 4 ranks for the schedule cases, one of 8 for
``run_gpt``, whose JAX mesh takes all 8 devices (dp = 2). Checked:

- pp = 2 (dp = 2), pp = 2 x tp = 2 with sequence parallelism, and pp = 2
  with V = 2 (one layer a chunk): on every rank the loss and the four
  per-micro-batch losses 1e-5 relative, every ``pre``, ``stages`` and
  ``post`` gradient 1e-4 relative in norm (fp32 products and sums in
  another order), and under sequence parallelism the ``post`` gradients
  equal on both tp ranks of a stage;
- three ``run_gpt`` steps at pp = 2 x tp = 2 with sequence parallelism
  (dp = 2, 2 micro-batches, Adam at lr 1e-3), the port's
  ``GPTPipelineTraining`` fed JAX's initial parameters and tokens: the
  losses 1e-5 relative; the replicated ``pre`` and ``post`` parameters
  bit-equal across the pp ranks after the three steps; and the port's
  ``run_gpt`` from its own seeded weights logs finite losses and its
  closing JSON line;
- ``init_post`` draws the head at JAX's std, 0.05, as a rule (the draw
  itself cannot be repeated): sample stds within 1%.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from apex_tpu.compat import shard_map
from apex_tpu.models.gpt_pipeline import build_gpt_pipeline as jbuild
from apex_tpu.parallel import parallel_state as jps
from apex_tpu.parallel.pipeline import forward_backward_with_pre_post
from apex_tpu.transformer import TransformerConfig as JaxConfig
from apex_tpu_torch.models import (
    gpt_params_from_jax,
    gpt_pipeline_params_from_jax,
)
from apex_tpu_torch.transformer.testing.distributed_test_base import spawn
from apex_tpu_torch.transformer.testing.pipeline_workers import jobs_worker

WORLD = 4
ALL = P(("dp", "pp", "cp", "tp"))
VOCAB, SEQ, MB, NUM_MICRO = 32, 8, 2, 4
CONFIG = dict(num_layers=4, hidden_size=16, num_attention_heads=4,
              vocab_size=VOCAB, max_position_embeddings=SEQ,
              hidden_dropout=0.0, attention_dropout=0.0)
CASES = {"pp2": dict(tp=1, pp=2, V=1, sp=False),
         "pp2_tp2_sp": dict(tp=2, pp=2, V=1, sp=True),
         "pp2_v2": dict(tp=1, pp=2, V=2, sp=False)}


def _np_tree(tree):
    return {part: {k: np.asarray(v) for k, v in named.items()}
            for part, named in tree.items()}


def _init(parts, V, tokens_mb, seed=0):
    """``run_gpt``'s init inside ``shard_map`` (V chunks a rank stacked
    on a leading dim, chunk v of pp rank r from ``fold_in(r * V + v)``)."""
    key = jax.random.PRNGKey(seed)
    pre = parts.embed.init(key, tokens_mb)["params"]
    h0 = parts.pre_fn(pre, tokens_mb)
    r = jax.lax.axis_index("pp")
    stage_key = jax.random.fold_in(key, 7)

    def chunk(i):
        return parts.chunk.init(jax.random.fold_in(stage_key, i), h0)["params"]

    if V == 1:
        stages = chunk(r)
    else:
        stages = jax.tree_util.tree_map(
            lambda *a: jnp.stack(a), *[chunk(r * V + v) for v in range(V)])
    return {"pre": pre, "stages": stages,
            "post": parts.init_post(jax.random.fold_in(key, 9))}


def _jax_case(name, tokens, labels):
    c = CASES[name]
    mesh = jps.initialize_model_parallel(
        tensor_model_parallel_size=c["tp"],
        pipeline_model_parallel_size=c["pp"], devices=jax.devices()[:WORLD])
    try:
        cfg = JaxConfig(compute_dtype=jnp.float32, sequence_parallel=c["sp"],
                        **CONFIG)
        parts = jbuild(cfg, c["pp"] * c["V"])

        def run(tokens, labels):
            params = _init(parts, c["V"], tokens[0])
            loss, losses, grads = forward_backward_with_pre_post(
                parts.pre_fn, parts.stage_fn, parts.post_loss_fn, params,
                tokens, labels, axis_name="pp", num_model_chunks=c["V"])
            stacked = jax.tree_util.tree_map(lambda a: a[None],
                                             (loss, losses, grads))
            return params, stacked

        f = shard_map(run, mesh=mesh, in_specs=(P(), P()),
                      out_specs=(P(), ALL), check_vma=False)
        params, (loss, losses, grads) = jax.jit(f)(tokens, labels)
        by_rank = [_np_tree(gpt_pipeline_params_from_jax(params, r))
                   for r in range(WORLD)]
        grads = jax.tree_util.tree_map(np.asarray, grads)
    finally:
        jps.destroy_model_parallel()
    return by_rank, (np.asarray(loss), np.asarray(losses), grads)


RUN_GPT_ARGV = (
    "--num-layers 4 --hidden-size 16 --num-attention-heads 4 "
    "--seq-length 8 --max-position-embeddings 8 --micro-batch-size 2 "
    "--global-batch-size 8 --make-vocab-size-divisible-by 32 "
    "--tensor-model-parallel-size 2 --pipeline-model-parallel-size 2 "
    "--sequence-parallel --train-iters 3").split()
RUN_GPT_WORLD = 8


def _jax_run_gpt():
    """JAX's ``run_gpt`` losses, and its initial parameters (by port rank)
    and tokens rebuilt as ``run_gpt`` builds them inside ``shard_map``."""
    from apex_tpu.transformer.testing.arguments import parse_args
    from apex_tpu.transformer.testing.standalone_gpt import (
        gpt_config_from_args,
        run_gpt,
    )

    args = parse_args(args=list(RUN_GPT_ARGV))
    assert args.world_size == RUN_GPT_WORLD  # jax.device_count()
    losses = run_gpt(args, log=lambda *a: None)
    mesh = jps.initialize_model_parallel(tensor_model_parallel_size=2,
                                         pipeline_model_parallel_size=2)
    try:
        dp = jps.get_data_parallel_world_size()
        cfg = gpt_config_from_args(args)
        parts = jbuild(cfg, 2)
        num_micro = args.global_batch_size // (MB * dp)
        tokens = jax.random.randint(jax.random.PRNGKey(args.seed),
                                    (args.train_iters, num_micro, MB * dp,
                                     SEQ), 0, cfg.vocab_size)
        f = shard_map(lambda t: _init(parts, 1, t[0, 0], args.seed),
                      mesh=mesh, in_specs=P(None, None, "dp"),
                      out_specs=P(), check_vma=False)
        params = jax.jit(f)(tokens)
        by_rank = [_np_tree(gpt_pipeline_params_from_jax(params, r))
                   for r in range(RUN_GPT_WORLD)]
    finally:
        jps.destroy_model_parallel()
    return losses, by_rank, np.asarray(tokens)


@pytest.fixture(scope="module")
def both():
    rs = np.random.RandomState(0)
    tokens = rs.randint(0, VOCAB, (NUM_MICRO, MB, SEQ)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=2)
    refs, cases = {}, []
    for name, c in CASES.items():
        by_rank, refs[name] = _jax_case(name, tokens, labels)
        cases.append(dict(name=name, tp=c["tp"], pp=c["pp"], V=c["V"],
                          config=dict(CONFIG, sequence_parallel=c["sp"]),
                          params=by_rank, tokens=tokens, labels=labels))
    ports = spawn(jobs_worker, WORLD,
                  args=([("gpt_pre_post_worker", (cases,))],),
                  timeout=240.0)
    return refs, [p[0] for p in ports]


@pytest.fixture(scope="module")
def run_gpt_both():
    losses, by_rank, tokens = _jax_run_gpt()
    ports = spawn(jobs_worker, RUN_GPT_WORLD, args=([
        ("run_gpt_worker", (RUN_GPT_ARGV, by_rank, tokens))],),
        timeout=240.0)
    return losses, [p[0] for p in ports]


def _rel(got, want):
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("name", list(CASES))
def test_pre_post_loss_and_losses_match_jax(both, name):
    refs, ports = both
    loss, losses, _ = refs[name]
    for r in range(WORLD):
        got = ports[r][name]
        np.testing.assert_allclose(got["loss"], loss[r], rtol=1e-5)
        assert got["losses"].shape == (NUM_MICRO,)
        np.testing.assert_allclose(got["losses"], losses[r], rtol=1e-5)


@pytest.mark.parametrize("name", list(CASES))
def test_pre_post_every_gradient_matches_jax(both, name):
    refs, ports = both
    _, _, grads = refs[name]
    for r in range(WORLD):
        got = ports[r][name]["grads"]
        for part in ("pre", "stages", "post"):
            want = {k: v.numpy() for k, v in gpt_params_from_jax(
                jax.tree_util.tree_map(lambda a, r=r: a[r],
                                       grads[part])).items()}
            assert set(got[part]) == set(want), part
            for k, w in want.items():
                assert got[part][k].shape == w.shape, (part, k)
                assert _rel(got[part][k], w) < 1e-4, (name, r, part, k)


def test_pre_post_post_grads_replicated_over_tp_under_sp(both):
    _, ports = both
    for r in range(0, WORLD, 2):  # the tp pairs (r, r + 1)
        a = ports[r]["pp2_tp2_sp"]["grads"]["post"]
        b = ports[r + 1]["pp2_tp2_sp"]["grads"]["post"]
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-7)
        assert np.abs(a["head"]).sum() > 0


def test_init_post_draws_the_head_at_jax_std():
    """The port cannot repeat ``jax.random``'s draw, so it is held to the
    rule: the norm's ones and zeros, and the head at JAX's std 0.05
    (``HEAD_STD``), not at ``--init-method-std``: both sample stds within
    1% of it at 64 x 4096."""
    import torch

    from apex_tpu_torch.models.gpt_pipeline import (
        HEAD_STD,
        build_gpt_pipeline,
    )
    from apex_tpu_torch.transformer import TransformerConfig

    wide = dict(CONFIG, num_layers=2, hidden_size=64, vocab_size=4096)
    theirs = jbuild(JaxConfig(**wide), 2).init_post(jax.random.PRNGKey(0))
    ours = build_gpt_pipeline(TransformerConfig(compute_dtype=torch.float32,
                                                **wide), 2,
                              device="cpu").init_post(0)
    assert HEAD_STD == 0.05
    for k in ("norm_scale", "norm_bias"):
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(theirs[k]))
    for head in (ours["head"].numpy(), np.asarray(theirs["head"])):
        assert head.shape == (64, 4096)
        assert abs(head.std() / HEAD_STD - 1) < 1e-2


def test_params_converter_reads_the_stacked_host_tree():
    """``init_all``'s host tree: stages lead with the pp dim (then V)."""
    rs = np.random.RandomState(1)
    tree = {"pre": {"position_embeddings": rs.randn(8, 4)},
            "stages": {"layer_0": {"mlp": {"k": rs.randn(2, 3, 5)}}},
            "post": {"head": rs.randn(4, 6)}}
    for tp in (1, 2):
        for r in range(2 * tp):
            got = gpt_pipeline_params_from_jax(tree, r, tp)
            np.testing.assert_array_equal(
                got["stages"]["layer_0.mlp.k"],
                tree["stages"]["layer_0"]["mlp"]["k"][r // tp])
            np.testing.assert_array_equal(got["post"]["head"],
                                          tree["post"]["head"])
            np.testing.assert_array_equal(got["pre"]["position_embeddings"],
                                          tree["pre"]["position_embeddings"])


def test_run_gpt_losses_match_jax(run_gpt_both):
    losses, ports = run_gpt_both
    assert len(losses) == 3
    for r in range(RUN_GPT_WORLD):
        np.testing.assert_allclose(ports[r]["losses"], losses, rtol=1e-5,
                                   err_msg=f"rank {r}")


def test_run_gpt_replicated_params_stay_bit_equal_across_pp(run_gpt_both):
    _, ports = run_gpt_both
    for r in range(RUN_GPT_WORLD):
        partner = r ^ 2  # rank (d, p, t) -> (d, 1 - p, t) at tp = pp = 2
        for part in ("pre", "post"):
            for k, v in ports[r]["params"][part].items():
                np.testing.assert_array_equal(
                    v, ports[partner]["params"][part][k],
                    err_msg=f"rank {r} {part} {k}")


def test_port_run_gpt_logs_its_steps_and_summary(run_gpt_both):
    _, ports = run_gpt_both
    for r in range(RUN_GPT_WORLD):
        out = ports[r]
        assert len(out["run_gpt"]) == 3
        assert np.isfinite(out["run_gpt"]).all()
        steps = [line for line in out["lines"]
                 if line.startswith("iteration")]
        assert len(steps) == 3 and "| lm loss" in steps[0]
        summary = json.loads(out["lines"][-1])
        assert (summary["world"], summary["tp"], summary["pp"],
                summary["dp"], summary["num_micro"]) == (8, 2, 2, 2, 2)
        assert summary["sequence_parallel"] is True
        assert summary["losses"] == out["run_gpt"]
        assert all(k in summary for k in (
            "step_ms", "tokens_per_s", "peak_mem_gb_by_rank",
            "launch_counts_first_stage", "launch_counts_last_stage",
            "staged_rank0"))
