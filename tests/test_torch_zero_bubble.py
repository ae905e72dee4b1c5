"""apex_tpu_torch's zero-bubble pipeline schedule (the B/W split) against
the JAX package's ``forward_backward_zero_bubble`` and
``forward_backward_zero_bubble_with_pre_post``.

The port runs in one spawned world of 4 gloo ranks on the CPU; the JAX
functions run under ``shard_map`` on 4 devices of the 8-device CPU mesh
laid out as the port's ranks are (device r is port rank r). Each JAX
reference is computed once for the module. Inputs come from a seeded
numpy RNG (the GPT weights from JAX's initializers inside ``shard_map``,
read per device). Checked, on every rank:

- the toy stage ``tanh(x @ w + b)`` with a squared-error loss at P = 2
  and 4 with M in {1, 3, 4, 8}: the mean loss and the per-micro-batch
  losses 1e-5 relative, every gradient 1e-4 relative in norm (1F1B's
  tolerances, ``tests/test_torch_pipeline.py``), and the same against
  the port's own 1F1B; the parameters' ``.grad`` stay None;
- the tiny GPT of ``tests/test_pipeline_gpt.py`` (4 layers, hidden 16,
  4 heads, vocab 32, seq 8, micro batch 2, M = 4, fp32) split by
  ``build_gpt_pipeline`` at pp = 2, pp = 4 and pp = 2 x tp = 2 with
  sequence parallelism, through the pre/post variant: the loss, the
  losses and every ``pre``, ``stages`` and ``post`` gradient at rtol
  5e-4, atol 5e-5 (JAX's own bound for the split against the fused
  path), and against the port's 1F1B ``forward_backward_with_pre_post``
  at the same bound;
- the card phase's runners at a tiny size on the CPU (``chip_smoke.py``
  runs them on the card): ``GPTPipelineTraining(zero_bubble=True)``
  through ``standalone_gpt.train`` at pp = 2 x tp = 2 with SP logs the
  zero-bubble schedule, finite losses and the layout, and
  ``zero_bubble_vs_1f1b_worker`` gives the losses 1e-5 and every
  gradient 1e-4 relative in norm of 1F1B's from the same weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from apex_tpu.compat import shard_map
from apex_tpu.models.gpt_pipeline import build_gpt_pipeline as jbuild
from apex_tpu.parallel import parallel_state as jps
from apex_tpu.parallel.pipeline import schedules as jsched
from apex_tpu.transformer import TransformerConfig as JaxConfig
from apex_tpu_torch.models import (
    gpt_params_from_jax,
    gpt_pipeline_params_from_jax,
)
from apex_tpu_torch.transformer.testing.cp_workers import jobs_worker
from apex_tpu_torch.transformer.testing.distributed_test_base import spawn
from apex_tpu_torch.transformer.testing.pipeline_workers import (
    interleaved_worker,
)

WORLD = 4
ALL = P(("dp", "pp", "cp", "tp"))
H, MB = 6, 2  # toy hidden size and micro-batch rows
VOCAB, SEQ, GMB, NUM_MICRO = 32, 8, 2, 4
CONFIG = dict(num_layers=4, hidden_size=16, num_attention_heads=4,
              vocab_size=VOCAB, max_position_embeddings=SEQ,
              hidden_dropout=0.0, attention_dropout=0.0)
GPT_CASES = {"pp2": dict(tp=1, pp=2, sp=False),
             "pp4": dict(tp=1, pp=4, sp=False),
             "pp2_tp2_sp": dict(tp=2, pp=2, sp=True)}
TOY = [(pp, M) for pp in (2, 4) for M in (1, 3, 4, 8)]
# standalone_gpt's arguments of the card phase, at a tiny size
TRAIN_ARGV = (
    "--num-layers 2 --hidden-size 32 --num-attention-heads 4 --seq-length 16 "
    "--max-position-embeddings 16 --make-vocab-size-divisible-by 64 "
    "--micro-batch-size 2 --global-batch-size 8 --seed 0 "
    "--pipeline-model-parallel-size 2 --tensor-model-parallel-size 2 "
    "--sequence-parallel --train-iters 2").split()


def _mesh(pp, tp=1):
    return Mesh(np.asarray(jax.devices()[:WORLD]).reshape(
        WORLD // (pp * tp), pp, 1, tp), jps.AXIS_ORDER)


def _jax_stage(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


def _jax_loss(y, t):
    return jnp.mean((y - t) ** 2)


def _jax_toy(pp, params, mbs, targets):
    def run(params, mbs, targets):
        local = jax.tree_util.tree_map(lambda a: a[0], params)
        loss, losses, grads = jsched.forward_backward_zero_bubble(
            _jax_stage, _jax_loss, local, mbs, targets)
        return (loss[None], losses[None],
                jax.tree_util.tree_map(lambda g: g[None], grads))

    spec = jax.tree_util.tree_map(lambda _: P("pp"), params)
    f = shard_map(run, mesh=_mesh(pp), in_specs=(spec, P(), P()),
                  out_specs=ALL, check_vma=False)
    return jax.tree_util.tree_map(np.asarray, jax.jit(f)(params, mbs,
                                                         targets))


def _toy_cases(rs):
    cases, refs = [], {}
    for pp, M in TOY:
        params = dict(w=(0.5 * rs.randn(pp, H, H)).astype(np.float32),
                      b=rs.randn(pp, H).astype(np.float32))
        mbs = rs.randn(M, MB, H).astype(np.float32)
        targets = rs.randn(M, MB, H).astype(np.float32)
        name = f"toy P{pp} M{M}"
        cases.append(dict(name=name, kind="toy", pp=pp,
                          params=[{k: v[p] for k, v in params.items()}
                                  for p in range(pp)],
                          microbatches=mbs, targets=targets))
        refs[name] = _jax_toy(pp, params, mbs, targets)
    return cases, refs


def _np_tree(tree):
    return {part: {k: np.asarray(v) for k, v in named.items()}
            for part, named in tree.items()}


def _init(parts, tokens_mb, seed=0):
    """``run_gpt``'s init inside ``shard_map``: stage r from
    ``fold_in(r)`` of the stage key."""
    key = jax.random.PRNGKey(seed)
    pre = parts.embed.init(key, tokens_mb)["params"]
    h0 = parts.pre_fn(pre, tokens_mb)
    stage_key = jax.random.fold_in(key, 7)
    stages = parts.chunk.init(
        jax.random.fold_in(stage_key, jax.lax.axis_index("pp")),
        h0)["params"]
    return {"pre": pre, "stages": stages,
            "post": parts.init_post(jax.random.fold_in(key, 9))}


def _jax_gpt(name, tokens, labels):
    c = GPT_CASES[name]
    mesh = jps.initialize_model_parallel(
        tensor_model_parallel_size=c["tp"],
        pipeline_model_parallel_size=c["pp"], devices=jax.devices()[:WORLD])
    try:
        cfg = JaxConfig(compute_dtype=jnp.float32, sequence_parallel=c["sp"],
                        **CONFIG)
        parts = jbuild(cfg, c["pp"])

        def run(tokens, labels):
            params = _init(parts, tokens[0])
            out = jsched.forward_backward_zero_bubble_with_pre_post(
                parts.pre_fn, parts.stage_fn, parts.post_loss_fn, params,
                tokens, labels, axis_name="pp")
            return params, jax.tree_util.tree_map(lambda a: a[None], out)

        f = shard_map(run, mesh=mesh, in_specs=(P(), P()),
                      out_specs=(P(), ALL), check_vma=False)
        params, (loss, losses, grads) = jax.jit(f)(tokens, labels)
        by_rank = [_np_tree(gpt_pipeline_params_from_jax(params, r))
                   for r in range(WORLD)]
        grads = jax.tree_util.tree_map(np.asarray, grads)
    finally:
        jps.destroy_model_parallel()
    return by_rank, (np.asarray(loss), np.asarray(losses), grads)


@pytest.fixture(scope="module")
def both():
    """(JAX references by case, the port's results by rank, the card
    runners' results by rank, the zero-bubble training run's summary)."""
    rs = np.random.RandomState(0)
    cases, refs = _toy_cases(rs)
    tokens = rs.randint(0, VOCAB, (NUM_MICRO, GMB, SEQ)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=2)
    for name, c in GPT_CASES.items():
        by_rank, refs[name] = _jax_gpt(name, tokens, labels)
        cases.append(dict(name=name, kind="pre_post", tp=c["tp"],
                          pp=c["pp"], params=by_rank, tokens=tokens,
                          labels=labels,
                          config=dict(CONFIG, sequence_parallel=c["sp"])))
    ports = spawn(jobs_worker, WORLD, args=([
        ("zero_bubble_worker", (cases,)),
        ("zero_bubble_vs_1f1b_worker", (TRAIN_ARGV, "cpu"))],),
        timeout=240.0)
    run = spawn(interleaved_worker, WORLD, args=(TRAIN_ARGV, "cpu", True),
                timeout=240.0)[0]
    return refs, [p[0] for p in ports], [p[1] for p in ports], run


def _rel(got, want):
    return float(np.linalg.norm(np.asarray(got) - want)
                 / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("pp,M", TOY, ids=[f"P{p}_M{m}" for p, m in TOY])
def test_toy_zero_bubble_matches_jax(both, pp, M):
    refs, ports, _, _ = both
    name = f"toy P{pp} M{M}"
    loss, losses, grads = refs[name]
    for r in range(WORLD):
        got = ports[r][name]["zb"]
        np.testing.assert_allclose(got["loss"], loss[r], rtol=1e-5)
        np.testing.assert_allclose(got["losses"], losses[r], rtol=1e-5)
        for k in ("w", "b"):
            assert got["grads"][k].shape == grads[k][r].shape
            assert _rel(got["grads"][k], grads[k][r]) < 1e-4, (r, k)
        assert all(got["fields_untouched"])


@pytest.mark.parametrize("pp,M", TOY, ids=[f"P{p}_M{m}" for p, m in TOY])
def test_toy_zero_bubble_equals_the_ports_1f1b(both, pp, M):
    _, ports, _, _ = both
    name = f"toy P{pp} M{M}"
    for r in range(WORLD):
        zb, ref = ports[r][name]["zb"], ports[r][name]["1f1b"]
        np.testing.assert_allclose(zb["loss"], ref["loss"], rtol=1e-5)
        np.testing.assert_allclose(zb["losses"], ref["losses"], rtol=1e-5)
        for k in ("w", "b"):
            assert _rel(zb["grads"][k], ref["grads"][k]) < 1e-4, (r, k)


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-5,
                               err_msg=what)


@pytest.mark.parametrize("name", list(GPT_CASES))
def test_pre_post_zero_bubble_matches_jax(both, name):
    refs, ports, _, _ = both
    loss, losses, grads = refs[name]
    for r in range(WORLD):
        got = ports[r][name]["zb"]
        _close(got["loss"], loss[r], f"{name} rank {r} loss")
        assert got["losses"].shape == (NUM_MICRO,)
        _close(got["losses"], losses[r], f"{name} rank {r} losses")
        for part in ("pre", "stages", "post"):
            want = {k: v.numpy() for k, v in gpt_params_from_jax(
                jax.tree_util.tree_map(lambda a, r=r: a[r],
                                       grads[part])).items()}
            assert set(got["grads"][part]) == set(want), part
            for k, w in want.items():
                _close(got["grads"][part][k], w, f"{name} {r} {part} {k}")


@pytest.mark.parametrize("name", list(GPT_CASES))
def test_pre_post_zero_bubble_equals_the_ports_1f1b(both, name):
    _, ports, _, _ = both
    for r in range(WORLD):
        zb, ref = ports[r][name]["zb"], ports[r][name]["1f1b"]
        _close(zb["loss"], ref["loss"], f"{name} rank {r} loss")
        _close(zb["losses"], ref["losses"], f"{name} rank {r} losses")
        for part in ("pre", "stages", "post"):
            for k, w in ref["grads"][part].items():
                _close(zb["grads"][part][k], w, f"{name} {r} {part} {k}")
        assert np.abs(zb["grads"]["post"]["head"]).sum() > 0


def test_card_phase_runners_run_on_the_cpu(both):
    _, _, versus, run = both
    assert run["schedule"] == "zero_bubble"
    assert (run["tp"], run["pp"], run["dp"], run["sequence_parallel"]) == \
        (2, 2, 1, True)
    assert len(run["losses"]) == 2 and np.isfinite(run["losses"]).all()
    for r in range(WORLD):
        out = versus[r]
        np.testing.assert_allclose(out["zero_bubble"], out["1f1b"],
                                   rtol=1e-5)
        assert len(out["grad_rel_worst"]) == 2
        assert all(rel < 1e-4 for _, rel in out["grad_rel_worst"])
