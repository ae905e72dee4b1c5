"""apex_tpu_torch's activation recompute against the JAX package's.

Same seeded numpy inputs through JAX on the CPU and through the port.
Checked:

- ``parallel.random.checkpoint`` (and its ``dots_saveable`` policy)
  against ``jax.checkpoint``: values rtol 1e-6, each gradient 1e-5
  relative in norm (fp32, the same products summed in another order),
  and bit-equal to no checkpoint;
- ``checkpoint_distributed`` on gloo worlds of 2 and 4 tp ranks against
  JAX's under ``shard_map`` (``tests/test_tensor_parallel.py``'s
  pattern): the same bounds, and JAX's refusal of a leading dim that does
  not divide;
- a tiny GPT (2 layers, hidden 32, fp32) at ``recompute_granularity``
  None, "selective" and "full" against JAX's at the same granularity:
  the loss rtol 1e-5, every gradient 1e-4 relative in norm; and the
  port's three bit-equal to each other;
- dropout 0.1: recompute's losses and gradients bit-equal to None's over
  two steps, and every generator's state after them equal, on one
  process and at tp = 2 with sequence parallelism (where the hidden
  dropout's tp fold happens on a first draw inside the region); with
  ``torch.utils.checkpoint`` bare in the layer they differ;
- ``memory_efficient`` on the functional LayerNorm and RMSNorm: bit-equal
  to the plain call, and against JAX's at 1e-5;
- the schedules at ``remat`` True and False and ``tick_block_remat`` 0,
  1, 2, 3 and 100 (1F1B, interleaved at V = 2, zero bubble; P = 2 and 4)
  on a world of 4 gloo ranks: every variant bit-equal to the others
  (fp32), and held to JAX's at the pipeline tests' bounds (losses 1e-5,
  gradients 1e-4 relative in norm); the pipelined GPT through
  ``chip_smoke.py``'s ``remat_worker`` at remat True and False,
  bit-equal: 1F1B and zero bubble at pp = 2 x tp = 2 with SP, the
  interleaved schedule at pp = 4 x V = 2.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from apex_tpu.compat import shard_map
from apex_tpu.models import GPTModel as JaxGPT
from apex_tpu.ops.layer_norm import layer_norm as jax_layer_norm
from apex_tpu.ops.layer_norm import rms_norm as jax_rms_norm
from apex_tpu.parallel import parallel_state as jps
from apex_tpu.parallel.pipeline import schedules as jsched
from apex_tpu.parallel.random import checkpoint as jax_checkpoint
from apex_tpu.parallel.random import (
    checkpoint_distributed as jax_checkpoint_distributed,
)
from apex_tpu.transformer import TransformerConfig as JaxConfig
from apex_tpu_torch.models import GPTModel, gpt_params_from_jax
from apex_tpu_torch.models.gpt import gpt_loss_fn
from apex_tpu_torch.ops.layer_norm import layer_norm, rms_norm
from apex_tpu_torch.parallel.random import checkpoint
from apex_tpu_torch.transformer import TransformerConfig
from apex_tpu_torch.transformer import layer as torch_layer
from apex_tpu_torch.transformer.layer import ShardAwareDropout
from apex_tpu_torch.transformer.testing.distributed_test_base import spawn
from apex_tpu_torch.transformer.testing.recompute_workers import jobs_worker

WORLD = 4
ALL = P(("dp", "pp", "cp", "tp"))
H, MB = 6, 2  # toy hidden size and micro-batch rows
GRANULARITIES = (None, "selective", "full")
VARIANTS = ((True, 0), (False, 0), (False, 1), (False, 2), (True, 3),
            (False, 100))
TOY = (("1f1b", 2, 1, 4), ("1f1b", 4, 1, 3), ("zero_bubble", 2, 1, 3),
       ("zero_bubble", 4, 1, 4), ("interleaved", 2, 2, 4),
       ("interleaved", 4, 2, 4))
TOY_NAMES = [f"{k} P{p} V{v} M{m}" for k, p, v, m in TOY]
GPT = dict(num_layers=2, hidden_size=32, num_attention_heads=4,
           vocab_size=64, max_position_embeddings=16)
# standalone_gpt at a tiny size, fp32: pp 2 x tp 2 with SP
PIPELINE_ARGV = (
    "--num-layers 4 --hidden-size 32 --num-attention-heads 4 --seq-length 16 "
    "--max-position-embeddings 16 --make-vocab-size-divisible-by 64 "
    "--micro-batch-size 2 --global-batch-size 8 --seed 0 "
    "--pipeline-model-parallel-size 2 --tensor-model-parallel-size 2 "
    "--sequence-parallel --train-iters 2").split()
# the interleaved schedule at pp 4 (the arguments want pp > 2) x V 2
INTERLEAVED_ARGV = (
    "--num-layers 8 --hidden-size 32 --num-attention-heads 4 --seq-length 16 "
    "--max-position-embeddings 16 --make-vocab-size-divisible-by 64 "
    "--micro-batch-size 2 --global-batch-size 8 --seed 0 "
    "--pipeline-model-parallel-size 4 "
    "--num-layers-per-virtual-pipeline-stage 1 --train-iters 2").split()
PIPELINE_RUNS = {
    "1f1b": (PIPELINE_ARGV, False),
    "interleaved": (INTERLEAVED_ARGV, False),
    "zero_bubble": (PIPELINE_ARGV, True)}


def _rel(got, want):
    return float(np.linalg.norm(np.asarray(got) - want)
                 / max(np.linalg.norm(want), 1e-30))


# -- checkpoint ----------------------------------------------------------------

def _fn(x, w1, w2, lib):
    return lib.sum(lib.tanh(lib.tanh(x @ w1) @ w2) ** 2)


@pytest.mark.parametrize("policy", [None, "dots_saveable"])
def test_checkpoint_value_and_gradients_match_jax(policy):
    rs = np.random.RandomState(0)
    x = rs.randn(8, 16).astype(np.float32)
    w1 = (0.3 * rs.randn(16, 16)).astype(np.float32)
    w2 = (0.3 * rs.randn(16, 8)).astype(np.float32)
    jpol = None if policy is None else jax.checkpoint_policies.dots_saveable
    jf = jax_checkpoint(functools.partial(_fn, lib=jnp), policy=jpol)
    val, grads = jax.value_and_grad(jf, argnums=(0, 1, 2))(x, w1, w2)
    ts = [torch.tensor(a, requires_grad=True) for a in (x, w1, w2)]
    out = checkpoint(functools.partial(_fn, lib=torch), policy=policy)(*ts)
    got = torch.autograd.grad(out, ts)
    np.testing.assert_allclose(float(out.detach()), float(val), rtol=1e-6)
    for g, w in zip(got, grads):
        assert _rel(g.numpy(), np.asarray(w)) < 1e-5
    # the same values as no checkpoint at all, bit for bit
    plain = torch.autograd.grad(_fn(*ts, lib=torch), ts)
    assert all(torch.equal(a, b) for a, b in zip(got, plain))


def test_checkpoint_refuses_an_unknown_policy():
    with pytest.raises(ValueError, match="policy"):
        checkpoint(torch.sin, policy="everything")(torch.ones(2,
                                                              requires_grad=True))


def _jax_checkpoint_distributed(tp, cases):
    mesh = jps.initialize_model_parallel(tensor_model_parallel_size=tp,
                                         devices=jax.devices()[:tp])
    try:
        def fn(x, w):
            return jnp.sum(jnp.tanh(x @ w) ** 2)

        @jax.jit
        @functools.partial(shard_map, mesh=mesh, in_specs=(P(), P()),
                           out_specs=(P(), (P(), P())), check_vma=False)
        def run(x, w):
            return jax.value_and_grad(
                lambda x_, w_: jax_checkpoint_distributed(fn)(x_, w_),
                argnums=(0, 1))(x, w)

        out = [jax.tree_util.tree_map(np.asarray, run(x, w))
               for x, w in cases]
        with pytest.raises(Exception) as err:
            run(np.zeros((tp + 1, 4), np.float32),
                np.zeros((4, 4), np.float32))
    finally:
        jps.destroy_model_parallel()
    return out, str(err.value)


def _distributed_cases(rs):
    return [((rs.randn(8, 16)).astype(np.float32),
             (0.3 * rs.randn(16, 16)).astype(np.float32)) for _ in range(2)]


@pytest.fixture(scope="module")
def tp2_world():
    cases = _distributed_cases(np.random.RandomState(1))
    ref = _jax_checkpoint_distributed(2, cases)
    ports = spawn(jobs_worker, 2, args=([
        ("checkpoint_distributed_worker", (cases,))],), timeout=180.0)
    return ref, [p[0] for p in ports]


def _jax_toy(kind, pp, V, params, mbs, targets):
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]).reshape(
        WORLD // pp, pp, 1, 1), jps.AXIS_ORDER)

    def stage(p, x):
        return jnp.tanh(x @ p["w"] + p["b"])

    def loss_fn(y, t):
        return jnp.mean((y - t) ** 2)

    def run(params, mbs, targets):
        local = jax.tree_util.tree_map(lambda a: a[0], params)
        if kind == "zero_bubble":
            out = jsched.forward_backward_zero_bubble(stage, loss_fn, local,
                                                      mbs, targets)
        else:
            fn = jsched.get_forward_backward_func(
                V if kind == "interleaved" else None, pp)
            out = fn(stage, loss_fn, local, mbs, targets)
        loss, losses, grads = out
        return (loss[None], losses[None],
                jax.tree_util.tree_map(lambda g: g[None], grads))

    spec = jax.tree_util.tree_map(lambda _: P("pp"), params)
    f = shard_map(run, mesh=mesh, in_specs=(spec, P(), P()),
                  out_specs=ALL, check_vma=False)
    return jax.tree_util.tree_map(np.asarray, jax.jit(f)(params, mbs,
                                                         targets))


@pytest.fixture(scope="module")
def world():
    """(JAX toy references by name, the port's results by rank and job,
    the cp checkpoint_distributed JAX reference)."""
    rs = np.random.RandomState(0)
    cases, refs = [], {}
    for (kind, pp, V, M), name in zip(TOY, TOY_NAMES):
        lead = (pp,) if V == 1 else (pp, V)
        params = dict(w=(0.5 * rs.randn(*lead, H, H)).astype(np.float32),
                      b=rs.randn(*lead, H).astype(np.float32))
        mbs = rs.randn(M, MB, H).astype(np.float32)
        targets = rs.randn(M, MB, H).astype(np.float32)
        refs[name] = _jax_toy(kind, pp, V, params, mbs, targets)
        cases.append(dict(name=name, schedule=kind, pp=pp, chunks=V,
                          params=[{k: v[p] for k, v in params.items()}
                                  for p in range(pp)],
                          microbatches=mbs, targets=targets))
    dist_cases = _distributed_cases(np.random.RandomState(2))
    dist_ref = _jax_checkpoint_distributed(WORLD, dist_cases)
    jobs = [("remat_toy_worker", (cases, VARIANTS)),
            ("checkpoint_distributed_worker", (dist_cases,)),
            ("sp_dropout_recompute_worker", (GRANULARITIES,))]
    jobs += [("remat_worker", (argv, "cpu", zb))
             for argv, zb in PIPELINE_RUNS.values()]
    ports = spawn(jobs_worker, WORLD, args=(jobs,), timeout=300.0)
    return refs, ports, dist_ref


@pytest.mark.parametrize("world_size", [2, 4])
def test_checkpoint_distributed_matches_jax(tp2_world, world, world_size):
    (ref, message), ranks = (tp2_world if world_size == 2
                             else (world[2], [p[1] for p in world[1]]))
    for r, got in enumerate(ranks):
        for (val, (gx, gw)), case in zip(ref, got["cases"]):
            np.testing.assert_allclose(case["value"], val, rtol=1e-6)
            assert _rel(case["gx"], gx) < 1e-5, r
            assert _rel(case["gw"], gw) < 1e-5, r
        assert "not divisible" in got["refusal"], got["refusal"]
        assert "not divisible" in message


# -- the layer's recompute -----------------------------------------------------

def _tokens(seed=0):
    rs = np.random.RandomState(seed)
    return rs.randint(0, GPT["vocab_size"], (2, 16)).astype(np.int32)


def _jax_loss_and_grads(granularity, tokens):
    cfg = JaxConfig(compute_dtype=jnp.float32, hidden_dropout=0.0,
                    attention_dropout=0.0, recompute_granularity=granularity,
                    **GPT)
    model = JaxGPT(config=cfg)
    params = model.init(jax.random.PRNGKey(0), tokens)["params"]
    labels = np.roll(tokens, -1, axis=1)

    def loss_fn(p):
        logits = model.apply({"params": p}, tokens).astype(jnp.float32)
        logp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, labels[..., None], -1))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return (jax.tree_util.tree_map(np.asarray, params), float(loss),
            jax.tree_util.tree_map(np.asarray, grads))


def _port_loss_and_grads(granularity, params, tokens, **extra):
    cfg = TransformerConfig(compute_dtype=torch.float32,
                            recompute_granularity=granularity,
                            **dict(dict(hidden_dropout=0.0,
                                        attention_dropout=0.0), **extra),
                            **GPT)
    model = GPTModel(cfg, device="cpu")
    if params is not None:
        model.load_state_dict(gpt_params_from_jax(params), strict=True)
    toks = torch.from_numpy(tokens).long()
    loss = gpt_loss_fn(model(toks, labels=torch.roll(toks, -1, 1)))
    loss.backward()
    return float(loss.detach()), {n: p.grad.numpy() for n, p in
                         model.named_parameters()}


@pytest.mark.parametrize("granularity", GRANULARITIES)
def test_gpt_recompute_matches_jax(granularity):
    tokens = _tokens()
    params, jloss, jgrads = _jax_loss_and_grads(granularity, tokens)
    loss, grads = _port_loss_and_grads(granularity, params, tokens)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    want = {k: v.numpy() for k, v in gpt_params_from_jax(jgrads).items()}
    assert set(grads) == set(want)
    for n, w in want.items():
        assert _rel(grads[n], w) < 1e-4, n
    # the port's granularities agree bit for bit
    loss0, grads0 = _port_loss_and_grads(None, params, tokens)
    assert loss == loss0
    assert all(np.array_equal(grads[n], grads0[n]) for n in grads)


def _dropout_run(granularity, steps=2):
    """Two SGD steps of a tiny GPT with dropout 0.1 at ``granularity``:
    the losses, each step's gradients and the dropout generators' states
    after the last step."""
    cfg = TransformerConfig(compute_dtype=torch.float32, hidden_dropout=0.1,
                            attention_dropout=0.1,
                            recompute_granularity=granularity, **GPT)
    model = GPTModel(cfg, device="cpu", seed=0).train()
    toks = torch.from_numpy(_tokens(3)).long()
    losses, grads = [], []
    for _ in range(steps):
        for p in model.parameters():
            p.grad = None
        loss = gpt_loss_fn(model(toks, labels=torch.roll(toks, -1, 1)))
        loss.backward()
        losses.append(float(loss.detach()))
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
        with torch.no_grad():
            for p in model.parameters():
                p.sub_(0.1 * p.grad)
    states = [m.generator.get_state() for m in model.modules()
              if isinstance(m, ShardAwareDropout)]
    return losses, grads, states


def _same(a, b):
    la, ga, sa = a
    lb, gb, sb = b
    return (la == lb and all(torch.equal(x[n], y[n])
                             for x, y in zip(ga, gb) for n in x)
            and all(torch.equal(x, y) for x, y in zip(sa, sb)))


@pytest.mark.parametrize("granularity", ["selective", "full"])
def test_dropout_recompute_replays_the_masks(granularity):
    assert _same(_dropout_run(granularity), _dropout_run(None))


def test_bare_torch_checkpoint_draws_other_masks(monkeypatch):
    """The check above can fail: a bare ``torch.utils.checkpoint`` in the
    layer neither replays the dropout generators nor leaves them where
    the forward did."""
    import torch.utils.checkpoint as tuc

    ref = _dropout_run(None)
    monkeypatch.setattr(torch_layer, "checkpoint", lambda f: functools.partial(
        tuc.checkpoint, f, use_reentrant=False))
    for granularity in ("selective", "full"):
        losses, grads, states = _dropout_run(granularity)
        assert not _same((losses, grads, states), ref)
        assert not all(torch.equal(x, y) for x, y in zip(states, ref[2]))


def test_dropout_recompute_under_sp_folds_the_same(world):
    _, ports, _ = world
    for r, jobs in enumerate(ports):
        out = jobs[2]
        ref = out[None]
        for g in ("selective", "full"):
            assert out[g]["losses"] == ref["losses"], (r, g)
            for got, want in zip(out[g]["grads"], ref["grads"]):
                for n, w in want.items():
                    assert np.array_equal(got[n], w), (r, g, n)
            for got, want in zip(out[g]["states"], ref["states"]):
                assert all(np.array_equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("norm", ["layer_norm", "rms_norm"])
def test_memory_efficient_norms(norm):
    rs = np.random.RandomState(4)
    x = rs.randn(6, 40).astype(np.float32)
    w = (1 + 0.1 * rs.randn(40)).astype(np.float32)
    b = (0.1 * rs.randn(40)).astype(np.float32)
    dy = rs.randn(6, 40).astype(np.float32)
    if norm == "layer_norm":
        args, jfn, tfn = (x, w, b), jax_layer_norm, layer_norm
    else:
        args, jfn, tfn = (x, w), jax_rms_norm, rms_norm
    jy, vjp = jax.vjp(lambda *a: jfn(*a, memory_efficient=True), *args)
    jgrads = vjp(dy)
    outs = []
    for me in (True, False):
        ts = [torch.tensor(a, requires_grad=True) for a in args]
        y = tfn(*ts, memory_efficient=me)
        outs.append((y.detach(), torch.autograd.grad(y, ts,
                                                      torch.tensor(dy))))
    (y, grads), (y0, grads0) = outs
    assert torch.equal(y, y0)
    assert all(torch.equal(a, c) for a, c in zip(grads, grads0))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5,
                                   atol=1e-5)


# -- the schedules ---------------------------------------------------------------

@pytest.mark.parametrize("name", TOY_NAMES)
def test_schedule_remat_variants_bit_equal_and_match_jax(world, name):
    refs, ports, _ = world
    loss, losses, grads = refs[name]
    for r, jobs in enumerate(ports):
        out = jobs[0]
        base = out[(name, True, 0)]
        np.testing.assert_allclose(base["loss"], loss[r], rtol=1e-5)
        np.testing.assert_allclose(base["losses"], losses[r], rtol=1e-5)
        for k in ("w", "b"):
            assert _rel(base["grads"][k], grads[k][r]) < 1e-4, (r, k)
        for remat, block in VARIANTS:
            got = out[(name, remat, block)]
            assert got["loss"] == base["loss"], (r, remat, block)
            assert np.array_equal(got["losses"], base["losses"])
            for k in ("w", "b"):
                assert np.array_equal(got["grads"][k], base["grads"][k]), (
                    r, remat, block, k)


def test_schedules_refuse_a_negative_tick_block():
    from apex_tpu_torch.parallel.pipeline import schedules as sched

    p = {"w": torch.ones(2, 2, requires_grad=True)}
    with pytest.raises(ValueError, match="tick_block_remat"):
        sched.forward_backward_pipelining_without_interleaving(
            lambda q, x: x @ q["w"], lambda y, t: (y - t).pow(2).mean(), p,
            torch.ones(1, 2, 2), torch.ones(1, 2, 2), tick_block_remat=-1)


@pytest.mark.parametrize("schedule", list(PIPELINE_RUNS))
def test_pipelined_gpt_remat_bit_equal(world, schedule):
    _, ports, _ = world
    index = 3 + list(PIPELINE_RUNS).index(schedule)
    for r, jobs in enumerate(ports):
        out = jobs[index]
        assert out["bit_equal"], (r, out["max_abs_diff"])
        assert out["remat_True"]["losses"] == out["remat_False"]["losses"]
        assert len(out["remat_True"]["losses"]) == 2
        assert np.isfinite(out["remat_True"]["losses"]).all()


def test_tensor_parallel_surface_has_the_jax_names():
    import apex_tpu.transformer.tensor_parallel as jtp
    import apex_tpu_torch.transformer.tensor_parallel as ttp

    assert sorted(ttp.__all__) == sorted(jtp.__all__)
    for name in ttp.__all__:
        assert callable(getattr(ttp, name)), name
    assert ttp.checkpoint is checkpoint
    g = ttp.model_parallel_rng_key(5)
    assert torch.equal(g.get_state(), torch.Generator().manual_seed(
        ttp.model_parallel_seed(5, 0)).get_state())
