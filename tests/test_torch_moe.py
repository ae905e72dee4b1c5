"""apex_tpu_torch's MoE (``transformer.moe``) against the JAX package's.

Same seeded numpy inputs and JAX's weights (``models.convert``) through
JAX on the CPU and through the port, fp32 (JAX's CPU backend refuses a
bf16 x bf16 -> fp32 product, so the bf16 path is held to the port's fp32
one only). Checked:

- dispatch positions and capacity: equal to JAX's;
- the router (probabilities, gates, the top-k experts, ties to the lower
  index as ``jax.lax.top_k``) and the load-balancing loss: rtol 1e-6;
- ``MoEMLP`` top-1 and top-2 against JAX (output rtol 1e-5, atol 1e-6;
  aux rtol 1e-6) and against the naive loop of ``tests/test_moe.py``
  (its bound, rtol 2e-4, atol 2e-5);
- the gradients of ``sum(out^2) + 0.01 aux`` to x, the router and the
  experts against JAX: 1e-5 relative in norm;
- expert parallelism on a world of 4 gloo ranks (experts over dp) against
  JAX's ``expert_axis="dp"`` under ``shard_map``: outputs and aux as
  above, every rank's gradients 1e-5 relative in norm; and
  ``chip_smoke.py``'s ``moe_gpt_ep_worker`` at a tiny size (ep = 4
  against ep = 1 on each rank's tokens);
- a layer with MoE and ``total_moe_aux_loss`` against JAX's sown loss;
- a tiny MoE GPT (2 layers, 4 experts, top-2) against JAX's: the loss
  plus the aux loss rtol 1e-5, every gradient 1e-4 relative in norm;
  ``moe_params_from_jax`` cuts a full tree to a rank's experts;
- a MoE layer at tensor-parallel size 2, with and without sequence
  parallelism, on a world of 2 gloo ranks against JAX's layer under
  ``shard_map`` (weights carried with ``gpt_tp_params_from_jax``):
  output and dx 1e-5, aux 1e-6, every gradient 1e-4 relative in norm.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from apex_tpu.compat import shard_map
from apex_tpu.models import GPTModel as JaxGPT
from apex_tpu.parallel import parallel_state as jps
from apex_tpu.transformer import ParallelTransformerLayer as JaxLayer
from apex_tpu.transformer import TransformerConfig as JaxConfig
from apex_tpu.transformer import moe as jmoe
from apex_tpu_torch.models import (
    GPTModel,
    gpt_params_from_jax,
    moe_params_from_jax,
)
from apex_tpu_torch.models.gpt import gpt_loss_fn
from apex_tpu_torch.transformer import ParallelTransformerLayer
from apex_tpu_torch.transformer import TransformerConfig
from apex_tpu_torch.transformer import moe
from apex_tpu_torch.transformer.testing.distributed_test_base import spawn
from apex_tpu_torch.transformer.testing.recompute_workers import jobs_worker

H, FFN, TOK = 16, 32, 64
WORLD = 4
BASE = dict(num_layers=1, hidden_size=H, num_attention_heads=4,
            vocab_size=32, max_position_embeddings=8, ffn_hidden_size=FFN,
            hidden_dropout=0.0, attention_dropout=0.0)
GPT = dict(num_layers=2, hidden_size=16, num_attention_heads=4,
           vocab_size=32, max_position_embeddings=8, hidden_dropout=0.0,
           attention_dropout=0.0, num_moe_experts=4, moe_top_k=2)


def _rel(got, want):
    return float(np.linalg.norm(np.asarray(got) - want)
                 / max(np.linalg.norm(want), 1e-30))


def _x(seed=0, shape=(TOK, H)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _jax_moe(e, top_k, cf=1.25, axis=None):
    return jmoe.MoEMLP(config=JaxConfig(compute_dtype=jnp.float32, **BASE),
                       num_experts=e, top_k=top_k, capacity_factor=cf,
                       expert_axis=axis)


def _port_moe(params, e, top_k, cf=1.25, dtype=torch.float32):
    mod = moe.MoEMLP(TransformerConfig(compute_dtype=dtype, **BASE),
                     num_experts=e, top_k=top_k, capacity_factor=cf,
                     expert_axis=None, device="cpu")
    mod.load_state_dict(moe_params_from_jax(params, e), strict=True)
    return mod


def naive_moe(params, x, num_experts, top_k, capacity):
    """The loop of tests/test_moe.py: route, drop past capacity per
    expert, weight by the gate."""
    gate_w, w_in, w_out = (np.asarray(params[k], np.float32)
                           for k in ("router", "w_in", "w_out"))
    logits = x @ gate_w
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    order = np.argsort(-probs, axis=-1, kind="stable")
    out = np.zeros_like(x)
    for k in range(top_k):
        counts = {e: 0 for e in range(num_experts)}
        for t in range(x.shape[0]):
            e = int(order[t, k])
            if counts[e] >= capacity:
                continue
            counts[e] += 1
            hdn = np.asarray(jax.nn.gelu(jnp.asarray(x[t] @ w_in[e])))
            out[t] += probs[t, e] * (hdn @ w_out[e])
    return out


def test_dispatch_positions_and_capacity():
    idx = torch.tensor([0, 1, 0, 0, 1, 0])
    pos = moe._dispatch_indices(idx, num_experts=2, capacity=2)
    assert pos.tolist() == [0, 0, 1, -1, 1, -1]
    rs = np.random.RandomState(1)
    for e, cap in ((4, 3), (8, 1), (3, 40)):
        idx = rs.randint(0, e, 100)
        want = np.asarray(jmoe._dispatch_indices(jnp.asarray(idx), e, cap))
        got = moe._dispatch_indices(torch.from_numpy(idx), e, cap)
        np.testing.assert_array_equal(got.numpy(), want)


def test_router_and_aux_match_jax():
    rs = np.random.RandomState(2)
    logits = rs.randn(TOK, 8).astype(np.float32)
    # ties: equal logits in a row pick the lower experts first
    logits[:4] = 0.5
    logits[4, [1, 6]] = 9.0
    for k in (1, 2):
        jp, jg, ji = jmoe.router_probs(jnp.asarray(logits), 8, k)
        tp, tg, ti = moe.router_probs(torch.from_numpy(logits), 8, k)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6)
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        aux = moe.load_balancing_loss(tp, ti, 8)
        jaux = jmoe.load_balancing_loss(jp, ji, 8)
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    assert ti[:4, 0].tolist() == [0, 0, 0, 0] and ti[4].tolist() == [1, 6]


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_mlp_matches_jax_and_the_naive_loop(top_k):
    e, x = 4, _x(3)
    jm = _jax_moe(e, top_k, cf=1.0)
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    jout, jaux = jm.apply({"params": params}, jnp.asarray(x))
    mod = _port_moe(params, e, top_k, cf=1.0)
    out, aux = mod(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-6)
    want = naive_moe(params, x, e, top_k, max(1, int(TOK / e)))
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=2e-4,
                               atol=2e-5)
    # the module keeps its last aux loss and the share it dropped
    assert mod.aux_loss is aux and 0.0 < float(mod.dropped_share) < 1.0


def test_moe_mlp_bf16_tracks_fp32():
    e, x = 4, _x(4)
    jm = _jax_moe(e, 2)
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(2), jnp.asarray(x))["params"])
    ref, _ = _port_moe(params, e, 2)(torch.from_numpy(x))
    out, _ = _port_moe(params, e, 2, dtype=torch.bfloat16)(
        torch.from_numpy(x).bfloat16())
    assert out.dtype == torch.bfloat16
    # a bf16 input and bf16 products: a few bf16 ulps of the output
    assert _rel(out.float().detach().numpy(), ref.detach().numpy()) < 2e-2


def _loss(out, aux, lib):
    return lib.sum(out ** 2) + 0.01 * aux


@pytest.mark.parametrize("top_k", [1, 2])
def test_gradients_to_router_and_experts_match_jax(top_k):
    e, x = 4, _x(5)
    jm = _jax_moe(e, top_k)
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(3), jnp.asarray(x))["params"])

    def jloss(p, xx):
        return _loss(*jm.apply({"params": p}, xx), jnp)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    mod = _port_moe(params, e, top_k)
    xt = torch.tensor(x, requires_grad=True)
    _loss(*mod(xt), torch).backward()
    assert _rel(xt.grad.numpy(), np.asarray(jgx)) < 1e-5
    for name in ("router", "w_in", "w_out"):
        g = getattr(mod, name).grad.numpy()
        assert np.abs(g).sum() > 0, name
        assert _rel(g, np.asarray(jgp[name])) < 1e-5, name


def _jax_ep(params, x, e, top_k):
    mesh = jps.initialize_model_parallel(devices=jax.devices()[:WORLD])
    try:
        mod = _jax_moe(e, top_k, axis="dp")
        spec = {"router": P(), "w_in": P("dp"), "w_out": P("dp")}

        @jax.jit
        @functools.partial(shard_map, mesh=mesh, in_specs=(spec, P()),
                           out_specs=(P(), P(), P("dp"), P("dp")),
                           check_vma=False)
        def run(p, xx):
            (out, aux) = mod.apply({"params": p}, xx)
            gp, gx = jax.grad(lambda p_, x_: _loss(
                *mod.apply({"params": p_}, x_), jnp), argnums=(0, 1))(p, xx)
            return out, aux, gp, gx[None]

        out, aux, gp, gx = jax.tree_util.tree_map(np.asarray, run(params, x))
    finally:
        jps.destroy_model_parallel()
    return out, aux, gp, gx


@pytest.fixture(scope="module")
def ep_world():
    e, top_k, x = 8, 2, _x(6)
    local = _jax_moe(e, top_k)
    params = jax.tree_util.tree_map(np.asarray, local.init(
        jax.random.PRNGKey(4), jnp.asarray(x))["params"])
    ref = _jax_ep(params, x, e, top_k)
    gpt = dict(num_layers=2, hidden_size=16, num_attention_heads=4,
               vocab_size=32, max_position_embeddings=16,
               hidden_dropout=0.0, attention_dropout=0.0, num_moe_experts=8,
               moe_top_k=2, compute_dtype=torch.float32)
    ports = spawn(jobs_worker, WORLD, args=([
        ("moe_ep_worker", (params, x, e, top_k)),
        ("moe_gpt_ep_worker", (gpt, 2, 16, "cpu"))],), timeout=180.0)
    return ref, ports


def test_expert_parallel_matches_jax(ep_world):
    (out, aux, gp, gx), ports = ep_world
    local = 8 // WORLD
    for r, (got, _) in enumerate(ports):
        np.testing.assert_allclose(got["out"], out, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["aux"], float(aux), rtol=1e-6)
        assert _rel(got["gx"], gx[r]) < 1e-5, r
        assert _rel(got["grads"]["router"],
                    gp["router"].reshape(WORLD, H, 8)[r]) < 1e-5, r
        for n in ("w_in", "w_out"):
            want = gp[n][r * local:(r + 1) * local]
            assert _rel(got["grads"][n], want) < 1e-5, (r, n)


def test_expert_parallel_gpt_matches_all_experts(ep_world):
    _, ports = ep_world
    for r, (_, got) in enumerate(ports):
        np.testing.assert_allclose(got["loss_ep"], got["loss_one"],
                                   rtol=1e-6)
        np.testing.assert_allclose(got["aux_ep"], got["aux_one"], rtol=1e-6)
        assert got["hidden_rel"] < 1e-6, r
        assert got["grad_rel_worst"][1] < 1e-5, (r, got["grad_rel_worst"])
        # gloo takes CPU tensors as they are: nothing staged (the card's
        # run counts its all-to-alls there)
        assert got["staged_ep"]["collectives"] == 0


def test_layer_with_moe_and_total_aux_loss_match_jax():
    c = JaxConfig(compute_dtype=jnp.float32, num_moe_experts=4, **BASE)
    layer = JaxLayer(config=c)
    h = _x(7, (8, 2, H))
    variables = layer.init(jax.random.PRNGKey(5), jnp.asarray(h))
    out, inter = layer.apply(variables, jnp.asarray(h),
                             mutable=["intermediates"])
    total = jmoe.total_moe_aux_loss(inter, c)
    port = ParallelTransformerLayer(TransformerConfig(
        compute_dtype=torch.float32, num_moe_experts=4, **BASE),
        device="cpu")
    port.load_state_dict(gpt_params_from_jax(jax.tree_util.tree_map(
        np.asarray, variables["params"])), strict=True)
    got = port(torch.from_numpy(h))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(port.mlp.aux_loss.detach()),
                               float(inter["intermediates"]["moe_aux_loss"][0]),
                               rtol=1e-6)
    cfg = TransformerConfig(num_moe_experts=4, **BASE)
    np.testing.assert_allclose(
        float(moe.total_moe_aux_loss(port, cfg).detach()), float(total),
        rtol=1e-6)


def test_moe_gpt_loss_and_gradients_match_jax():
    tokens = np.random.RandomState(8).randint(0, 32, (2, 8)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    cfg = JaxConfig(compute_dtype=jnp.float32, **GPT)
    model = JaxGPT(config=cfg)
    params = jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(6), tokens)["params"])

    def jloss(p):
        logits, inter = model.apply({"params": p}, tokens,
                                    mutable=["intermediates"])
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        task = -jnp.mean(jnp.take_along_axis(logp, labels[..., None], -1))
        return task + jmoe.total_moe_aux_loss(inter, cfg)

    jl, jg = jax.value_and_grad(jloss)(params)
    tcfg = TransformerConfig(compute_dtype=torch.float32, **GPT)
    port = GPTModel(tcfg, device="cpu")
    port.load_state_dict(moe_params_from_jax(params, 4), strict=True)
    toks = torch.from_numpy(tokens).long()
    loss = gpt_loss_fn(port(toks, labels=torch.from_numpy(labels).long()))
    loss = loss + moe.total_moe_aux_loss(port, tcfg)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    want = gpt_params_from_jax(jax.tree_util.tree_map(np.asarray, jg))
    for n, p in port.named_parameters():
        assert _rel(p.grad.numpy(), want[n].numpy()) < 1e-4, n


def test_moe_params_cut_to_a_ranks_experts():
    full = {"transformer": {"layer_0": {"mlp": {
        "router": np.zeros((4, 8), np.float32),
        "w_in": np.arange(8 * 2 * 3, dtype=np.float32).reshape(8, 2, 3),
        "w_out": np.arange(8 * 3 * 2, dtype=np.float32).reshape(8, 3, 2)}}}}
    got = moe_params_from_jax(full, 8, rank=2, ep=4)
    np.testing.assert_array_equal(
        got["transformer.layer_0.mlp.w_in"].numpy(),
        full["transformer"]["layer_0"]["mlp"]["w_in"][4:6])
    assert got["transformer.layer_0.mlp.router"].shape == (4, 8)
    # a rank's own experts (a tree read per device) stay as they are
    mine = moe_params_from_jax({"mlp": {"w_in": np.zeros((2, 2, 3))}}, 8,
                               rank=1, ep=4)
    assert mine["mlp.w_in"].shape == (2, 2, 3)


# -- MoE at tensor-parallel size 2 ---------------------------------------------

MOE_TP = 2


def _moe_tp_case(sp):
    """A MoE layer (4 experts, top-2) at tp 2 on 2 devices of the CPU
    mesh, initialised inside ``shard_map`` (each device keeping its
    attention shards; the router and experts are not split over tp):
    JAX's output, aux loss and gradients of ``<out, ct> + 0.01 aux`` by
    device, and the port's case."""
    from apex_tpu_torch.models import gpt_tp_params_from_jax

    cfg = JaxConfig(compute_dtype=jnp.float32, num_moe_experts=4,
                    moe_top_k=2, sequence_parallel=sp, **BASE)
    layer = JaxLayer(config=cfg)
    s = 8 // MOE_TP if sp else 8
    x = np.stack([_x(11 + (r if sp else 0), (s, 2, H))
                  for r in range(MOE_TP)])
    ct = np.stack([_x(21 + (r if sp else 0), (s, 2, H))
                   for r in range(MOE_TP)])
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:MOE_TP]).reshape(
        1, 1, 1, MOE_TP), jps.AXIS_ORDER)
    every = P(("dp", "pp", "cp", "tp"))

    @jax.jit
    @functools.partial(shard_map, mesh=mesh, in_specs=(every,),
                       out_specs=P(), check_vma=False)
    def init(a):
        return layer.init(jax.random.PRNGKey(5), a[0])["params"]

    params = init(jnp.asarray(x))

    @jax.jit
    @functools.partial(shard_map, mesh=mesh, in_specs=(P(), every, every),
                       out_specs=(every,) * 4, check_vma=False)
    def run(p, a, c):
        def f(p, a):
            y, inter = layer.apply({"params": p}, a,
                                   mutable=["intermediates"])
            aux = jmoe.total_moe_aux_loss(inter, cfg)
            return jnp.sum(y * c[0]) + aux, (y, aux)

        (_, (y, aux)), (gp, gx) = jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True)(p, a[0])
        return y[None], (aux / cfg.moe_aux_loss_coeff)[None], gx[None], \
            jax.tree_util.tree_map(lambda t: t[None], gp)

    y, aux, gx, gp = run(params, jnp.asarray(x), jnp.asarray(ct))
    case = dict(config=dict(BASE, compute_dtype=torch.float32,
                            num_moe_experts=4, moe_top_k=2,
                            sequence_parallel=sp),
                params=[{k: v.numpy() for k, v in
                         gpt_tp_params_from_jax(params, r).items()}
                        for r in range(MOE_TP)], x=x, ct=ct)
    ref = dict(y=np.asarray(y), aux=np.asarray(aux), dx=np.asarray(gx),
               grads=[gpt_params_from_jax(jax.tree_util.tree_map(
                   lambda t: np.asarray(t)[r], gp)) for r in range(MOE_TP)])
    return case, ref


@pytest.fixture(scope="module")
def moe_tp():
    from apex_tpu_torch.transformer.testing.distributed_test_base import (
        jobs_worker,
    )

    jps.initialize_model_parallel(tensor_model_parallel_size=MOE_TP,
                                  devices=jax.devices()[:MOE_TP])
    try:
        pairs = {("sp" if sp else "tp"): _moe_tp_case(sp)
                 for sp in (False, True)}
    finally:
        jps.destroy_model_parallel()
    ports = spawn(jobs_worker, MOE_TP, args=([
        ("apex_tpu_torch.transformer.testing.tp_workers:moe_tp_worker",
         (MOE_TP, {k: c for k, (c, _) in pairs.items()}))],), timeout=180.0)
    return {k: r for k, (_, r) in pairs.items()}, [p[0] for p in ports]


@pytest.mark.parametrize("mode", ["tp", "sp"])
def test_moe_layer_at_tp2_matches_jax(moe_tp, mode):
    """The Queue 3 repair: MoE at tp = 2, with and without sequence
    parallelism, against JAX's layer under ``shard_map``: output and dx
    1e-5, the aux loss 1e-6 relative and every gradient 1e-4 relative in
    norm, on each rank. Without SP both ranks route the same tokens, so
    the expert gradients are equal; under SP each rank routes its own
    shard and keeps its own expert gradients (no tp sum), as JAX does."""
    refs, ports = moe_tp
    ref = refs[mode]
    for r in range(MOE_TP):
        got = ports[r][mode]
        np.testing.assert_allclose(got["y"], ref["y"][r], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got["dx"], ref["dx"][r], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got["aux"], float(ref["aux"][r]),
                                   rtol=1e-6)
        want = ref["grads"][r]
        assert set(got["grads"]) == set(want)
        for n, g in want.items():
            assert _rel(got["grads"][n], g.numpy()) < 1e-4, (mode, r, n)
    w_in = "mlp.w_in"
    same = np.array_equal(ports[0][mode]["grads"][w_in],
                          ports[1][mode]["grads"][w_in])
    assert same == (mode == "tp")
