"""apex_tpu_torch's tensor and sequence parallelism against the JAX package.

The port runs in one spawned world of 4 gloo ranks on the CPU (file-store
rendezvous, ``transformer.testing.distributed_test_base.spawn``); the JAX
functions run under ``shard_map`` on 4 devices of the 8-device CPU mesh
(``tests/conftest.py``) laid out as the port's ranks are: device r is
port rank r, tp innermost. Every input is made from a seeded numpy RNG,
per rank where the ranks' inputs differ, and passed to both. Checked:

- the seven regions of ``parallel.mappings``, forward and backward, at
  tp = 2 and 4: exact where only data moves, 1e-6 where a sum is taken;
- ``ColumnParallelLinear`` and ``RowParallelLinear`` (with and without
  sequence parallelism), ``VocabParallelEmbedding`` and the vocab-parallel
  cross entropy (label smoothing 0 and 0.1) at tp = 2: outputs and every
  gradient to 1e-5 (fp32 products and sums in another order);
- a ``ParallelTransformerLayer`` (MHA, and GQA of 4 heads over 2
  groups: one group a rank) and a 2-layer ``GPTModel`` at tp = 2 with
  sequence parallelism, fp32, from JAX's per-device shards
  (``gpt_tp_params_from_jax``): outputs and logits to 1e-5, loss 1e-5
  relative, every gradient 1e-4 relative plus 2e-6 absolute (the GPT
  test's tolerances: matmul chains summed in another order; for the
  layer, driven by N(0, 1) cotangents, 1e-5 of each gradient's largest
  element in place of the 2e-6).
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
from apex_tpu.models import gpt_loss_fn as jax_gpt_loss_fn
from apex_tpu.parallel import layers as jlayers
from apex_tpu.parallel import mappings as jmappings
from apex_tpu.parallel import parallel_state as jps
from apex_tpu.parallel.cross_entropy import (
    vocab_parallel_cross_entropy as jax_ce,
)
from apex_tpu.transformer import TransformerConfig as JaxConfig
from apex_tpu.transformer.layer import (
    ParallelTransformerLayer as JaxLayer,
)
from apex_tpu_torch.models import gpt_params_from_jax, gpt_tp_params_from_jax
from apex_tpu_torch.transformer.testing.distributed_test_base import spawn
from apex_tpu_torch.transformer.testing.parallel_workers import (
    REGIONS,
    sequence_worker,
)

WORLD = 4
ALL = P(("dp", "pp", "cp", "tp"))  # device r <- row r of a stacked array
S, B, H = 8, 2, 8  # mapping inputs (seq, batch, hidden), all divisible by 4


def _stacked(tree):
    return jax.tree_util.tree_map(lambda a: a[None], tree)


def _on_mesh(fn, tp, n_in, n_out):
    """``fn`` per device under shard_map on the (4 // tp, 1, 1, tp) mesh,
    with its inputs and outputs stacked by device."""
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]).reshape(
        WORLD // tp, 1, 1, tp), jps.AXIS_ORDER)
    f = shard_map(fn, mesh=mesh, in_specs=(ALL,) * n_in,
                  out_specs=(ALL,) * n_out if n_out > 1 else ALL,
                  check_vma=False)
    return jax.jit(f)


# -- the JAX side, computed once for the whole module ------------------------

def _region_shapes(name, tp):
    """(input shape, output shape) of one rank."""
    full, seq, last = (S, B, H), (S // tp, B, H), (S, B, H // tp)
    return {
        "copy_to_tensor_model_parallel_region": (full, full),
        "reduce_from_tensor_model_parallel_region": (full, full),
        "scatter_to_tensor_model_parallel_region": (full, last),
        "gather_from_tensor_model_parallel_region": (last, full),
        "scatter_to_sequence_parallel_region": (full, seq),
        "gather_from_sequence_parallel_region": (seq, full),
        "reduce_scatter_to_sequence_parallel_region": (full, seq),
    }[name]


def _mapping_cases():
    rs = np.random.RandomState(0)
    cases, refs = {}, {}
    for tp in (2, 4):
        cases[tp], refs[tp] = {}, {}
        for name in REGIONS:
            xs, ys = _region_shapes(name, tp)
            x = rs.randn(WORLD, *xs).astype(np.float32)
            ct = rs.randn(WORLD, *ys).astype(np.float32)
            fn = getattr(jmappings, name)

            def per_device(x, ct, fn=fn):
                y, vjp = jax.vjp(lambda a: fn(a, "tp"), x[0])
                return y[None], vjp(ct[0])[0][None]

            y, g = _on_mesh(per_device, tp, 2, 2)(x, ct)
            cases[tp][name] = (x, ct)
            refs[tp][name] = (np.asarray(y), np.asarray(g))
    return cases, refs


LAYER_TP = 2


def _layer_cases():
    """Column, Row, the embedding and the CE at tp = 2, initialized inside
    shard_map (each tp rank draws its own shard, tp_rank_init), with the
    JAX outputs and gradients."""
    rs = np.random.RandomState(1)
    s, b, hin, hout, vocab = 8, 2, 16, 12, 24
    cases, refs = {}, {}

    def linear(name, kind, module, kw, x_shape, y_shape):
        x = rs.randn(WORLD, *x_shape).astype(np.float32)
        ct = rs.randn(WORLD, *y_shape).astype(np.float32)

        def per_device(x, ct):
            params = module.init(jax.random.PRNGKey(0), x[0])
            y, vjp = jax.vjp(module.apply, params, x[0])
            gp, gx = vjp(ct[0])
            return _stacked(params["params"]), y[None], gx[None], \
                _stacked(gp["params"])

        params, y, gx, gp = _on_mesh(per_device, LAYER_TP, 2, 4)(x, ct)
        cases[name] = dict(kind=kind, kw=kw, x=x, ct=ct,
                           params=jax.tree_util.tree_map(np.asarray, params))
        refs[name] = dict(y=np.asarray(y), dx=np.asarray(gx),
                          grads=jax.tree_util.tree_map(np.asarray, gp))

    for sp in (False, True):
        tag = " sp" if sp else ""
        linear("column" + tag, "column",
               jlayers.ColumnParallelLinear(
                   output_size=hout, sequence_parallel_enabled=sp),
               dict(input_size=hin, output_size=hout,
                    sequence_parallel_enabled=sp),
               (s // LAYER_TP if sp else s, b, hin), (s, b, hout // LAYER_TP))
        linear("row" + tag, "row",
               jlayers.RowParallelLinear(
                   output_size=hout, sequence_parallel_enabled=sp),
               dict(input_size=hin, output_size=hout,
                    sequence_parallel_enabled=sp),
               (s, b, hin // LAYER_TP), (s // LAYER_TP if sp else s, b, hout))

    # the embedding: ids of every rank's vocab range, the same within a
    # tp group (dp groups differ)
    ids = np.repeat(rs.randint(0, vocab, (WORLD // LAYER_TP, 1, b, s)),
                    LAYER_TP, axis=1).reshape(WORLD, b, s).astype(np.int32)
    ct = rs.randn(WORLD, b, s, hin).astype(np.float32)
    emb = jlayers.VocabParallelEmbedding(num_embeddings=vocab,
                                         embedding_dim=hin)

    def emb_device(ids, ct):
        params = emb.init(jax.random.PRNGKey(0), ids[0])
        y, vjp = jax.vjp(lambda p: emb.apply(p, ids[0]), params)
        return _stacked(params["params"]), y[None], \
            _stacked(vjp(ct[0])[0]["params"])

    params, y, gp = _on_mesh(emb_device, LAYER_TP, 2, 3)(ids, ct)
    cases["embedding"] = dict(
        kind="embedding", kw=dict(num_embeddings=vocab, embedding_dim=hin),
        x=ids, ct=ct, params=jax.tree_util.tree_map(np.asarray, params))
    refs["embedding"] = dict(y=np.asarray(y),
                             grads=jax.tree_util.tree_map(np.asarray, gp))

    # the CE: logits of this rank's vocab shard, targets of the tp group
    labels = ids
    for ls in (0.0, 0.1):
        x = (rs.randn(WORLD, b, s, vocab // LAYER_TP) * 3).astype(np.float32)
        ct = rs.rand(WORLD, b, s).astype(np.float32)

        def ce_device(x, lab, ct, ls=ls):
            y, vjp = jax.vjp(lambda a: jax_ce(a, lab[0], ls), x[0])
            return y[None], vjp(ct[0])[0][None]

        y, g = _on_mesh(ce_device, LAYER_TP, 3, 2)(x, labels, ct)
        name = f"cross_entropy ls={ls}"
        cases[name] = dict(kind="cross_entropy", x=x, ct=ct, labels=labels,
                           ls=ls)
        refs[name] = dict(y=np.asarray(y), dx=np.asarray(g))
    return cases, refs


GPT = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
           vocab_size=128, max_position_embeddings=16, hidden_dropout=0.0,
           attention_dropout=0.0, sequence_parallel=True)
GPT_SEQ, GPT_MICRO = 16, 2


def _gpt_cases():
    """Layers (MHA, and GQA with 4 heads over 2 groups) and the model at
    tp = 2 with sequence parallelism, fp32."""
    rs = np.random.RandomState(2)
    tp = 2
    # the layers: their shards initialized inside shard_map,
    # sequence-split hidden states per rank
    layer_cases, layer_refs = {}, {}
    for name, extra in (("mha", {}), ("gqa", {"num_query_groups": 2})):
        jcfg = JaxConfig(compute_dtype=jnp.float32, **GPT, **extra)
        x = rs.randn(WORLD, GPT_SEQ // tp, GPT_MICRO, 64).astype(np.float32)
        ct = rs.randn(*x.shape).astype(np.float32)
        layer = JaxLayer(config=jcfg)

        def layer_device(x, ct, layer=layer):
            params = layer.init(jax.random.PRNGKey(0), x[0])
            y, vjp = jax.vjp(layer.apply, params, x[0])
            gp, gx = vjp(ct[0])
            return _stacked(params["params"]), y[None], gx[None], \
                _stacked(gp["params"])

        params, y, gx, gp = _on_mesh(layer_device, tp, 2, 4)(x, ct)
        layer_cases[name] = dict(config=extra, x=x, ct=ct, params=[
            {k: v.numpy() for k, v in gpt_params_from_jax(
                jax.tree_util.tree_map(lambda a: np.asarray(a)[r],
                                       params)).items()}
            for r in range(WORLD)])
        layer_refs[name] = dict(y=np.asarray(y), dx=np.asarray(gx), grads=[
            gpt_params_from_jax(jax.tree_util.tree_map(
                lambda a: np.asarray(a)[r], gp)) for r in range(WORLD)])

    # the model: initialized as the JAX training target does (out_specs
    # P() under check_vma=False, each device keeping its own shards),
    # read back per device by gpt_tp_params_from_jax
    model = JaxGPT(config=JaxConfig(compute_dtype=jnp.float32, **GPT))
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]).reshape(2, 1, 1, tp),
                jps.AXIS_ORDER)
    tokens = rs.randint(0, 128, (2 * GPT_MICRO, GPT_SEQ)).astype(np.int32)
    labels = rs.randint(0, 128, (2 * GPT_MICRO, GPT_SEQ)).astype(np.int32)

    @jax.jit
    @functools.partial(shard_map, mesh=mesh, in_specs=P(), out_specs=P(),
                       check_vma=False)
    def init(tok):
        return model.init(jax.random.PRNGKey(0), tok)["params"]

    jparams = init(jnp.asarray(tokens[:GPT_MICRO]))

    @jax.jit
    @functools.partial(shard_map, mesh=mesh,
                       in_specs=(P(), P("dp"), P("dp")),
                       out_specs=(ALL, ALL, ALL), check_vma=False)
    def run(p, tok, lab):
        def loss_fn(p):
            return jax_gpt_loss_fn(model.apply({"params": p}, tok,
                                               labels=lab))
        loss, g = jax.value_and_grad(loss_fn)(p)
        logits = model.apply({"params": p}, tok)
        return logits[None], loss[None], _stacked(g)

    logits, loss, grads = run(jparams, tokens, labels)
    model_case = dict(
        tokens=[tokens[(r // tp) * GPT_MICRO:(r // tp + 1) * GPT_MICRO]
                for r in range(WORLD)],
        labels=[labels[(r // tp) * GPT_MICRO:(r // tp + 1) * GPT_MICRO]
                for r in range(WORLD)],
        params=[{k: v.numpy() for k, v in
                 gpt_tp_params_from_jax(jparams, r).items()}
                for r in range(WORLD)])
    model_ref = dict(logits=np.asarray(logits), loss=np.asarray(loss),
                     grads=[gpt_params_from_jax(jax.tree_util.tree_map(
                         lambda a: np.asarray(a)[r], grads))
                         for r in range(WORLD)])
    return layer_cases, layer_refs, model_case, model_ref


@pytest.fixture(scope="module")
def both():
    """(the JAX references, the port's results by rank): one spawned
    world of 4 runs every port check of this module."""
    jps.initialize_model_parallel(tensor_model_parallel_size=LAYER_TP,
                                  devices=jax.devices()[:WORLD])
    try:
        map_cases, map_refs = _mapping_cases()
        layer_cases, layer_refs = _layer_cases()
        layer_cases_gpt, layer_refs_gpt, model_case, model_ref = _gpt_cases()
    finally:
        jps.destroy_model_parallel()
    config = dict(GPT, compute_dtype=torch.float32)
    ports = spawn(sequence_worker, WORLD, args=([
        ("mappings_worker", (map_cases,)),
        ("layers_worker", (LAYER_TP, layer_cases)),
        ("gpt_worker", (2, config, layer_cases_gpt, model_case)),
    ],), timeout=240.0)
    refs = dict(mappings=map_refs, layers=layer_refs, layer=layer_refs_gpt,
                model=model_ref, mapping_inputs=map_cases)
    return refs, ports


# regions whose forward or backward sums over the ranks
_SUMMED = {
    "copy_to_tensor_model_parallel_region": (False, True),
    "reduce_from_tensor_model_parallel_region": (True, False),
    "gather_from_sequence_parallel_region": (False, True),
    "reduce_scatter_to_sequence_parallel_region": (True, False),
}


def _same(got, want, summed, what):
    if summed:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("region", REGIONS)
def test_region_forward_and_backward_match_jax(both, region, tp):
    refs, ports = both
    y_ref, g_ref = refs["mappings"][tp][region]
    fwd_sum, bwd_sum = _SUMMED.get(region, (False, False))
    x = both[0]["mapping_inputs"][tp][region][0]
    for r in range(WORLD):
        y, g = ports[r][0][tp][region]
        _same(y, y_ref[r], fwd_sum, f"{region} rank {r} forward")
        _same(g, g_ref[r], bwd_sum, f"{region} rank {r} backward")
        # broadcast_data: tp rank 0's input on every rank of the group
        np.testing.assert_array_equal(
            ports[r][0][tp][region + " broadcast_data"], x[r - r % tp])


@pytest.mark.parametrize("case", [
    "column", "column sp", "row", "row sp", "embedding",
    "cross_entropy ls=0.0", "cross_entropy ls=0.1"])
def test_parallel_layer_matches_jax(both, case):
    refs, ports = both
    ref = refs["layers"][case]
    for r in range(WORLD):
        got = ports[r][1][case]
        np.testing.assert_allclose(got["y"], ref["y"][r], atol=1e-5,
                                   rtol=1e-5, err_msg=f"{case} rank {r}")
        if "dx" in ref:
            np.testing.assert_allclose(got["dx"], ref["dx"][r], atol=1e-5,
                                       rtol=1e-5, err_msg=f"{case} dx")
        for name, g in ref.get("grads", {}).items():
            np.testing.assert_allclose(got["grads"][name], g[r], atol=1e-5,
                                       rtol=1e-5, err_msg=f"{case} {name}")
        assert set(got.get("grads", {})) == set(ref.get("grads", {}))


def _grads_match(got, ref, what, scaled=False):
    """1e-4 relative plus 2e-6 absolute; ``scaled``: plus 1e-5 of the
    tensor's largest element instead (the layer's random cotangents make
    gradients of O(10), whose fp32 sums cancel to small elements)."""
    assert set(got) == set(ref), what
    for name, g in ref.items():
        g = g.numpy()
        atol = 1e-5 * float(np.abs(g).max()) if scaled else 2e-6
        np.testing.assert_allclose(got[name], g, atol=atol, rtol=1e-4,
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("attention", ["mha", "gqa"])
def test_gpt_layer_tp2_sequence_parallel_matches_jax(both, attention):
    refs, ports = both
    ref = refs["layer"][attention]
    for r in range(WORLD):
        got = ports[r][2][attention]
        np.testing.assert_allclose(got["y"], ref["y"][r], atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(got["dx"], ref["dx"][r], atol=1e-5,
                                   rtol=1e-5)
        # the norms' gradients are the tp sums of the rank's rows, equal
        # on both tp ranks, as JAX's copy-to region makes them
        _grads_match(got["grads"], ref["grads"][r], f"layer rank {r}",
                     scaled=True)


def test_gpt_model_tp2_sequence_parallel_matches_jax(both):
    refs, ports = both
    ref = refs["model"]
    for r in range(WORLD):
        got = ports[r][2]["model"]
        assert got["logits"].shape == (GPT_MICRO, GPT_SEQ, 128 // 2)
        np.testing.assert_allclose(got["logits"], ref["logits"][r],
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got["loss"], float(ref["loss"][r]),
                                   rtol=1e-5)
        _grads_match(got["grads"], ref["grads"][r], f"model rank {r}")
        assert len(got["grads"]) == 2 * 12 + 4


def test_jax_tp_init_keeps_each_devices_shard():
    """The JAX init at tp > 1 (out_specs P(), check_vma=False) leaves each
    device its own tp shard under a sharding that claims replication:
    ``np.asarray`` reads device 0's, and ``gpt_tp_params_from_jax`` reads
    each device's."""
    mesh = jps.initialize_model_parallel(tensor_model_parallel_size=2,
                                         devices=jax.devices()[:2])
    try:
        model = JaxGPT(config=JaxConfig(compute_dtype=jnp.float32, **GPT))

        @jax.jit
        @functools.partial(shard_map, mesh=mesh, in_specs=P(),
                           out_specs=P(), check_vma=False)
        def init(tok):
            return model.init(jax.random.PRNGKey(0), tok)["params"]

        params = init(jnp.zeros((1, GPT_SEQ), jnp.int32))
    finally:
        jps.destroy_model_parallel()
    by_rank = [gpt_tp_params_from_jax(params, r) for r in range(2)]
    plain = gpt_params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    qkv = "transformer.layer_0.self_attention.query_key_value.kernel"
    assert by_rank[0][qkv].shape == (64, 3 * 64 // 2)
    assert not np.array_equal(by_rank[0][qkv], by_rank[1][qkv])
    for name in ("embedding.word_embeddings.embedding", qkv,
                 "transformer.layer_0.mlp.dense_4h_to_h.kernel"):
        assert np.array_equal(by_rank[0][name], plain[name])
        assert not np.array_equal(by_rank[1][name], plain[name])
    for name in ("embedding.position_embeddings",
                 "transformer.final_layernorm.scale",
                 "transformer.layer_1.mlp.dense_4h_to_h.bias"):
        assert np.array_equal(by_rank[0][name], by_rank[1][name])
