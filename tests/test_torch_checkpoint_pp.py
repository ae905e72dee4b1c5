"""Checkpoints of apex_tpu_torch at pp x tp and at cp against the JAX
package's orbax checkpoints of the same states, and the layout changes
each restore refuses or computes.

One spawned world of 4 gloo ranks runs three jobs
(``transformer/testing/checkpoint_workers.py``):

- pp 2 x tp 2: ``standalone_gpt``'s ``GPTPipelineTraining`` at the
  pipeline tests' tiny size (4 layers, hidden 16, 4 heads, vocab 32, seq
  8, sequence parallel, fp32) from JAX's initial weights (``run_gpt``'s
  init inside ``shard_map``, each device its own stage and tp shards),
  2 steps, then saved through ``AutoResume``;
- cp 2 x dp 2: a ring-attention ``GPTModel`` of the same width (2
  layers) under ``RingCPTraining`` with ZeRO over dp, from JAX
  ``GPTModel``'s weights, 2 steps, then saved;
- the GPT training step with ZeRO at tp 2, restored at tp 1.

The JAX side lays out the same stepped states as global arrays on 4 of
the 8 forced CPU devices, with the shardings of the JAX package's own
states (``pp``-stacked stages sharded ``P("pp", ...)``, tp dims
``"tp"``; the ZeRO buffers as ``distributed_fused_adam``'s ``init``
under ``shard_map`` shards them): device ``d``'s part of each leaf is
port rank ``d``'s leaf at the save, and where devices hold replicas the
ranks' copies must agree bit for bit. It saves them with
``save_checkpoint_verified``. After 2 steps the moments are nonzero and
differ by stage and by tp shard, so a stage order, a tp concatenation or
a replica taken from the wrong rank shows. Held:

- every leaf of the port's saved global tree equals the JAX checkpoint's
  exactly (fp32 bits), path for path, and the per-leaf crc32s, global
  shapes, specs and mesh axes of the two manifests agree;
- a restore plus 2 steps equals 2 uninterrupted steps bit for bit (the
  losses and every leaf), the restore equals the save, a rollback
  snapshot taken at the save equals it too, and every rank's restored
  leaves equal its own leaves at the save;
- a change of pp is refused by both packages (the port's error names
  ``pp``), a change of cp (2 -> 1, dp 2 -> 4) is computed by both with
  equal results, and a change of tp under ZeRO (2 -> 1) is refused by
  both.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from apex_tpu.compat import shard_map
from apex_tpu.models import GPTModel as JaxGPT
from apex_tpu.models.gpt_pipeline import build_gpt_pipeline as jbuild
from apex_tpu.optimizers import distributed_fused_adam as jax_dfa
from apex_tpu.optimizers import zero_state_specs
from apex_tpu.optimizers.fused_adam import FusedAdamState as JaxAdamState
from apex_tpu.parallel import parallel_state as jps
from apex_tpu.resilience import integrity as jint
from apex_tpu.resilience.elastic import ElasticRestoreError as JaxRefusal
from apex_tpu.resilience.elastic import restore_resharded as jax_restore
from apex_tpu.resilience.replay.targets import GPTTargetConfig as JaxTarget
from apex_tpu.resilience.replay.targets import build_gpt_training as jbgt
from apex_tpu.transformer import TransformerConfig as JaxConfig
from apex_tpu.transformer.testing.arguments import parse_args as jparse
from apex_tpu.transformer.testing.standalone_gpt import (
    gpt_config_from_args as jconfig,
)
from apex_tpu.utils.checkpoint import load_checkpoint as jax_load
from apex_tpu_torch.models import gpt_pipeline_params_from_jax
from apex_tpu_torch.transformer.testing.distributed_test_base import (
    jobs_worker,
    spawn,
)

WORLD = 4
SEED = 1234
WARMUP = 2  # the steps before the save


def _argv(pp: int):
    return ("--num-layers 4 --hidden-size 16 --num-attention-heads 4 "
            "--seq-length 8 --max-position-embeddings 8 "
            "--micro-batch-size 2 --global-batch-size 4 "
            "--make-vocab-size-divisible-by 32 --tensor-model-parallel-size 2 "
            f"--pipeline-model-parallel-size {pp} --sequence-parallel "
            f"--train-iters 3 --seed {SEED}").split()


CP_CONFIG = dict(num_layers=2, hidden_size=16, num_attention_heads=4,
                 vocab_size=32, max_position_embeddings=16,
                 hidden_dropout=0.0, attention_dropout=0.0)
TP_CFG = dict(vocab=64, seq_len=16, layers=1, hidden=32, heads=4,
              micro_batch=1, global_batch=4, max_devices=WORLD)


def _unflatten(flat):
    out = {}
    for name, v in flat.items():
        node = out
        *head, last = name.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def _keyed(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _bits(a):
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def _manifest(directory, step):
    return jint.read_manifest(os.path.join(directory, f"step_{step}"))


def _assemble(template, by_rank):
    """``template``'s global arrays (shapes, dtypes, shardings) filled
    from the port's ranks: device ``d``'s part of a leaf is
    ``by_rank[d]``'s leaf of the same path (rank ``d``'s state at the
    save), reshaped to the part's shape (a stage's leaf takes the
    ``pp`` axis's 1). The parts that several devices hold must come from
    ranks that agree bit for bit."""
    def leaf(path, a):
        key = jax.tree_util.keystr(path)
        out = np.zeros(a.shape, a.dtype)
        seen = np.zeros(a.shape, bool)
        for dev, idx in a.sharding.devices_indices_map(a.shape).items():
            part = by_rank[dev.id][key]
            assert part.dtype == a.dtype, key
            part = part.reshape(np.shape(out[idx]))
            if seen[idx].any():
                assert seen[idx].all(), key
                np.testing.assert_array_equal(
                    _bits(np.asarray(out[idx])), _bits(part),
                    err_msg=f"{key}: device {dev.id}'s replica")
            out[idx] = part
            seen[idx] = True
        assert seen.all(), key
        return jax.device_put(out, a.sharding)

    return jax.tree_util.tree_map_with_path(leaf, template)


# -- the JAX states ------------------------------------------------------


def _pp_init(parts, tokens_mb, seed):
    """``run_gpt``'s init inside ``shard_map``: the embedding from the
    seed, pp rank r's stage from ``fold_in(fold_in(key, 7), r)``."""
    key = jax.random.PRNGKey(seed)
    pre = parts.embed.init(key, tokens_mb)["params"]
    h0 = parts.pre_fn(pre, tokens_mb)
    r = jax.lax.axis_index("pp")
    stage = parts.chunk.init(jax.random.fold_in(jax.random.fold_in(key, 7),
                                                r), h0)["params"]
    return {"pre": pre, "stages": stage,
            "post": parts.init_post(jax.random.fold_in(key, 9))}


def _pp_by_rank(pp: int, tp: int, devices: int):
    """Each device's ``{"pre", "stages", "post"}`` (flat names, numpy)."""
    cfg = jconfig(jparse(args=_argv(pp)))
    mesh = jps.initialize_model_parallel(
        tensor_model_parallel_size=tp, pipeline_model_parallel_size=pp,
        devices=jax.devices()[:devices])
    try:
        parts = jbuild(cfg, pp)
        tokens = jnp.zeros((2, 8), jnp.int32)
        f = shard_map(lambda t: _pp_init(parts, t, SEED), mesh=mesh,
                      in_specs=P(), out_specs=P(), check_vma=False)
        params = jax.jit(f)(tokens)
        return [{part: {n: t.numpy() for n, t in named.items()}
                 for part, named in gpt_pipeline_params_from_jax(
                     params, r).items()} for r in range(devices)]
    finally:
        jps.destroy_model_parallel()


def _pp_state(pp: int, tp: int):
    """The JAX global initial state ``(params, FusedAdamState)`` at pp x
    tp on 4 devices (dp = 4 / (pp tp)), and each device's params; the tp
    dim of a leaf is where its shard's shape differs from the tp 1
    build's."""
    by_rank = _pp_by_rank(pp, tp, WORLD)
    full = _pp_by_rank(pp, 1, pp)[0]
    mesh = jps.initialize_model_parallel(
        tensor_model_parallel_size=tp, pipeline_model_parallel_size=pp,
        devices=jax.devices()[:WORLD])
    jps.destroy_model_parallel()
    params = {}
    for part, named in full.items():
        params[part] = {}
        for name, whole in named.items():
            local = by_rank[0][part][name]
            dim = next((i for i, (a, b) in enumerate(zip(local.shape,
                                                         whole.shape))
                        if a != b), None)

            def own(p, part=part, name=name, dim=dim):
                parts_ = [by_rank[p * tp + t][part][name] for t in range(tp)]
                return parts_[0] if dim is None else np.concatenate(parts_,
                                                                    dim)
            inner = [None] * local.ndim
            if dim is not None:
                inner[dim] = "tp"
            if part == "stages":
                arr, spec = np.stack([own(p) for p in range(pp)]), \
                    ["pp"] + inner
            else:
                arr, spec = own(0), inner
            params[part][name] = jax.device_put(
                arr, NamedSharding(mesh, P(*spec)))
    params = {part: _unflatten(named) for part, named in params.items()}
    rep = NamedSharding(mesh, P())
    zeros = jax.tree_util.tree_map(
        lambda a: jax.device_put(jnp.zeros(a.shape, jnp.float32),
                                 a.sharding), params)
    opt = JaxAdamState(step=jax.device_put(jnp.zeros((), jnp.int32), rep),
                       exp_avg=zeros, exp_avg_sq=zeros)
    return mesh, (params, opt), by_rank


def _cp_params():
    cfg = JaxConfig(compute_dtype=jnp.float32, **CP_CONFIG)
    variables = JaxGPT(config=cfg).init(jax.random.PRNGKey(SEED),
                                        jnp.zeros((2, 16), jnp.int32))
    return jax.tree_util.tree_map(np.asarray, variables["params"])


def _cp_state(params, cp: int):
    """The JAX global initial state ``(params, ZeRO state)`` at cp x dp on
    4 devices: params replicated, ``distributed_fused_adam`` over dp."""
    mesh = jps.initialize_model_parallel(context_parallel_size=cp,
                                         devices=jax.devices()[:WORLD])
    jps.destroy_model_parallel()
    dp = WORLD // cp
    rep = NamedSharding(mesh, P())
    live = jax.tree_util.tree_map(lambda a: jax.device_put(a, rep), params)
    opt = jax_dfa(lr=1e-3, axis_name="dp", axis_size=dp)
    init = jax.jit(shard_map(opt.init, mesh=mesh, in_specs=(P(),),
                             out_specs=zero_state_specs("dp"),
                             check_vma=False))
    return mesh, (live, init(live))


def _flat_names(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in tree.items():
        out.update(_flat_names(v, f"{prefix}.{k}" if prefix else k))
    return out


# -- the two sides ---------------------------------------------------------


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt_pp")
    dirs = {k: str(root / k) for k in ("jax_pp", "port_pp", "jax_cp",
                                       "port_cp", "jax_tp", "port_tp")}

    # the port first: from JAX's initial weights, WARMUP steps, the trip
    _, pp_template, by_rank = _pp_state(2, 2)
    cp_params = _cp_params()
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, 32, (4, 16))
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1),
             "kpm": np.zeros((4, 16), bool),
             "loss_mask": np.ones((4, 16), np.float32)}
    cp_cfg = dict(CP_CONFIG, context_parallel_mode="ring")
    mod = "apex_tpu_torch.transformer.testing.checkpoint_workers"
    ranks = spawn(jobs_worker, WORLD, args=([
        (f"{mod}:pipeline_checkpoint_worker",
         (_argv(2), dirs["port_pp"], by_rank, "cpu", WARMUP, 2, True)),
        (f"{mod}:cp_checkpoint_worker",
         (cp_cfg, batch, dirs["port_cp"], _flat_names(cp_params), 2,
          "cpu", 1e-3, WARMUP, 2, True)),
        (f"{mod}:tp_change_worker", (TP_CFG, dirs["port_tp"], "cpu")),
    ],), timeout=600.0)
    port = ranks[0]

    # then JAX's checkpoints of the ranks' states at the save
    jax_side = {}
    state = _assemble(pp_template, [r[0]["local"] for r in ranks])
    jint.save_checkpoint_verified(dirs["jax_pp"], WARMUP, state)
    jax_side["pp2_tp2"] = {
        "tree": _keyed(jax_load(dirs["jax_pp"], WARMUP, target=state)),
        "manifest": _manifest(dirs["jax_pp"], WARMUP)}
    mesh1, target1, _ = _pp_state(1, 2)
    try:
        jax_restore(dirs["jax_pp"], target1, mesh=mesh1)
        jax_side["pp_refusal"] = None
    except JaxRefusal as e:
        jax_side["pp_refusal"] = str(e)

    _, cp_template = _cp_state(cp_params, 2)
    state = _assemble(cp_template, [r[1]["local"] for r in ranks])
    jint.save_checkpoint_verified(dirs["jax_cp"], WARMUP, state)
    jax_side["cp2_dp2"] = {
        "tree": _keyed(jax_load(dirs["jax_cp"], WARMUP, target=state)),
        "manifest": _manifest(dirs["jax_cp"], WARMUP)}
    mesh1, target1 = _cp_state(cp_params, 1)
    _, restored = jax_restore(dirs["jax_cp"], target1, mesh=mesh1)
    jax_side["cp1"] = _keyed(restored)

    two = jbgt(JaxTarget(tp=2, zero=True, **TP_CFG))
    jint.save_checkpoint_verified(dirs["jax_tp"], 1, two.init_state())
    one = jbgt(JaxTarget(tp=1, zero=True, **TP_CFG))
    try:
        jax_restore(dirs["jax_tp"], one.init_state(), mesh=one.mesh)
        jax_side["tp_refusal"] = None
    except JaxRefusal as e:
        jax_side["tp_refusal"] = str(e)
    return jax_side, {"pp2_tp2": port[0], "cp2_dp2": port[1],
                      "tp_refusal": port[2]}


LAYOUTS = ["pp2_tp2", "cp2_dp2"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_saved_global_tree_equals_jax_checkpoint(sides, layout):
    """Tolerance: none, every fp32 (and int32) leaf bit for bit."""
    jax_side, port = sides
    want, got = jax_side[layout]["tree"], port[layout]["tree"]
    assert list(got) == list(want)
    # the state was stepped: the step count and the moments are live
    moments = [a for path, a in want.items() if "exp_avg" in path]
    assert moments and all(np.any(a != 0) for a in moments)
    assert any(a.dtype == np.int32 and a.ndim == 0 and int(a) == WARMUP
               for a in want.values())
    for path, a in want.items():
        b = got[path]
        assert b.shape == a.shape and b.dtype == a.dtype, path
        np.testing.assert_array_equal(_bits(b), _bits(a), err_msg=path)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_fingerprints_and_topology_equal_jax(sides, layout):
    jax_side, port = sides
    manifest = jax_side[layout]["manifest"]
    assert port[layout]["crc"] == {
        leaf["path"]: leaf["crc32"]
        for leaf in manifest["fingerprint"]["leaves"]}
    want = {leaf["path"]: leaf for leaf in manifest["topology"]["leaves"]}
    got = port[layout]["topology"]
    for path, leaf in want.items():
        for key in ("shape", "dtype", "zero_shard_axis"):
            assert got[path][key] == leaf[key], (path, key)
        # JAX writes a replicated leaf's spec as all-None entries
        spec = leaf["spec"]
        if spec is not None and all(e is None for e in spec):
            spec = None
        assert got[path]["spec"] == spec, path
    assert port[layout]["mesh"] == manifest["topology"]["mesh"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_restore_then_steps_equal_uninterrupted(sides, layout):
    """Tolerance: none (bitwise), the losses and every leaf."""
    _, port = sides
    run = port[layout]
    assert run["restored_step"] == run["saved_step"] == WARMUP
    assert run["restore_equals_save"] and run["rollback_equals_save"]
    assert run["every_rank_restores_its_save"]
    assert run["losses_equal"] and run["state_equal"]
    assert run["state_max_rel"] == 0.0
    assert all(np.isfinite(run["losses"]))


@pytest.mark.parametrize("change", ["pp", "cp", "tp"])
def test_layout_change_refused_or_computed_as_jax(sides, change):
    """pp 2 -> 1 and tp 2 -> 1 under ZeRO: both packages refuse (the
    port's pp refusal names the axis); cp 2 -> 1: both restore, with
    equal global leaves (bitwise)."""
    jax_side, port = sides
    if change == "pp":
        assert jax_side["pp_refusal"] is not None
        assert "'pp'" in port["pp2_tp2"]["pp_refusal"]
    elif change == "tp":
        assert jax_side["tp_refusal"] is not None
        assert port["tp_refusal"] is not None
        assert "a change of tp is a migration" in port["tp_refusal"]
    else:
        assert "cp1_refusal" not in port["cp2_dp2"]
        want, got = jax_side["cp1"], port["cp2_dp2"]["cp1"]
        assert list(got) == list(want)
        for path, a in want.items():
            np.testing.assert_array_equal(got[path], a, err_msg=path)
