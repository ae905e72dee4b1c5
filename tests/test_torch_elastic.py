"""apex_tpu_torch's elastic restart against the JAX package's: the
checkpoint at world > 1, the topology block, the resharder and its
refusals, ``zero_regroup_flat``, ``parallel_state``'s sub-world and the
gate.

The port runs its gate's rank function (``resilience.elastic.__main__
.selftest_rank``) once, in one spawned world of 4 gloo ranks: JAX's toy
(a ZeRO-2 state beside replicated params, a loss scale and an RNG key,
param total 225) saved at dp 4 as it starts and after 3 steps, then
restored 4 -> 2 -> 4 -> 3 -> 4 ranks with one step and one save a leg,
then the refusals at dp 2. The JAX side runs the same legs on 4-, 2- and
3-device sub-meshes of the CPU mesh (``restore_resharded``,
``integrity.save_checkpoint_verified``) from the same initial arrays
(carried across as numpy; the toy's ``emb`` is replicated on the JAX
side too, so the dp-3 mesh divides it). Held:

- each side's restored flat buffers equal its own saved ones bit for bit
  on the common prefix, with zero padding (JAX's ``flat_prefix_equal``),
  and its params bit for bit;
- the flat buffers are 65,536 long at dp 1, 2 and 4 in both packages
  (225 padded to the flatten's chunk) and 65,538 at dp 3;
- the initial state's per-leaf crc32s in the port's manifest equal
  JAX's exactly, leaf for leaf;
- every saved state along the trip agrees with JAX's: params and flat
  buffers at rtol 1e-5, atol 1e-7 (fp32 Adam; XLA may contract the
  update's ops), the step counter, RNG key and loss scale exactly;
- each refusal (a non-ZeRO shape change, a spec naming an absent axis, a
  structure change) is JAX's verdict, naming the same leaf; a corrupted
  newest step and a pre-topology manifest fall back to the same step.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from apex_tpu.compat import shard_map
from apex_tpu.optimizers import distributed_fused_adam as jax_dfa
from apex_tpu.optimizers import zero_regroup_flat as jax_regroup
from apex_tpu.optimizers import zero_state_specs
from apex_tpu.resilience import chaos as jchaos
from apex_tpu.resilience import integrity as jint
from apex_tpu.resilience.elastic import ElasticRestoreError as JaxRefusal
from apex_tpu.resilience.elastic import restore_resharded as jax_restore
from apex_tpu.utils.checkpoint import save_checkpoint as jax_save
from apex_tpu_torch.optimizers import zero_regroup_flat
from apex_tpu_torch.parallel import parallel_state as ps
from apex_tpu_torch.resilience import integrity
from apex_tpu_torch.resilience.elastic import (
    ElasticRestoreError,
    needs_reshard,
    restore_resharded,
    topology_block,
)
from apex_tpu_torch.resilience.elastic.__main__ import (
    CHUNK,
    flat_prefix_equal,
    selftest_rank,
)
from apex_tpu_torch.resilience.elastic.layout import StateLayout
from apex_tpu_torch.transformer.testing.distributed_test_base import spawn

WORLD = 4
ZERO_FIELDS = ("master_shard", "exp_avg", "exp_avg_sq")
#: (devices, expected restored step, steps, saved step) of each leg after
#: the first (the port gate's order)
LEGS = ((2, 3, 1, 4), (4, 4, 1, 5), (3, 5, 1, 6), (4, 6, 0, 7))


def _jax_init():
    k = jax.random.PRNGKey(0)
    return {"w": np.asarray(jax.random.normal(k, (12, 16))),
            "b": np.zeros((1,), np.float32),
            "emb": np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                                (8, 4)))}


def _jax_state(init, n):
    """JAX's toy on the first ``n`` CPU devices (its selftest's
    ``make_state``, every param replicated)."""
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("dp",))
    rep = NamedSharding(mesh, P())
    specs = zero_state_specs("dp")
    opt = jax_dfa(lr=0.1, axis_name="dp", axis_size=n)
    params = {k: jax.device_put(jnp.asarray(v), rep) for k, v in init.items()}
    init_opt = jax.jit(shard_map(opt.init, mesh=mesh, in_specs=(P(),),
                                 out_specs=specs, check_vma=False))

    def step(params, opt_state):
        def loss_fn(p):
            return sum(jnp.sum(leaf.astype(jnp.float32) ** 2)
                       for leaf in jax.tree_util.tree_leaves(p))

        grads = jax.grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    train = jax.jit(shard_map(step, mesh=mesh, in_specs=(P(), specs),
                              out_specs=(P(), specs), check_vma=False))
    state = {"params": params, "opt": init_opt(params),
             "loss_scale": jax.device_put(jnp.float32(1024.0), rep),
             "rng": jax.device_put(
                 jax.random.PRNGKey(7).astype(jnp.uint32), rep)}

    def run():
        state["params"], state["opt"] = train(state["params"], state["opt"])

    return mesh, state, run


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _crc(directory, step):
    return {leaf["path"]: leaf["crc32"] for leaf in jint.read_manifest(
        os.path.join(directory, f"step_{step}"))["fingerprint"]["leaves"]}


def _leaf_named(message):
    """The leaf a refusal names (or, for a structure change, the
    target-only leaves it lists)."""
    m = re.search(r"leaf (\[\S*?\])(?:\.\w+)?:", message)
    if m:
        return message[m.start(1):message.index(":", m.start(1))]
    m = re.search(r"target-only leaves (\[.*?\])", message)
    return m.group(1) if m else None


def _refusal(fn):
    try:
        fn()
    except (JaxRefusal, ElasticRestoreError) as e:
        return True, str(e)
    return False, ""


def _jax_trip(directory, init):
    out = {"saved": {}, "restored": {}, "crc": {}}

    def save(state, step):
        jint.save_checkpoint_verified(directory, step, state)
        out["saved"][step] = _flat(state)
        out["crc"][step] = _crc(directory, step)

    mesh, state, run = _jax_state(init, WORLD)
    save(state, 0)
    for _ in range(3):
        run()
    save(state, 3)
    for devices, want, steps, saved in LEGS:
        mesh, target, run = _jax_state(init, devices)
        step, restored = jax_restore(directory, target, mesh=mesh)
        assert step == want
        target.update(restored)
        out["restored"][step] = _flat(target)
        for _ in range(steps):
            run()
        save(target, saved)
    mesh, target, _ = _jax_state(init, 2)
    bad = dict(target, params=dict(target["params"]))
    bad["params"]["w"] = jax.device_put(jnp.zeros((12, 17), jnp.float32),
                                        NamedSharding(mesh, P()))
    out["refusals"] = {
        "shape": _refusal(lambda: jax_restore(directory, bad, mesh=mesh)),
        "axis": _refusal(lambda: jax_restore(
            directory, target, mesh=mesh,
            target_specs=jax.tree_util.tree_map(lambda _: P("tp"),
                                                target))),
        "structure": _refusal(lambda: jax_restore(
            directory, dict(target, bonus=jax.device_put(
                jnp.zeros((2,), jnp.float32), NamedSharding(mesh, P()))),
            mesh=mesh)),
    }
    jchaos.corrupt_checkpoint(os.path.join(directory, "step_7"),
                              mode="bitflip")
    out["corrupt"] = jax_restore(directory, target, mesh=mesh)[0]
    jint.write_manifest(jax_save(directory, 8, target))
    out["legacy"] = jax_restore(directory, target, mesh=mesh)[0]
    return out


@pytest.fixture(scope="module")
def trips(tmp_path_factory):
    init = _jax_init()
    jax_dir = str(tmp_path_factory.mktemp("jax"))
    port_dir = str(tmp_path_factory.mktemp("port"))
    port = spawn(selftest_rank, WORLD, args=(port_dir, init, "cpu"),
                 timeout=300.0)[0]
    return _jax_trip(jax_dir, init), port


def test_the_port_gate_passes_every_check(trips):
    _, port = trips
    failed = [label for ok, label in port["checks"] if not ok]
    assert not failed and len(port["checks"]) >= 30


@pytest.mark.parametrize("step", [3, 4, 5, 6])
def test_restored_flat_buffers_keep_the_saved_prefix(trips, step):
    """Both packages: the restore of ``step``'s predecessor equals what
    was saved, params bit for bit and flat buffers on the prefix."""
    for side in trips:
        saved, restored = side["saved"][step], side["restored"][step]
        for p in saved:
            if p.startswith("['opt'].") and p.split(".")[-1] in ZERO_FIELDS:
                assert flat_prefix_equal(saved[p], restored[p]), p
            elif p != "['opt'].step":
                np.testing.assert_array_equal(saved[p], restored[p],
                                              err_msg=p)


def test_flat_lengths_follow_the_chunk_and_dp(trips):
    for side in trips:
        lengths = {s: side["saved"][s]["['opt'].master_shard"].shape[0]
                   for s in (3, 4, 5, 6, 7)}
        assert lengths == {3: CHUNK, 4: CHUNK, 5: CHUNK, 6: CHUNK + 2,
                           7: CHUNK}


def test_initial_state_crc32s_equal_jax_exactly(trips):
    jax_side, port = trips
    assert port["crc"][0] == jax_side["crc"][0]
    assert len(port["crc"][0]) == 10


@pytest.mark.parametrize("step", [3, 4, 5, 6, 7])
def test_saved_states_agree_with_jax(trips, step):
    jax_side, port = trips
    want, got = jax_side["saved"][step], port["saved"][step]
    assert sorted(want) == sorted(got)
    for p in want:
        if p in ("['rng']", "['loss_scale']", "['opt'].step"):
            np.testing.assert_array_equal(got[p], want[p], err_msg=p)
        else:
            assert got[p].shape == want[p].shape, p
            np.testing.assert_allclose(got[p], want[p], rtol=1e-5,
                                       atol=1e-7, err_msg=p)


@pytest.mark.parametrize("case", ["shape", "axis", "structure"])
def test_refusals_match_jax(trips, case):
    jax_side, port = trips
    want, got = jax_side["refusals"][case], port["refusals"][case]
    assert want[0] and got[0]
    assert _leaf_named(got[1]) == _leaf_named(want[1]) is not None


def test_corruption_and_pre_topology_fallbacks_match_jax(trips):
    jax_side, port = trips
    assert jax_side["corrupt"] == jax_side["legacy"] == 6
    labels = {label for ok, label in port["checks"] if ok}
    assert "corrupted newest step skipped; fell back to verified step" \
        in labels
    assert "pre-topology newest manifest skipped (format-upgrade " \
        "rollback)" in labels


@pytest.mark.parametrize("n,target", [(10, 10), (10, 12), (12, 10)])
def test_zero_regroup_flat_matches_jax(n, target):
    flat = np.zeros(12, np.float32)
    flat[:10] = np.arange(1, 11)
    flat = flat[:n]
    np.testing.assert_array_equal(
        zero_regroup_flat(torch.from_numpy(flat), target).numpy(),
        np.asarray(jax_regroup(flat, target)))


def test_zero_regroup_flat_refuses_dropping_state_as_jax_does():
    flat = np.arange(1, 13, dtype=np.float32)
    with pytest.raises(ValueError, match="nonzero"):
        jax_regroup(flat, 10)
    with pytest.raises(ValueError, match="2 nonzero"):
        zero_regroup_flat(torch.from_numpy(flat), 10)
    # the int16 remainders regroup by the same rule (zeros are padding)
    rem = torch.tensor([3, -2, 0, 0], dtype=torch.int16)
    assert zero_regroup_flat(rem, 2).tolist() == [3, -2]
    assert zero_regroup_flat(rem, 6).dtype == torch.int16


def test_world_of_one_layout_is_the_checkpoint_it_always_was(tmp_path):
    """At a world of one the global tree is the live one: the topology
    block's shapes are the leaves', the ZeRO buffers are marked, and a
    save and restore are the plain ones."""
    from apex_tpu_torch.optimizers import distributed_fused_adam

    params = {"w": torch.randn(4, 8), "b": torch.zeros(3)}
    opt = distributed_fused_adam(lr=0.1)
    tree = {"params": params, "opt": opt.init(params)}
    block = topology_block(tree)
    by_path = {leaf["path"]: leaf for leaf in block["leaves"]}
    assert by_path["['params']['w']"]["shape"] == [4, 8]
    assert by_path["['params']['w']"]["spec"] is None
    assert by_path["['opt'].master_shard"]["zero_shard_axis"] == "dp"
    assert by_path["['opt'].master_shard"]["spec"] == ["dp"]
    assert by_path["['opt'].ef_residual"]["ef"] is True
    assert block["mesh"]["devices"] == 1
    layout = StateLayout(tree)
    host = layout.gather(tree)
    assert host["params"]["w"] is not params["w"]
    assert torch.equal(host["params"]["w"], params["w"])
    integrity.save_checkpoint_verified(str(tmp_path), 1, tree)
    assert needs_reshard(str(tmp_path)) is False
    step, loaded = restore_resharded(str(tmp_path), tree)
    assert step == 1 and torch.equal(loaded["params"]["w"], params["w"])


def test_the_world_makes_each_group_once(trips):
    """Six layouts (4, 2, 4, 3, 4 and 2 ranks) take their groups from the
    world's cache: (0), (1), (2), (3), (0, 1), (0, 1, 2) and the world
    itself, 7 ``new_group`` calls (28 if each layout made its own)."""
    _, port = trips
    assert port["groups_made"] == 7


def test_sub_world_count_fits_the_world():
    assert ps._device_count(2, 4) == 2
    assert ps._device_count(None, 4) == 4
    with pytest.raises(ValueError, match="devices=5"):
        ps._device_count(5, 4)
    assert ps.participates() and ps.get_model_world_size() == 1
    assert ps.get_model_world_group() is None
