"""apex_tpu_torch's data parallelism against the JAX package: the gradient
all-reduce (``all_reduce_gradients``, ``Reducer``, ``broadcast_params``),
ZeRO-2 Adam (``distributed_fused_adam``) at dp = 2, 3 and 4, and
``SyncBatchNorm`` at dp = 2 and 4.

The port runs in one spawned world of 4 gloo ranks on the CPU, each case
over a group of its ranks; the JAX functions run under ``shard_map``
(``check_vma=False``, per-rank gradients, as the JAX training step runs)
on as many devices of the CPU mesh. Inputs are seeded numpy arrays, per
rank. Tolerances, stated per check: sums over the ranks taken in another
order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from apex_tpu.compat import shard_map
from apex_tpu.optimizers import distributed_fused_adam as jax_dfa
from apex_tpu.parallel.ddp import DistributedDataParallel as JaxDDP
from apex_tpu.parallel.ddp import Reducer as JaxReducer
from apex_tpu.parallel.ddp import all_reduce_gradients as jax_all_reduce
from apex_tpu.parallel.ddp import broadcast_params as jax_broadcast
from apex_tpu.parallel.sync_batch_norm import SyncBatchNorm as JaxSyncBN
from apex_tpu_torch.transformer.testing.distributed_test_base import spawn
from apex_tpu_torch.transformer.testing.parallel_workers import (
    sequence_worker,
)

WORLD = 4


def _mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), ("dp",))


def _per_rank(fn, n, n_in, n_out, replicated_in=0):
    """``fn`` per device of an n-device ``dp`` mesh; the first
    ``replicated_in`` inputs are the same on every rank, the others and
    every output stacked by rank."""
    specs = (P(),) * replicated_in + (P("dp"),) * (n_in - replicated_in)
    return jax.jit(shard_map(fn, mesh=_mesh(n), in_specs=specs,
                             out_specs=(P("dp"),) * n_out, check_vma=False))


def _stack(tree):
    return jax.tree_util.tree_map(lambda a: a[None], tree)


def _first(tree):
    return jax.tree_util.tree_map(lambda a: a[0], tree)


# -- all_reduce_gradients, Reducer, broadcast_params over the world of 4 ----

def _ddp_case():
    rs = np.random.RandomState(0)
    grads = {"w": rs.randn(WORLD, 5, 3).astype(np.float32),
             "b": rs.randn(WORLD, 7).astype(np.float32),
             "h": rs.randn(WORLD, 6).astype(np.float16)}

    def per_device(g):
        g = _first(g)
        return tuple(_stack(x) for x in (
            jax_all_reduce(g, "dp"),
            jax_all_reduce(g, "dp", gradient_predivide_factor=2.0,
                           allreduce_always_fp32=True),
            jax_all_reduce(g, "dp", gradient_average=False),
            JaxReducer("dp").reduce(g),
            jax_broadcast(g, "dp")))

    refs = _per_rank(per_device, WORLD, 1, 5)(grads)
    names = ("mean", "predivide", "sum", "reducer", "broadcast")
    refs = {k: jax.tree_util.tree_map(np.asarray, v)
            for k, v in zip(names, refs)}
    # DistributedDataParallel.value_and_grad: the rank's loss, the dp mean
    # of the gradients of w, the same on every rank
    w = rs.randn(3, 2).astype(np.float32)
    x = rs.randn(WORLD, 5, 3).astype(np.float32)
    ddp = JaxDDP(lambda p, x: jnp.mean(jnp.square(x @ p["w"])), "dp")

    def vg_device(w, x):
        loss, g = ddp.value_and_grad()({"w": w}, x[0])
        return loss[None], g["w"][None]

    loss, g = _per_rank(vg_device, WORLD, 2, 2, replicated_in=1)(w, x)
    refs["value_and_grad"] = {"loss": np.asarray(loss), "w": np.asarray(g)}
    return dict(ddp_grads=grads, vg_w=w, vg_x=x), refs


# -- distributed_fused_adam -------------------------------------------------

ZERO_STEPS = 3
ZERO_CASES = {
    # _grads' norms are ~10-30, so max_grad_norm 1.0 clips every step
    "dp=2 clipped": dict(ranks=[0, 1], hyper=dict(
        lr=1e-2, weight_decay=0.05, max_grad_norm=1.0)),
    "dp=4 adam (L2 mode)": dict(ranks=[0, 1, 2, 3], hyper=dict(
        lr=1e-2, weight_decay=0.05, adam_w_mode=False)),
    # 65,536 elements after the chunk padding: not a multiple of 3, so
    # _padded_flatten pads the buffer to 65,538
    "dp=3 ragged, clipped": dict(ranks=[0, 1, 2], hyper=dict(
        lr=1e-2, weight_decay=0.01, max_grad_norm=1.0)),
}


def _zero_cases():
    cases, refs = {}, {}
    for i, (name, c) in enumerate(ZERO_CASES.items()):
        rs = np.random.RandomState(10 + i)
        n = len(c["ranks"])
        params = {"a": rs.randn(4, 5).astype(np.float32),
                  "b": rs.randn(13).astype(np.float32),
                  "c": rs.randn(3, 2, 2).astype(np.float32)}
        grads = [{k: (rs.randn(n, *v.shape) * 4).astype(np.float32)
                  for k, v in params.items()} for _ in range(ZERO_STEPS)]
        opt = jax_dfa(axis_name="dp", axis_size=n, **c["hyper"])

        def per_device(p, gs, opt=opt):
            state = opt.init(p)
            for g in gs:
                upd, state = opt.update(_first(g), state, p)
                p = jax.tree_util.tree_map(lambda a, u: a + u, p, upd)
            return _stack(p), state.master_shard[None], \
                state.exp_avg[None], state.step[None]

        out = _per_rank(per_device, n, 2, 4, replicated_in=1)(
            params, grads)
        cases[name] = dict(c, params=params, grads=grads)
        refs[name] = jax.tree_util.tree_map(np.asarray, out)
    return cases, refs


# -- SyncBatchNorm ------------------------------------------------------------

def _syncbn_cases():
    cases, refs = {}, {}
    for i, n in enumerate((2, 4)):
        rs = np.random.RandomState(20 + i)
        c = 4
        x = (rs.randn(n, 2, 3, 3, c) * 2 + 1).astype(np.float32)  # NHWC
        ct = rs.randn(*x.shape).astype(np.float32)
        variables = {
            "params": {"scale": (1 + 0.1 * rs.randn(c)).astype(np.float32),
                       "bias": (0.1 * rs.randn(c)).astype(np.float32)},
            "batch_stats": {"mean": (0.1 * rs.randn(c)).astype(np.float32),
                            "var": (1 + 0.1 * rs.rand(c)).astype(
                                np.float32)}}
        bn = JaxSyncBN(use_running_average=False, momentum=0.1,
                       axis_names=("dp",))

        def per_device(v, x, ct, bn=bn):
            def f(params, a):
                return bn.apply({"params": params,
                                 "batch_stats": v["batch_stats"]}, a,
                                mutable=["batch_stats"])
            y, stats = f(v["params"], x[0])
            _, pull = jax.vjp(lambda p, a: f(p, a)[0], v["params"], x[0])
            gp, gx = pull(ct[0])
            return y[None], gx[None], _stack(gp), \
                _stack(stats["batch_stats"])

        y, gx, gp, stats = _per_rank(per_device, n, 3, 4,
                                     replicated_in=1)(variables, x, ct)
        to_nchw = (0, 1, 4, 2, 3)  # (rank, N, H, W, C) -> (rank, N, C, H, W)
        cases[f"dp={n}"] = dict(
            ranks=list(range(n)), features=c,
            x=x.transpose(to_nchw), ct=ct.transpose(to_nchw),
            params={**variables["params"], **variables["batch_stats"]})
        refs[f"dp={n}"] = dict(
            y=np.asarray(y).transpose(to_nchw),
            dx=np.asarray(gx).transpose(to_nchw),
            grads=jax.tree_util.tree_map(np.asarray, gp),
            stats=jax.tree_util.tree_map(np.asarray, stats))
    return cases, refs


@pytest.fixture(scope="module")
def both():
    ddp_case, ddp_refs = _ddp_case()
    zero_cases, zero_refs = _zero_cases()
    bn_cases, bn_refs = _syncbn_cases()
    ports = spawn(sequence_worker, WORLD, args=([
        ("data_parallel_worker", (dict(ddp_case, zero=zero_cases,
                                       syncbn=bn_cases),)),
    ],), timeout=240.0)
    return dict(ddp=ddp_refs, zero=zero_refs, syncbn=bn_refs), \
        [p[0] for p in ports]


@pytest.mark.parametrize("mode", ["mean", "predivide", "sum", "reducer",
                                  "broadcast", "value_and_grad"])
def test_gradient_all_reduce_matches_jax(both, mode):
    """fp32 sums of 4 ranks in another order: 1e-6 relative; the fp16
    leaf rides its own bucket, summed in fp16 (one fp16 rounding a sum,
    1e-3 relative) unless ``allreduce_always_fp32``; the broadcast is
    exact; value_and_grad's loss and mean gradient 1e-6."""
    refs, ports = both
    for r in range(WORLD):
        got, want = ports[r]["ddp"][mode], refs["ddp"][mode]
        assert set(got) == set(want)
        for name, w in want.items():
            g = got[name]
            assert g.shape == w.shape[1:], name
            if mode == "broadcast":
                np.testing.assert_array_equal(g, w[r].astype(np.float32))
            else:
                tol = 2e-3 if name == "h" and mode != "predivide" else 1e-6
                np.testing.assert_allclose(g, w[r].astype(np.float32),
                                           rtol=tol, atol=tol,
                                           err_msg=f"{mode} rank {r} {name}")


@pytest.mark.parametrize("case", sorted(ZERO_CASES))
def test_distributed_fused_adam_matches_jax_over_dp(both, case):
    """Three steps: the params, this rank's master and first-moment
    shards and the step, on every rank of the group. The reduce-scattered
    sums and the clip's norm are taken in another order: 1e-6 relative,
    and 1e-7 absolute for elements near 0."""
    refs, ports = both
    want_p, want_master, want_m, want_step = refs["zero"][case]
    ranks = ZERO_CASES[case]["ranks"]
    n = len(ranks)
    total = sum(v.size for v in refs["zero"][case][0].values()) // n
    for i, r in enumerate(ranks):
        got = ports[r]["zero"][case]
        assert got["step"] == int(want_step[i]) == ZERO_STEPS
        for name, w in want_p.items():
            np.testing.assert_allclose(got["params"][name], w[i], rtol=1e-6,
                                       atol=1e-7, err_msg=f"{case} {name}")
        for key, w in (("master_shard", want_master), ("exp_avg", want_m)):
            assert got[key].shape == w[i].shape, key
            np.testing.assert_allclose(got[key], w[i], rtol=1e-6, atol=1e-7,
                                       err_msg=f"{case} rank {r} {key}")
        shard = got["master_shard"].shape[0]
        assert got["shard_range"] == (i * shard, (i + 1) * shard)
        assert got["padded_total"] == shard * n >= total
    if n == 3:
        assert ports[0]["zero"][case]["padded_total"] == 65538


@pytest.mark.parametrize("case", ["dp=2", "dp=4"])
def test_sync_batch_norm_matches_jax_over_dp(both, case):
    """Output, input and parameter gradients and the running statistics:
    the (n, sum x, sum x^2) moments against JAX's count-weighted mean and
    variance, summed in another order: 1e-5."""
    refs, ports = both
    ref = refs["syncbn"][case]
    for r in range(int(case[3:])):
        got = ports[r]["syncbn"][case]
        for key in ("y", "dx"):
            np.testing.assert_allclose(got[key], ref[key][r], atol=1e-5,
                                       rtol=1e-5, err_msg=f"{case} {key}")
        for name, g in ref["grads"].items():
            np.testing.assert_allclose(got["grads"][name], g[r], atol=1e-5,
                                       rtol=1e-5, err_msg=f"{case} {name}")
        for name, s in ref["stats"].items():
            np.testing.assert_allclose(got[name], s[r], atol=1e-6,
                                       rtol=1e-5, err_msg=f"{case} {name}")


def test_convert_syncbn_model_keeps_state_and_points_at_the_group():
    import torch

    from apex_tpu_torch.parallel import SyncBatchNorm, convert_syncbn_model

    net = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 1),
                              torch.nn.BatchNorm2d(4, momentum=0.2),
                              torch.nn.Sequential(torch.nn.BatchNorm1d(4)))
    bn = net[1]
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.uniform_(-1, 1)
        bn.running_mean.uniform_(-1, 1)
    group = object()  # stands for a process group; no collective runs
    out = convert_syncbn_model(net, process_group=group)
    assert out is net
    sb, inner = net[1], net[2][0]
    assert isinstance(sb, SyncBatchNorm) and isinstance(inner, SyncBatchNorm)
    assert sb.process_group is group and inner.process_group is group
    assert sb.momentum == 0.2 and sb.epsilon == bn.eps
    assert torch.equal(sb.scale, bn.weight) and torch.equal(sb.bias, bn.bias)
    assert torch.equal(sb.mean, bn.running_mean)
    assert torch.equal(sb.var, bn.running_var)
    # an existing SyncBatchNorm is re-pointed, not rebuilt
    assert convert_syncbn_model(sb, process_group=None) is sb
    assert sb.process_group is None
    # the converted norm computes what the torch one did, in training
    x = torch.randn(8, 4, 3, 3)
    sb.process_group = None
    ref = torch.nn.functional.batch_norm(
        x, None, None, bn.weight, bn.bias, training=True, eps=bn.eps)
    torch.testing.assert_close(sb(x), ref, atol=1e-5, rtol=1e-5)
