"""apex_tpu_torch.contrib.bottleneck against the JAX package's.

``Bottleneck`` in one process: strides 1 and 2, a dilated 3x3, train
(batch statistics, running ones updated) and eval, fp32 and bf16
compute, from the JAX variables through ``bottleneck_params_from_jax``:
outputs, the input gradient, every parameter gradient and the running
statistics. ``SpatialBottleneck`` in ONE spawned world of 4 gloo ranks
(H split over the context-parallel group; the JAX side under shard_map
on 4 devices of the CPU mesh, as ``tests/test_bottleneck.py`` runs it):
each rank's halo rows (exact: data only moves), the rows' outputs
against JAX's spatial block, the input gradient through the halo
exchange's backward and the parameter gradients summed over the ranks
against JAX's unsharded block, and the synced running statistics, at
strides 1 and 2, train and eval. Tolerances: fp32 the network tolerance
of ``tests/test_torch_resnet.py`` (atol 1e-4 of values of order 1, rtol
1e-3: convolutions and three BatchNorms summed in another order), the
gradients' atol scaled by each gradient's largest element (the loss
sum(out ** 2) gives weight gradients up to about 100 that are sums of
terms which cancel); bf16 1.56e-2 relative in norm (activations rounded
to bf16 at each layer).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import apex_tpu.contrib as jc
import apex_tpu_torch.contrib as tc
from apex_tpu.compat import shard_map
from apex_tpu.parallel import parallel_state as jps
from apex_tpu_torch.models import bottleneck_params_from_jax
from apex_tpu_torch.transformer.testing.contrib_workers import (
    spatial_bottleneck_worker,
)
from apex_tpu_torch.transformer.testing.distributed_test_base import spawn

NET_TOL = dict(atol=1e-4, rtol=1e-3)
N, H, W, C, MID, OUT = 2, 16, 8, 8, 4, 16
SP = 4


def close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **NET_TOL)


def close_grad(got, want):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               rtol=NET_TOL["rtol"],
                               atol=NET_TOL["atol"] * scale)


def nhwc_to_port(x):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)


def port_to_nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def perturbed(variables, seed):
    """BatchNorm scales and biases and running statistics off their
    initial ones and zeros (variances kept positive)."""
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: p + jnp.asarray(rs.rand(*p.shape) * 0.2, p.dtype)
        if p.ndim == 1 else p, variables)


def jax_block(mod, variables, x, train):
    """JAX output, batch_stats after the call, and the gradients of
    sum(out ** 2) with respect to x and the params."""
    def loss(params, x):
        out, mut = mod.apply({"params": params,
                              "batch_stats": variables["batch_stats"]}, x,
                             train=train, mutable=["batch_stats"])
        return jnp.sum(out.astype(jnp.float32) ** 2), (out, mut)

    (_, (out, mut)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables["params"], x)
    return out, mut["batch_stats"], gp, gx


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("stride,dilation", [(1, 1), (2, 1), (1, 2)])
def test_bottleneck_matches_jax(stride, dilation, train):
    x = np.random.RandomState(0).randn(N, H, W, C).astype(np.float32)
    kw = dict(stride=stride, dilation=dilation)
    jmod = jc.Bottleneck(in_channels=C, bottleneck_channels=MID,
                         out_channels=OUT, **kw)
    variables = perturbed(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                    train=True), 1)
    out, stats, gp, gx = jax_block(jmod, variables, jnp.asarray(x), train)
    port = tc.Bottleneck(C, MID, OUT, device="cpu", **kw)
    port.load_state_dict(bottleneck_params_from_jax(
        host(variables["params"]), host(variables["batch_stats"])))
    tx = nhwc_to_port(x).requires_grad_(True)
    y = port(tx, train=train)
    y.square().sum().backward()
    close(port_to_nhwc(y), out)
    close_grad(port_to_nhwc(tx.grad), gx)
    grads = bottleneck_params_from_jax(host(gp), {})
    for name, p in port.named_parameters():
        close_grad(p.grad, grads[name])
    for name, v in bottleneck_params_from_jax({}, host(stats)).items():
        close(port.state_dict()[name], v)


def test_bottleneck_bf16_compute():
    x = np.random.RandomState(1).randn(N, H, W, C).astype(np.float32)
    jmod = jc.Bottleneck(in_channels=C, bottleneck_channels=MID,
                         out_channels=OUT, stride=2,
                         compute_dtype=jnp.bfloat16)
    variables = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x), train=True)
    want, _ = jmod.apply(variables, jnp.asarray(x), train=True,
                         mutable=["batch_stats"])
    port = tc.Bottleneck(C, MID, OUT, stride=2,
                         compute_dtype=torch.bfloat16, device="cpu")
    port.load_state_dict(bottleneck_params_from_jax(
        host(variables["params"]), host(variables["batch_stats"])))
    got = port(nhwc_to_port(x), train=True)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    rel = np.linalg.norm(port_to_nhwc(got) - want) / np.linalg.norm(want)
    assert rel < 1.56e-2, rel


def test_halo_exchange_without_a_group_pads_zeros():
    x = torch.randn(2, 3, 4, 5)
    h = tc.halo_exchange_1d(x, "cp")
    assert h.shape == (2, 3, 6, 5)
    assert torch.equal(h[:, :, 1:-1], x)
    assert bool((h[:, :, 0] == 0).all() and (h[:, :, -1] == 0).all())


# -- the spatial block in a world of 4 ---------------------------------------

CASES = [(stride, train) for stride in (1, 2) for train in (False, True)]


def _jax_spatial(variables, x, stride, train):
    mesh = jps.initialize_model_parallel(context_parallel_size=SP,
                                         devices=jax.devices()[:SP])
    mod = jc.SpatialBottleneck(in_channels=C, bottleneck_channels=MID,
                               out_channels=OUT, stride=stride)

    @jax.jit
    @functools.partial(shard_map, mesh=mesh, in_specs=(P(), P(None, "cp")),
                       out_specs=(P(None, "cp"), P()), check_vma=False)
    def run(variables, x):
        out, mut = mod.apply(variables, x, train=train,
                             mutable=["batch_stats"])
        return out, mut["batch_stats"]

    return run(variables, x)


@pytest.fixture(scope="module")
def spatial():
    """Per case: the JAX spatial block's output and statistics, the JAX
    unsharded block's gradients, the variables, and the port's ranks'
    results from one world of 4."""
    rs = np.random.RandomState(2)
    x = rs.randn(N, H, W, C).astype(np.float32)
    jax_out, port_cases = [], []
    for i, (stride, train) in enumerate(CASES):
        ref = jc.Bottleneck(in_channels=C, bottleneck_channels=MID,
                            out_channels=OUT, stride=stride)
        variables = perturbed(ref.init(jax.random.PRNGKey(i),
                                       jnp.asarray(x), train=True), 10 + i)
        out, stats = _jax_spatial(variables, jnp.asarray(x), stride, train)
        _, _, gp, gx = jax_block(ref, variables, jnp.asarray(x), train)
        jax_out.append(dict(out=np.asarray(out), stats=host(stats),
                            gp=host(gp), gx=np.asarray(gx)))
        port_cases.append(dict(
            channels=(C, MID, OUT), stride=stride, train=train, x=x,
            state=bottleneck_params_from_jax(
                host(variables["params"]), host(variables["batch_stats"]))))
    ranks = spawn(spatial_bottleneck_worker, SP, args=(port_cases, "cpu"),
                  timeout=240.0)
    return x, jax_out, ranks


def _rows(ranks, case, key):
    """The ranks' (N, C, H_local, W) arrays along H, as NHWC."""
    return np.concatenate([r[case][key] for r in ranks],
                          axis=2).transpose(0, 2, 3, 1)


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"stride{s}-{'train' if t else 'eval'}"
                              for s, t in CASES])
def test_spatial_bottleneck_matches_jax(spatial, case):
    x, jax_out, ranks = spatial
    want = jax_out[case]
    close(_rows(ranks, case, "out"), want["out"])
    close_grad(_rows(ranks, case, "dx"), want["gx"])  # through the halo
    grads = bottleneck_params_from_jax(want["gp"], {})
    for name in grads:
        close_grad(sum(r[case]["param_grads"][name] for r in ranks),
                   grads[name])
    stats = bottleneck_params_from_jax({}, want["stats"])
    for r in ranks:
        for name, v in r[case]["stats"].items():
            close(v, stats[name])
        # the port's own unsharded block, on rank 0's whole input
        assert r[case]["err_out"] <= 1e-4 + 1e-3 * r[case]["scale_out"]
        assert r[case]["err_dx"] <= 1e-4 + 1e-3 * r[case]["scale_dx"]
        assert r[case]["err_params"] < 1e-4
        assert r[case]["err_stats"] < 1e-5


def test_halo_rows_are_the_neighbours_rows(spatial):
    x, _, ranks = spatial
    h_local = H // SP
    for r, res in enumerate(ranks):
        top, bottom = (t.transpose(0, 2, 3, 1)[:, 0]
                       for t in res[0]["halo"])
        want_top = np.zeros_like(top) if r == 0 else x[:, r * h_local - 1]
        want_bottom = (np.zeros_like(bottom) if r == SP - 1
                       else x[:, (r + 1) * h_local])
        np.testing.assert_array_equal(top, want_top)
        np.testing.assert_array_equal(bottom, want_bottom)
