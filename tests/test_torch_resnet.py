"""apex_tpu_torch's ResNet slice against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through the JAX modules and
the port: softmax cross-entropy (loss and gradient), SyncBatchNorm at a
world of one (train and eval), a stride-2 'SAME' convolution, a tiny
ResNet of each block type (logits, loss, every gradient, the new
``batch_stats``), its bf16 logits, and whole ``bench.py``-style training
steps (loss, gradients, ``fused_sgd``). Weights go from JAX to the port
through ``models.convert.resnet_params_from_jax``.

Tolerances, fp32: FP32_TOL (1e-5 absolute and relative) for a single op,
the same arithmetic in another order; NET_TOL (atol 1e-4 of values of
order 1, rtol 1e-3) for a whole network, where XLA's and oneDNN's
convolutions sum over up to 1,152 terms in another order through 2-3
BatchNorms whose batch variance divides the gradients. bf16 logits: 1.56e-2
(the port's bf16 tolerance: activations rounded to bf16 at each layer, at
points that may differ).
"""

import json
import subprocess
import sys
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from apex_tpu.models import resnet as jresnet
from apex_tpu.ops.xentropy import softmax_cross_entropy_loss as jax_xent
from apex_tpu.optimizers import fused_sgd as jax_fused_sgd
from apex_tpu.parallel.sync_batch_norm import SyncBatchNorm as JaxSyncBN
from apex_tpu_torch import bench
from apex_tpu_torch.models import resnet
from apex_tpu_torch.models.convert import resnet_params_from_jax
from apex_tpu_torch.ops.xentropy import softmax_cross_entropy_loss
from apex_tpu_torch.optimizers import fused_sgd
from apex_tpu_torch.parallel import SyncBatchNorm

ROOT = Path(__file__).resolve().parent.parent
FP32_TOL = dict(atol=1e-5, rtol=1e-5)
NET_TOL = dict(atol=1e-4, rtol=1e-3)
BF16_TOL = 1.56e-2
BLOCKS = {"basic": (jresnet.BasicBlock, resnet.BasicBlock),
          "bottleneck": (jresnet.BottleneckBlock, resnet.BottleneckBlock)}


def close(got, want, **tol):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32), **tol)


def nhwc_to_port(x):
    """An NHWC numpy array as the port's channels-last NCHW tensor."""
    return torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_softmax_cross_entropy_matches_jax(smoothing, dtype):
    rs = np.random.RandomState(0)
    logits = (rs.randn(6, 5, 37) * 3).astype(np.float32)
    labels = rs.randint(0, 37, (6, 5))
    jl = jnp.asarray(logits).astype(dtype)

    def jloss(lg):
        return jnp.mean(jax_xent(lg, jnp.asarray(labels), smoothing))

    want, want_g = jax.value_and_grad(jloss)(jl)
    per_ex = jax_xent(jl, jnp.asarray(labels), smoothing)
    tl = torch.from_numpy(logits).to(getattr(torch, dtype)).requires_grad_()
    got = softmax_cross_entropy_loss(tl, torch.from_numpy(labels), smoothing)
    assert got.dtype == torch.float32 and got.shape == (6, 5)
    close(got.detach(), per_ex, **FP32_TOL)
    got.mean().backward()
    tol = FP32_TOL if dtype == "float32" else dict(atol=BF16_TOL, rtol=0)
    close(tl.grad, np.asarray(want_g, np.float32), **tol)
    close(got.mean(), float(want), **FP32_TOL)


@pytest.mark.parametrize("train", [True, False])
def test_sync_batch_norm_matches_flax(train):
    rs = np.random.RandomState(1)
    x = (rs.randn(4, 5, 6, 8) * 2 + 0.5).astype(np.float32)
    scale = (1 + 0.3 * rs.randn(8)).astype(np.float32)
    bias = (0.2 * rs.randn(8)).astype(np.float32)
    mean0 = (0.1 * rs.randn(8)).astype(np.float32)
    var0 = (1 + 0.5 * rs.rand(8)).astype(np.float32)
    jbn = JaxSyncBN(use_running_average=not train, momentum=0.1,
                    axis_names=())
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    want, mutated = jbn.apply(variables, jnp.asarray(x),
                              mutable=["batch_stats"])
    bn = SyncBatchNorm(8, momentum=0.1, device="cpu")
    bn.load_state_dict({"scale": torch.from_numpy(scale),
                        "bias": torch.from_numpy(bias),
                        "mean": torch.from_numpy(mean0),
                        "var": torch.from_numpy(var0)})
    got = bn(nhwc_to_port(x), use_running_average=not train)
    close(got.permute(0, 2, 3, 1), want, **FP32_TOL)
    close(bn.mean, mutated["batch_stats"]["mean"], **FP32_TOL)
    close(bn.var, mutated["batch_stats"]["var"], **FP32_TOL)
    if not train:
        assert torch.equal(bn.mean, torch.from_numpy(mean0))


def test_sync_batch_norm_refuses_a_group_of_two(monkeypatch):
    # a group of two is ported now (tests/test_torch_parallel_data.py
    # holds it to JAX over 2 and 4 ranks): the module keeps its group;
    # what it still refuses is a call with no use_running_average
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda g: 2)
    group = object()
    assert SyncBatchNorm(8, process_group=group,
                         device="cpu").process_group is group
    with pytest.raises(ValueError, match="use_running_average"):
        SyncBatchNorm(8, device="cpu")(torch.zeros(2, 8, 1, 1))


@pytest.mark.parametrize("size", [8, 9])
def test_stride2_same_padding_matches_flax(size):
    """flax pads a 3x3/2 'SAME' conv (0, 1) on an even map and (1, 1) on
    an odd one; the shapes agree either way, only the values tell."""
    assert resnet.same_padding(size, 3, 2) == ((0, 1) if size % 2 == 0
                                               else (1, 1))
    rs = np.random.RandomState(2)
    x = rs.randn(2, size, size, 4).astype(np.float32)
    kernel = rs.randn(3, 3, 4, 6).astype(np.float32)
    conv = fnn.Conv(6, (3, 3), (2, 2), use_bias=False)
    want = conv.apply({"params": {"kernel": kernel}}, jnp.asarray(x))
    port = resnet.Conv(4, 6, (3, 3), (2, 2), device="cpu")
    port.load_state_dict(resnet_params_from_jax({"kernel": kernel}, {}))
    got = port(nhwc_to_port(x))
    assert got.shape == (2, 6, -(-size // 2), -(-size // 2))
    close(got.permute(0, 2, 3, 1), want, **FP32_TOL)


def jax_model(block, **kw):
    return jresnet.ResNet(stage_sizes=[1, 2], block_cls=BLOCKS[block][0],
                          num_classes=10, num_filters=8, **kw)


def port_model(block, **kw):
    return resnet.ResNet([1, 2], BLOCKS[block][1], num_classes=10,
                         num_filters=8, device="cpu", **kw)


def random_variables(model, size, seed):
    """The JAX model's variables, with every BatchNorm scale and bias and
    the running statistics moved off their init (a zero scale would zero
    its branch's gradients)."""
    rs = np.random.RandomState(seed)
    variables = model.init(jax.random.PRNGKey(seed),
                           jnp.zeros((1, size, size, 3)))

    def perturb(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "scale":
            return 1 + 0.3 * rs.randn(*shape).astype(np.float32)
        if name in ("bias", "mean"):
            return 0.2 * rs.randn(*shape).astype(np.float32)
        if name == "var":
            return 1 + 0.5 * rs.rand(*shape).astype(np.float32)
        return np.asarray(leaf)

    return {k: jax.tree_util.tree_map_with_path(perturb, v)
            for k, v in variables.items()}


def inputs(size, seed=3, batch=4):
    rs = np.random.RandomState(seed)
    return (rs.randn(batch, size, size, 3).astype(np.float32),
            rs.randint(0, 10, (batch,)))


def load(model, variables):
    model.load_state_dict(resnet_params_from_jax(variables["params"],
                                                 variables["batch_stats"]))
    return model


@pytest.mark.parametrize("size", [32, 33])
@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_tiny_resnet_matches_jax(block, size):
    """fp32 logits, loss, every gradient and the new batch_stats of a
    training forward; the eval logits."""
    jm = jax_model(block)
    variables = random_variables(jm, size, seed=4)
    x, labels = inputs(size)

    def loss_fn(p):
        logits, mutated = jm.apply(
            {"params": p, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jresnet.cross_entropy_loss(logits, jnp.asarray(labels)), (
            logits, mutated["batch_stats"])

    (want_loss, (want_logits, want_bs)), want_g = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    pm = load(port_model(block), variables)
    logits = pm(torch.from_numpy(x), train=True)
    assert logits.dtype == torch.float32 and logits.shape == (4, 10)
    loss = resnet.cross_entropy_loss(logits, torch.from_numpy(labels))
    loss.backward()
    close(logits, want_logits, **NET_TOL)
    close(loss, float(want_loss), **NET_TOL)
    grads = resnet_params_from_jax(jax.tree_util.tree_map(np.asarray, want_g),
                                   {})
    named = dict(pm.named_parameters())
    assert set(grads) == set(named)
    for name, g in grads.items():
        close(named[name].grad, g, err_msg=name, **NET_TOL)
    stats = resnet_params_from_jax({}, jax.tree_util.tree_map(np.asarray,
                                                              want_bs))
    buffers = dict(pm.named_buffers())
    assert set(stats) == set(buffers)
    for name, v in stats.items():
        close(buffers[name], v, err_msg=name, **NET_TOL)
    want_eval = jm.apply(variables, jnp.asarray(x))
    pm_eval = load(port_model(block), variables)
    with torch.no_grad():
        close(pm_eval(torch.from_numpy(x)), want_eval, **NET_TOL)


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_tiny_resnet_bf16_logits_match_jax(block):
    jm = jax_model(block, dtype=jnp.bfloat16)
    variables = random_variables(jm, 32, seed=5)
    x, _ = inputs(32, seed=6)
    pm = load(port_model(block, dtype=torch.bfloat16), variables)
    assert all(p.dtype == torch.float32 for p in pm.parameters())
    for train in (False, True):  # a training forward updates the stats
        want, _ = jm.apply(variables, jnp.asarray(x), train=train,
                           mutable=["batch_stats"])
        with torch.no_grad():
            got = pm(torch.from_numpy(x), train=train)
        assert got.dtype == torch.float32
        close(got, want, atol=BF16_TOL, rtol=BF16_TOL)


def test_resnet50_layout_matches_flax():
    """ResNet-50's parameter and statistic names and shapes against the
    JAX model's, through the converter (no forward at 224^2 here)."""
    jm = jresnet.ResNet50(num_classes=1000)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                   shapes)
    want = resnet_params_from_jax(zeros["params"], zeros["batch_stats"])
    pm = resnet.ResNet50(num_classes=1000, device="cpu")
    got = pm.state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert sum(p.numel() for p in pm.parameters()) == 25_557_032
    # the last BatchNorm of every block starts at a zero scale
    assert all(float(got[f"BottleneckBlock_{i}.SyncBatchNorm_2.scale"]
                     .abs().sum()) == 0 for i in range(16))


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_bench_steps_match_jax(block):
    """Two ``bench.py`` training steps (the first takes the momentum
    buffer's bootstrap): loss, the updated parameters and batch_stats, and
    the momentum buffers, against JAX's ``loss_fn``, ``fused_sgd`` and
    ``optax.apply_updates``."""
    jm = jax_model(block)
    variables = random_variables(jm, 32, seed=7)
    x, labels = inputs(32, seed=8)
    params, batch_stats = variables["params"], variables["batch_stats"]
    opt = jax_fused_sgd(**bench.SGD)
    opt_state = opt.init(params)

    def loss_fn(p, bs):
        logits, mutated = jm.apply({"params": p, "batch_stats": bs},
                                   jnp.asarray(x), train=True,
                                   mutable=["batch_stats"])
        return jresnet.cross_entropy_loss(logits, jnp.asarray(labels)), \
            mutated["batch_stats"]

    pm = load(port_model(block), variables)
    step = bench.train_step(pm, fused_sgd(**bench.SGD), torch.from_numpy(x),
                            torch.from_numpy(labels))
    for _ in range(2):
        (want_loss, batch_stats), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params, batch_stats)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        close(step(), float(want_loss), **NET_TOL)
        want = resnet_params_from_jax(
            jax.tree_util.tree_map(np.asarray, params),
            jax.tree_util.tree_map(np.asarray, batch_stats))
        got = pm.state_dict()
        for name, v in want.items():
            close(got[name], v, err_msg=name, **NET_TOL)


def test_bench_cli_runs_on_the_cpu():
    res = subprocess.run(
        [sys.executable, "-m", "apex_tpu_torch.bench", "--model", "resnet18",
         "--image-size", "32", "--batch", "8", "--device", "cpu",
         "--warmup", "1", "--steps", "2"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    rec = json.loads(res.stdout.strip().splitlines()[-1])
    assert rec["device"] == "cpu" and rec["batch"] == 8
    assert rec["O0"]["tf32"] is False
    for mode in ("O2", "O0"):
        assert rec[mode]["imgs_per_s"] > 0 and len(rec[mode]["losses"]) == 3
    assert rec["o2_over_o0"] == rec["O2"]["imgs_per_s"] / \
        rec["O0"]["imgs_per_s"]
