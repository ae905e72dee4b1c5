"""apex_tpu_torch's FP8 delayed scaling (``amp.fp8``) against the JAX
package's ``apex_tpu.amp.fp8`` and its example.

Same seeded numpy inputs through JAX on the CPU and through the port.
Checked:

- the fp8 dtypes; ``quantize``'s bits equal to JAX's (both formats,
  several scales, saturated and subnormal values), no inf past the
  format's range; the round trip's error within the format's epsilon;
- the state machine against JAX's, exactly: the window max, the margin,
  the zero window, and the history's order;
- ``fp8_dense``: the delayed semantics (the first call at scale 1
  saturates, the second recovers), its output, its returned states
  (exactly) and its gradients against JAX's, output and gradients 1e-6
  relative in norm (the same dequantized operands, fp32 products summed
  in another order), and the e4m3 rounding of the gradient through the
  cast (x's gradient 1.03125 at scale 3, not 1.0), equal to JAX's;
- the amax synced over a world of 4 gloo ranks (tp 2 x dp 2) against
  JAX's ``pmax`` under ``shard_map``: every rank's state carries the
  global max;
- the example (``examples.fp8.train_fp8_mlp``) against the JAX example's
  loop from the same weights and data for 8 steps: the losses rtol 1e-5;
  every parameter after every step atol 1e-6, about 8 ulps of an O(1)
  weight and 3e-4 of a step of lr 3e-3 (the update is
  ``torch.optim.Adam`` against ``optax.adam``: the same formula with eps
  outside the root, rounded in another order; 2.4e-7 measured); the fp8
  forward from JAX's weights and states after every step against JAX's
  eager forward 1e-6 relative in norm; the ``qerr`` column against the
  JAX example's rtol 0.1 (that example's forward is compiled, and XLA's
  compiled forward rounds its fp8 casts otherwise: up to 1.4e-2 apart
  from JAX's own eager forward in the output, 4.4% of qerr measured);
  and its own 60 steps at the defaults on
  the CPU: the loss falls, the demo's saturated error above its
  recovered one.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from apex_tpu.amp import fp8 as jfp8
from apex_tpu.compat import shard_map
from apex_tpu.parallel import parallel_state as jps
from apex_tpu_torch import amp
from apex_tpu_torch.amp import fp8
from apex_tpu_torch.examples.fp8 import train_fp8_mlp as example
from apex_tpu_torch.transformer.testing.distributed_test_base import spawn
from apex_tpu_torch.transformer.testing.recompute_workers import jobs_worker

WORLD = 4
_JAX_EXAMPLE = os.path.join(os.path.dirname(__file__), os.pardir, "examples",
                            "fp8", "train_fp8_mlp.py")


def _rel(got, want):
    return float(np.linalg.norm(np.asarray(got) - want)
                 / max(np.linalg.norm(want), 1e-30))


def _cpu_state(n=4):
    return fp8.init_fp8_state(n, "cpu")


def test_fp8_dtypes_and_exports():
    x = torch.linspace(-2.0, 2.0, 64)
    assert fp8.quantize(x, torch.tensor(1.0), "e4m3").dtype == \
        torch.float8_e4m3fn
    assert fp8.quantize(x, torch.tensor(1.0), "e5m2").dtype == \
        torch.float8_e5m2
    assert fp8.FP8_MAX == jfp8.FP8_MAX
    for name in ("Fp8TensorState", "fp8_dense", "init_fp8_state",
                 "update_fp8_state"):
        assert getattr(amp, name) is getattr(fp8, name)


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_quantize_bits_match_jax(fmt):
    rs = np.random.RandomState(0)
    x = np.concatenate([rs.randn(4096) * 100, rs.randn(256) * 1e-5,
                        [1e6, -1e6, 0.0, -0.0, 447.9, 448.1, 57344.0,
                         -60000.0]]).astype(np.float32)
    for scale in (1.0, 3.0, 0.37, 448.0 / 91.3, 2.0 ** -7):
        jq = jfp8.quantize(jnp.asarray(x), jnp.float32(scale), fmt)
        got = fp8.quantize(torch.from_numpy(x), torch.tensor(scale), fmt)
        np.testing.assert_array_equal(got.view(torch.uint8).numpy(),
                                      np.asarray(jq).view(np.uint8))
        back = fp8.dequantize(got, torch.tensor(scale))
        assert bool(torch.isfinite(back).all())
        np.testing.assert_array_equal(
            back.numpy(), np.asarray(jfp8.dequantize(jq, jnp.float32(scale))))


def test_saturation_not_inf():
    x = torch.tensor([1e6, -1e6, 3.0])
    out = fp8.dequantize(fp8.quantize(x, torch.tensor(1.0), "e4m3"),
                         torch.tensor(1.0))
    assert bool(torch.isfinite(out).all())
    assert out[:2].tolist() == [448.0, -448.0]


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_roundtrip_error_bounded(fmt):
    x = torch.from_numpy(np.random.RandomState(1).randn(512)
                         .astype(np.float32))
    scale = fp8.FP8_MAX[fmt] / x.abs().max()
    err = (fp8.dequantize(fp8.quantize(x, scale, fmt), scale) - x).abs()
    eps = 2.0 ** (-3 if fmt == "e4m3" else -2)
    assert bool((err <= eps * x.abs() + 1e-7).all())


def _same_state(got, want):
    np.testing.assert_array_equal(got.amax_history.numpy(),
                                  np.asarray(want.amax_history))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))


def test_state_machine_matches_jax_exactly():
    s, j = _cpu_state(4), jfp8.init_fp8_state(4)
    for amax, fmt, margin in ((2.0, "e4m3", 0), (8.0, "e4m3", 0),
                              (1.0, "e4m3", 0), (1.0, "e4m3", 1),
                              (3.3, "e5m2", 0), (1.0, "e4m3", 0),
                              (0.7, "e4m3", 2), (1.0, "e5m2", 0)):
        s = fp8.update_fp8_state(s, amax, fmt, margin)
        j = jfp8.update_fp8_state(j, amax, fmt, margin)
        _same_state(s, j)


def test_scale_tracks_window_max_margin_and_zero_window():
    s = fp8.update_fp8_state(_cpu_state(4), 2.0, "e4m3")
    assert float(s.scale) == 448.0 / 2.0
    s = fp8.update_fp8_state(s, 8.0, "e4m3")
    assert float(s.scale) == 448.0 / 8.0
    for _ in range(3):  # the spike stays inside the window
        s = fp8.update_fp8_state(s, 1.0, "e4m3")
        assert float(s.scale) == 448.0 / 8.0
    s = fp8.update_fp8_state(s, 1.0, "e4m3")  # and ages out
    assert float(s.scale) == 448.0
    s = fp8.update_fp8_state(_cpu_state(4), 2.0, "e4m3", margin=1)
    assert float(s.scale) == 448.0 / 2.0 / 2.0
    s = fp8.update_fp8_state(_cpu_state(4), 0.0, "e4m3")
    assert float(s.scale) == 1.0


def test_delayed_semantics():
    rs = np.random.RandomState(2)
    x = torch.from_numpy((rs.randn(8, 16) * 1000).astype(np.float32))
    w = torch.from_numpy(rs.randn(16, 4).astype(np.float32))
    ref = x @ w
    sx, sw = _cpu_state(), _cpu_state()
    y1, (sx, sw) = fp8.fp8_dense(x, w, sx, sw)
    err1 = float((y1 - ref).abs().max() / ref.abs().max())
    y2, _ = fp8.fp8_dense(x, w, sx, sw)
    err2 = float((y2 - ref).abs().max() / ref.abs().max())
    assert err2 < err1 * 0.2 and err2 < 0.1, (err1, err2)


def _jax_state(s):
    return jfp8.Fp8TensorState(jnp.asarray(s.amax_history.numpy()),
                               jnp.asarray(s.scale.numpy()))


@pytest.mark.parametrize("fmt,margin", [("e4m3", 0), ("e5m2", 1)])
def test_fp8_dense_values_states_and_gradients_match_jax(fmt, margin):
    rs = np.random.RandomState(3)
    x = (rs.randn(32, 24) * 30).astype(np.float32)
    w = rs.randn(24, 16).astype(np.float32)
    b = rs.randn(16).astype(np.float32)
    dy = rs.randn(32, 16).astype(np.float32)
    sx = fp8.update_fp8_state(_cpu_state(), 70.0, fmt)
    sw = fp8.update_fp8_state(_cpu_state(), 2.5, fmt)

    def jrun(x_, w_, b_):
        return jfp8.fp8_dense(x_, w_, _jax_state(sx), _jax_state(sw), bias=b_,
                              fmt=fmt, margin=margin)

    jy, (jsx, jsw) = jrun(x, w, b)
    _, vjp = jax.vjp(lambda *a: jrun(*a)[0], x, w, b)
    jgrads = vjp(jnp.asarray(dy))
    ts = [torch.tensor(a, requires_grad=True) for a in (x, w, b)]
    y, (nsx, nsw) = fp8.fp8_dense(*ts[:2], sx, sw, bias=ts[2], fmt=fmt,
                                  margin=margin)
    grads = torch.autograd.grad(y, ts, torch.from_numpy(dy))
    assert _rel(y.detach().numpy(), np.asarray(jy)) < 1e-6
    _same_state(nsx, jsx)
    _same_state(nsw, jsw)
    for g, jg in zip(grads, jgrads):
        assert _rel(g.numpy(), np.asarray(jg)) < 1e-6


def test_gradient_rounds_through_e4m3_as_jax():
    sx = fp8.Fp8TensorState(torch.zeros(4), torch.tensor(3.0))
    x = torch.ones(2, 2, requires_grad=True)
    y, _ = fp8.fp8_dense(x, torch.eye(2), sx, _cpu_state())
    y.sum().backward()
    jsx = jfp8.Fp8TensorState(jnp.zeros(4), jnp.float32(3.0))
    jg = jax.grad(lambda a: jfp8.fp8_dense(a, jnp.eye(2), jsx,
                                           jfp8.init_fp8_state(4))[0].sum())(
        jnp.ones((2, 2)))
    assert x.grad.tolist() == [[1.03125, 1.03125], [1.03125, 1.03125]]
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(jg))


def test_amax_synced_over_a_gloo_world():
    rs = np.random.RandomState(4)
    x = rs.randn(8, 16).astype(np.float32)
    x[0, 0] = 37.0  # one rank's shard holds the global max
    w = rs.randn(16, 4).astype(np.float32)
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]).reshape(2, 1, 1, 2),
                jps.AXIS_ORDER)
    jps.initialize_model_parallel(tensor_model_parallel_size=2,
                                  devices=jax.devices()[:WORLD])
    try:
        @jax.jit
        @functools.partial(shard_map, mesh=mesh,
                           in_specs=(P(("dp", "tp")), P()),
                           out_specs=P(("dp", "tp")), check_vma=False)
        def run(x_, w_):
            _, (sx, _) = jfp8.fp8_dense(x_, w_, jfp8.init_fp8_state(4),
                                        jfp8.init_fp8_state(4))
            return sx.amax_history[:1][None]

        want = np.asarray(run(x, w))[:, 0]
    finally:
        jps.destroy_model_parallel()
    shards = np.split(x, WORLD)  # rank r = (d, t): shard 2 d + t
    ranks = spawn(jobs_worker, WORLD, args=([
        ("amax_worker", (shards, w, 2))],), timeout=120.0)
    for r, (got,) in enumerate(ranks):
        assert got["x_amax"] == want[r] == 37.0, r
        assert got["w_amax"] == float(np.abs(w).max())


def _load_jax_example():
    spec = importlib.util.spec_from_file_location("jax_fp8_example",
                                                  _JAX_EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_trajectory_matches_the_jax_example():
    jex = _load_jax_example()
    steps, history, lr = 8, 8, 3e-3
    key = jax.random.PRNGKey(0)
    dims = [32, 128, 128, 1]
    params = jex.make_params(key, dims)
    kx, _ = jax.random.split(jax.random.fold_in(key, 99))
    x = jax.random.normal(kx, (256, dims[0]))
    y = jnp.sum(jnp.sin(x), axis=-1, keepdims=True)
    states = [(jfp8.init_fp8_state(history), jfp8.init_fp8_state(history))
              for _ in params]
    opt = optax.adam(lr)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, states, opt_state):
        def loss_fn(p):
            out, new = jex.forward(p, states, x)
            return jnp.mean((out - y) ** 2), new

        (loss, new), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        q_out, _ = jex.forward(params, new, x)
        f_out, _ = jex.forward(params, None, x, use_fp8=False)
        qerr = jnp.max(jnp.abs(q_out - f_out)) / (jnp.max(jnp.abs(f_out))
                                                   + 1e-9)
        return params, new, opt_state, loss, qerr

    want, jparams = [], []
    p, s, o = params, states, opt_state
    for _ in range(steps):
        p, s, o, loss, qerr = step(p, s, o)
        want.append((float(loss), float(qerr)))
        jparams.append((p, s))
    args = example.parse_args(["--device", "cpu", "--steps", str(steps)])
    seen = []
    got = example.train(
        args, params=[jax.tree_util.tree_map(np.asarray, layer)
                      for layer in params],
        data=(np.asarray(x), np.asarray(y)), log=lambda *a: None,
        hook=lambda i, p_, s_: seen.append(
            [{k: t.detach().clone() for k, t in layer.items()}
             for layer in p_]))
    np.testing.assert_allclose([r["loss"] for r in got],
                               [w[0] for w in want], rtol=1e-5)
    # Adam against optax.adam: every parameter after every step
    worst = 0.0
    for mine, (theirs, _) in zip(seen, jparams):
        for a, b in zip(mine, theirs):
            for k in ("w", "b"):
                worst = max(worst, float(np.abs(a[k].numpy()
                                                - np.asarray(b[k])).max()))
    assert worst < 1e-6
    # qerr from JAX's weights and states: the port's forward against JAX's
    # forward run eagerly (XLA's compiled forward, the example's, rounds
    # its fp8 casts otherwise: up to 1.4e-2 apart in the output)
    xt = torch.from_numpy(np.array(x))
    for p_, s_ in jparams:
        tp = [{k: torch.from_numpy(np.array(v)) for k, v in layer.items()}
              for layer in p_]
        ts = [tuple(fp8.Fp8TensorState(torch.from_numpy(np.array(
            st.amax_history)), torch.from_numpy(np.array(st.scale)))
            for st in pair) for pair in s_]
        q_out, _ = example.forward(tp, ts, xt)
        assert _rel(q_out.numpy(), np.asarray(jex.forward(p_, s_, x)[0])) \
            < 1e-6
    # the column along each run, against the compiled JAX example's
    np.testing.assert_allclose([r["qerr"] for r in got],
                               [w[1] for w in want], rtol=0.1)


def test_example_runs_at_its_defaults_on_the_cpu():
    lines = []
    records = example.train(example.parse_args(["--device", "cpu"]),
                            log=lines.append)
    assert len(records) == 60
    assert records[-1]["loss"] < records[0]["loss"]
    demo = lines[0]
    assert demo.startswith("[demo] rel err at scale 1 (saturated)")
    saturated, recovered = (float(t.rstrip(";")) for t in
                            (demo.split()[7], demo.split()[-1]))
    assert recovered < 0.2 * saturated
    assert all(r["qerr"] < 0.2 for r in records)


def test_example_refuses_a_host_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.train(example.parse_args([]), log=lambda *a: None)
