"""apex_tpu_torch's amp front end against the JAX package's: the opt
levels and ``initialize``, the keep-fp32 rule on ResNet-50 and the DCGAN
nets, the scaler's free functions, ``AmpOptimizer`` (several losses,
skips, the sentinel, state_dict), ``fp16_utils``, and the ``mlp``,
``fused_dense`` and ``normalization`` modules, forward and backward.

Inputs are numpy arrays from a seed; the JAX side runs on the CPU (the
norms in Pallas interpret mode where the JAX op dispatches there).
Tolerances: the policy fields, scales, skip flags and dtypes are exact;
fp32 values 1e-5 relative (the same operations summed in another
order); bf16 values 2e-2 (one bf16 rounding at different points).
"""

import importlib
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu_torch import amp
from apex_tpu_torch.models import convert
from apex_tpu_torch.optimizers import fused_adam

ROOT = Path(__file__).resolve().parent.parent
JDT = {jnp.dtype(jnp.float32): torch.float32,
       jnp.dtype(jnp.bfloat16): torch.bfloat16,
       jnp.dtype(jnp.float16): torch.float16}
HALVES = [(jnp.bfloat16, torch.bfloat16), (jnp.float16, torch.float16)]
FP32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _tdt(jdt):
    return None if jdt is None else JDT[jnp.dtype(jdt)]


def load_jax_example(rel):
    """A JAX example script as a module (``examples/`` is no package)."""
    spec = importlib.util.spec_from_file_location(
        "jax_example_" + rel.replace("/", "_")[:-3], ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def flat_paths(tree, prefix=""):
    """{dotted path: leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_paths(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


# -- the opt levels ---------------------------------------------------------

@pytest.mark.parametrize("level", ["O0", "O1", "O2", "O3"])
@pytest.mark.parametrize("halves", HALVES, ids=["bf16", "fp16"])
def test_policy_fields_match_jax(level, halves):
    jh, th = halves
    jp, tp = jamp.opt_levels[level](jh), amp.opt_levels[level](th)
    for f in ("opt_level", "enabled", "keep_batchnorm_fp32",
              "master_weights", "loss_scale", "patch_functions"):
        assert getattr(tp, f) == getattr(jp, f), f
    assert tp.cast_model_type == _tdt(jp.cast_model_type)
    assert tp.compute_dtype == _tdt(jp.compute_dtype)
    assert tp.make_scaler().dynamic == jp.make_scaler().dynamic


def test_initialize_levels_overrides_and_refusal():
    p = {"w": torch.ones(2, 2), "ln.weight": torch.ones(2),
         "final_norm.weight": torch.ones(2),
         "step": torch.zeros((), dtype=torch.int32)}
    cast, opt, policy = amp.initialize(p, fused_adam(), "O2")
    assert cast["w"].dtype == torch.bfloat16
    assert cast["final_norm.weight"].dtype == torch.float32
    assert cast["ln.weight"].dtype == torch.bfloat16  # JAX has no "ln" token
    assert cast["step"].dtype == torch.int32 and opt.num_losses == 1
    assert p["w"].dtype == torch.float32  # a dict comes back as a new one
    cast, _, policy = amp.initialize(p, None, "O3", torch.float16)
    assert {t.dtype for t in cast.values()} == {torch.float16, torch.int32}
    _, opt, policy = amp.initialize(None, fused_adam(), "O2", torch.float16,
                                    num_losses=3, loss_scale=128.0,
                                    master_weights=False)
    assert policy.loss_scale == 128.0 and not policy.master_weights
    assert opt.num_losses == 3 and not opt.scaler.dynamic
    with pytest.raises(ValueError, match="Unexpected optimization level"):
        amp.initialize(p, None, "O4")


def test_cast_inputs_outputs_pass_non_floats():
    policy = amp.O2(torch.bfloat16)
    tree = {"x": torch.ones(2), "i": torch.ones(2, dtype=torch.int64),
            "s": "batch_stats", "n": None, "k": 3,
            "t": (torch.ones(1), [torch.ones(1, dtype=torch.float16)])}
    out = policy.cast_inputs(tree)
    assert out["x"].dtype == torch.bfloat16
    assert out["i"].dtype == torch.int64
    assert out["s"] == "batch_stats" and out["n"] is None and out["k"] == 3
    assert out["t"][0].dtype == torch.bfloat16
    assert out["t"][1][0].dtype == torch.bfloat16
    assert policy.cast_outputs(out)["x"].dtype == torch.float32
    assert amp.O0().cast_inputs(tree) is tree


def _jax_kept(params, level="O2"):
    """The dotted paths JAX's policy keeps fp32."""
    zeros = jax.tree_util.tree_map(lambda s: jnp.zeros((1,), jnp.float32),
                                   params)
    cast = jamp.opt_levels[level](jnp.bfloat16).cast_params(zeros)
    return {k for k, v in flat_paths(cast).items() if v.dtype == jnp.float32}


def _port_kept(module, level="O2"):
    amp.initialize(module, None, level)
    named = list(module.named_parameters()) + list(module.named_buffers())
    return {n for n, t in named if t.dtype == torch.float32}


def _kernel_to_weight(paths):
    return {p[:-len("kernel")] + "weight" if p.endswith(".kernel") else p
            for p in paths}


def test_o2_keeps_the_same_tensors_fp32_on_resnet50():
    """Under ``models/convert``'s name map (kernel -> weight; the
    batch_stats tree's leaves are the BatchNorm buffers, which JAX never
    casts), the port keeps fp32 exactly the tensors JAX keeps."""
    from apex_tpu.models import ResNet50 as JaxResNet50
    from apex_tpu_torch.models.resnet import ResNet50

    shapes = jax.eval_shape(JaxResNet50(num_classes=1000).init,
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3), jnp.float32))
    want = _kernel_to_weight(_jax_kept(shapes["params"]))
    want |= set(flat_paths(shapes["batch_stats"]))
    got = _port_kept(ResNet50(num_classes=1000, device="cpu"))
    assert got == want
    assert len(got) == 4 * 53  # 53 BatchNorms: scale, bias, mean, var


def test_o2_keeps_the_same_tensors_fp32_on_the_dcgan_nets():
    from apex_tpu_torch.examples.dcgan.main_amp import build_models

    jex = load_jax_example("examples/dcgan/main_amp.py")
    jg, jd = jex.build_models(32, 100)
    gshapes = jax.eval_shape(jg.init, jax.random.PRNGKey(0),
                             jnp.zeros((2, 100)))["params"]
    dshapes = jax.eval_shape(jd.init, jax.random.PRNGKey(0),
                             jnp.zeros((2, 32, 32, 3)))["params"]
    g, d = build_models(32, 100, device="cpu")
    for shapes, module in ((gshapes, g), (dshapes, d)):
        want = _kernel_to_weight(_jax_kept(shapes))
        got = _port_kept(module)
        assert got == want
        assert set(dict(module.named_parameters())) == _kernel_to_weight(
            set(flat_paths(shapes)))
    assert len(_port_kept(g)) == 6  # three GroupNorms' scale and bias


def test_keep_fp32_predicate_reads_torch_names():
    pred = amp.policy.default_keep_fp32_predicate
    for name in ("bn1.weight", "layer1.0.bn2.bias", "ln_f.norm.weight",
                 "norm.weight", "GroupNorm_0.scale", "bn1.running_mean",
                 "bn1.running_var", "batch_stats.x"):
        assert pred(name), name
    for name in ("conv1.weight", "fc.bias", "head.weight"):
        assert not pred(name), name
    from collections import OrderedDict

    bn = torch.nn.BatchNorm1d(3)
    model = torch.nn.Sequential(OrderedDict(fc=torch.nn.Linear(3, 3), bn=bn))
    amp.initialize(model, None, "O2", torch.float16)
    assert model.fc.weight.dtype == torch.float16
    assert bn.weight.dtype == bn.running_mean.dtype == torch.float32
    assert bn.num_batches_tracked.dtype == torch.int64


# -- the scaler's free functions --------------------------------------------

def test_scale_loss_and_unscale_grads_match_jax():
    rs = np.random.RandomState(1)
    g = {"a": rs.randn(3, 4).astype(np.float32),
         "b": rs.randn(5).astype(np.float32)}
    js = jamp.LossScaler().init()
    ts = amp.LossScaler().init("cpu")
    assert float(amp.scale_loss(torch.tensor(1.5), ts)) == \
        float(jamp.scale_loss(jnp.float32(1.5), js))
    jg, jinf = jamp.unscale_grads({k: jnp.asarray(v) for k, v in g.items()},
                                  js)
    tg, tinf = amp.unscale_grads({k: torch.from_numpy(v)
                                  for k, v in g.items()}, ts)
    for k in g:
        np.testing.assert_array_equal(tg[k].numpy(), np.asarray(jg[k]))
    assert bool(tinf) is bool(jinf) is False
    g["b"][2] = np.inf
    _, tinf = amp.unscale_grads({k: torch.from_numpy(v)
                                 for k, v in g.items()}, ts)
    assert bool(tinf)


# -- AmpOptimizer -------------------------------------------------------------

def _jax_and_port_amp(level, half, num_losses=1, lr=1e-2):
    jh, th = half
    _, jopt, _ = jamp.initialize(None, __import__(
        "apex_tpu.optimizers", fromlist=["fused_adam"]).fused_adam(lr=lr),
        level, jh, num_losses)
    _, topt, _ = amp.initialize(None, fused_adam(lr=lr), level, th,
                                num_losses)
    return jopt, topt


def test_step_unscaled_advances_each_scaler_on_its_own_flag():
    """Three losses; loss 0 overflows, loss 2 is clean, loss 1 did not
    contribute: the step is skipped, scaler 0 halves, scaler 2 counts a
    clean step, scaler 1 stays as it was, as JAX's."""
    jopt, topt = _jax_and_port_amp("O2", HALVES[1], num_losses=3)
    p = np.ones((4,), np.float32)
    jstate = jopt.init({"w": jnp.asarray(p).astype(jnp.float16)})
    tp = {"w": torch.from_numpy(p).half()}
    tstate = topt.init(tp)
    g = {"w": jnp.full((4,), 0.5, jnp.float32)}
    jp2, jstate, jinfo = jopt.step_unscaled(
        g, jstate, {"w": jnp.asarray(p).astype(jnp.float16)},
        {0: jnp.asarray(True), 2: jnp.asarray(False)})
    _, tstate, tinfo = topt.step_unscaled(
        {"w": torch.full((4,), 0.5)}, tstate, tp,
        {0: torch.tensor(True), 2: torch.tensor(False)})
    assert bool(tinfo["skipped"]) and bool(jinfo["skipped"])
    for i in range(3):
        assert float(tstate.scaler[i].scale) == float(jstate.scaler[i].scale)
        assert int(tstate.scaler[i].growth_tracker) == \
            int(jstate.scaler[i].growth_tracker)
    assert [float(s.scale) for s in tstate.scaler] == [32768.0, 65536.0,
                                                       65536.0]
    assert float(tinfo["loss_scale"]) == 32768.0
    torch.testing.assert_close(tp["w"], torch.ones(4).half(), rtol=0, atol=0)
    with pytest.raises(ValueError, match="invalid"):
        topt.step_unscaled({"w": torch.ones(4)}, tstate, tp,
                           {3: torch.tensor(False)})
    with pytest.raises(ValueError, match="out of range"):
        topt.scale_loss(torch.tensor(1.0), tstate, loss_id=5)


def test_sentinel_gates_without_touching_the_scaler():
    from apex_tpu.resilience.sentinel import AnomalySentinel as JaxSentinel
    from apex_tpu_torch.resilience.sentinel import AnomalySentinel

    jopt, topt = _jax_and_port_amp("O2", HALVES[0])
    jsent, tsent = JaxSentinel(), AnomalySentinel()
    p = np.ones((4,), np.float32)
    jp = {"w": jnp.asarray(p).astype(jnp.bfloat16)}
    tp = {"w": torch.from_numpy(p).bfloat16()}
    jstate, tstate = jopt.init(jp), topt.init(tp)
    jss, tss = jsent.init(), tsent.init("cpu")
    g = np.full((4,), 0.25, np.float32)
    for loss in (1.0, float("nan")):
        jp, jstate, jinfo = jopt.step(
            {"w": jnp.asarray(g).astype(jnp.bfloat16)}, jstate, jp,
            sentinel=jsent, sentinel_state=jss, unscaled_loss=loss)
        tp, tstate, tinfo = topt.step(
            {"w": torch.from_numpy(g).bfloat16()}, tstate, tp,
            sentinel=tsent, sentinel_state=tss, unscaled_loss=loss,
            collect_metrics=True)
        jss, tss = jinfo["sentinel_state"], tinfo["sentinel_state"]
        assert int(tinfo["verdict"]) == int(jinfo["verdict"])
        assert bool(tinfo["skipped"]) == bool(jinfo["skipped"])
        assert not bool(tinfo["found_inf"])
        np.testing.assert_allclose(tp["w"].float().numpy(),
                                   np.asarray(jp["w"], np.float32), **BF16)
        np.testing.assert_allclose(tstate.master["w"].numpy(),
                                   np.asarray(jstate.master["w"]), **FP32)
    assert int(tstate.scaler.skipped) == 0  # a spike is not an overflow
    np.testing.assert_allclose(float(tinfo["grad_norm"]), 0.5, rtol=1e-6)
    fields = amp.AmpOptimizer.journal_fields(tinfo)
    assert fields["skipped"] is True and fields["found_inf"] is False
    assert fields["loss_scale"] == 1.0 and isinstance(fields["verdict"], int)
    with pytest.raises(ValueError, match="sentinel wiring"):
        topt.step({"w": torch.ones(4).bfloat16()}, tstate, tp,
                  sentinel=tsent)


def test_state_dict_round_trips_and_refuses_across_num_losses():
    jopt, topt = _jax_and_port_amp("O2", HALVES[1], num_losses=2)
    p = np.ones((4,), np.float32)
    jp = {"w": jnp.asarray(p).astype(jnp.float16)}
    tp = {"w": torch.from_numpy(p).half()}
    jstate, tstate = jopt.init(jp), topt.init(tp)
    g = {"w": np.full((4,), np.inf, np.float32)}
    jp, jstate, _ = jopt.step_unscaled({"w": jnp.asarray(g["w"])}, jstate,
                                       jp, {1: jnp.asarray(True)})
    tp, tstate, _ = topt.step_unscaled({"w": torch.from_numpy(g["w"])},
                                       tstate, tp, {1: torch.tensor(True)})
    d = topt.state_dict(tstate)
    assert d == jopt.state_dict(jstate)
    fresh = topt.init(tp)
    back = topt.load_state_dict(fresh, d)
    assert topt.state_dict(back) == d
    _, single = _jax_and_port_amp("O2", HALVES[1], num_losses=1)
    with pytest.raises(ValueError, match="2 scalers"):
        single.load_state_dict(single.init(tp), d)
    with pytest.raises(ValueError, match="single-scaler"):
        topt.load_state_dict(fresh, single.state_dict(single.init(tp)))
    assert amp.master_params(tstate) is tstate.master


def test_module_loop_writes_in_place_and_masters_stay_fp32():
    model = torch.nn.Linear(4, 2)
    model, opt, _ = amp.initialize(model, fused_adam(lr=0.1), "O2",
                                   torch.bfloat16)
    params = dict(model.named_parameters())
    state = opt.init(model)
    before = model.weight.detach().clone()
    x = torch.randn(3, 4)
    loss = model(x.bfloat16()).float().square().mean()
    grads = torch.autograd.grad(opt.scale_loss(loss, state),
                                list(params.values()))
    out, state, info = opt.step(dict(zip(params, grads)), state, params)
    assert out["weight"] is model.weight
    assert model.weight.dtype == torch.bfloat16
    assert state.master["weight"].dtype == torch.float32
    assert not torch.equal(model.weight, before)
    torch.testing.assert_close(model.weight, state.master["weight"].bfloat16(),
                               rtol=0, atol=0)


# -- fp16_utils ---------------------------------------------------------------

def test_fp16util_conversions_match_jax():
    from apex_tpu import fp16_utils as jfu
    from apex_tpu_torch import fp16_utils as tfu

    tree = {"conv": {"kernel": np.ones((2, 2), np.float32)},
            "bn": {"scale": np.ones(2, np.float32)},
            "LayerNorm_0": {"bias": np.ones(2, np.float32)},
            "count": np.zeros((), np.int32)}
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    tt = {k: torch.from_numpy(np.array(v))
          for k, v in flat_paths(tree).items()}
    for fn, args in (("tofp16", ()), ("BN_convert_float", ()),
                     ("network_to_half", ()),
                     ("convert_network", (jnp.bfloat16,))):
        jout = flat_paths(getattr(jfu, fn)(jt, *args))
        targs = tuple(_tdt(a) for a in args)
        tout = getattr(tfu, fn)(tt, *targs)
        for k, v in jout.items():
            want = JDT.get(jnp.dtype(v.dtype), torch.int32)
            assert tout[k].dtype == want, (fn, k)
    model, master = tfu.prep_param_lists({"w": torch.ones(2).half()})
    assert master["w"].dtype == torch.float32
    back = tfu.master_params_to_model_params(model, {"w": master["w"] * 3})
    assert back["w"].dtype == torch.float16 and float(back["w"][0]) == 3.0
    assert tfu.model_grads_to_master_grads(
        {"w": torch.ones(1).half()})["w"].dtype == torch.float32
    assert tfu.to_python_float(torch.tensor([2.5])) == 2.5
    from collections import OrderedDict

    m = tfu.network_to_half(torch.nn.Sequential(OrderedDict(
        fc=torch.nn.Linear(2, 2), bn=torch.nn.BatchNorm1d(2))))
    assert m.fc.weight.dtype == torch.float16
    assert m.bn.weight.dtype == torch.float32


def test_legacy_loss_scalers_follow_jax():
    from apex_tpu import fp16_utils as jfu
    from apex_tpu_torch import fp16_utils as tfu

    j, t = jfu.DynamicLossScaler(2.0 ** 10, scale_window=3), \
        tfu.DynamicLossScaler(2.0 ** 10, scale_window=3)
    for overflow in (False, True, False, False, False, True, False):
        j.update_scale(overflow)
        t.update_scale(overflow)
        assert t.state_dict() == j.state_dict()
    assert t.has_overflow({"g": torch.tensor([1.0, float("nan")])})
    assert not t.has_overflow({"g": torch.ones(2)})
    s = tfu.LossScaler(4.0)
    assert float(s.unscale(s.scale_gradient({"g": torch.ones(1)}))["g"]) == 1
    assert not s.has_overflow(None) and s.loss_scale == 4.0


def test_fp16_optimizer_matches_jax_over_three_steps():
    from apex_tpu import fp16_utils as jfu
    from apex_tpu.optimizers import fused_adam as jax_adam
    from apex_tpu_torch import fp16_utils as tfu

    rs = np.random.RandomState(4)
    p = rs.randn(6).astype(np.float32)
    jo = jfu.FP16_Optimizer(jax_adam(lr=1e-2), dynamic_loss_scale=True)
    to = tfu.FP16_Optimizer(fused_adam(lr=1e-2), dynamic_loss_scale=True)
    jp = {"w": jnp.asarray(p).astype(jnp.float16)}
    tp = {"w": torch.from_numpy(p).half()}
    js, ts = jo.init(jp), to.init(tp)
    for step in range(3):
        g = (rs.randn(6) * 1e3).astype(np.float32)
        if step == 1:
            g[0] = np.inf
        jp, js, jinfo = jo.step({"w": jnp.asarray(g).astype(jnp.float16)},
                                js, jp)
        tp, ts, tinfo = to.step({"w": torch.from_numpy(g).half()}, ts, tp)
        assert bool(tinfo["skipped"]) == bool(jinfo["skipped"])
        assert float(tinfo["loss_scale"]) == float(jinfo["loss_scale"])
        np.testing.assert_allclose(ts.master["w"].numpy(),
                                   np.asarray(js.master["w"]), **FP32)
    assert to.state_dict(ts) == jo.state_dict(js)
    assert float(to.scale_loss(torch.tensor(2.0), ts)) == \
        float(jo.scale_loss(jnp.float32(2.0), js))


# -- mlp, fused_dense, normalization -----------------------------------------

def _vjp_jax(fn, args, ct):
    out, vjp = jax.vjp(fn, *args)
    return out, vjp(ct)


def _vjp_port(fn, args, ct):
    args = [a.detach().requires_grad_() for a in args]
    out = fn(*args)
    grads = torch.autograd.grad(out, args, ct)
    return out, grads


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("activation", ["relu", "sigmoid", "none"])
def test_mlp_apply_matches_jax(dtype, activation):
    from apex_tpu.ops import mlp_apply as jax_mlp_apply
    from apex_tpu_torch.ops.mlp import mlp_apply

    rs = np.random.RandomState(2)
    sizes = [16, 32, 8]
    ws = [rs.randn(o, i).astype(np.float32) / np.sqrt(i)
          for i, o in zip(sizes[:-1], sizes[1:])]
    bs = [rs.randn(o).astype(np.float32) for o in sizes[1:]]
    x = rs.randn(6, 16).astype(np.float32)
    ct = rs.randn(6, 8).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jparams = {"weights": [jnp.asarray(w).astype(jdt) for w in ws],
               "biases": [jnp.asarray(b).astype(jdt) for b in bs]}
    names = [f"weights.{i}" for i in range(2)] + \
        [f"biases.{i}" for i in range(2)]
    tparams = convert.mlp_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams))
    assert sorted(tparams) == sorted(names)

    def jfn(x, *leaves):
        return jax_mlp_apply({"weights": list(leaves[:2]),
                              "biases": list(leaves[2:])}, x, activation)

    def tfn(x, *leaves):
        return mlp_apply(dict(zip(names, leaves)), x, activation)

    jargs = [jnp.asarray(x).astype(jdt)] + jparams["weights"] + \
        jparams["biases"]
    targs = [torch.from_numpy(x).to(tdt)] + [tparams[n] for n in names]
    jout, jgrads = _vjp_jax(jfn, jargs, jnp.asarray(ct).astype(jdt))
    tout, tgrads = _vjp_port(tfn, targs, torch.from_numpy(ct).to(tdt))
    tol = FP32 if dtype == "float32" else BF16
    assert tout.dtype == tdt
    np.testing.assert_allclose(tout.detach().float().numpy(),
                               np.asarray(jout, np.float32), **tol)
    for jg, tg in zip(jgrads, tgrads):
        np.testing.assert_allclose(tg.float().numpy(),
                                   np.asarray(jg, np.float32),
                                   **(tol if dtype == "float32" else
                                      dict(rtol=5e-2, atol=5e-2)))


@pytest.mark.parametrize("bias", [True, False])
def test_mlp_module_matches_jax(bias):
    from apex_tpu.mlp import MLP as JaxMLP
    from apex_tpu_torch.mlp import MLP

    jm = JaxMLP([8, 16, 4], bias=bias, activation="sigmoid")
    x = np.random.RandomState(3).randn(5, 8).astype(np.float32)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tm = MLP([8, 16, 4], bias=bias, activation="sigmoid", device="cpu")
    tm.load_state_dict(convert.module_params_from_jax(
        jax.tree_util.tree_map(np.asarray, variables["params"])))
    want = jm.apply(variables, jnp.asarray(x))
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(want), **FP32)
    with pytest.raises(TypeError, match="activation"):
        MLP([2, 2], activation="tanh", device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_dense_modules_match_jax(dtype):
    from apex_tpu.fused_dense import FusedDense as JaxFD
    from apex_tpu.fused_dense import FusedDenseGeluDense as JaxFDGD
    from apex_tpu_torch.fused_dense import FusedDense, FusedDenseGeluDense

    rs = np.random.RandomState(5)
    x = rs.randn(4, 3, 8).astype(np.float32)
    ct = rs.randn(4, 3, 6).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tol = FP32 if dtype == "float32" else BF16
    for jm, tm in ((JaxFD(8, 6), FusedDense(8, 6, device="cpu")),
                   (JaxFDGD(8, 16, 6), FusedDenseGeluDense(8, 16, 6,
                                                           device="cpu"))):
        params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
        params = jax.tree_util.tree_map(lambda a: a + 0.01, params)
        tm.load_state_dict(convert.module_params_from_jax(
            jax.tree_util.tree_map(np.asarray, params)))
        jout, (jdx,) = _vjp_jax(lambda a: jm.apply({"params": params}, a),
                                [jnp.asarray(x).astype(jdt)],
                                jnp.asarray(ct).astype(jdt))
        tout, (tdx,) = _vjp_port(tm, [torch.from_numpy(x).to(tdt)],
                                 torch.from_numpy(ct).to(tdt))
        assert tout.dtype == tdt
        np.testing.assert_allclose(tout.detach().float().numpy(),
                                   np.asarray(jout, np.float32), **tol)
        np.testing.assert_allclose(tdx.float().numpy(),
                                   np.asarray(jdx, np.float32), **tol)
    with pytest.raises(ValueError, match="without bias"):
        FusedDenseGeluDense(2, 2, 2, bias=False, device="cpu")


NORMS = [("FusedLayerNorm", (4, 8)), ("FusedLayerNorm", 8),
         ("FusedRMSNorm", (4, 8)), ("MixedFusedRMSNorm", 8),
         ("MixedFusedLayerNorm", 8)]


@pytest.mark.parametrize("name,shape", NORMS)
@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_normalization_modules_match_jax(name, shape, affine, dtype):
    """Forward and every gradient against the flax module; with
    ``memory_efficient`` the port's values equal its plain call exactly."""
    from apex_tpu import normalization as jnorm
    from apex_tpu_torch import normalization as tnorm

    rs = np.random.RandomState(6)
    x = rs.randn(3, 4, 8).astype(np.float32)
    ct = rs.randn(3, 4, 8).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jm = getattr(jnorm, name)(shape, elementwise_affine=affine)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree_util.tree_map(
        lambda a: a + jnp.asarray(rs.randn(*a.shape) * 0.1, a.dtype), params)

    def jfn(a, p):
        return jm.apply(p, a)

    jout, (jdx, jdp) = _vjp_jax(jfn, [jnp.asarray(x).astype(jdt), params],
                                jnp.asarray(ct).astype(jdt))
    tol = FP32 if dtype == "float32" else BF16
    outs = []
    for me in (False, True):
        tm = getattr(tnorm, name)(shape, elementwise_affine=affine,
                                  memory_efficient=me, device="cpu")
        if affine:
            tm.load_state_dict(convert.module_params_from_jax(
                jax.tree_util.tree_map(np.asarray, params["params"])))
        else:
            assert not list(tm.parameters())
        xt = torch.from_numpy(x).to(tdt).requires_grad_()
        out = tm(xt)
        out.backward(torch.from_numpy(ct).to(tdt))
        assert out.dtype == tdt
        np.testing.assert_allclose(out.detach().float().numpy(),
                                   np.asarray(jout, np.float32), **tol)
        np.testing.assert_allclose(xt.grad.float().numpy(),
                                   np.asarray(jdx, np.float32),
                                   **(tol if dtype == "float32" else
                                      dict(rtol=5e-2, atol=5e-2)))
        if affine:
            jp = flat_paths(jdp["params"])
            for k, p in tm.named_parameters():
                np.testing.assert_allclose(p.grad.numpy(),
                                           np.asarray(jp[k]), rtol=1e-4,
                                           atol=1e-4 if dtype == "float32"
                                           else 5e-2)
        outs.append((out.detach(), xt.grad,
                     [p.grad for p in tm.parameters()]))
    (o0, g0, p0), (o1, g1, p1) = outs
    assert torch.equal(o0, o1) and torch.equal(g0, g1)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    with pytest.raises(ValueError, match="trailing dims"):
        tm(torch.ones(3, 5))


def test_transformer_surfaces_re_export_the_ops():
    from apex_tpu_torch.amp.grad_scaler import GradScaler
    from apex_tpu_torch.ops import rope, softmax
    from apex_tpu_torch.transformer import amp as tamp
    from apex_tpu_torch.transformer import functional as tf

    assert tamp.GradScaler is GradScaler
    assert tf.FusedScaleMaskSoftmax is softmax.FusedScaleMaskSoftmax
    assert tf.fused_apply_rotary_pos_emb is rope.apply_rotary_pos_emb
    assert tf.fused_apply_rotary_pos_emb_cached is \
        rope.apply_rotary_pos_emb_cached
    jt = importlib.import_module("apex_tpu.transformer.functional")
    assert set(tf.__all__) == set(jt.__all__)


def test_amp_exports_what_jax_exports_but_fp8():
    fp8 = {"Fp8TensorState", "fp8_dense", "init_fp8_state",
           "update_fp8_state"}
    assert set(jamp.__all__) - fp8 <= set(amp.__all__)
