"""The three ported amp examples against the JAX package's.

Each JAX example's step is repeated here (its code, with the data and
weights as numpy, so the port can start from the same ones), and the
JAX simple example's own ``main`` is run too, its printed lines held to
the repeated step's. The port runs the ported example's ``train`` on
the CPU from the same weights and data.

Tolerances: loss scales and skip flags exactly; fp32 losses 1e-5
relative (fp32 arithmetic in another order, compounded over 8 steps);
fp16 losses 2e-3 relative (one fp16 rounding of the activations at
different points); bf16 2e-2. The DCGAN's G output 1e-5 and its
gradients 1e-4 relative in norm (a deeper chain of fp32 sums in another
order). The ResNet's parameters after two steps: 1e-4 relative in norm
at fp32, 2e-2 in bf16 with 1e-3 absolute for the tensors that start at
zero.
"""

import contextlib
import importlib.util
import io
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu_torch.models import convert

ROOT = Path(__file__).resolve().parent.parent
HALF = {"bfloat16": jnp.bfloat16, "float16": jnp.float16}


def load_jax_example(rel):
    """A JAX example script as a module (``examples/`` is no package)."""
    spec = importlib.util.spec_from_file_location(
        "jax_example_" + rel.replace("/", "_")[:-3], ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# -- simple ---------------------------------------------------------------------

def _jax_simple(opt_level, half, steps, inject=-1, snapshot_at=None):
    """examples/simple/amp_mlp_train.py's loop: (initial params, (x, y),
    records, the (params, amp state) after ``snapshot_at`` steps)."""
    from apex_tpu.ops import layer_norm, mlp_apply, mlp_init
    from apex_tpu.optimizers import clip_grad_norm, fused_adam

    params = mlp_init(jax.random.PRNGKey(0), [256, 512, 512, 1])
    initial = _np_tree(params)
    tx = fused_adam(lr=1e-3, weight_decay=1e-4)
    params, amp_opt, policy = jamp.initialize(
        params, tx, opt_level=opt_level, half_dtype=HALF[half])
    state = amp_opt.init(params)
    kx, ky = jax.random.split(jax.random.PRNGKey(1))
    x = jax.random.normal(kx, (512, 256), jnp.float32)
    w_true = jax.random.normal(ky, (256,), jnp.float32)
    y = (x @ w_true)[:, None]
    ln_w, ln_b = jnp.ones((256,)), jnp.zeros((256,))

    def loss_fn(p, x, y):
        x = layer_norm(x, ln_w, ln_b)
        h = mlp_apply(p, policy.cast_inputs(x))
        return jnp.mean((h.astype(jnp.float32) - y) ** 2)

    @jax.jit
    def step(params, state, x, y, poison):
        def scaled(p):
            return amp_opt.scale_loss(loss_fn(p, x, y), state)

        loss, grads = jax.value_and_grad(scaled)(params)
        grads = jax.tree_util.tree_map(
            lambda g: jnp.where(poison, jnp.full_like(g, jnp.inf), g), grads)
        grads, _ = clip_grad_norm(grads, 1e9)
        unscaled_loss = loss / state.scaler.scale
        params, state, info = amp_opt.step(grads, state, params)
        return params, state, unscaled_loss, info

    records, snap = [], None
    for i in range(steps):
        if i == snapshot_at:
            snap = (_np_tree(params), state)
        params, state, loss, info = step(params, state, x, y,
                                         jnp.asarray(i == inject))
        records.append({"loss": float(loss),
                        "scale": float(info["loss_scale"]),
                        "skipped": bool(info["found_inf"])})
    return initial, (np.asarray(x), np.asarray(y)), records, snap


def _run_jax_main(path, argv):
    out = io.StringIO()
    saved = sys.argv
    sys.argv = ["x"] + argv
    try:
        with contextlib.redirect_stdout(out):
            load_jax_example(path).main()
    finally:
        sys.argv = saved
    return [line for line in out.getvalue().splitlines()
            if line.startswith("step")]


def _port_simple_args(opt_level, half, steps, inject=-1):
    from apex_tpu_torch.examples.simple import amp_mlp_train

    return amp_mlp_train.parse_args([
        "--device", "cpu", "--steps", str(steps), "--opt-level", opt_level,
        "--half", half, "--inject-overflow-at", str(inject)])


SIMPLE = {"O0_fp32": ("O0", "bfloat16", -1, dict(rtol=1e-5)),
          "O2_fp16_overflow": ("O2", "float16", 3, dict(rtol=2e-3)),
          "O2_bf16": ("O2", "bfloat16", -1, dict(rtol=2e-2))}


@pytest.mark.parametrize("case", sorted(SIMPLE))
def test_simple_example_follows_jax(case):
    from apex_tpu_torch.examples.simple import amp_mlp_train

    level, half, inject, tol = SIMPLE[case]
    initial, data, want, _ = _jax_simple(level, half, 8, inject)
    lines = []
    got = amp_mlp_train.train(_port_simple_args(level, half, 8, inject),
                              params=convert.mlp_params_from_jax(initial),
                              data=data, log=lines.append)
    assert [r["scale"] for r in got] == [r["scale"] for r in want]
    assert [r["skipped"] for r in got] == [r["skipped"] for r in want]
    np.testing.assert_allclose([r["loss"] for r in got],
                               [r["loss"] for r in want], **tol)
    if inject >= 0:
        assert got[inject]["skipped"]
    # the JAX example's own printout is the repeated step's
    printed = _run_jax_main("examples/simple/amp_mlp_train.py", [
        "--steps", "8", "--opt-level", level, "--half", half,
        "--inject-overflow-at", str(inject)])
    assert printed == [
        f"step {i:4d} loss {r['loss']:10.4f} scale {r['scale']:10.1f} "
        f"skipped {r['skipped']}" for i, r in enumerate(want)
        if i % 10 == 0 or i == 7 or r["skipped"]]
    assert [ln.split(" loss")[0] for ln in lines if ln.startswith("step")] \
        == [ln.split(" loss")[0] for ln in printed]


def test_simple_example_resumes_from_a_jax_state():
    """Four JAX steps, then the port from JAX's params, masters, Adam
    moments and scaler state, for four more: the steps JAX took next."""
    from apex_tpu_torch.examples.simple import amp_mlp_train
    from apex_tpu_torch.optimizers.fused_adam import FusedAdamState

    _, data, want, (params, state) = _jax_simple("O2", "float16", 8, -1,
                                                 snapshot_at=4)
    jstate = jax.tree_util.tree_map(np.asarray, state)
    mlp_names = convert.mlp_params_from_jax

    def inner(s, dev):
        return convert.optimizer_state_from_jax(s, FusedAdamState, dev,
                                                params_from_jax=mlp_names)

    tstate = convert.amp_state_from_jax(jstate, inner, "cpu",
                                        params_from_jax=mlp_names)
    assert tstate.master["weights.0"].dtype == torch.float32
    assert int(tstate.inner.step) == sum(not r["skipped"] for r in want[:4])
    got = amp_mlp_train.train(_port_simple_args("O2", "float16", 4),
                              params=mlp_names(params), data=data,
                              log=lambda s: None, state=tstate)
    assert [r["scale"] for r in got] == [r["scale"] for r in want[4:]]
    assert [r["skipped"] for r in got] == [r["skipped"] for r in want[4:]]
    np.testing.assert_allclose([r["loss"] for r in got],
                               [r["loss"] for r in want[4:]], rtol=2e-3)


# -- DCGAN ----------------------------------------------------------------------

DC = dict(batch=8, image=32, nz=100, lr=2e-4)


def _dcgan_data(steps, seed=0):
    rs = np.random.RandomState(seed)
    return [(rs.uniform(-1, 1, (DC["batch"], DC["image"], DC["image"], 3))
             .astype(np.float32),
             rs.randn(DC["batch"], DC["nz"]).astype(np.float32))
            for _ in range(steps)]


def _jax_dcgan(opt_level, half, data, inject=None):
    """examples/dcgan/main_amp.py's train_step (repeated, with the data
    given and the port's overflow injection): initial G and D params
    and each step's record."""
    import optax

    from apex_tpu.optimizers import fused_adam

    jex = load_jax_example("examples/dcgan/main_amp.py")
    netG, netD = jex.build_models(DC["image"], DC["nz"])
    kG, kD, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    g_params = netG.init(kG, jnp.zeros((DC["batch"], DC["nz"])))["params"]
    d_params = netD.init(kD, jnp.zeros((DC["batch"], DC["image"],
                                        DC["image"], 3)))["params"]
    initial = (_np_tree(g_params), _np_tree(d_params))
    txG = fused_adam(lr=DC["lr"], betas=(0.5, 0.999))
    txD = fused_adam(lr=DC["lr"], betas=(0.5, 0.999))
    d_params, d_amp, policy = jamp.initialize(
        d_params, txD, opt_level=opt_level, half_dtype=HALF[half],
        num_losses=2)
    g_params, g_amp, _ = jamp.initialize(
        g_params, txG, opt_level=opt_level, half_dtype=HALF[half])
    d_state, g_state = d_amp.init(d_params), g_amp.init(g_params)
    d_apply = policy.wrap_apply(netD.apply)
    g_apply = policy.wrap_apply(netG.apply)
    bce = optax.sigmoid_binary_cross_entropy

    @jax.jit
    def train_step(d_params, d_state, g_params, g_state, real, z, poison):
        fake = g_apply({"params": g_params}, z)

        def d_loss_real(p):
            logits = d_apply({"params": p}, real)
            loss = jnp.mean(bce(logits, jnp.ones_like(logits)))
            return d_amp.scale_loss(loss, d_state, loss_id=0), loss

        def d_loss_fake(p):
            logits = d_apply({"params": p}, jax.lax.stop_gradient(fake))
            loss = jnp.mean(bce(logits, jnp.zeros_like(logits)))
            return d_amp.scale_loss(loss, d_state, loss_id=1), loss

        dg_real, err_real = jax.grad(d_loss_real, has_aux=True)(d_params)
        dg_fake, err_fake = jax.grad(d_loss_fake, has_aux=True)(d_params)
        dg_fake = jax.tree_util.tree_map(
            lambda g: jnp.where(poison, jnp.full_like(g, jnp.inf), g),
            dg_fake)
        g_real, inf0 = d_amp.unscale_grads(dg_real, d_state, loss_id=0)
        g_fake, inf1 = d_amp.unscale_grads(dg_fake, d_state, loss_id=1)
        d_grads = jax.tree_util.tree_map(jnp.add, g_real, g_fake)
        d_params, d_state, d_info = d_amp.step_unscaled(
            d_grads, d_state, d_params, {0: inf0, 1: inf1})

        def g_loss(p):
            logits = d_apply({"params": d_params},
                             g_apply({"params": p}, z))
            loss = jnp.mean(bce(logits, jnp.ones_like(logits)))
            return g_amp.scale_loss(loss, g_state), loss

        g_grads, errG = jax.grad(g_loss, has_aux=True)(g_params)
        g_params, g_state, g_info = g_amp.step(g_grads, g_state, g_params)
        return d_params, d_state, g_params, g_state, {
            "errD": err_real + err_fake, "errG": errG,
            "scale_d0": d_state.scaler[0].scale,
            "scale_d1": d_state.scaler[1].scale,
            "scale_g": g_state.scaler.scale,
            "d_skipped": d_info["found_inf"],
            "g_skipped": g_info["found_inf"]}

    records = []
    for step, (real, z) in enumerate(data):
        d_params, d_state, g_params, g_state, info = train_step(
            d_params, d_state, g_params, g_state, jnp.asarray(real),
            jnp.asarray(z), jnp.asarray(inject == (step, 1)))
        records.append({k: (bool(v) if k.endswith("skipped") else float(v))
                        for k, v in info.items()})
    return initial, records, (jex, netG, netD)


def _port_dcgan(initial, opt_level, half, data, inject=None):
    from apex_tpu_torch.examples.dcgan import main_amp

    g, d = main_amp.build_models(DC["image"], DC["nz"], device="cpu")
    g.load_state_dict(convert.dcgan_params_from_jax(initial[0]))
    d.load_state_dict(convert.dcgan_params_from_jax(initial[1]))
    args = main_amp.parse_args([
        "--device", "cpu", "--opt-level", opt_level, "--half", half,
        "--batch-size", str(DC["batch"]), "--steps", str(len(data))])
    return main_amp.train(args, models=(g, d), data=data,
                          log=lambda s: None, inject_overflow=inject)


def test_dcgan_nets_and_gradients_match_jax_at_fp32():
    """G's images, D's logits and the gradients of the D-real and G
    losses, from the JAX initialisation."""
    import optax

    from apex_tpu_torch.examples.dcgan import main_amp

    data = _dcgan_data(1)
    initial, _, (jex, netG, netD) = _jax_dcgan("O0", "bfloat16", [])
    gp, dp = (jax.tree_util.tree_map(jnp.asarray, t) for t in initial)
    real, z = (jnp.asarray(a) for a in data[0])
    g, d = main_amp.build_models(DC["image"], DC["nz"], device="cpu")
    g.load_state_dict(convert.dcgan_params_from_jax(initial[0]))
    d.load_state_dict(convert.dcgan_params_from_jax(initial[1]))
    fake = jax.jit(netG.apply)({"params": gp}, z)
    tfake = g(torch.from_numpy(data[0][1]))
    np.testing.assert_allclose(tfake.detach().numpy(), np.asarray(fake),
                               rtol=1e-5, atol=1e-5)
    bce = optax.sigmoid_binary_cross_entropy

    def d_loss(p):
        logits = netD.apply({"params": p}, real)
        return jnp.mean(bce(logits, jnp.ones_like(logits)))

    def g_loss(p):
        logits = netD.apply({"params": dp}, netG.apply({"params": p}, z))
        return jnp.mean(bce(logits, jnp.ones_like(logits)))

    for jloss, module, params, loss_fn in (
            (d_loss, d, dp, lambda: d(torch.from_numpy(data[0][0]))),
            (g_loss, g, gp, lambda: d(g(torch.from_numpy(data[0][1]))))):
        jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
        logits = loss_fn()
        loss = main_amp.bce_with_logits(logits,
                                        torch.ones_like(logits)).mean()
        grads = torch.autograd.grad(loss, list(module.parameters()))
        np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
        want = convert.dcgan_params_from_jax(_np_tree(jg))
        for (name, _), gr in zip(module.named_parameters(), grads):
            ref = want[name].numpy()
            err = np.linalg.norm(gr.numpy() - ref)
            assert err <= 1e-4 * np.linalg.norm(ref) + 1e-7, name


@pytest.mark.parametrize("case", ["O0_fp32", "O2_fp16_overflow"])
def test_dcgan_example_follows_jax(case):
    """Three steps: both losses and the three scales after each, and the
    skips; in fp16 an overflow injected into D's fake loss at step 1
    skips D's step and halves scaler 1 alone, G steps on."""
    level, half, inject = (("O0", "bfloat16", None) if case == "O0_fp32"
                           else ("O2", "float16", (1, 1)))
    data = _dcgan_data(3)
    initial, want, _ = _jax_dcgan(level, half, data, inject)
    got = _port_dcgan(initial, level, half, data, inject)
    for k in ("scale_d0", "scale_d1", "scale_g", "d_skipped", "g_skipped"):
        assert [r[k] for r in got] == [r[k] for r in want], k
    tol = dict(rtol=1e-5) if level == "O0" else dict(rtol=2e-3)
    for k in ("errD", "errG"):
        np.testing.assert_allclose([r[k] for r in got],
                                   [r[k] for r in want], err_msg=k, **tol)
    if inject:
        assert got[1]["d_skipped"] and not got[1]["g_skipped"]
        assert got[1]["scale_d1"] == got[0]["scale_d1"] / 2
        assert got[1]["scale_d0"] == got[0]["scale_d0"]
        assert got[1]["scale_g"] == got[0]["scale_g"]


# -- imagenet -----------------------------------------------------------------

IMG = dict(batch=4, image=32, classes=1000)


@pytest.mark.parametrize("level", ["O0", "O2"])
def test_imagenet_example_follows_jax(level):
    """Two steps of the JAX example's step on a small ResNet (a BasicBlock
    stage and a strided one, 8 filters, 32^2, batch 4) and of the ported
    example's ``train`` from the same weights and batch: losses, scales,
    skips and the parameters after."""
    from apex_tpu.models import cross_entropy_loss as jax_xent
    from apex_tpu.models import resnet as jresnet
    from apex_tpu.optimizers import fused_sgd as jax_sgd
    from apex_tpu_torch.examples.imagenet import main_amp
    from apex_tpu_torch.models import resnet

    half = jnp.bfloat16
    policy = jamp.opt_levels[level](half_dtype=half)
    model = jresnet.ResNet(stage_sizes=[1, 1], block_cls=jresnet.BasicBlock,
                           num_filters=8, num_classes=IMG["classes"],
                           dtype=policy.compute_dtype or jnp.float32)
    rs = np.random.RandomState(7)
    images = rs.randn(IMG["batch"], IMG["image"], IMG["image"], 3).astype(
        np.float32)
    labels = rs.randint(0, IMG["classes"], (IMG["batch"],)).astype(np.int32)
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(images))
    params, batch_stats = variables["params"], variables["batch_stats"]
    initial = (_np_tree(params), _np_tree(batch_stats))
    tx = jax_sgd(lr=0.1, momentum=0.9, weight_decay=1e-4)
    params, amp_opt, policy = jamp.initialize(params, tx, opt_level=level,
                                              half_dtype=half)
    state = amp_opt.init(params)

    @jax.jit
    def step(params, batch_stats, state, images, labels):
        def scaled(p):
            logits, mutated = model.apply(
                {"params": p, "batch_stats": batch_stats},
                policy.cast_inputs(images), train=True,
                mutable=["batch_stats"])
            loss = jax_xent(logits, labels)
            return amp_opt.scale_loss(loss, state), (loss,
                                                     mutated["batch_stats"])

        grads, (loss, bs) = jax.grad(scaled, has_aux=True)(params)
        params, state_new, info = amp_opt.step(grads, state, params)
        return params, bs, state_new, loss, info

    want = []
    for _ in range(2):
        params, batch_stats, state, loss, info = step(
            params, batch_stats, state, jnp.asarray(images),
            jnp.asarray(labels))
        want.append((float(loss), float(info["loss_scale"]),
                     bool(info["found_inf"])))

    dtype = torch.float32 if level == "O0" else torch.bfloat16
    tmodel = resnet.ResNet([1, 1], resnet.BasicBlock,
                           num_classes=IMG["classes"], num_filters=8,
                           dtype=dtype, device="cpu")
    tmodel.load_state_dict(convert.resnet_params_from_jax(*initial))
    args = main_amp.parse_args([
        "--device", "cpu", "--opt-level", level, "--batch-size",
        str(IMG["batch"]), "--image-size", str(IMG["image"]), "--steps",
        "2"])
    rec = main_amp.train(args, model=tmodel, data=(images, labels),
                         log=lambda s: None)
    assert rec["scales"] == [w[1] for w in want]
    assert rec["skipped"] == [w[2] for w in want]
    tol = dict(rtol=1e-5, atol=1e-6) if level == "O0" else dict(rtol=2e-2)
    np.testing.assert_allclose(rec["losses"], [w[0] for w in want], **tol)
    ref = convert.resnet_params_from_jax(_np_tree(params),
                                         _np_tree(batch_stats))
    for name, p in rec["params"].items():
        r = ref[name].float()
        err = float((p.detach().float() - r).norm())
        # bf16: a tensor that starts at zero (the BN biases) holds two SGD
        # steps of lr 0.1 on a gradient bf16 rounding moves: 1e-3 absolute
        bound = (1e-4 * float(r.norm()) + 1e-6 if level == "O0"
                 else 2e-2 * float(r.norm()) + 1e-3)
        assert err <= bound, (name, err)
