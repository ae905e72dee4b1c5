"""apex_tpu_torch's Adam kernel plain version, fused_adam and flat buffers
against the JAX package.

The same numpy inputs, made from a seed, go through the JAX functions
(``adam_flat`` with ``impl="pallas"``, the Pallas kernel in interpret
mode; ``fused_adam``'s optax transform) and through the port on CPU
tensors, which runs the plain version of the CUDA kernel. Both write the
same fp32 operations in the same order, but XLA's CPU compiler contracts
``b1 * m + (1 - b1) * g`` into a fused multiply-add, so the moments are
held element for element to MOMENT_ATOL, a few ulp of their O(1) terms;
the updates (also through ``beta ** step`` from two libraries' pow) to
1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.multi_tensor import flatten_pytree as jax_flatten
from apex_tpu.optimizers import fused_adam as jax_fused_adam
from apex_tpu.optimizers._fused_kernels import adam_flat as jax_adam_flat
from apex_tpu_torch.models.convert import (
    fused_adam_state_from_jax,
    gpt_params_from_jax,
)
from apex_tpu_torch.ops.multi_tensor import (
    CHUNK_SIZE,
    flatten_pytree,
    unflatten_pytree,
)
from apex_tpu_torch.optimizers import FusedAdam, adam_flat, fused_adam
from apex_tpu_torch.utils.pytree import tree_any_non_finite, tree_leaves

UPD_TOL = 1e-6  # relative; pow and the division chain may differ by an ulp
MOMENT_ATOL = 2e-7  # absolute: one fp32 ulp of terms up to ~2
UPD_ATOL = 1e-9  # absolute: 1e-6 of lr, for updates of moments near 0
HYPER = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8)


def _buffers(n, seed=0):
    rs = np.random.RandomState(seed)
    g = rs.randn(n).astype(np.float32)
    p = rs.randn(n).astype(np.float32)
    m = (rs.randn(n) * 0.1).astype(np.float32)
    v = (rs.rand(n) * 0.01).astype(np.float32)
    return g, p, m, v


@pytest.mark.parametrize("adam_w_mode", [True, False])
@pytest.mark.parametrize("step", [1, 10])
def test_adam_flat_matches_pallas(adam_w_mode, step):
    g, p, m, v = _buffers(CHUNK_SIZE, seed=step)
    bc1 = np.float32(1 - 0.9 ** step)
    bc2 = np.float32(1 - 0.999 ** step)
    kw = dict(HYPER, weight_decay=0.01, adam_w_mode=adam_w_mode)
    ref = jax_adam_flat(*(jnp.asarray(t) for t in (g, p, m, v)),
                        jnp.asarray(bc1), jnp.asarray(bc2), impl="pallas",
                        **kw)
    out = adam_flat(*(torch.from_numpy(t) for t in (g, p, m, v)),
                    torch.tensor(bc1), torch.tensor(bc2), **kw)
    upd, m_out, v_out = (np.asarray(r) for r in ref)
    np.testing.assert_allclose(out[1].numpy(), m_out, atol=MOMENT_ATOL,
                               rtol=0)
    np.testing.assert_allclose(out[2].numpy(), v_out, atol=MOMENT_ATOL,
                               rtol=0)
    np.testing.assert_allclose(out[0].numpy(), upd, rtol=UPD_TOL,
                               atol=UPD_ATOL)


def test_adam_flat_takes_any_length_and_leaves_p_alone():
    g, p, m, v = (torch.from_numpy(t) for t in _buffers(1001, seed=3))
    p0 = p.clone()
    one = torch.tensor(1.0)
    upd, m2, v2 = adam_flat(g, p, m, v, one, one, weight_decay=0.0,
                            adam_w_mode=True, **HYPER)
    assert upd.shape == m2.shape == v2.shape == (1001,)
    assert torch.equal(p, p0)


def _params(seed=0):
    """A nested tree whose sorted order differs from insertion order."""
    rs = np.random.RandomState(seed)
    tree = {
        "transformer": {
            "layer_2": {"kernel": rs.randn(4, 6), "bias": rs.randn(6)},
            "layer_10": {"kernel": rs.randn(6, 4), "bias": rs.randn(4)},
        },
        "embedding": {"word": rs.randn(9, 4)},
    }
    return jax.tree_util.tree_map(lambda a: a.astype(np.float32), tree)


def _grads(step):
    return jax.tree_util.tree_map(
        lambda a: (a * (step + 1) * 0.3).astype(np.float32), _params(seed=7))


def test_flatten_order_matches_jax_leaf_order():
    tree = _params()
    ref, spec = jax_flatten(jax.tree_util.tree_map(jnp.asarray, tree))
    flat, fspec = flatten_pytree(gpt_params_from_jax(tree))
    assert flat.shape == (spec.padded_total,) == (CHUNK_SIZE,)
    assert fspec.total == spec.total
    np.testing.assert_array_equal(flat.numpy(), np.asarray(ref))
    assert fspec.names.index("transformer.layer_10.bias") < \
        fspec.names.index("transformer.layer_2.bias")
    back = unflatten_pytree(flat, fspec)
    for name, t in gpt_params_from_jax(tree).items():
        assert torch.equal(back[name], t)


def _run_both(fuse, adam_w_mode, steps=3):
    """(jax updates, jax state, port updates, port state) per step."""
    kw = dict(lr=1e-2, weight_decay=0.05, adam_w_mode=adam_w_mode, fuse=fuse)
    jopt, topt = jax_fused_adam(**kw), fused_adam(**kw)
    jp = jax.tree_util.tree_map(jnp.asarray, _params())
    tp = gpt_params_from_jax(_params())
    js, ts = jopt.init(jp), topt.init(tp)
    out = []
    for step in range(steps):
        jg = jax.tree_util.tree_map(jnp.asarray, _grads(step))
        ju, js = jopt.update(jg, js, jp)
        tu, ts = topt.update(gpt_params_from_jax(_grads(step)), ts, tp)
        jp = jax.tree_util.tree_map(lambda a, b: a + b, jp, ju)
        tp = {n: tp[n] + tu[n] for n in tp}
        out.append((ju, js, jp, tu, ts, tp))
    return out


@pytest.mark.parametrize("adam_w_mode", [True, False])
@pytest.mark.parametrize("fuse", ["tree", "flat"])
def test_fused_adam_matches_jax_over_three_steps(fuse, adam_w_mode):
    for ju, js, jp, tu, ts, tp in _run_both(fuse, adam_w_mode):
        ref_u = gpt_params_from_jax(jax.tree_util.tree_map(np.asarray, ju))
        ref_p = gpt_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
        for n in tp:
            np.testing.assert_allclose(tu[n].numpy(), ref_u[n].numpy(),
                                       rtol=UPD_TOL, atol=UPD_ATOL)
            np.testing.assert_allclose(tp[n].numpy(), ref_p[n].numpy(),
                                       rtol=UPD_TOL, atol=1e-8)
        assert int(ts.step) == int(js.step)
        if fuse == "flat":
            # the moments' flat buffers, element for element
            assert ts.exp_avg.shape == js.exp_avg.shape
            for t, r in ((ts.exp_avg, js.exp_avg),
                         (ts.exp_avg_sq, js.exp_avg_sq)):
                np.testing.assert_allclose(t.numpy(), np.asarray(r),
                                           atol=MOMENT_ATOL, rtol=0)
        else:
            ref_m = gpt_params_from_jax(
                jax.tree_util.tree_map(np.asarray, js.exp_avg))
            for n in tp:
                np.testing.assert_allclose(ts.exp_avg[n].numpy(),
                                           ref_m[n].numpy(),
                                           atol=MOMENT_ATOL, rtol=0)


@pytest.mark.parametrize("fuse", ["tree", "flat"])
def test_state_from_jax_continues_like_jax(fuse):
    """Both frameworks take one more step from the JAX state of step 2."""
    ju, js, jp, *_ = _run_both(fuse, True, steps=2)[-1]
    ts = fused_adam_state_from_jax(
        jax.tree_util.tree_map(np.asarray, js), device="cpu")
    tp = gpt_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    kw = dict(lr=1e-2, weight_decay=0.05, fuse=fuse)
    ju2, js2 = jax_fused_adam(**kw).update(
        jax.tree_util.tree_map(jnp.asarray, _grads(2)), js, jp)
    tu2, ts2 = fused_adam(**kw).update(gpt_params_from_jax(_grads(2)), ts, tp)
    ref = gpt_params_from_jax(jax.tree_util.tree_map(np.asarray, ju2))
    for n in tp:
        np.testing.assert_allclose(tu2[n].numpy(), ref[n].numpy(),
                                   rtol=UPD_TOL, atol=UPD_ATOL)
    assert int(ts2.step) == 3


def test_bias_correction_off_and_amsgrad_refused():
    kw = dict(lr=1e-2, bias_correction=False)
    jopt, topt = jax_fused_adam(**kw), fused_adam(**kw)
    jp = jax.tree_util.tree_map(jnp.asarray, _params())
    tp = gpt_params_from_jax(_params())
    ju, _ = jopt.update(jax.tree_util.tree_map(jnp.asarray, _grads(0)),
                        jopt.init(jp), jp)
    tu, _ = topt.update(gpt_params_from_jax(_grads(0)), topt.init(tp), tp)
    ref = gpt_params_from_jax(jax.tree_util.tree_map(np.asarray, ju))
    for n in tp:
        np.testing.assert_allclose(tu[n].numpy(), ref[n].numpy(),
                                   rtol=UPD_TOL, atol=UPD_ATOL)
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedAdam(amsgrad=True)
    with pytest.raises(ValueError, match="tree|flat"):
        fused_adam(fuse="chunked")


def test_tree_any_non_finite_and_leaf_order():
    tree = {"b": torch.ones(3), "a": {"x": torch.zeros(2),
                                      "i": torch.arange(3)}}
    assert [t.shape[0] for t in tree_leaves(tree)] == [3, 2, 3]
    assert not bool(tree_any_non_finite(tree))
    tree["b"][1] = float("inf")
    assert bool(tree_any_non_finite(tree))
    assert not bool(tree_any_non_finite({}))


# -- the sum of squares and ZeRO-2 Adam at a data-parallel world of one ------
# sumsq_flat against the JAX function with impl="pallas" (its Pallas kernel in
# interpret mode, over a zero-padded chunk grid): 1e-6 relative, fp32 sums of
# up to ~2e5 terms in another order. distributed_fused_adam against the JAX
# one inside shard_map on a one-device "dp" mesh, 3 steps with the clip
# active on every step: the same fp32 operations, the moments held as
# fused_adam's are. The clip factor comes from two sums in another order
# and XLA contracts the moments' updates into FMAs, so the master and the
# params, entries up to ~2.5 summed with updates of 1e-2, are held to
# MASTER_ATOL, two fp32 ulps of 2 (1e-6 relative alone fails where such a
# sum cancels to near 0).

MASTER_ATOL = 5e-7

@pytest.mark.parametrize("n", [1, 1023, 3 * CHUNK_SIZE + 7])
def test_sumsq_and_l2norm_flat_match_pallas(n):
    from apex_tpu.optimizers._fused_kernels import l2norm_flat as jax_l2norm
    from apex_tpu.optimizers._fused_kernels import sumsq_flat as jax_sumsq
    from apex_tpu_torch.optimizers import l2norm_flat, sumsq_flat

    x = np.random.RandomState(n).randn(n).astype(np.float32)
    ref = float(jax_sumsq(jnp.asarray(x), impl="pallas"))
    got = sumsq_flat(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), ref, rtol=1e-6)
    np.testing.assert_allclose(float(l2norm_flat(torch.from_numpy(x))),
                               float(jax_l2norm(jnp.asarray(x),
                                                impl="pallas")), rtol=1e-6)
    # another dtype is read as fp32, as the JAX function casts it
    xb = torch.from_numpy(x).bfloat16()
    np.testing.assert_allclose(float(sumsq_flat(xb)),
                               float((xb.double() ** 2).sum()), rtol=1e-6)


def _dfa_run_jax(kw, steps=3):
    """JAX distributed_fused_adam at dp = 1: (params, state) per step."""
    import functools

    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from apex_tpu.compat import shard_map
    from apex_tpu.optimizers import distributed_fused_adam as jax_dfa

    mesh = Mesh(np.array(jax.devices()[:1]), ("dp",))
    opt = jax_dfa(axis_size=1, **kw)

    @jax.jit
    @functools.partial(shard_map, mesh=mesh, in_specs=(P(), P()),
                       out_specs=P(), check_vma=False)
    def run(params, grads_seq):
        state = opt.init(params)
        out = []
        for i in range(steps):
            g = jax.tree_util.tree_map(lambda a: a[i], grads_seq)
            upd, state = opt.update(g, state, params)
            params = jax.tree_util.tree_map(lambda a, b: a + b, params, upd)
            out.append((params, state))
        return out

    seq = jax.tree_util.tree_map(lambda *a: jnp.stack(a),
                                 *[_grads(i) for i in range(steps)])
    return run(jax.tree_util.tree_map(jnp.asarray, _params()), seq)


@pytest.mark.parametrize("adam_w_mode", [True, False])
def test_distributed_fused_adam_matches_jax_at_dp1(adam_w_mode):
    from apex_tpu_torch.optimizers import distributed_fused_adam

    # _grads' global norms are ~8-25, so max_grad_norm 1.0 clips every step
    kw = dict(lr=1e-2, weight_decay=0.05, adam_w_mode=adam_w_mode,
              max_grad_norm=1.0)
    ref = _dfa_run_jax(kw)
    opt = distributed_fused_adam(**kw)
    tp = gpt_params_from_jax(_params())
    ts = opt.init(tp)
    for step, (jp, js) in enumerate(ref):
        tu, ts = opt.update(gpt_params_from_jax(_grads(step)), ts, tp)
        tp = {n: tp[n] + tu[n] for n in tp}
        want = gpt_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
        for n in tp:
            np.testing.assert_allclose(tp[n].numpy(), want[n].numpy(),
                                       rtol=UPD_TOL, atol=MASTER_ATOL,
                                       err_msg=n)
        assert int(ts.step) == int(js.step) == step + 1
        assert ts.master_shard.shape == js.master_shard.shape
        np.testing.assert_allclose(ts.master_shard.numpy(),
                                   np.asarray(js.master_shard),
                                   atol=MASTER_ATOL, rtol=UPD_TOL)
        for t, r in ((ts.exp_avg, js.exp_avg), (ts.exp_avg_sq, js.exp_avg_sq)):
            np.testing.assert_allclose(t.numpy(), np.asarray(r),
                                       atol=MOMENT_ATOL, rtol=UPD_TOL)


def test_distributed_fused_adam_refuses_what_is_not_ported():
    from apex_tpu_torch.optimizers import (
        DistributedFusedAdam,
        distributed_fused_adam,
    )

    # an axis_size that is not the data-parallel group's size (here a
    # world of one: no process group)
    with pytest.raises(ValueError, match="axis_size 2"):
        distributed_fused_adam(axis_size=2)
    with pytest.raises(NotImplementedError, match="compress"):
        distributed_fused_adam(compression=object())
    with pytest.raises(NotImplementedError, match="remainders"):
        DistributedFusedAdam(store_param_remainders=True)
    # the bucketed gather is bit-identical at a world of one
    a, b = (distributed_fused_adam(lr=1e-2, param_gather_buckets=k)
            for k in (None, 4))
    tp = gpt_params_from_jax(_params())
    ua, _ = a.update(gpt_params_from_jax(_grads(0)), a.init(tp), tp)
    ub, _ = b.update(gpt_params_from_jax(_grads(0)), b.init(tp), tp)
    assert all(torch.equal(ua[n], ub[n]) for n in tp)


# fused_sgd: bench.py's settings, Nesterov, dampening, and no momentum.
# Each op is one fp32 rounding on both sides, but XLA may contract
# ``momentum * b + (1 - dampening) * g`` into an FMA: SGD_TOL, a few ulp.
SGD_TOL = dict(rtol=1e-6, atol=1e-7)
SGD_CASES = {
    "bench": dict(lr=0.1, momentum=0.9, weight_decay=1e-4),
    "nesterov": dict(lr=0.05, momentum=0.9, weight_decay=1e-3,
                     nesterov=True),
    "dampening": dict(lr=0.1, momentum=0.8, dampening=0.3),
    "no_momentum": dict(lr=0.1, weight_decay=1e-2),
}


@pytest.mark.parametrize("case", sorted(SGD_CASES))
def test_fused_sgd_matches_jax_over_three_steps(case):
    """The updates and momentum buffers of 3 steps, the first of which
    bootstraps the buffer with the gradient itself."""
    import optax

    from apex_tpu.optimizers import fused_sgd as jax_fused_sgd
    from apex_tpu_torch.optimizers import FusedSGD, fused_sgd

    kw = SGD_CASES[case]
    rs = np.random.RandomState(11)
    shapes = {"a": (7, 5), "b": (13,), "c": (2, 3, 4)}
    jp = {n: jnp.asarray(rs.randn(*s).astype(np.float32))
          for n, s in shapes.items()}
    tp = {n: torch.from_numpy(np.array(v)) for n, v in jp.items()}
    jopt, opt = jax_fused_sgd(**kw), fused_sgd(**kw)
    js, ts = jopt.init(jp), FusedSGD(**kw).init(tp)
    for step in range(3):
        g = {n: rs.randn(*s).astype(np.float32) for n, s in shapes.items()}
        jupd, js = jopt.update({n: jnp.asarray(v) for n, v in g.items()}, js,
                               jp)
        upd, ts = opt.update({n: torch.from_numpy(v) for n, v in g.items()},
                             ts, tp)
        for n in shapes:
            np.testing.assert_allclose(upd[n].numpy(), np.asarray(jupd[n]),
                                       err_msg=n, **SGD_TOL)
            np.testing.assert_allclose(ts.momentum_buffer[n].numpy(),
                                       np.asarray(js.momentum_buffer[n]),
                                       err_msg=n, **SGD_TOL)
            if step == 0 and kw.get("momentum"):  # the bootstrap: buf = g
                want = g[n] + kw.get("weight_decay", 0.0) * tp[n].numpy()
                np.testing.assert_allclose(ts.momentum_buffer[n].numpy(),
                                           want, **SGD_TOL)
        jp = optax.apply_updates(jp, jupd)
        tp = {n: tp[n] + upd[n] for n in tp}
        assert int(ts.step) == int(js.step) == step + 1


def test_fused_sgd_checks_its_arguments():
    from apex_tpu_torch.optimizers import fused_sgd

    with pytest.raises(ValueError, match="Nesterov"):
        fused_sgd(momentum=0.0, nesterov=True)
    with pytest.raises(ValueError, match="Nesterov"):
        fused_sgd(momentum=0.9, dampening=0.1, nesterov=True)
    opt = fused_sgd(momentum=0.9)
    p = {"w": torch.ones(3)}
    with pytest.raises(ValueError, match="requires params"):
        opt.update(p, opt.init(p))


# -- the rest of the fused optimizers, clip_grad_norm, multi_tensor ops ----
# Three steps of each on the same seeded params and grads, the port's
# updates and states against the JAX transform's. Norms and trust ratios
# sum in another order than XLA's reductions, and XLA contracts the
# moment updates into FMAs: OPT_TOL, a few fp32 ulp relative.
OPT_TOL = dict(rtol=2e-5, atol=1e-7)
OPT_SHAPES = {"a": (7, 5), "b": (13,), "c.w": (2, 3, 4), "c.z": (6,)}


def _jax_tree(d):
    """Dotted names as the nested dicts they stand for."""
    out = {}
    for k, v in d.items():
        node = out
        *head, last = k.split(".")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _state_leaves(state):
    """Every tensor of a port optimizer state, by field and name."""
    import dataclasses

    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, dict):
            out.update({f"{f.name}/{n}": t for n, t in v.items()})
        elif isinstance(v, torch.Tensor):
            out[f.name] = v
    return out


OPT_CASES = {
    "lamb": ("fused_lamb", dict(lr=1e-2, weight_decay=0.01)),
    "lamb_clip": ("fused_lamb", dict(lr=1e-2, max_grad_norm=0.5,
                                     weight_decay=0.0)),
    "lamb_nvlamb_nobc": ("fused_lamb", dict(lr=1e-2, use_nvlamb=True,
                                            bias_correction=False)),
    "novograd": ("fused_novograd", dict(lr=1e-2, weight_decay=1e-3)),
    "novograd_init_zero": ("fused_novograd", dict(
        lr=1e-2, init_zero=True, grad_averaging=False)),
    "adagrad": ("fused_adagrad", dict(lr=1e-2, weight_decay=1e-3)),
    "adagrad_w": ("fused_adagrad", dict(lr=1e-2, weight_decay=1e-3,
                                        adagrad_w_mode=True)),
    "adam_swa": ("fused_adam_swa", dict(swa_decay_rate=0.9, lr=1e-2,
                                        weight_decay=1e-3)),
    "adam_swa_w": ("fused_adam_swa", dict(swa_decay_rate=0.9, lr=1e-2,
                                          weight_decay=1e-3,
                                          adam_math_mode=1,
                                          grad_clip_scale=0.5)),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimizer_matches_jax_over_three_steps(case):
    import optax

    import apex_tpu.optimizers as jopts
    import apex_tpu_torch.optimizers as topts

    name, kw = OPT_CASES[case]
    rs = np.random.RandomState(21)
    params = {n: rs.randn(*s).astype(np.float32)
              for n, s in OPT_SHAPES.items()}
    jp = _jax_tree({n: jnp.asarray(v) for n, v in params.items()})
    tp = {n: torch.from_numpy(v.copy()) for n, v in params.items()}
    jopt, opt = getattr(jopts, name)(**kw), getattr(topts, name)(**kw)
    js, ts = jopt.init(jp), opt.init(tp)
    for step in range(3):
        g = {n: rs.randn(*s).astype(np.float32)
             for n, s in OPT_SHAPES.items()}
        jupd, js = jopt.update(_jax_tree({n: jnp.asarray(v)
                                          for n, v in g.items()}), js, jp)
        upd, ts = opt.update({n: torch.from_numpy(v) for n, v in g.items()},
                             ts, tp)
        want = _flat(jupd)
        for n in OPT_SHAPES:
            np.testing.assert_allclose(upd[n].numpy(), want[n],
                                       err_msg=f"{case} step {step} {n}",
                                       **OPT_TOL)
        jstate = js._asdict()
        for key, t in _state_leaves(ts).items():
            field, _, leaf = key.partition("/")
            ref = _flat(jstate[field])[leaf] if leaf else np.asarray(
                jstate[field])
            np.testing.assert_allclose(t.numpy(), ref, err_msg=key,
                                       **OPT_TOL)
        jp = optax.apply_updates(jp, jupd)
        tp = {n: tp[n] + upd[n] for n in tp}
    if name == "fused_adam_swa":
        avg = topts.swa_params(ts, like=tp)
        jav = _flat(jopts.swa_params(js, like=jp))
        for n in OPT_SHAPES:
            np.testing.assert_allclose(avg[n].numpy(), jav[n], **OPT_TOL)


@pytest.mark.parametrize("clip", [True, False])
def test_larc_matches_jax_over_three_steps(clip):
    import optax

    from apex_tpu.optimizers import fused_sgd as jax_sgd
    from apex_tpu.optimizers import larc as jax_larc
    from apex_tpu_torch.optimizers import LARC, fused_sgd, larc

    kw = dict(lr=0.1, trust_coefficient=0.02, clip=clip, weight_decay=1e-4)
    rs = np.random.RandomState(5)
    params = {n: rs.randn(*s).astype(np.float32)
              for n, s in OPT_SHAPES.items()}
    params["zero"] = np.zeros(3, np.float32)  # ||p|| = 0: factor 1
    shapes = {n: v.shape for n, v in params.items()}
    jp = _jax_tree({n: jnp.asarray(v) for n, v in params.items()})
    tp = {n: torch.from_numpy(v.copy()) for n, v in params.items()}
    jopt = jax_larc(jax_sgd(lr=0.1, momentum=0.9), **kw)
    opt = larc(fused_sgd(lr=0.1, momentum=0.9), **kw)
    assert isinstance(LARC(fused_sgd(lr=0.1), lr=0.1), type(opt))
    js, ts = jopt.init(jp), opt.init(tp)
    for _ in range(3):
        g = {n: rs.randn(*s).astype(np.float32) for n, s in shapes.items()}
        jupd, js = jopt.update(_jax_tree({n: jnp.asarray(v)
                                          for n, v in g.items()}), js, jp)
        upd, ts = opt.update({n: torch.from_numpy(v) for n, v in g.items()},
                             ts, tp)
        want = _flat(jupd)
        for n in shapes:
            np.testing.assert_allclose(upd[n].numpy(), want[n], err_msg=n,
                                       **OPT_TOL)
        jp = optax.apply_updates(jp, jupd)
        tp = {n: tp[n] + upd[n] for n in tp}


def test_optimizers_refuse_what_jax_refuses():
    from apex_tpu_torch.optimizers import (
        FusedAdamSWA,
        FusedLAMB,
        fused_adagrad,
        fused_adam_swa,
        fused_lamb,
        fused_novograd,
    )

    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedLAMB(amsgrad=True)
    with pytest.raises(NotImplementedError, match="amsgrad"):
        FusedAdamSWA(0.9, amsgrad=True)
    with pytest.raises(ValueError, match="norm_type"):
        fused_novograd(norm_type=1)
    with pytest.raises(ValueError, match="math mode"):
        fused_adam_swa(0.9, adam_math_mode=7)
    p = {"a": torch.ones(2)}
    for opt in (fused_lamb(), fused_novograd(), fused_adagrad(),
                fused_adam_swa(0.9)):
        with pytest.raises(ValueError, match="requires params"):
            opt.update(p, opt.init(p), None)


@pytest.mark.parametrize("norm_type", [2.0, float("inf"), 1.5])
@pytest.mark.parametrize("max_norm", [1e9, 0.5])
def test_clip_grad_norm_matches_jax(norm_type, max_norm):
    """The norm and the clipped grads, fp32 and a bf16 leaf (cast back to
    its dtype, as JAX does)."""
    from apex_tpu.optimizers import clip_grad_norm as jax_clip
    from apex_tpu_torch.optimizers import clip_grad_norm

    rs = np.random.RandomState(3)
    g = {n: rs.randn(*s).astype(np.float32) for n, s in OPT_SHAPES.items()}
    jg = _jax_tree({n: jnp.asarray(v) for n, v in g.items()})
    jg["h"] = jnp.asarray(g["b"]).astype(jnp.bfloat16)
    tg = {n: torch.from_numpy(v) for n, v in g.items()}
    tg["h"] = torch.from_numpy(g["b"]).to(torch.bfloat16)
    jc, jn = jax_clip(jg, max_norm, norm_type)
    tc, tn = clip_grad_norm(tg, max_norm, norm_type)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    want = _flat(jc)
    for n, t in tc.items():
        assert t.dtype == tg[n].dtype
        ref = want[n].astype(np.float32)
        if t.dtype == torch.bfloat16:  # one bf16 rounding of close values
            np.testing.assert_allclose(t.float().numpy(), ref, rtol=8e-3)
        else:
            np.testing.assert_allclose(t.numpy(), ref, rtol=1e-6, atol=1e-8)


def test_multi_tensor_ops_match_jax():
    from apex_tpu.multi_tensor_apply import multi_tensor_applier as japply
    from apex_tpu.ops import multi_tensor as jmt
    from apex_tpu_torch.multi_tensor_apply import (
        MultiTensorApply,
        multi_tensor_applier,
    )
    from apex_tpu_torch.ops import multi_tensor as tmt

    rs = np.random.RandomState(9)
    x = {n: rs.randn(*s).astype(np.float32) for n, s in OPT_SHAPES.items()}
    y = {n: rs.randn(*s).astype(np.float32) for n, s in OPT_SHAPES.items()}
    jx, jy = (_jax_tree({n: jnp.asarray(v) for n, v in d.items()})
              for d in (x, y))
    tx, ty = ({n: torch.from_numpy(v) for n, v in d.items()} for d in (x, y))
    js, jf = jmt.multi_tensor_scale(jx, 0.25)
    ts, tf = tmt.multi_tensor_scale(tx, 0.25)
    ja, jaf = jmt.multi_tensor_axpby(2.0, -0.5, jx, jy)
    ta, taf = tmt.multi_tensor_axpby(2.0, -0.5, tx, ty)
    for n in OPT_SHAPES:
        np.testing.assert_allclose(ts[n].numpy(), _flat(js)[n], rtol=1e-7)
        np.testing.assert_allclose(ta[n].numpy(), _flat(ja)[n], rtol=1e-6,
                                   atol=1e-7)
    assert bool(tf) is bool(jf) is False and bool(taf) is bool(jaf) is False
    jt, jper = jmt.multi_tensor_l2norm(jx, per_tensor=True)
    tt, tper = tmt.multi_tensor_l2norm(tx, per_tensor=True)
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-6)
    np.testing.assert_allclose(tper.numpy(), np.asarray(jper), rtol=1e-6)
    bad = dict(tx, a=torch.full((7, 5), float("inf")))
    assert bool(tmt.multi_tensor_scale(bad, 1.0)[1])
    assert bool(tmt.multi_tensor_axpby(1.0, 1.0, tx, bad)[1])
    z, zper = tmt.multi_tensor_l2norm({}, per_tensor=True)
    assert float(z) == 0.0 and zper.shape == (0,)

    def op(flag, lists, scale):
        return [[t * scale for t in lst] for lst in lists], flag

    out, flag = multi_tensor_applier(op, 0, [[tx["a"]]], 3.0)
    jout, _ = japply(op, 0, [[jx["a"]]], 3.0)
    np.testing.assert_allclose(out[0][0].numpy(), np.asarray(jout[0][0]))
    assert multi_tensor_applier.available and flag == 0
    assert MultiTensorApply(1024).chunk_size == 1024
