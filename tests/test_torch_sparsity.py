"""apex_tpu_torch.contrib.sparsity against the JAX package's.

Masks are 0/1 and the permutation search is the same numpy code, so both
are held EXACTLY: the 1-D and 2-D 2:4 masks of seeded matrices, ASP's
masks of a flax-layout tree (``kernel``, (in, out)) and of torch-layout
weights (``nn.Linear``'s (out, in), a convolution's OIHW) against JAX's
masks of the converted kernels (mask for mask), the permutation searches'
permutations and ``permute_and_mask``'s mask. A masked fine-tune with
the port's ``fused_adam`` keeps every pruned weight at exactly zero and
follows JAX's ``fused_adam`` + ``masked_update`` to 1e-5 (fp32 Adam
steps from gradients summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import apex_tpu.contrib.sparsity as js
import apex_tpu_torch.contrib.sparsity as ts
from apex_tpu.optimizers import fused_adam as jax_fused_adam
from apex_tpu_torch.models import gpt_params_from_jax
from apex_tpu_torch.optimizers import fused_adam

TOL = dict(rtol=1e-5, atol=1e-5)


def equal(got, want):
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))


@pytest.mark.parametrize("pattern", ["m4n2_1d", "m4n2_2d_best"])
@pytest.mark.parametrize("axis", [-1, 0])
def test_create_mask_equals_jax(pattern, axis):
    a = np.random.RandomState(0).randn(16, 24).astype(np.float32)
    want = js.create_mask(jnp.asarray(a), pattern, axis=axis)
    got = ts.create_mask(torch.from_numpy(a), pattern, axis=axis)
    equal(got, want)
    assert ts.fill(got) == pytest.approx(0.5)


def test_mn_masks_and_refusals():
    a = np.random.RandomState(1).randn(3, 8, 12).astype(np.float32)
    equal(ts.mn_1d_best(torch.from_numpy(a), 4, 2),
          js.mn_1d_best(jnp.asarray(a), 4, 2))
    equal(ts.mn_2d_best(torch.from_numpy(a), 4, 2),
          js.mn_2d_best(jnp.asarray(a), 4, 2))
    with pytest.raises(ValueError):
        ts.mn_1d_best(torch.zeros(4, 6), 4, 2)
    with pytest.raises(ValueError):
        ts.create_mask(torch.zeros(4, 8), "m2n1")


def _tree(rs):
    """A flax-layout tree: eligible kernels, an embedding, a bias, a
    kernel whose reduction dim is too short, a conv kernel (HWIO)."""
    return {
        "fc1": {"kernel": rs.randn(64, 32).astype(np.float32),
                "bias": rs.randn(32).astype(np.float32)},
        "fc2": {"kernel": rs.randn(32, 48).astype(np.float32)},
        "short": {"kernel": rs.randn(16, 8).astype(np.float32)},
        "embed": {"kernel": rs.randn(64, 32).astype(np.float32)},
        "conv": {"kernel": rs.randn(3, 3, 32, 16).astype(np.float32)},
    }


@pytest.mark.parametrize("pattern", ["m4n2_1d", "m4n2_2d_best"])
def test_asp_masks_equal_jax(pattern):
    tree = _tree(np.random.RandomState(2))
    want = jax.tree_util.tree_map(
        np.asarray, js.compute_sparse_masks(
            jax.tree_util.tree_map(jnp.asarray, tree), pattern))
    # the port's flax-layout modules: the same tree by dotted names
    got = ts.compute_sparse_masks(gpt_params_from_jax(tree), pattern)
    for name, mask in gpt_params_from_jax(want).items():
        equal(got[name], mask)
    # torch-layout weights: Linear (out, in) and conv OIHW, whose masks
    # equal JAX's of the kernels the converter makes of them
    weights = {"fc1.weight": torch.from_numpy(tree["fc1"]["kernel"].T),
               "fc2.weight": torch.from_numpy(tree["fc2"]["kernel"].T),
               "conv.weight": torch.from_numpy(
                   tree["conv"]["kernel"].transpose(3, 2, 0, 1).copy())}
    got = ts.compute_sparse_masks(weights, pattern)
    equal(got["fc1.weight"], want["fc1"]["kernel"].T)
    equal(got["fc2.weight"], want["fc2"]["kernel"].T)
    equal(got["conv.weight"], want["conv"]["kernel"].transpose(3, 2, 0, 1))
    assert float(got["fc1.weight"].mean()) == 0.5


def test_eligibility():
    elig = ts.default_eligibility
    assert elig("fc.weight", torch.zeros(8, 32))
    assert elig("fc.kernel", torch.zeros(32, 8))
    assert not elig("fc.kernel", torch.zeros(8, 32))  # reduction dim 8
    assert not elig("fc.bias", torch.zeros(32, 32))
    assert not elig("embed.weight", torch.zeros(32, 32))
    assert not elig("fc.weight", torch.zeros(32, 32, dtype=torch.int32))
    assert not elig("fc.weight", torch.zeros(32))


def test_permutation_searches_equal_jax():
    a = np.random.RandomState(3).randn(16, 32).astype(np.float32)
    np.testing.assert_array_equal(
        ts.exhaustive_search(a, escape_attempts=3, seed=1),
        js.exhaustive_search(a, escape_attempts=3, seed=1))
    np.testing.assert_array_equal(
        ts.search_for_good_permutation(a, max_iters=300, seed=2),
        js.search_for_good_permutation(a, max_iters=300, seed=2))
    for method in ("exhaustive", "greedy"):
        perm, mask = ts.permute_and_mask(torch.from_numpy(a), method=method)
        jperm, jmask = js.permute_and_mask(jnp.asarray(a), method=method)
        np.testing.assert_array_equal(perm, jperm)
        equal(mask, jmask)
    inv = ts.invert_permutation(perm)
    t = torch.from_numpy(a)
    assert torch.equal(ts.apply_permutation(ts.apply_permutation(t, perm),
                                            inv), t)
    with pytest.raises(ValueError, match="method"):
        ts.permute_and_mask(t, method="random")


def test_masked_fine_tune_keeps_zeros_and_follows_jax():
    rs = np.random.RandomState(4)
    params = {"in": {"kernel": (rs.randn(32, 64) * 0.1).astype(np.float32)},
              "out": {"kernel": (rs.randn(64, 4) * 0.1).astype(np.float32)}}
    x = rs.randn(16, 32).astype(np.float32)
    y = rs.randn(16, 4).astype(np.float32)

    def jloss(p):
        return jnp.mean((jnp.tanh(x @ p["in"]["kernel"])
                         @ p["out"]["kernel"] - y) ** 2)

    jasp = js.ASP()
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jasp.init_model_for_pruning(jp)
    with pytest.warns(UserWarning):
        jopt = jasp.init_optimizer_for_pruning(jax_fused_adam(lr=1e-3))
        jstate = jopt.init(jp)

    asp = ts.ASP()
    tp = gpt_params_from_jax(params)
    asp.init_model_for_pruning(tp)
    with pytest.warns(UserWarning):
        opt = asp.init_optimizer_for_pruning(fused_adam(lr=1e-3))
        state = opt.init(tp)

    def tloss(p):
        return torch.mean((torch.tanh(torch.from_numpy(x) @ p["in.kernel"])
                           @ p["out.kernel"] - torch.from_numpy(y)) ** 2)

    def tstep(p, state):
        p = {n: t.detach().requires_grad_(True) for n, t in p.items()}
        loss = tloss(p)
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        upd, state = opt.update(grads, state, p)
        return {n: (t + upd[n]).detach() for n, t in p.items()}, state

    def jstep(p, state):
        g = jax.grad(jloss)(p)
        upd, state = jopt.update(g, state, p)
        return optax.apply_updates(p, upd), state

    for _ in range(2):  # dense
        tp, state = tstep(tp, state)
        jp, jstate = jstep(jp, jstate)
    with pytest.raises(RuntimeError, match="placeholder"):
        asp.compute_sparse_masks(tp)
    tp, state = asp.prune_trained_model(tp, state)
    jp, jstate = jasp.prune_trained_model(jp, jstate)
    for _ in range(3):  # sparse
        tp, state = tstep(tp, state)
        jp, jstate = jstep(jp, jstate)
    want = gpt_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    masks = asp.masks
    for name, t in tp.items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(), **TOL)
        assert bool((t[masks[name] == 0] == 0).all()), name
        equal(masks[name], gpt_params_from_jax(
            jax.tree_util.tree_map(np.asarray, jasp.masks))[name])


def test_prune_example_on_the_cpu():
    from apex_tpu_torch.examples.sparsity import prune_mlp

    lines = []
    with pytest.warns(UserWarning, match="before masks"):
        rep = prune_mlp.train(prune_mlp.parse_args(
            ["--device", "cpu", "--steps", "30"]), log=lines.append)
    assert rep["final_loss"] < rep["pruned_loss"]
    assert rep["permuted_kept"] >= rep["naive_kept"]
    assert lines[-1].endswith("2:4 zeros preserved through training")
