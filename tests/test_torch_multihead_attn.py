"""apex_tpu_torch.contrib.multihead_attn against the JAX package's modules.

Both modules across the feature matrix (packed and separate QKV, biases,
``include_norm_add``, ``mask_additive`` against boolean masks, causal,
key padding with a fully padded row, the fused and the unfused route),
from one set of parameters (the JAX ones, perturbed so that biases and
the norm's gamma are not trivial, through
``multihead_attn_params_from_jax``) and the same seeded inputs and
cotangents: outputs, the input gradients and every parameter gradient.
The JAX modules run as their own tests run them on the CPU: ``impl=
"auto"`` resolves to the jnp path, and one case also runs JAX's
``impl="pallas"`` (the flash kernel in interpret mode) against the port's
flash route. Tolerance 1e-5 (fp32: the same products and sums in another
order through a few matmuls at width 32). Dropout draws from a
``torch.Generator``; its masks are recomputed here from a twin generator
and fed to a numpy composition.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.contrib as jc
import apex_tpu_torch.contrib as tc
from apex_tpu_torch.models import multihead_attn_params_from_jax
from apex_tpu_torch.transformer.layer import keep_mask

S, SK, B, E, H = 8, 6, 3, 32, 4
TOL = dict(rtol=1e-5, atol=1e-5)


def close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **TOL)


def padding_mask(sk):
    """(B, sk): row 0 unpadded, row 1 fully padded, row 2 the last two
    keys padded."""
    kpm = np.zeros((B, sk), bool)
    kpm[1] = True
    kpm[2, -2:] = True
    return kpm


def perturbed(variables, seed):
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: p + jnp.asarray(rs.randn(*p.shape) * 0.1, p.dtype),
        variables)


def run_both(jmod, tmod_cls, kw, inputs, call_kw, seed=0):
    """JAX output and gradients (inputs, params) against the port's."""
    rs = np.random.RandomState(seed)
    xs = [jnp.asarray(x) for x in inputs]
    variables = perturbed(jmod.init(jax.random.PRNGKey(seed), *xs,
                                    **call_kw), seed + 1)
    want, vjp = jax.vjp(lambda v, *a: jmod.apply(v, *a, **call_kw),
                        variables, *xs)
    ct = rs.randn(*want.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(ct))
    port = tmod_cls(**kw, device="cpu")
    port.load_state_dict(multihead_attn_params_from_jax(
        jax.tree_util.tree_map(np.asarray, variables["params"])))
    txs = [torch.from_numpy(np.asarray(x)).requires_grad_(True)
           for x in inputs]
    pkw = {k: torch.from_numpy(np.asarray(v)) if v is not None else None
           for k, v in call_kw.items()}
    got = port(*txs, **pkw)
    got.backward(torch.from_numpy(ct))
    close(got, want)
    for tx, g in zip(txs, jgrads[1:]):
        close(tx.grad, g)
    jparams = jgrads[0]["params"]
    for name, p in port.named_parameters():
        close(p.grad, jparams[name])
    return got


SELF_CASES = {
    "packed": dict(),
    "separate qkv + bias": dict(separate_qkv_params=True, bias=True),
    "norm-add + bias": dict(include_norm_add=True, bias=True),
    "causal": dict(causal=True),
    "causal + bias, unfused": dict(causal=True, bias=True, impl="xla"),
    "packed, unfused": dict(impl="xla"),
}


@pytest.mark.parametrize("padded", [False, True], ids=["", "key-padding"])
@pytest.mark.parametrize("case", list(SELF_CASES))
def test_self_attn(case, padded):
    kw = dict(embed_dim=E, num_heads=H, **SELF_CASES[case])
    x = np.random.RandomState(3).randn(S, B, E).astype(np.float32)
    call = {"key_padding_mask": padding_mask(S)} if padded else {}
    got = run_both(jc.SelfMultiheadAttn(**kw), tc.SelfMultiheadAttn, kw,
                   [x], call)
    if padded and kw.get("impl") != "xla" and not (
            kw.get("bias") or kw.get("include_norm_add")):
        # the fused route outputs zeros on a fully padded row
        assert bool((got[:, 1] == 0).all())


@pytest.mark.parametrize("boolean", [False, True])
def test_self_attn_masks(boolean):
    """``mask_additive`` with an additive (S, S) mask and key padding
    folded in as -1e30, and the boolean attention mask."""
    rs = np.random.RandomState(4)
    x = rs.randn(S, B, E).astype(np.float32)
    kpm = padding_mask(S)
    kpm[1] = False  # an additive mask over a fully padded row is NaN-free
    if boolean:
        mask = rs.rand(S, S) > 0.7
        np.fill_diagonal(mask, False)
        kw = dict(embed_dim=E, num_heads=H, bias=True)
    else:
        mask = (rs.randn(S, S) * 2).astype(np.float32)
        kw = dict(embed_dim=E, num_heads=H, mask_additive=True)
    run_both(jc.SelfMultiheadAttn(**kw), tc.SelfMultiheadAttn, kw, [x],
             {"key_padding_mask": kpm, "attn_mask": mask})


ENCDEC_CASES = {
    "plain": dict(),
    "bias": dict(bias=True),
    "norm-add + bias": dict(include_norm_add=True, bias=True),
    "unfused": dict(bias=True, impl="xla"),
}


@pytest.mark.parametrize("padded", [False, True], ids=["", "key-padding"])
@pytest.mark.parametrize("case", list(ENCDEC_CASES))
def test_encdec_attn(case, padded):
    kw = dict(embed_dim=E, num_heads=H, **ENCDEC_CASES[case])
    rs = np.random.RandomState(5)
    q = rs.randn(S, B, E).astype(np.float32)
    k = rs.randn(SK, B, E).astype(np.float32)  # sq != sk
    call = {"key_padding_mask": padding_mask(SK)} if padded else {}
    run_both(jc.EncdecMultiheadAttn(**kw), tc.EncdecMultiheadAttn, kw,
             [q, k], call)


def test_flash_route_against_jax_pallas_interpret():
    """JAX's ``impl="pallas"`` (the Pallas flash kernel in interpret mode)
    against the port's flash route, with key padding and a fully padded
    row, norm-add and biases."""
    kw = dict(embed_dim=E, num_heads=H, include_norm_add=True, bias=True,
              impl="pallas")
    x = np.random.RandomState(6).randn(S, B, E).astype(np.float32)
    got = run_both(jc.SelfMultiheadAttn(**kw), tc.SelfMultiheadAttn, kw,
                   [x], {"key_padding_mask": padding_mask(S)})
    assert got.shape == (S, B, E)


def test_pallas_refuses_the_unfused_cases():
    x = torch.randn(S, B, E)
    mod = tc.SelfMultiheadAttn(E, H, mask_additive=True, impl="pallas",
                               device="cpu")
    with pytest.raises(ValueError, match="fused path"):
        mod(x, attn_mask=torch.zeros(S, S))
    mod = tc.SelfMultiheadAttn(E, H, dropout=0.1, impl="pallas",
                               device="cpu")
    with pytest.raises(ValueError, match="fused path"):
        mod(x, deterministic=False, generator=torch.Generator())
    assert mod(x).shape == (S, B, E)  # deterministic: the fused path
    with pytest.raises(ValueError, match="unknown impl"):
        tc.SelfMultiheadAttn(E, H, impl="fast", device="cpu")
    with pytest.raises(ValueError, match="generator"):
        tc.SelfMultiheadAttn(E, H, dropout=0.1, device="cpu")(
            x, deterministic=False)


def test_dropout_matches_a_composition_with_the_same_masks():
    """Attention and output dropout (norm-add) from a generator, against a
    numpy composition with the masks a twin generator draws in the same
    order."""
    rate = 0.25
    rs = np.random.RandomState(7)
    x = rs.randn(S, B, E).astype(np.float32)
    mod = tc.SelfMultiheadAttn(E, H, dropout=rate, include_norm_add=True,
                               bias=True, device="cpu", seed=3)
    with torch.no_grad():
        for p in mod.parameters():
            p.add_(torch.from_numpy(rs.randn(*p.shape).astype(np.float32))
                   * 0.1)
    got = mod(torch.from_numpy(x), deterministic=False,
              generator=torch.Generator().manual_seed(5))
    twin = torch.Generator().manual_seed(5)
    keep_p = keep_mask(twin, 1 - rate, (B, H, S, S), "cpu").numpy()
    keep_o = keep_mask(twin, 1 - rate, (S, B, E), "cpu").numpy()
    p = {n: t.detach().numpy() for n, t in mod.named_parameters()}
    mu, var = x.mean(-1, keepdims=True), x.var(-1, keepdims=True)
    ln = (x - mu) / np.sqrt(var + 1e-5) * p["lyr_nrm_gamma"] \
        + p["lyr_nrm_beta"]
    q, k, v = np.split(ln @ p["in_proj_weight"] + p["in_proj_bias"], 3, -1)

    def heads(t):
        return t.reshape(S, B, H, E // H).transpose(1, 2, 0, 3)

    s = heads(q) @ heads(k).transpose(0, 1, 3, 2) / np.sqrt(E // H)
    probs = np.exp(s - s.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    probs = np.where(keep_p, probs / (1 - rate), 0.0)
    ctx = (probs @ heads(v)).transpose(2, 0, 1, 3).reshape(S, B, E)
    out = ctx @ p["out_proj_weight"] + p["out_proj_bias"]
    want = x + np.where(keep_o, out / (1 - rate), 0.0)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("argv", [["--norm-add", "--biases"],
                                  ["--encdec-attn", "--fwd", "--ref"]])
def test_perf_example_on_the_cpu(argv):
    from apex_tpu_torch.examples.multihead_attn import (
        perf_test_multihead_attn as ex,
    )

    lines = []
    rows = ex.run(ex.parse_args(
        ["--device", "cpu", "--num-seqs-start", "2", "--num-seqs-stop", "4",
         "--num-seqs-inc", "2", "--layers", "2", "--hidden-dim", "32",
         "--heads", "4", "--seq-length", "8", *argv]), log=lines.append,
        reps=1, target_signal=0.0, max_span=2)
    assert [r["seqs"] for r in rows] == [2, 4]
    assert all(r["ms"] > 0 and r["mtok_s"] > 0 for r in rows)
    assert len(lines) == 3 and "Mtok/s" in lines[-1]
