"""apex_tpu_torch.ops.layer_norm against the JAX package's layer_norm.

The same numpy inputs, made from a seed, go through the JAX function with
``impl="pallas"`` (the Pallas kernel in interpret mode on the CPU; hidden
sizes that are not multiples of 128 take its XLA reference, as on the
TPU) and through the port on CPU tensors, which runs the plain version of
the CUDA kernel. Tolerances: 1e-5 in fp32 (the same fp32 arithmetic
summed in another order), 2e-2 in bf16 (one bf16 ulp of values up to 4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import layer_norm as jax_layer_norm
from apex_tpu.ops import rms_norm as jax_rms_norm
from apex_tpu.ops.layer_norm import _ln_ref as jax_ln_ref
from apex_tpu_torch.ops.layer_norm import layer_norm, rms_norm

FP32_TOL = 1e-5
BF16_TOL = 2e-2


def _inputs(rows, hidden, seed=0):
    rs = np.random.RandomState(seed)
    x = (rs.randn(rows, hidden) * 3 + 1).astype(np.float32)
    w = rs.randn(hidden).astype(np.float32)
    b = rs.randn(hidden).astype(np.float32)
    return x, w, b


# (8, 768), (768, 768) and (8192, 768) are the GPT-2 serving and training
# shapes at which the card tests hold the CUDA forward (its
# register-resident row) to this plain version; 770 is not a multiple of
# the kernel's 16-byte vector, so it takes the kernel's loop.
@pytest.mark.parametrize("rows,hidden", [(1, 128), (13, 256), (64, 768),
                                         (5, 100), (8, 768), (768, 768),
                                         (8192, 768), (77, 770)])
def test_layer_norm_matches_pallas(rows, hidden):
    x, w, b = _inputs(rows, hidden)
    ref = jax_layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                         eps=1e-5, impl="pallas")
    out = layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                     torch.from_numpy(b), eps=1e-5)
    assert out.dtype == torch.float32 and out.shape == x.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FP32_TOL,
                               rtol=FP32_TOL)


def test_layer_norm_3d_and_no_affine_match_reference():
    x, _, _ = _inputs(24, 128, seed=1)
    x3 = x.reshape(4, 6, 128)
    ref = jax_ln_ref(jnp.asarray(x3), None, None, 1e-5)
    out = layer_norm(torch.from_numpy(x3), eps=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FP32_TOL,
                               rtol=FP32_TOL)


def test_layer_norm_bf16_input_fp32_params():
    x, w, b = _inputs(32, 256, seed=2)
    ref = jax_layer_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w),
                         jnp.asarray(b), eps=1e-5, impl="pallas")
    out = layer_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(w),
                     torch.from_numpy(b), eps=1e-5)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=BF16_TOL, rtol=BF16_TOL)


def test_layer_norm_bf16_params_match_reference():
    x, w, b = _inputs(8, 128, seed=3)
    ref = jax_ln_ref(jnp.asarray(x), jnp.asarray(w, jnp.bfloat16),
                     jnp.asarray(b, jnp.bfloat16), 1e-5)
    out = layer_norm(torch.from_numpy(x), torch.from_numpy(w).bfloat16(),
                     torch.from_numpy(b).bfloat16(), eps=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FP32_TOL,
                               rtol=FP32_TOL)


@pytest.mark.parametrize("rows,hidden", [(7, 128), (16, 384)])
def test_rms_norm_matches_pallas(rows, hidden):
    x, w, _ = _inputs(rows, hidden, seed=4)
    ref = jax_rms_norm(jnp.asarray(x), jnp.asarray(w), eps=1e-5,
                       impl="pallas")
    out = rms_norm(torch.from_numpy(x), torch.from_numpy(w), eps=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FP32_TOL,
                               rtol=FP32_TOL)


# The RMSNorm forward kernel holds a row in registers where hidden is a
# multiple of the 16-byte vector and fits the register budget (Llama's 2048,
# at a prefill's rows and a decode step's 8 or 1), and keeps its loop
# otherwise (1000). Its plain version is held to the JAX function at those
# shapes, under no_grad as the engine calls it.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("rows,hidden", [(1, 2048), (8, 2048), (5, 1000)])
def test_rms_norm_forward_at_the_kernel_routes_matches_jax(rows, hidden,
                                                          dtype):
    x, w, _ = _inputs(rows, hidden, seed=15)
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref = jax_rms_norm(jnp.asarray(x, jd), jnp.asarray(w), eps=1e-5,
                       impl="pallas")
    with torch.no_grad():
        out = rms_norm(torch.from_numpy(x).to(dtype), torch.from_numpy(w),
                       eps=1e-5)
    assert out.dtype == dtype and out.shape == x.shape
    tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=tol, rtol=tol)


# -- backward ---------------------------------------------------------------
# The port's layer_norm differentiates through _LayerNormFn, whose CPU
# backward is _ln_bwd_ref (the plain version of the backward kernel),
# against jax.vjp of the Pallas path (its custom_vjp runs _ln_bwd_kernel in
# interpret mode). Tolerances: fp32 1e-5 for dx and 1e-4 for dgamma/dbeta
# (sums over the rows in another order); bf16 x: dx 2e-2 (one bf16 rounding
# of dx), dgamma/dbeta 1e-4 (both sides upcast the same bf16 x and dy and
# sum in fp32).

def _ln_grads_jax(x, w, b, dy):
    import jax

    def f(xx, ww, bb):
        return jax_layer_norm(xx, ww, bb, eps=1e-5, impl="pallas")

    _, vjp = jax.vjp(f, x, jnp.asarray(w), jnp.asarray(b))
    return [np.asarray(g.astype(jnp.float32)) for g in vjp(dy)]


def _ln_grads_port(x, w, b, dy):
    xt = x.clone().requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    layer_norm(xt, wt, bt, eps=1e-5).backward(dy)
    return [t.grad.float().numpy() for t in (xt, wt, bt)]


@pytest.mark.parametrize("rows,hidden", [(1, 128), (13, 256), (40, 384)])
def test_layer_norm_backward_matches_pallas(rows, hidden):
    x, w, b = _inputs(rows, hidden, seed=5)
    dy = np.random.RandomState(6).randn(rows, hidden).astype(np.float32)
    ref = _ln_grads_jax(jnp.asarray(x), w, b, jnp.asarray(dy))
    out = _ln_grads_port(torch.from_numpy(x), w, b, torch.from_numpy(dy))
    for o, r, tol in zip(out, ref, (FP32_TOL, 1e-4, 1e-4)):
        np.testing.assert_allclose(o, r, atol=tol, rtol=tol)


def test_layer_norm_backward_bf16_x_fp32_params_matches_pallas():
    x, w, b = _inputs(24, 256, seed=7)
    dy = np.random.RandomState(8).randn(24, 256).astype(np.float32)
    ref = _ln_grads_jax(jnp.asarray(x, jnp.bfloat16), w, b,
                        jnp.asarray(dy, jnp.bfloat16))
    out = _ln_grads_port(torch.from_numpy(x).bfloat16(), w, b,
                         torch.from_numpy(dy).bfloat16())
    for o, r, tol in zip(out, ref, (BF16_TOL, 1e-4, 1e-4)):
        np.testing.assert_allclose(o, r, atol=tol, rtol=tol)


def test_ln_bwd_ref_matches_autograd_of_ln_ref():
    """The plain backward agrees with autograd of the plain forward, also
    on a hidden size the JAX kernel does not take and with no affine."""
    from apex_tpu_torch.ops.layer_norm import _ln_bwd_ref, _ln_ref

    x, w, _ = _inputs(9, 100, seed=9)
    dy = torch.from_numpy(np.random.RandomState(10).randn(9, 100)
                          .astype(np.float32))
    for wt in (torch.from_numpy(w), None):
        xt = torch.from_numpy(x).requires_grad_(True)
        ww = None if wt is None else wt.clone().requires_grad_(True)
        _ln_ref(xt, ww, None, 1e-5).backward(dy)
        dx, dg, db = _ln_bwd_ref(torch.from_numpy(x), wt, dy, 1e-5)
        torch.testing.assert_close(dx, xt.grad, atol=FP32_TOL, rtol=FP32_TOL)
        if ww is not None:
            torch.testing.assert_close(dg, ww.grad, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(db, dy.sum(0))


def test_layer_norm_without_grad_skips_the_function():
    x, w, b = _inputs(4, 128)
    wt = torch.from_numpy(w).requires_grad_(True)
    with torch.no_grad():
        out = layer_norm(torch.from_numpy(x), wt, torch.from_numpy(b))
    assert out.grad_fn is None
    out = layer_norm(torch.from_numpy(x), wt, torch.from_numpy(b))
    assert type(out.grad_fn).__name__ == "_LayerNormFnBackward"


# -- RMSNorm forward and backward -------------------------------------------
# The port's rms_norm differentiates through _RMSNormFn, whose CPU backward
# is _rms_bwd_ref (the plain version of the RMSNorm backward kernel),
# against jax.vjp of rms_norm(impl="pallas"): with a weight its custom_vjp
# runs _rms_fwd_kernel and _rms_bwd_kernel in interpret mode; without one
# the JAX function takes _rms_ref and autodiff. Tolerances as for
# LayerNorm: fp32 1e-5 (y, dx) and 1e-4 (dgamma, a sum over the rows in
# another order); bf16 x: y and dx 2e-2 (one bf16 rounding), dgamma 1e-4.

def _rms_both(x_np, w_np, dy_np, dtype):
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jw = None if w_np is None else jnp.asarray(w_np)

    def f(xx, ww):
        return jax_rms_norm(xx, ww, eps=1e-5, impl="pallas")

    import jax

    y_ref, vjp = jax.vjp(f, jnp.asarray(x_np, jd), jw)
    grads_ref = vjp(jnp.asarray(dy_np, jd))
    xt = torch.from_numpy(x_np).to(dtype).requires_grad_(True)
    wt = None if w_np is None else torch.from_numpy(w_np).requires_grad_(True)
    y = rms_norm(xt, wt, eps=1e-5)
    y.backward(torch.from_numpy(dy_np).to(dtype))
    ref = [y_ref, grads_ref[0]] + ([] if w_np is None else [grads_ref[1]])
    out = [y, xt.grad] + ([] if w_np is None else [wt.grad])
    return ([np.asarray(r.astype(jnp.float32)) for r in ref],
            [o.detach().float().numpy() for o in out])


# (8192, 2048) is the TinyLlama fine-tuning shape at which the card tests
# hold the CUDA backward (its register-resident rows) to this plain
# version; 770 is not a multiple of the kernel's vector (its loop).
@pytest.mark.parametrize("weighted", [True, False], ids=["w", "no_w"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("rows,hidden", [(1, 128), (13, 256), (40, 384),
                                         (8192, 2048), (77, 770)])
def test_rms_norm_forward_backward_matches_pallas(rows, hidden, dtype,
                                                  weighted):
    x, w, _ = _inputs(rows, hidden, seed=11)
    dy = np.random.RandomState(12).randn(rows, hidden).astype(np.float32)
    ref, out = _rms_both(x, w if weighted else None, dy, dtype)
    tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
    for o, r, t in zip(out, ref, (tol, tol, 1e-4)):
        np.testing.assert_allclose(o, r, atol=t, rtol=t)


def test_rms_bwd_ref_matches_autograd_of_rms_ref():
    """The plain backward agrees with autograd of the plain forward, on a
    hidden size the JAX kernel does not take, with and without weight."""
    from apex_tpu_torch.ops.layer_norm import _rms_bwd_ref, _rms_ref

    x, w, _ = _inputs(9, 100, seed=13)
    dy = torch.from_numpy(np.random.RandomState(14).randn(9, 100)
                          .astype(np.float32))
    for wt in (torch.from_numpy(w), None):
        xt = torch.from_numpy(x).requires_grad_(True)
        ww = None if wt is None else wt.clone().requires_grad_(True)
        _rms_ref(xt, ww, 1e-5).backward(dy)
        dx, dg = _rms_bwd_ref(torch.from_numpy(x), wt, dy, 1e-5)
        torch.testing.assert_close(dx, xt.grad, atol=FP32_TOL, rtol=FP32_TOL)
        if ww is not None:
            torch.testing.assert_close(dg, ww.grad, atol=1e-4, rtol=1e-4)


def test_rms_norm_without_grad_skips_the_function():
    x, w, _ = _inputs(4, 128)
    wt = torch.from_numpy(w).requires_grad_(True)
    with torch.no_grad():
        out = rms_norm(torch.from_numpy(x), wt)
    assert out.grad_fn is None
    out = rms_norm(torch.from_numpy(x), wt)
    assert type(out.grad_fn).__name__ == "_RMSNormFnBackward"
