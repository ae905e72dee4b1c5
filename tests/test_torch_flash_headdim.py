"""The port's attention past head_dim 256 against the JAX package's
flash_attention.

The CUDA kernels take d > 256 by their wide route (csrc/flash_wide.cuh);
here, on CPU tensors, the port runs their plain versions, which these
tests hold to JAX's ``flash_attention(impl="pallas")`` (the Pallas
kernel in interpret mode, which takes any head_dim) on the same numpy
inputs, forward and gradients, at (1, 2, 128, d) over one kv head (GQA,
group 2) with a key-padding row, for d = 300 (not a multiple of 8), 320
and 512. The kernels themselves are held to the same plain versions on
the card (``chip_smoke.py``'s ``headdim_flash_parity``, and
``tests/test_torch_cuda.py``). Tolerances: fp32 forward 1e-5 and
gradients 1e-4 (the same fp32 arithmetic in another order, sums over up
to 512 head_dim terms and 128 keys), bf16 forward 2e-2 (P rounded to
bf16 before P.V on both sides, at different points of the online
softmax).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.attention import flash_attention as jax_flash
from apex_tpu_torch.ops import attention as at

FP32_TOL = 1e-5
GRAD_TOL = 1e-4
BF16_TOL = 2e-2

HEAD_DIMS = (300, 320, 512)


def _inputs(d, seed):
    rs = np.random.RandomState(seed)
    q = rs.randn(1, 2, 128, d).astype(np.float32)
    k = rs.randn(1, 1, 128, d).astype(np.float32)
    v = rs.randn(1, 1, 128, d).astype(np.float32)
    kpm = np.zeros((1, 128), bool)
    kpm[0, 100:] = True
    do = rs.randn(1, 2, 128, d).astype(np.float32)
    return q, k, v, kpm, do


def _jax_fwd(q, k, v, kpm, dtype=jnp.float32):
    return jax_flash(*(jnp.asarray(t, dtype) for t in (q, k, v)),
                     causal=True, key_padding_mask=jnp.asarray(kpm),
                     impl="pallas", block_q=32, block_k=32)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_forward_past_256_matches_pallas(d):
    q, k, v, kpm, _ = _inputs(d, seed=d)
    ref = _jax_fwd(q, k, v, kpm)
    out = at.flash_attention(*(torch.from_numpy(t) for t in (q, k, v)),
                             causal=True,
                             key_padding_mask=torch.from_numpy(kpm))
    assert out.shape == q.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FP32_TOL,
                               rtol=FP32_TOL)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_gradients_past_256_match_pallas(d):
    q, k, v, kpm, do = _inputs(d, seed=d + 1)
    _, vjp = jax.vjp(lambda a, b, c: _jax_fwd(a, b, c, kpm),
                     *(jnp.asarray(t) for t in (q, k, v)))
    ref = vjp(jnp.asarray(do))
    ts = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    out = at.flash_attention(*ts, causal=True,
                             key_padding_mask=torch.from_numpy(kpm))
    assert type(out.grad_fn).__name__ == "_FlashFnBackward"
    out.backward(torch.from_numpy(do))
    for t, r in zip(ts, ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r),
                                   atol=GRAD_TOL, rtol=GRAD_TOL)


def test_bf16_forward_past_256_matches_pallas():
    q, k, v, kpm, _ = _inputs(320, seed=7)
    ref = _jax_fwd(q, k, v, kpm, jnp.bfloat16)
    out = at.flash_attention(
        *(torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v)),
        causal=True, key_padding_mask=torch.from_numpy(kpm))
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=BF16_TOL, rtol=BF16_TOL)


def test_cuda_arguments_take_any_head_dim():
    """The wrapper refuses no head_dim: its check of a CUDA launch's
    arguments has no upper bound (the kernels' wide route takes d > 256),
    so what reaches the card at d = 512 is only the dtype and device."""
    q = torch.zeros(1, 2, 4, 512)
    with pytest.raises(ValueError, match="CUDA"):
        at._check_kernel_args(q, q, q, None)
    assert not hasattr(at, "_MAX_HEAD_DIM")
