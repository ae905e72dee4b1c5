"""apex_tpu_torch.ops.rope against the JAX package's ops/rope.py.

The same numpy inputs, made from a seed, go through the JAX functions and
the port's on CPU tensors: the angle table, full rotation, partial
rotation (``rotary_percent`` 0.5, the rest passed through) and the
cached cos/sin form, in fp32 and bf16, and the gradient of the port's
rotation (autograd) against ``jax.vjp``. Tolerances: the angles are the
same fp32 products, so equal to 1 ulp (atol 1e-5 on angles up to 64);
rotated values 1e-5 in fp32 (cos and sin from two libms, a few ulp);
bf16 outputs 2e-2 (one bf16 rounding of values up to ~4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import rope as jax_rope
from apex_tpu.transformer import TransformerConfig as JaxConfig
from apex_tpu.transformer.layer import (
    rotary_embedding_for as jax_rotary_embedding_for,
)
from apex_tpu_torch.ops import rope
from apex_tpu_torch.transformer import TransformerConfig
from apex_tpu_torch.transformer.layer import rotary_embedding_for

FP32_TOL = 1e-5
BF16_TOL = 2e-2


def _t(s=24, b=2, h=4, d=32, seed=0):
    return np.random.RandomState(seed).randn(s, b, h, d).astype(np.float32)


@pytest.mark.parametrize("dim,seq,base", [(32, 24, 10000.0), (16, 64, 500.0)])
def test_rope_frequencies_match_jax(dim, seq, base):
    ref = jax_rope.rope_frequencies(dim, seq, base=base)
    out = rope.rope_frequencies(dim, seq, base=base)
    assert out.shape == (seq, 1, 1, dim) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FP32_TOL,
                               rtol=1e-6)


@pytest.mark.parametrize("percent", [1.0, 0.5], ids=["full", "partial"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rotary_pos_emb_matches_jax(percent, dtype):
    t = _t()
    rot = int(t.shape[-1] * percent)
    jf = jax_rope.rope_frequencies(rot, t.shape[0])
    ref = jax_rope.apply_rotary_pos_emb(jnp.asarray(t, dtype), jf)
    out = rope.apply_rotary_pos_emb(torch.from_numpy(t).to(getattr(
        torch, dtype)), rope.rope_frequencies(rot, t.shape[0]))
    assert out.dtype == getattr(torch, dtype) and out.shape == t.shape
    tol = FP32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=tol, rtol=tol)
    if percent < 1.0:  # channels past rot_dim pass through untouched
        np.testing.assert_array_equal(out[..., rot:].float().numpy(),
                                      torch.from_numpy(t[..., rot:]).to(
                                          getattr(torch, dtype)).float())


def test_apply_rotary_pos_emb_cached_matches_jax():
    t = _t(seed=1)
    f = np.asarray(jax_rope.rope_frequencies(32, t.shape[0]))
    cos_, sin_ = np.cos(f), np.sin(f)
    ref = jax_rope.apply_rotary_pos_emb_cached(jnp.asarray(t), cos_, sin_)
    out = rope.apply_rotary_pos_emb_cached(
        torch.from_numpy(t), torch.from_numpy(cos_), torch.from_numpy(sin_))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FP32_TOL,
                               rtol=FP32_TOL)


def test_cached_rows_per_batch_row_match_each_rows_own_rotation():
    """Rows of one batch at different positions ((s, b, 1, d) tables, as
    a decode step builds them) rotate as each row alone would."""
    t = _t(s=1, b=3, seed=2)
    positions = [5, 0, 17]
    f = rope.rope_frequencies(32, 32)[:, 0, 0, :]
    cos_, sin_ = (g(f)[positions][None, :, None, :] for g in (torch.cos,
                                                               torch.sin))
    out = rope.apply_rotary_pos_emb_cached(torch.from_numpy(t), cos_, sin_)
    assert out.shape == t.shape
    jf = jax_rope.rope_frequencies(32, 32)
    for r, pos in enumerate(positions):
        ref = jax_rope.apply_rotary_pos_emb(jnp.asarray(t[:, r:r + 1]),
                                            jf[pos:pos + 1])
        np.testing.assert_allclose(out[:, r:r + 1].numpy(), np.asarray(ref),
                                   atol=FP32_TOL, rtol=FP32_TOL)


def test_rotation_gradient_matches_jax_vjp():
    t = _t(s=8, seed=3)
    dy = np.random.RandomState(4).randn(*t.shape).astype(np.float32)
    jf = jax_rope.rope_frequencies(16, 8)
    _, vjp = jax.vjp(lambda x: jax_rope.apply_rotary_pos_emb(x, jf),
                     jnp.asarray(t))
    (ref,) = vjp(jnp.asarray(dy))
    tt = torch.from_numpy(t).requires_grad_(True)
    rope.apply_rotary_pos_emb(tt, rope.rope_frequencies(16, 8)).backward(
        torch.from_numpy(dy))
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(ref),
                               atol=FP32_TOL, rtol=FP32_TOL)


@pytest.mark.parametrize("percent", [1.0, 0.5])
def test_rotary_embedding_for_matches_jax(percent):
    kw = dict(num_layers=1, hidden_size=128, num_attention_heads=4,
              rotary_percent=percent, rotary_base=500.0)
    ref, ref_k = jax_rotary_embedding_for(JaxConfig(**kw), 40)
    out, out_k = rotary_embedding_for(TransformerConfig(**kw), 40)
    assert out.shape == (40, 1, 1, int(32 * percent))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FP32_TOL,
                               rtol=1e-6)
    assert out_k is out
