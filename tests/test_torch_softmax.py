"""apex_tpu_torch.ops.softmax against apex_tpu.ops.softmax.

The same seeded numpy scores, (batch 2, heads 4, 32 queries, 32 keys),
and masks go through each JAX function and its port on the CPU.
Tolerance: fp32 1e-6 (the same fp32 exp and sums in another order); a
bf16 input 1e-2 (one bf16 rounding of the fp32 result, 2^-8 relative).
A padding row whose keys are all masked is uniform on both sides, not
NaN (the -10000 fill).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import softmax as jsm
from apex_tpu_torch.ops import softmax as tsm
from apex_tpu_torch.transformer import AttnMaskType

B, NP, S = 2, 4, 32
TOL = 1e-6


def _scores(seed=0, shape=(B, NP, S, S)):
    return (np.random.RandomState(seed).randn(*shape) * 4).astype(np.float32)


def _padding_mask(seed=1):
    """(b, 1, s, s) True = masked, BERT's extended mask of two lengths:
    padded queries have every key masked."""
    lens = np.array([S, 19])
    keep = np.arange(S)[None, :] < lens[:, None]
    ext = keep[:, None, :] & keep[:, :, None]
    return ~ext[:, None]


def _check(out, ref, tol=TOL):
    out = out.float().numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, np.asarray(ref, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("scale", [1.0, 0.125])
def test_scaled_softmax(scale):
    x = _scores()
    _check(tsm.scaled_softmax(torch.from_numpy(x), scale),
           jsm.scaled_softmax(jnp.asarray(x), scale))


@pytest.mark.parametrize("fn", ["scaled_masked_softmax",
                                "generic_scaled_masked_softmax"])
@pytest.mark.parametrize("masked", [True, False])
def test_masked_softmax(fn, masked):
    x, m = _scores(2), _padding_mask()
    tm = torch.from_numpy(m) if masked else None
    jm = jnp.asarray(m) if masked else None
    _check(getattr(tsm, fn)(torch.from_numpy(x), tm, 0.5),
           getattr(jsm, fn)(jnp.asarray(x), jm, 0.5))


def test_fully_masked_padding_row_is_uniform_not_nan():
    x, m = _scores(3), _padding_mask()
    out = tsm.scaled_masked_softmax(torch.from_numpy(x), torch.from_numpy(m))
    ref = jsm.scaled_masked_softmax(jnp.asarray(x), jnp.asarray(m))
    _check(out, ref)
    dead = out[1, :, 19:]  # padded queries of the short sequence
    assert torch.isfinite(dead).all()
    torch.testing.assert_close(dead, torch.full_like(dead, 1.0 / S),
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("shape", [(B * NP, S, S), (B * NP, 20, S)],
                         ids=["square", "sq<sk"])
def test_upper_triang_masked_softmax(shape):
    x = _scores(4, shape)
    out = tsm.scaled_upper_triang_masked_softmax(torch.from_numpy(x), 0.3)
    _check(out, jsm.scaled_upper_triang_masked_softmax(jnp.asarray(x), 0.3))
    sq, sk = shape[1:]
    future = np.arange(sk)[None, :] > np.arange(sq)[:, None] + (sk - sq)
    assert (out.numpy()[:, future] == 0).all()


def _mask_func(x, mask):
    """A caller's mask function: fill the masked scores with -1e4."""
    if isinstance(x, torch.Tensor):
        return x.masked_fill(mask, -1e4)
    return jnp.where(mask, -1e4, x)


@pytest.mark.parametrize("case", ["padding", "padding-no-mask", "mask_func",
                                  "causal"])
def test_fused_scale_mask_softmax_dispatcher(case):
    x, m = _scores(5), _padding_mask()
    kind = "causal" if case == "causal" else "padding"
    func = _mask_func if case == "mask_func" else None
    port = tsm.FusedScaleMaskSoftmax(
        input_in_bf16=True, attn_mask_type=getattr(AttnMaskType, kind),
        mask_func=func, scale=0.7)
    ref = jsm.FusedScaleMaskSoftmax(input_in_bf16=True, attn_mask_type=kind,
                                    mask_func=func, scale=0.7)
    use_mask = case in ("padding", "mask_func")
    out = port(torch.from_numpy(x), torch.from_numpy(m) if use_mask else None)
    _check(out, ref(jnp.asarray(x), jnp.asarray(m) if use_mask else None))


@pytest.mark.parametrize("causal", [False, True])
def test_fused_scale_mask_softmax_function(causal):
    x, m = _scores(6), _padding_mask()
    tm = None if causal else torch.from_numpy(m)
    jm = None if causal else jnp.asarray(m)
    _check(tsm.fused_scale_mask_softmax(torch.from_numpy(x), tm, 2.0, causal),
           jsm.fused_scale_mask_softmax(jnp.asarray(x), jm, 2.0, causal))


def test_bf16_input_keeps_its_dtype():
    x, m = _scores(7), _padding_mask()
    xb = torch.from_numpy(x).bfloat16()
    out = tsm.scaled_masked_softmax(xb, torch.from_numpy(m), 0.5)
    ref = jsm.scaled_masked_softmax(jnp.asarray(x, jnp.bfloat16),
                                    jnp.asarray(m), 0.5)
    assert out.dtype == torch.bfloat16
    _check(out, np.asarray(ref.astype(jnp.float32)), tol=1e-2)


def test_causal_refuses_an_explicit_mask():
    x = torch.from_numpy(_scores(8))
    m = torch.from_numpy(_padding_mask())
    with pytest.raises(AssertionError, match="explicit mask"):
        tsm.fused_scale_mask_softmax(x, m, causal=True)
    with pytest.raises(AssertionError, match="explicit mask"):
        tsm.FusedScaleMaskSoftmax(attn_mask_type=AttnMaskType.causal)(x, m)
