"""apex_tpu_torch.ops.attention against the JAX package's flash_attention.

The same numpy inputs, made from a seed, go through the JAX function with
``impl="pallas"`` (the Pallas kernel in interpret mode on the CPU, or the
XLA reference where the JAX dispatcher sends the case there, as it does
on the TPU) and through the port on CPU tensors, which runs the plain
version of the CUDA kernel. Tolerances: 1e-5 in fp32 (the same fp32
arithmetic in another order; outputs are averages of N(0, 1) values),
2e-2 in bf16 (P is rounded to bf16 before P.V on both sides, at
different points of the online softmax).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.attention import causal_mask as jax_causal_mask
from apex_tpu.ops.attention import flash_attention as jax_flash
from apex_tpu.ops.attention import window_mask as jax_window_mask
from apex_tpu_torch.ops.attention import (
    causal_mask,
    flash_attention,
    window_mask,
)

FP32_TOL = 1e-5
BF16_TOL = 2e-2


def _qkv(b, h, h_kv, sq, sk, d, seed=0):
    rs = np.random.RandomState(seed)
    q = rs.randn(b, h, sq, d).astype(np.float32)
    k = rs.randn(b, h_kv, sk, d).astype(np.float32)
    v = rs.randn(b, h_kv, sk, d).astype(np.float32)
    return q, k, v


def _both(q, k, v, tol=FP32_TOL, dtype=np.float32, kpm=None, mask=None,
          **kw):
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    ref = jax_flash(*(jnp.asarray(t, jd) for t in (q, k, v)),
                    key_padding_mask=None if kpm is None else jnp.asarray(kpm),
                    mask=None if mask is None else jnp.asarray(mask),
                    impl="pallas", block_q=32, block_k=32, **kw)
    out = flash_attention(*(torch.from_numpy(t).to(td) for t in (q, k, v)),
                          key_padding_mask=(None if kpm is None
                                            else torch.from_numpy(kpm)),
                          mask=None if mask is None else torch.from_numpy(mask),
                          **kw)
    assert out.dtype == td and out.shape == q.shape
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=tol, rtol=tol)
    return out


@pytest.mark.parametrize("causal", [False, True])
def test_prefill_matches_pallas(causal):
    _both(*_qkv(2, 3, 3, 64, 64, 32), causal=causal)


def test_key_padding_with_dead_row_matches_pallas():
    q, k, v = _qkv(3, 2, 2, 64, 64, 32, seed=1)
    kpm = np.zeros((3, 64), bool)
    kpm[0, 40:] = True
    kpm[2, :] = True  # every key padded: the row outputs zeros
    out = _both(q, k, v, causal=True, kpm=kpm)
    assert torch.count_nonzero(out[2]) == 0


@pytest.mark.parametrize("h_kv", [1, 2])
def test_gqa_matches_pallas(h_kv):
    _both(*_qkv(2, 4, h_kv, 64, 64, 32, seed=2), causal=True)


def test_window_matches_pallas():
    _both(*_qkv(1, 2, 2, 96, 96, 32, seed=3), causal=True, window=20)


def test_decode_shape_matches_pallas():
    """sq = 1 against a 64-slot cache with per-row lengths (1 = padded),
    the engine's decode call."""
    q, k, v = _qkv(4, 3, 3, 1, 64, 32, seed=4)
    lens = np.array([1, 17, 64, 40])
    kpm = np.arange(64)[None, :] >= lens[:, None]
    _both(q, k, v, causal=False, kpm=kpm)


def test_bf16_matches_pallas():
    _both(*_qkv(1, 2, 2, 64, 64, 32, seed=5), tol=BF16_TOL, dtype="bf16",
          causal=True)


# The CUDA kernels' widest instantiation: head_dim 256, and 160 zero-padded
# to it (ten 16-wide steps), with GQA and causal cases, in both dtypes.
@pytest.mark.parametrize("h,h_kv,d,dtype,causal", [
    (4, 2, 160, "fp32", True),
    (2, 2, 160, "bf16", False),
    (4, 1, 256, "fp32", True),
    (4, 2, 256, "bf16", True),
    (2, 2, 256, "fp32", False),
])
def test_wide_head_dim_matches_pallas(h, h_kv, d, dtype, causal):
    _both(*_qkv(1, h, h_kv, 64, 64, d, seed=40 + d + h), dtype=dtype,
          tol=BF16_TOL if dtype == "bf16" else FP32_TOL, causal=causal)


def test_causal_rectangular_and_dense_mask_match_reference():
    """sq != sk causal (bottom-right aligned) and a dense mask: the JAX
    dispatcher sends both to its XLA reference."""
    q, k, v = _qkv(1, 2, 2, 16, 48, 32, seed=6)
    _both(q, k, v, causal=True)
    mask = np.random.RandomState(7).rand(1, 1, 16, 48) < 0.3
    _both(q, k, v, causal=False, mask=mask)


def test_explicit_scale_matches_pallas():
    _both(*_qkv(1, 2, 2, 32, 32, 32, seed=8), causal=True, scale=0.05)


@pytest.mark.parametrize("sq,sk", [(8, 8), (5, 12)])
def test_masks_match_jax(sq, sk):
    np.testing.assert_array_equal(causal_mask(sq, sk).numpy(),
                                  np.asarray(jax_causal_mask(sq, sk)))
    np.testing.assert_array_equal(window_mask(sq, sk, 3).numpy(),
                                  np.asarray(jax_window_mask(sq, sk, 3)))


def test_argument_errors():
    q = torch.zeros(1, 3, 4, 8)
    kv = torch.zeros(1, 2, 4, 8)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="requires causal"):
        flash_attention(q, q, q, window=2)
    with pytest.raises(ValueError, match=">= 1"):
        flash_attention(q, q, q, causal=True, window=0)


# -- backward ---------------------------------------------------------------
# The port differentiates through _FlashFn, whose CPU backward is
# _flash_bwd_ref (the plain version of the dq and dk/dv kernels: p and ds
# recomputed from the saved lse), against jax.vjp of the JAX function:
# the Pallas path (its custom_vjp runs _flash_bwd_dq/_dkv_kernel in
# interpret mode), or the XLA path where the JAX dispatcher sends the case
# (causal with sq != sk). Tolerances: fp32 1e-4 (gradients of O(1) summed
# over up to 96 keys and queries in another order); bf16 5e-2 (p and ds are
# rounded to bf16 before the products on both sides, but from fp32 values
# that differ in their last bits, and the grads are rounded to bf16).

GRAD_TOL = 1e-4
BF16_GRAD_TOL = 5e-2


def _grads_both(q, k, v, dtype="fp32", kpm=None, impl="pallas", tol=GRAD_TOL,
                **kw):
    import jax

    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    do = np.random.RandomState(99).randn(*q.shape).astype(np.float32)
    jkpm = None if kpm is None else jnp.asarray(kpm)

    def f(qq, kk, vv):
        return jax_flash(qq, kk, vv, key_padding_mask=jkpm, impl=impl,
                         block_q=32, block_k=32, **kw)

    _, vjp = jax.vjp(f, *(jnp.asarray(t, jd) for t in (q, k, v)))
    ref = vjp(jnp.asarray(do, jd))
    ts = [torch.from_numpy(t).to(td).requires_grad_(True) for t in (q, k, v)]
    out = flash_attention(*ts, key_padding_mask=(None if kpm is None
                                                 else torch.from_numpy(kpm)),
                          **kw)
    assert type(out.grad_fn).__name__ == "_FlashFnBackward"
    out.backward(torch.from_numpy(do).to(td))
    for t, r in zip(ts, ref):
        assert t.grad.dtype == td and t.grad.shape == t.shape
        np.testing.assert_allclose(t.grad.float().numpy(),
                                   np.asarray(r.astype(jnp.float32)),
                                   atol=tol, rtol=tol)
    return ts


@pytest.mark.parametrize("causal", [True, False])
def test_backward_matches_pallas(causal):
    _grads_both(*_qkv(2, 3, 3, 64, 64, 32, seed=11), causal=causal)


@pytest.mark.parametrize("h_kv", [1, 2])
def test_backward_gqa_matches_pallas(h_kv):
    _grads_both(*_qkv(2, 4, h_kv, 64, 64, 32, seed=12), causal=True)


def test_backward_window_matches_pallas():
    _grads_both(*_qkv(1, 2, 2, 96, 96, 32, seed=13), causal=True, window=20)


def test_backward_key_padding_dead_row_matches_pallas():
    q, k, v = _qkv(3, 2, 2, 64, 64, 32, seed=14)
    kpm = np.zeros((3, 64), bool)
    kpm[0, 40:] = True
    kpm[2, :] = True  # every key padded: no gradient flows through row 2
    ts = _grads_both(q, k, v, causal=True, kpm=kpm)
    for t in ts:
        assert torch.count_nonzero(t.grad[2]) == 0


def test_backward_bf16_matches_pallas():
    _grads_both(*_qkv(1, 2, 2, 64, 64, 32, seed=15), dtype="bf16",
                tol=BF16_GRAD_TOL, causal=True)


# The contract the bf16 tensor-core kernels are held to on the card (their
# plain version, _flash_bwd_ref, against the Pallas kernels here): a GQA
# group of 4, head_dim 80, which the CUDA kernels zero-pad to 128, and
# head_dim 256 and 160 (zero-padded to 256).
@pytest.mark.parametrize("h,h_kv,d,dtype,window", [
    (8, 2, 32, "fp32", None),
    (8, 2, 32, "bf16", None),
    (8, 2, 64, "fp32", 24),
    (2, 2, 80, "fp32", None),
    (2, 2, 80, "bf16", None),
    (4, 1, 80, "fp32", 24),
    (4, 2, 160, "fp32", None),
    (4, 2, 160, "bf16", 24),
    (4, 1, 256, "fp32", 24),
    (4, 2, 256, "bf16", None),
])
def test_backward_gqa_and_padded_head_dim_match_pallas(h, h_kv, d, dtype,
                                                       window):
    q, k, v = _qkv(1, h, h_kv, 64, 64, d, seed=21 + d + h)
    _grads_both(q, k, v, dtype=dtype, causal=True, window=window,
                tol=BF16_GRAD_TOL if dtype == "bf16" else GRAD_TOL)


def test_backward_causal_rectangular_matches_xla():
    """sq != sk, bottom-right aligned: the kernels' offset; the JAX
    dispatcher differentiates its XLA reference here."""
    _grads_both(*_qkv(1, 2, 2, 16, 48, 32, seed=16), impl="xla", causal=True)
    _grads_both(*_qkv(1, 2, 2, 16, 48, 32, seed=17), impl="xla", causal=True,
                window=10)


def test_plain_backward_matches_autograd_of_attn_ref():
    """_flash_fwd_ref's lse and _flash_bwd_ref agree with autograd of the
    plain forward (GQA, window, a dead row, sq != sk)."""
    from apex_tpu_torch.ops.attention import (
        _flash_bwd_ref,
        _flash_fwd_ref,
        _flash_ref,
    )

    q, k, v = (torch.from_numpy(t) for t in _qkv(2, 4, 2, 20, 30, 16,
                                                   seed=18))
    kpm = torch.zeros(2, 30, dtype=torch.bool)
    kpm[1, :] = True
    do = torch.from_numpy(np.random.RandomState(19).randn(2, 4, 20, 16)
                          .astype(np.float32))
    scale = 0.25
    ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
    _flash_ref(*ts, scale, True, None, kpm, 7).backward(do)
    o, lse = _flash_fwd_ref(q, k, v, scale, True, kpm, 7)
    assert bool((lse[1] == 1e30).all()) and torch.isfinite(lse[0]).all()
    delta = (do * o).sum(-1)
    grads = _flash_bwd_ref(q, k, v, do, lse, delta, scale, True, kpm, 7)
    for g, t in zip(grads, ts):
        torch.testing.assert_close(g, t.grad, atol=GRAD_TOL, rtol=GRAD_TOL)


def test_no_grad_and_dense_mask_skip_the_function():
    q, k, v = (torch.from_numpy(t).requires_grad_(True)
               for t in _qkv(1, 2, 2, 8, 8, 16, seed=20))
    with torch.no_grad():
        assert flash_attention(q, k, v, causal=True).grad_fn is None
    mask = torch.zeros(1, 1, 8, 8, dtype=torch.bool)
    out = flash_attention(q, k, v, mask=mask)
    assert type(out.grad_fn).__name__ != "_FlashFnBackward"


@pytest.mark.parametrize("b,h,h_kv,sk,dtype,want", [
    (4, 32, 4, 2048, torch.bfloat16, 2),   # Llama training: 512 blocks
    (8, 12, 12, 1024, torch.bfloat16, 1),  # GPT-2: no group to split
    (1, 16, 2, 200, torch.bfloat16, 8),    # few blocks: one head a block
    (2, 12, 4, 300, torch.bfloat16, 3),
    (4, 32, 4, 2048, torch.float32, 1),    # the scalar fp32 kernel
])
def test_dkv_kernel_splits_the_gqa_group(b, h, h_kv, sk, dtype, want):
    """The dk/dv kernel's split of a GQA group over blocks: a divisor of
    the group, chosen from the shape alone (so a repeat call sums the same
    fp32 partials in the same order)."""
    from apex_tpu_torch.ops.attention import _dkv_splits

    q = torch.empty(b, h, sk, 64, dtype=dtype, device="meta")
    k = torch.empty(b, h_kv, sk, 64, dtype=dtype, device="meta")
    assert _dkv_splits(q, k) == want


# -- the split decode (sq = 1, bf16 on the card) ------------------------------
# The decode kernel splits each (batch, kv head) pair's keys over up to 8
# blocks, by a rule of the shapes alone, and merges their partials (row max,
# row sum, unnormalised o) in split order. _flash_decode_split_ref is the
# plain version of that merge; on the CPU it is held to _flash_fwd_ref (the
# kernel's contract, o and lse) and to the JAX function at the decode shape.
# Tolerances: fp32 1e-5 (the same sums in another order); bf16 2e-2 (P is
# rounded to bf16 relative to each split's max instead of the row's).

@pytest.mark.parametrize("b,h,h_kv,sk,dtype,want", [
    (8, 12, 12, 1024, torch.bfloat16, 4),  # GPT-2 serving: 96 pairs
    (8, 32, 4, 2048, torch.bfloat16, 8),   # Llama serving: 32 pairs, capped
    (64, 12, 12, 1024, torch.bfloat16, 1),  # 768 blocks fill the card
    (8, 12, 12, 1000, torch.bfloat16, 4),  # ragged sk: 16 tiles, the last short
    (8, 12, 12, 100, torch.bfloat16, 2),   # two tiles, one each
    (3, 8, 2, 700, torch.bfloat16, 6),     # 11 tiles over 2-tile splits
    (8, 12, 12, 1024, torch.float32, 1),   # the scalar fp32 kernel
])
def test_decode_splits_from_the_shape(b, h, h_kv, sk, dtype, want):
    from apex_tpu_torch.ops.attention import _decode_splits

    q = torch.empty(b, h, 1, 64, dtype=dtype, device="meta")
    k = torch.empty(b, h_kv, sk, 64, dtype=dtype, device="meta")
    got = _decode_splits(q, k)
    assert got == want
    tiles = -(-sk // 64)
    per = -(-tiles // got)
    assert -(-tiles // per) == got  # no split without a tile
    # prefill (sq > 1) never splits
    assert _decode_splits(torch.empty(b, h, 2, 64, dtype=dtype,
                                      device="meta"), k) == 1


def _decode_inputs(b, h, h_kv, sk, d, seed):
    q, k, v = (torch.from_numpy(t) for t in _qkv(b, h, h_kv, 1, sk, d, seed))
    kpm = torch.zeros(b, sk, dtype=torch.bool)
    kpm[0] = True                  # a dead lane
    kpm[1 % b, 40:] = True         # keys in the first split only
    return q, k, v, kpm


@pytest.mark.parametrize("splits", [1, 3, 8])
@pytest.mark.parametrize("window", [None, 100])
def test_split_decode_merge_matches_plain_forward(splits, window):
    from apex_tpu_torch.ops.attention import (
        _flash_decode_split_ref,
        _flash_fwd_ref,
    )

    q, k, v, kpm = _decode_inputs(3, 8, 2, 700, 32, seed=30)
    causal = window is not None
    o, lse = _flash_decode_split_ref(q, k, v, 0.2, causal, kpm, window,
                                     splits)
    ro, rl = _flash_fwd_ref(q, k, v, 0.2, causal, kpm, window)
    torch.testing.assert_close(o, ro, atol=FP32_TOL, rtol=FP32_TOL)
    torch.testing.assert_close(lse, rl, atol=FP32_TOL, rtol=FP32_TOL)
    assert torch.count_nonzero(o[0]) == 0 and bool((lse[0] == 1e30).all())


def test_split_decode_merge_matches_pallas_bf16():
    from apex_tpu_torch.ops.attention import _flash_decode_split_ref

    q, k, v, kpm = _decode_inputs(2, 8, 2, 320, 32, seed=31)
    ref = jax_flash(*(jnp.asarray(t.numpy(), jnp.bfloat16) for t in (q, k, v)),
                    key_padding_mask=jnp.asarray(kpm.numpy()), impl="pallas",
                    block_q=1, block_k=32)
    o, _ = _flash_decode_split_ref(*(t.bfloat16() for t in (q, k, v)),
                                   32 ** -0.5, False, kpm, None, 5)
    assert o.dtype == torch.bfloat16
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=BF16_TOL, rtol=BF16_TOL)
