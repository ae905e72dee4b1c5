"""Scaled (masked) softmax family (counterpart of apex_tpu/ops/softmax.py).

The four Megatron softmax functions and the ``FusedScaleMaskSoftmax``
dispatcher, as plain torch in fp32: the JAX package writes them as jnp
code that XLA fuses, with no Pallas kernel, so the port has none either.
Masks are True where a score is masked out. The padding fill is -10000,
not -inf, so a row whose keys are all masked (a padded query under BERT's
extended mask) becomes a uniform softmax, not NaN; the causal fill is
-1e30, so future positions get exactly zero probability.
"""

from typing import Callable, Optional

import torch

from apex_tpu_torch._cast_state import casts_disabled

__all__ = [
    "FusedScaleMaskSoftmax", "fused_scale_mask_softmax",
    "generic_scaled_masked_softmax", "scaled_masked_softmax",
    "scaled_softmax", "scaled_upper_triang_masked_softmax",
]

_MASK_VALUE = -10000.0
_CAUSAL_MASK_VALUE = -1e30


def _is_causal(attn_mask_type) -> bool:
    """Accepts AttnMaskType or its string name."""
    return getattr(attn_mask_type, "name", attn_mask_type) == "causal"


def _softmax_fp32(x, dtype):
    xf = x.float()
    xf = xf - xf.amax(dim=-1, keepdim=True)
    p = torch.exp(xf)
    return (p / p.sum(dim=-1, keepdim=True)).to(dtype)


@casts_disabled
def scaled_softmax(x, scale: float = 1.0):
    """softmax(x * scale)."""
    return _softmax_fp32(x * scale, x.dtype)


@casts_disabled
def scaled_masked_softmax(x, mask, scale: float = 1.0):
    """softmax of x * scale with the masked scores set to -10000; ``mask``
    broadcasts to x ((b, 1, sq, sk) against (b, np, sq, sk))."""
    xf = x.float() * scale
    if mask is not None:
        xf = xf.masked_fill(mask.bool(), _MASK_VALUE)
    return _softmax_fp32(xf, x.dtype)


@casts_disabled
def generic_scaled_masked_softmax(x, mask, scale: float = 1.0):
    """The arbitrary-size variant: the same function as
    :func:`scaled_masked_softmax`."""
    return scaled_masked_softmax(x, mask, scale)


@casts_disabled
def scaled_upper_triang_masked_softmax(x, scale: float = 1.0):
    """Causal softmax over the last two dims (sq, sk): keys past a query's
    position (bottom-right aligned) are masked out."""
    sq, sk = x.shape[-2], x.shape[-1]
    row = torch.arange(sq, device=x.device)[:, None]
    col = torch.arange(sk, device=x.device)[None, :]
    xf = (x.float() * scale).masked_fill(col > row + (sk - sq),
                                         _CAUSAL_MASK_VALUE)
    return _softmax_fp32(xf, x.dtype)


class FusedScaleMaskSoftmax:
    """The Megatron dispatcher's call surface. The ``*_fusion`` and dtype
    flags are taken and ignored, as in JAX: the math is always fp32."""

    def __init__(self, input_in_fp16: bool = False,
                 input_in_bf16: bool = False, attn_mask_type="padding",
                 scaled_masked_softmax_fusion: bool = True,
                 mask_func: Optional[Callable] = None,
                 softmax_in_fp32: bool = True,
                 scale: Optional[float] = None):
        self.attn_mask_type = attn_mask_type
        self.mask_func = mask_func
        self.scale = 1.0 if scale is None else scale
        del input_in_fp16, input_in_bf16, scaled_masked_softmax_fusion
        del softmax_in_fp32

    @casts_disabled
    def __call__(self, x, mask=None):
        if _is_causal(self.attn_mask_type):
            assert mask is None, (
                "FusedScaleMaskSoftmax(attn_mask_type=causal) does not accept "
                "an explicit mask; fold padding into the mask and use the "
                "padding mask type instead"
            )
            b, np_, sq, sk = x.shape
            out = scaled_upper_triang_masked_softmax(
                x.reshape(b * np_, sq, sk), self.scale)
            return out.reshape(b, np_, sq, sk)
        if mask is not None and self.mask_func is not None:
            return _softmax_fp32(self.mask_func(x.float() * self.scale, mask),
                                 x.dtype)
        return scaled_masked_softmax(x, mask, self.scale)


@casts_disabled
def fused_scale_mask_softmax(x, mask=None, scale: float = 1.0,
                             causal: bool = False):
    """Functional form of the dispatcher."""
    if causal:
        assert mask is None, (
            "fused_scale_mask_softmax(causal=True) does not accept an "
            "explicit mask; fold padding into the mask and pass causal=False"
        )
        shape = x.shape
        return scaled_upper_triang_masked_softmax(
            x.reshape(-1, shape[-2], shape[-1]), scale).reshape(shape)
    return scaled_masked_softmax(x, mask, scale)
