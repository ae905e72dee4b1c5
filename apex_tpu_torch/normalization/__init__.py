"""``apex.normalization`` import surface (counterpart of
apex_tpu/normalization): ``FusedLayerNorm``, ``FusedRMSNorm`` and their
``MixedFused*`` names, as ``nn.Module``s over ``ops.layer_norm``, so
that on CUDA tensors they run the hand-written kernels (#1, #2 for
LayerNorm; #3, #4 for RMSNorm).

``normalized_shape`` names the trailing dims; they are flattened into
one axis for the kernel (the same reduction), and the parameters keep
the reference's ``normalized_shape`` layout. ``elementwise_affine=False``
has no parameters. ``memory_efficient=True`` runs the call under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)`` (JAX's
``jax.checkpoint``): nothing of the norm is kept for the backward but
its inputs, which the backward runs the forward again from; the values
are unchanged. The kernels take parameters of any dtype, so the mixed
variants are the same classes.
"""

from typing import Sequence, Union

import torch
import torch.utils.checkpoint
from torch import nn

from apex_tpu_torch._kernels import resolve_device
from apex_tpu_torch.ops.layer_norm import layer_norm, rms_norm

__all__ = ["FusedLayerNorm", "FusedRMSNorm", "MixedFusedLayerNorm",
           "MixedFusedRMSNorm"]


def _shape_tuple(normalized_shape) -> tuple:
    if isinstance(normalized_shape, int):
        return (int(normalized_shape),)
    return tuple(int(d) for d in normalized_shape)


class _FusedNorm(nn.Module):
    with_bias = True

    def __init__(self, normalized_shape: Union[int, Sequence[int]],
                 eps: float = 1e-5, elementwise_affine: bool = True,
                 memory_efficient: bool = False,
                 params_dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        self.normalized_shape = _shape_tuple(normalized_shape)
        self.eps, self.elementwise_affine = eps, elementwise_affine
        self.memory_efficient = memory_efficient
        dev = resolve_device(device)
        self.weight = self.bias = None
        if elementwise_affine:
            self.weight = nn.Parameter(torch.ones(
                self.normalized_shape, dtype=params_dtype, device=dev))
            if self.with_bias:
                self.bias = nn.Parameter(torch.zeros(
                    self.normalized_shape, dtype=params_dtype, device=dev))

    def _norm(self, x2, w, b):
        raise NotImplementedError

    def forward(self, x):
        shape = self.normalized_shape
        if tuple(x.shape[x.dim() - len(shape):]) != shape:
            raise ValueError(f"input trailing dims "
                             f"{tuple(x.shape[x.dim() - len(shape):])} != "
                             f"normalized_shape {shape}")
        n = 1
        for d in shape:
            n *= d
        x2 = x.reshape(x.shape[:x.dim() - len(shape)] + (n,))
        w = None if self.weight is None else self.weight.reshape(n)
        b = None if self.bias is None else self.bias.reshape(n)
        if self.memory_efficient:
            out = torch.utils.checkpoint.checkpoint(
                self._norm, x2, w, b, use_reentrant=False)
        else:
            out = self._norm(x2, w, b)
        return out.reshape(x.shape)


class FusedLayerNorm(_FusedNorm):
    """``apex.normalization.FusedLayerNorm``: weight ones, bias zeros."""

    def _norm(self, x2, w, b):
        return layer_norm(x2, w, b, eps=self.eps)


class FusedRMSNorm(_FusedNorm):
    """``apex.normalization.FusedRMSNorm``: weight ones, no bias."""

    with_bias = False

    def _norm(self, x2, w, b):
        return rms_norm(x2, w, eps=self.eps)


MixedFusedLayerNorm = FusedLayerNorm
MixedFusedRMSNorm = FusedRMSNorm
