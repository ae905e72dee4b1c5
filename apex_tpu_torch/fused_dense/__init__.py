"""``apex.fused_dense`` import surface (counterpart of
apex_tpu/fused_dense): ``FusedDense`` and ``FusedDenseGeluDense`` as
``nn.Module``s over ``ops.fused_dense``, weights stored (out, in)."""

import torch
from torch import nn

from apex_tpu_torch._kernels import resolve_device
from apex_tpu_torch.models.resnet import lecun_normal
from apex_tpu_torch.ops.fused_dense import fused_dense, \
    fused_dense_gelu_dense

__all__ = ["FusedDense", "FusedDenseGeluDense"]


def _lecun_normal(shape, gen):
    """flax's ``lecun_normal`` on ``shape`` as the JAX module draws it:
    its fan-in axis is shape[-2], which for an (out, in) weight is
    ``out``."""
    return lecun_normal(shape, shape[-2], gen)


class FusedDense(nn.Module):
    """``apex.fused_dense.FusedDense(in_features, out_features, bias)``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 params_dtype: torch.dtype = torch.float32, device="cuda",
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.weight = nn.Parameter(_lecun_normal(
            (out_features, in_features), gen).to(dev, params_dtype))
        self.bias = nn.Parameter(torch.zeros(
            out_features, dtype=params_dtype, device=dev)) if bias else None

    def forward(self, x):
        return fused_dense(x, self.weight, self.bias)


class FusedDenseGeluDense(nn.Module):
    """``apex.fused_dense.FusedDenseGeluDense``; like the reference, it
    refuses ``bias=False``."""

    def __init__(self, in_features: int, intermediate_features: int,
                 out_features: int, bias: bool = True,
                 params_dtype: torch.dtype = torch.float32, device="cuda",
                 seed: int = 0):
        super().__init__()
        if not bias:
            raise ValueError("DenseGeluDense module without bias is "
                             "currently not supported")
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)

        def param(t):
            return nn.Parameter(t.to(dev, params_dtype))

        self.weight1 = param(_lecun_normal(
            (intermediate_features, in_features), gen))
        self.bias1 = param(torch.zeros(intermediate_features))
        self.weight2 = param(_lecun_normal(
            (out_features, intermediate_features), gen))
        self.bias2 = param(torch.zeros(out_features))

    def forward(self, x):
        return fused_dense_gelu_dense(x, self.weight1, self.bias1,
                                      self.weight2, self.bias2)
