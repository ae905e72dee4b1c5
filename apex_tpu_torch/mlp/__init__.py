"""``apex.mlp`` import surface (counterpart of apex_tpu/mlp): ``MLP``, an
``nn.Module`` over ``ops.mlp.mlp_apply``."""

import math
from typing import Sequence

import torch
from torch import nn

from apex_tpu_torch._kernels import resolve_device
from apex_tpu_torch.ops.mlp import ACTIVATIONS, mlp_apply

__all__ = ["MLP"]


class MLP(nn.Module):
    """``apex.mlp.MLP(mlp_sizes, bias, activation)``: the activation after
    every layer but the last. Parameters ``weight_<i>`` (out, in) and
    ``bias_<i>`` (the flax module's names), initialised as the JAX module
    initialises them: weights normal with std sqrt(2 / (fan_in +
    fan_out)), biases normal with std sqrt(1 / fan_out), from a generator
    of ``seed``; without ``bias`` the biases are zeros and not
    parameters."""

    def __init__(self, mlp_sizes: Sequence[int], bias: bool = True,
                 activation: str = "relu",
                 params_dtype: torch.dtype = torch.float32, device="cuda",
                 seed: int = 0):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise TypeError("activation must be none, relu, or sigmoid")
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.mlp_sizes, self.bias, self.activation = (
            tuple(mlp_sizes), bias, activation)
        for i in range(len(mlp_sizes) - 1):
            fan_in, fan_out = mlp_sizes[i], mlp_sizes[i + 1]
            w = torch.randn(fan_out, fan_in, generator=gen) * math.sqrt(
                2.0 / (fan_in + fan_out))
            self.register_parameter(f"weight_{i}", nn.Parameter(
                w.to(device=dev, dtype=params_dtype)))
            b = torch.randn(fan_out, generator=gen) * math.sqrt(1.0 / fan_out)
            if bias:
                self.register_parameter(f"bias_{i}", nn.Parameter(
                    b.to(device=dev, dtype=params_dtype)))

    def forward(self, x):
        n = len(self.mlp_sizes) - 1
        params = {}
        for i in range(n):
            w = getattr(self, f"weight_{i}")
            params[f"weights.{i}"] = w
            params[f"biases.{i}"] = getattr(self, f"bias_{i}") if self.bias \
                else torch.zeros(w.shape[0], dtype=w.dtype, device=w.device)
        return mlp_apply(params, x, activation=self.activation)
