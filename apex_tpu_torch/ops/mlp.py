"""The fused MLP's functions (counterpart of apex_tpu/ops/mlp.py; ref
``mlp_cuda`` and apex.mlp.MLP).

Parameters are a dict of named tensors, ``weights.<i>`` of shape (out,
in) and ``biases.<i>`` (out,), the JAX tree's paths joined with dots.
Each layer is the JAX chain: a GEMM with an fp32 result, the bias and
the activation in fp32 (every layer but the last), the output cast to
the input's dtype. The GEMM multiplies the operands upcast to fp32,
which is exact for a bf16 or fp16 value, and accumulates in fp32, the
``preferred_element_type=float32`` of the JAX ``dot_general``; under
O1 its operands are rounded to the half dtype first, as JAX's patched
``dot_general`` rounds them. There is no Pallas site here.

On the card this makes every GEMM of ``mlp_apply`` and of
``ops.fused_dense`` an fp32 GEMM, at O2 and O3 too: without TF32 it
runs on the CUDA cores, not the tensor cores, so it is slower than the
half GEMM with an fp32 output type that the JAX ``dot_general``
describes. That cost is not measured yet, and the half GEMM with an
fp32 output is left for later work.
"""

import math
from typing import Dict, Sequence

import torch

from apex_tpu_torch._kernels import resolve_device
from apex_tpu_torch._cast_state import casts_disabled, half_function

__all__ = ["ACTIVATIONS", "dense_f32", "mlp_apply", "mlp_init"]

ACTIVATIONS = {
    "none": lambda x: x,
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
}


@half_function
@casts_disabled
def dense_f32(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``x @ weight.T`` as an fp32 tensor (weight (out, in))."""
    return torch.matmul(x.float(), weight.float().t())


def mlp_init(seed, mlp_sizes: Sequence[int], dtype=torch.float32,
             device="cuda") -> Dict[str, torch.Tensor]:
    """Weights and biases of the layer sizes ``mlp_sizes``, each uniform
    in (-1/sqrt(fan_in), 1/sqrt(fan_in)), drawn from a generator of
    ``seed`` (an int or a ``torch.Generator``) on the CPU, layer by layer,
    weight then bias."""
    dev = resolve_device(device)
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator().manual_seed(seed)
    params = {}
    for i in range(len(mlp_sizes) - 1):
        fan_in, fan_out = mlp_sizes[i], mlp_sizes[i + 1]
        bound = 1.0 / math.sqrt(fan_in)
        for name, shape in ((f"weights.{i}", (fan_out, fan_in)),
                            (f"biases.{i}", (fan_out,))):
            t = torch.empty(shape).uniform_(-bound, bound, generator=gen)
            params[name] = t.to(device=dev, dtype=dtype)
    return params


def mlp_apply(params: Dict[str, torch.Tensor], x: torch.Tensor,
              activation: str = "relu") -> torch.Tensor:
    """Forward through the chain; ``activation`` after every layer but
    the last."""
    act = ACTIVATIONS[activation]
    n = sum(1 for k in params if k.startswith("weights."))
    h = x
    for i in range(n):
        h = dense_f32(h, params[f"weights.{i}"])
        h = h + params[f"biases.{i}"].float()
        if i < n - 1:
            h = act(h)
        h = h.to(x.dtype)
    return h
