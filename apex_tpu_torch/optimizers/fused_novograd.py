"""Fused NovoGrad (counterpart of apex_tpu/optimizers/fused_novograd.py;
ref apex.optimizers.FusedNovoGrad): Adam with a per-tensor scalar second
moment ``v = beta2 * v + (1 - beta2) * ||g||^2`` (on the first step
``||g||^2`` itself unless ``init_zero``), ``m = beta1 * m + c * (g /
(sqrt(v / bc2) + eps) + wd * p)`` and ``p -= lr * m / bc1``. Plain
torch, as the JAX transform is plain ``jnp``."""

import dataclasses
from typing import Dict, Tuple

import torch

from apex_tpu_torch.optimizers.transform import Transform, bias_corrections

__all__ = ["FusedNovoGrad", "FusedNovoGradState", "fused_novograd"]

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass
class FusedNovoGradState:
    step: torch.Tensor  # 0-d int32
    exp_avg: Tensors  # fp32, per parameter
    exp_avg_sq: Tensors  # 0-d fp32 per tensor; -1 until the first step


def fused_novograd(lr: float = 1e-3, betas: Tuple[float, float] = (0.95, 0.98),
                   eps: float = 1e-8, weight_decay: float = 0.0,
                   grad_averaging: bool = True, init_zero: bool = False,
                   norm_type: int = 2, bias_correction: bool = True
                   ) -> Transform:
    if norm_type != 2:
        raise ValueError("only norm_type=2 is supported (matches reference "
                         "default)")
    beta1, beta2 = betas

    @torch.no_grad()
    def init(params: Tensors) -> FusedNovoGradState:
        dev = next(iter(params.values())).device
        m = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in params.items()}
        v = {n: torch.full((), 0.0 if init_zero else -1.0,
                           dtype=torch.float32, device=p.device)
             for n, p in params.items()}
        return FusedNovoGradState(
            torch.zeros((), dtype=torch.int32, device=dev), m, v)

    @torch.no_grad()
    def update(grads: Tensors, state: FusedNovoGradState, params=None):
        if params is None:
            raise ValueError("fused_novograd requires params")
        step = state.step + 1
        bc1, bc2 = bias_corrections(step, betas, bias_correction)
        coeff = (1.0 - beta1) if grad_averaging else 1.0
        m, v, updates = {}, {}, {}
        for n, p in params.items():
            gf = grads[n].float()
            gn2 = gf.square().sum()
            old = state.exp_avg_sq[n]
            v[n] = torch.where(old < 0, gn2, beta2 * old + (1.0 - beta2) * gn2)
            g = gf / (torch.sqrt(v[n] / bc2) + eps)
            if weight_decay != 0.0:
                g = g + weight_decay * p.float()
            m[n] = beta1 * state.exp_avg[n] + coeff * g
            updates[n] = (-lr * m[n] / bc1).to(p.dtype)
        return updates, FusedNovoGradState(step, m, v)

    return Transform(init, update)


class FusedNovoGrad:
    """Class-style constructor with the reference's signature."""

    def __new__(cls, lr: float = 1e-3, bias_correction: bool = True,
                betas: Tuple[float, float] = (0.95, 0.98), eps: float = 1e-8,
                weight_decay: float = 0.0, grad_averaging: bool = True,
                norm_type: int = 2, init_zero: bool = False,
                set_grad_none: bool = True, **_unused):
        del set_grad_none
        return fused_novograd(lr=lr, betas=betas, eps=eps,
                              weight_decay=weight_decay,
                              grad_averaging=grad_averaging,
                              init_zero=init_zero, norm_type=norm_type,
                              bias_correction=bias_correction)
