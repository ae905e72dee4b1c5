"""Fused Adagrad (counterpart of apex_tpu/optimizers/fused_adagrad.py;
ref apex.optimizers.FusedAdagrad): ``h += g^2; p -= lr * g / (sqrt(h) +
eps)``, weight decay into the gradient or, with ``adagrad_w_mode``,
decoupled. Plain torch, as the JAX transform is plain ``jnp``."""

import dataclasses
from typing import Dict

import torch

from apex_tpu_torch.optimizers.transform import Transform

__all__ = ["FusedAdagrad", "FusedAdagradState", "fused_adagrad"]

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass
class FusedAdagradState:
    sum: Tensors  # accumulated squared gradients, fp32


def fused_adagrad(lr: float = 1e-2, eps: float = 1e-10,
                  weight_decay: float = 0.0, adagrad_w_mode: bool = False
                  ) -> Transform:
    @torch.no_grad()
    def init(params: Tensors) -> FusedAdagradState:
        return FusedAdagradState({n: torch.zeros(p.shape, dtype=torch.float32,
                                                 device=p.device)
                                  for n, p in params.items()})

    @torch.no_grad()
    def update(grads: Tensors, state: FusedAdagradState, params=None):
        if params is None:
            raise ValueError("fused_adagrad requires params")
        updates, h = {}, {}
        for n, p in params.items():
            gf = grads[n].float()
            if not adagrad_w_mode and weight_decay != 0.0:
                gf = gf + weight_decay * p.float()
            h[n] = state.sum[n] + gf * gf
            upd = gf / (torch.sqrt(h[n]) + eps)
            if adagrad_w_mode and weight_decay != 0.0:
                upd = upd + weight_decay * p.float()
            updates[n] = (-lr * upd).to(p.dtype)
        return updates, FusedAdagradState(h)

    return Transform(init, update)


class FusedAdagrad:
    """Class-style constructor with the reference's signature."""

    def __new__(cls, lr: float = 1e-2, eps: float = 1e-10,
                weight_decay: float = 0.0, adagrad_w_mode: bool = False,
                set_grad_none: bool = True, **_unused):
        del set_grad_none
        return fused_adagrad(lr=lr, eps=eps, weight_decay=weight_decay,
                             adagrad_w_mode=adagrad_w_mode)
