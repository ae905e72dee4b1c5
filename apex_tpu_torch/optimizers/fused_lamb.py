"""Fused LAMB (counterpart of apex_tpu/optimizers/fused_lamb.py; ref
apex.optimizers.FusedLAMB and FusedMixedPrecisionLamb).

The global gradient norm and the per-tensor norms of the parameters and
of the updates come from ``ops.multi_tensor.multi_tensor_l2norm``, so on
CUDA tensors each leaf's sum of squares is kernel #9; the rest is plain
torch, as the JAX transform is plain ``jnp``: the global norm clips the
gradients, Adam moments follow, and each tensor's update is scaled by
its trust ratio ``||p|| / ||u||``.
"""

import dataclasses
from typing import Dict, Tuple

import torch

from apex_tpu_torch.ops.multi_tensor import multi_tensor_l2norm
from apex_tpu_torch.optimizers.transform import Transform, bias_corrections
from apex_tpu_torch.utils.pytree import leaf_order

__all__ = ["FusedLAMB", "FusedLAMBState", "FusedMixedPrecisionLamb",
           "fused_lamb"]

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass
class FusedLAMBState:
    step: torch.Tensor  # 0-d int32
    exp_avg: Tensors  # fp32
    exp_avg_sq: Tensors  # fp32


def _zeros(params):
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}


def fused_lamb(lr: float = 1e-3, bias_correction: bool = True,
               betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-6,
               weight_decay: float = 0.01, max_grad_norm: float = 1.0,
               adam_w_mode: bool = True, use_nvlamb: bool = False
               ) -> Transform:
    """LAMB; ``adam_w_mode`` is taken for the signature (decoupled decay is
    the only mode of the reference kernels)."""
    beta1, beta2 = betas
    del adam_w_mode

    @torch.no_grad()
    def init(params: Tensors) -> FusedLAMBState:
        dev = next(iter(params.values())).device
        return FusedLAMBState(torch.zeros((), dtype=torch.int32, device=dev),
                              _zeros(params), _zeros(params))

    @torch.no_grad()
    def update(grads: Tensors, state: FusedLAMBState, params=None):
        if params is None:
            raise ValueError("fused_lamb requires params")
        names = list(params)
        step = state.step + 1
        bc1, bc2 = bias_corrections(step, betas, bias_correction)
        global_norm = multi_tensor_l2norm({n: grads[n] for n in names})
        clip = torch.where((max_grad_norm > 0) & (global_norm > max_grad_norm),
                           global_norm / max_grad_norm,
                           torch.ones_like(global_norm))
        m, v, u = {}, {}, {}
        for n in names:
            gf = grads[n].float() / clip
            m[n] = beta1 * state.exp_avg[n] + (1.0 - beta1) * gf
            v[n] = beta2 * state.exp_avg_sq[n] + (1.0 - beta2) * gf * gf
            u[n] = (m[n] / bc1) / (torch.sqrt(v[n] / bc2) + eps)
            if weight_decay != 0.0:
                u[n] = u[n] + weight_decay * params[n].float()
        # per-tensor trust ratios (stage 2 of multi_tensor_lamb)
        _, w_norm = multi_tensor_l2norm(
            {n: params[n].float() for n in names}, per_tensor=True)
        _, u_norm = multi_tensor_l2norm(u, per_tensor=True)
        updates = {}
        for i, n in enumerate(leaf_order(names)):  # the norms' order
            wn, un = w_norm[i], u_norm[i]
            if use_nvlamb:
                ok = un > 0
            else:
                ok = (wn > 0) & (un > 0)
            ratio = torch.where(ok, wn / un, torch.ones_like(wn))
            updates[n] = (-lr * ratio * u[n]).to(params[n].dtype)
        return ({n: updates[n] for n in names},
                FusedLAMBState(step, m, v))

    return Transform(init, update)


class FusedLAMB:
    """Class-style constructor with the reference's signature."""

    def __new__(cls, lr: float = 1e-3, bias_correction: bool = True,
                betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-6,
                weight_decay: float = 0.01, amsgrad: bool = False,
                adam_w_mode: bool = True, grad_averaging: bool = True,
                set_grad_none: bool = True, max_grad_norm: float = 1.0,
                use_nvlamb: bool = False, **_unused):
        if amsgrad:
            raise RuntimeError("FusedLAMB does not support the AMSGrad "
                               "variant.")
        del grad_averaging, set_grad_none
        return fused_lamb(lr=lr, bias_correction=bias_correction,
                          betas=betas, eps=eps, weight_decay=weight_decay,
                          max_grad_norm=max_grad_norm,
                          adam_w_mode=adam_w_mode, use_nvlamb=use_nvlamb)


class FusedMixedPrecisionLamb:
    """Mixed-precision LAMB: the fp32 masters over half parameters are
    ``amp.AmpOptimizer(fused_lamb(...), O2)``; this builds the inner
    transform."""

    def __new__(cls, *args, **kwargs):
        return FusedLAMB(*args, **kwargs)
