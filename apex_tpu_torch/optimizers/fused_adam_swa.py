"""Fused Adam with stochastic weight averaging (counterpart of
apex_tpu/optimizers/fused_adam_swa.py; ref
apex.contrib.openfold_triton.FusedAdamSWA).

The state carries fp32 masters and an fp32 SWA stream beside the
moments. A step scales the gradients by ``grad_clip_scale``, runs Adam on
the masters (``kApexAdamW``: decoupled decay; ``kApexAdam`` and
``kPyTorchAdam``, which share one algebra: decay into the gradient),
averages the result into the SWA stream (a copy at the first average,
``swa += (1 - decay) * (p - swa)`` after) and returns, as updates, the
step from the compute parameters to the masters in their dtype. The
averaged weights are :func:`swa_params`. Plain torch, as the JAX
transform is plain ``jnp``.
"""

import dataclasses
from typing import Any, Dict, Tuple

import torch

from apex_tpu_torch.optimizers.transform import Transform, bias_corrections

__all__ = ["FusedAdamSWA", "FusedAdamSWAState", "fused_adam_swa",
           "kApexAdam", "kApexAdamW", "kPyTorchAdam", "swa_params"]

Tensors = Dict[str, torch.Tensor]

kApexAdam = 0
kApexAdamW = 1
kPyTorchAdam = 2
_ADAM_MODES = {kApexAdam: False, kApexAdamW: True, kPyTorchAdam: False,
               "apex": False, "apexw": True, "pytorch": False}


@dataclasses.dataclass
class FusedAdamSWAState:
    step: torch.Tensor  # 0-d int32
    exp_avg: Tensors  # fp32
    exp_avg_sq: Tensors  # fp32
    master: Tensors  # fp32 state params
    swa: Tensors  # fp32 averaged params
    n_averaged: torch.Tensor  # 0-d int32


def fused_adam_swa(swa_decay_rate: float, lr: float = 1e-3,
                   bias_correction: bool = True,
                   betas: Tuple[float, float] = (0.9, 0.999),
                   eps: float = 1e-8, adam_math_mode=kPyTorchAdam,
                   weight_decay: float = 0.0, grad_clip_scale: float = 1.0
                   ) -> Transform:
    """The transform; ``params`` given to init and update are the compute
    parameters (bf16 in openfold)."""
    if adam_math_mode not in _ADAM_MODES:
        raise ValueError(f"Unknown Adam math mode {adam_math_mode!r}; "
                         f"expected kApexAdam(0) / kApexAdamW(1) / "
                         f"kPyTorchAdam(2)")
    adam_w_mode = _ADAM_MODES[adam_math_mode]
    beta1, beta2 = betas

    @torch.no_grad()
    def init(params: Tensors) -> FusedAdamSWAState:
        dev = next(iter(params.values())).device

        def zeros():
            return {n: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
                    for n, p in params.items()}

        def f32():
            return {n: p.detach().float().clone() for n, p in params.items()}

        def i32():
            return torch.zeros((), dtype=torch.int32, device=dev)

        return FusedAdamSWAState(i32(), zeros(), zeros(), f32(), f32(), i32())

    @torch.no_grad()
    def update(grads: Tensors, state: FusedAdamSWAState, params=None):
        if params is None:
            raise ValueError("fused_adam_swa requires params")
        step = state.step + 1
        bc1, bc2 = bias_corrections(step, betas, bias_correction)
        first = state.n_averaged == 0
        master, m, v, swa, updates = {}, {}, {}, {}, {}
        for n, p in params.items():
            g = grads[n].float() * grad_clip_scale
            pm = state.master[n]
            if not adam_w_mode and weight_decay != 0.0:
                g = g + weight_decay * pm
            m[n] = beta1 * state.exp_avg[n] + (1.0 - beta1) * g
            v[n] = beta2 * state.exp_avg_sq[n] + (1.0 - beta2) * g * g
            upd = (m[n] / bc1) / (torch.sqrt(v[n] / bc2) + eps)
            if adam_w_mode and weight_decay != 0.0:
                upd = upd + weight_decay * pm
            master[n] = pm - lr * upd
            s = state.swa[n]
            swa[n] = torch.where(first, master[n],
                                 s + (1.0 - swa_decay_rate) * (master[n] - s))
            updates[n] = master[n].to(p.dtype) - p
        return updates, FusedAdamSWAState(step, m, v, master, swa,
                                          state.n_averaged + 1)

    return Transform(init, update)


def swa_params(state: FusedAdamSWAState, like: Any = None) -> Tensors:
    """The averaged weights, cast to the dtypes of ``like`` (a dict of
    the same names) when given."""
    if like is None:
        return state.swa
    return {n: s.to(like[n].dtype) for n, s in state.swa.items()}


class FusedAdamSWA:
    """Class-style constructor with the reference's signature; the masters
    and the SWA stream live in the state."""

    def __new__(cls, swa_decay_rate: float, lr: float = 1e-3,
                bias_correction: bool = True,
                betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                adam_math_mode=kPyTorchAdam, weight_decay: float = 0.0,
                grad_clip_scale: float = 1.0, amsgrad: bool = False,
                capturable: bool = False, master_weights: bool = False,
                **_unused):
        if amsgrad:
            raise NotImplementedError("amsgrad is not supported by "
                                      "FusedAdamSWA")
        del capturable, master_weights
        return fused_adam_swa(swa_decay_rate=swa_decay_rate, lr=lr,
                              bias_correction=bias_correction, betas=betas,
                              eps=eps, adam_math_mode=adam_math_mode,
                              weight_decay=weight_decay,
                              grad_clip_scale=grad_clip_scale)
