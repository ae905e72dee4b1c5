"""Fused momentum SGD (counterpart of apex_tpu/optimizers/fused_sgd.py).

``fused_sgd(...)`` returns an :class:`SGDTransform` with the optax shape
of the JAX transform, as ``fused_adam`` does: ``init(params)`` and
``update(grads, state, params) -> (updates, state)`` over dicts from
parameter names to tensors. It writes nothing in place: the caller
applies ``p += update``.

The semantics are amp_C.multi_tensor_sgd's: L2 weight decay added to the
gradient before momentum; on the first step the momentum buffer is the
gradient itself, after that ``momentum * buf + (1 - dampening) * grad``;
Nesterov optionally. Plain torch over the whole collection
(``torch._foreach_*``): the JAX package has no Pallas kernel for it. The
first step is told apart on the device from the 0-d step tensor, so a
step needs no host sync.
"""

import dataclasses
from typing import Callable, Dict, NamedTuple, Tuple

import torch

__all__ = ["FusedSGD", "FusedSGDState", "SGDTransform", "fused_sgd"]

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass
class FusedSGDState:
    step: torch.Tensor  # 0-d int32
    momentum_buffer: Tensors  # per-name fp32


class SGDTransform(NamedTuple):
    init: Callable[[Tensors], FusedSGDState]
    update: Callable[..., Tuple[Tensors, FusedSGDState]]


def fused_sgd(lr: float = 1e-3, momentum: float = 0.0,
              dampening: float = 0.0, weight_decay: float = 0.0,
              nesterov: bool = False) -> SGDTransform:
    """Momentum SGD; see the module docstring."""
    if nesterov and (momentum <= 0 or dampening != 0):
        raise ValueError("Nesterov momentum requires a momentum and zero "
                         "dampening")

    @torch.no_grad()
    def init(params: Tensors) -> FusedSGDState:
        dev = next(iter(params.values())).device
        return FusedSGDState(
            torch.zeros((), dtype=torch.int32, device=dev),
            {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in params.items()})

    @torch.no_grad()
    def update(grads: Tensors, state: FusedSGDState, params=None):
        if params is None:
            raise ValueError("fused_sgd requires params")
        names = list(params)
        g = [grads[n].float() for n in names]
        if weight_decay != 0.0:
            g = torch._foreach_add(g, [params[n].float() for n in names],
                                   alpha=weight_decay)
        buf = [state.momentum_buffer[n] for n in names]
        if momentum != 0.0:
            # first step: buf = 0 * buf + 1 * g = g exactly (the buffer
            # starts at zero); after it the EMA
            first = state.step == 0
            keep = torch.where(first, 0.0, momentum)
            take = torch.where(first, 1.0, 1.0 - dampening)
            buf = torch._foreach_mul(buf, keep)
            torch._foreach_add_(buf, torch._foreach_mul(g, take))
            d = torch._foreach_add(g, buf, alpha=momentum) if nesterov \
                else buf
        else:
            d = g
        updates = torch._foreach_mul(d, -lr)
        return ({n: u.to(params[n].dtype) for n, u in zip(names, updates)},
                FusedSGDState(state.step + 1, dict(zip(names, buf))))

    return SGDTransform(init, update)


class FusedSGD:
    """Class-style constructor with the reference's signature; returns
    :func:`fused_sgd`'s transform."""

    def __new__(cls, lr: float = 1e-3, momentum: float = 0.0,
                dampening: float = 0.0, weight_decay: float = 0.0,
                nesterov: bool = False, **_unused):
        return fused_sgd(lr=lr, momentum=momentum, dampening=dampening,
                         weight_decay=weight_decay, nesterov=nesterov)
