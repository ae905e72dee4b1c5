"""Fused Adam / AdamW (counterpart of apex_tpu/optimizers/fused_adam.py).

``fused_adam(...)`` returns an :class:`AdamTransform` with the optax
shape of the JAX transform: ``init(params)`` and
``update(grads, state, params) -> (updates, state)`` over dicts from
parameter names to tensors (``dict(model.named_parameters())``). It
writes nothing in place: the caller applies ``p += update``.

Both engines run the Adam kernel on CUDA tensors (``_fused_kernels``):
- ``"tree"`` (the default, and the JAX target's): moments per parameter
  tensor, one kernel launch per tensor (148 for GPT-2 small);
- ``"flat"``: moments in one fp32 buffer zero-padded to a multiple of
  ``CHUNK_SIZE`` in the JAX leaf order (``ops.multi_tensor``), so it is
  interchangeable with the JAX flat engine's; one launch per step.

The bias corrections ``1 - beta**step`` are computed in fp32 on the
step's device from the 0-d int32 step tensor, and the kernel reads them
there, so a step needs no host sync.
"""

import dataclasses
from typing import Callable, Dict, NamedTuple, Tuple, Union

import torch

from apex_tpu_torch.ops.multi_tensor import (
    CHUNK_SIZE,
    flatten_pytree,
    unflatten_pytree,
)
from apex_tpu_torch.optimizers._fused_kernels import adam_flat
from apex_tpu_torch.optimizers.transform import bias_corrections

__all__ = ["AdamTransform", "FusedAdam", "FusedAdamState", "fused_adam"]

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass
class FusedAdamState:
    step: torch.Tensor  # 0-d int32
    exp_avg: Union[Tensors, torch.Tensor]  # per-name fp32, or flat fp32
    exp_avg_sq: Union[Tensors, torch.Tensor]


class AdamTransform(NamedTuple):
    init: Callable[[Tensors], FusedAdamState]
    update: Callable[..., Tuple[Tensors, FusedAdamState]]


def fused_adam(lr: float = 1e-3, bias_correction: bool = True,
               betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
               adam_w_mode: bool = True, weight_decay: float = 0.0,
               fuse: str = "tree") -> AdamTransform:
    """Adam with amp_C.multi_tensor_adam semantics; see the module
    docstring for ``fuse``."""
    beta1, beta2 = betas
    if fuse not in ("tree", "flat"):
        raise ValueError(f"unknown fuse mode {fuse!r}; expected tree|flat")
    kw = dict(lr=lr, beta1=beta1, beta2=beta2, eps=eps,
              weight_decay=weight_decay, adam_w_mode=adam_w_mode)

    def device_of(params):
        return next(iter(params.values())).device

    def step0(params):
        return torch.zeros((), dtype=torch.int32, device=device_of(params))

    @torch.no_grad()
    def init_tree(params: Tensors) -> FusedAdamState:
        def zeros():
            return {n: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device) for n, p in params.items()}
        return FusedAdamState(step0(params), zeros(), zeros())

    @torch.no_grad()
    def update_tree(grads: Tensors, state: FusedAdamState, params=None):
        if params is None:
            raise ValueError("fused_adam requires params")
        step = state.step + 1
        bc1, bc2 = bias_corrections(step, betas, bias_correction)
        updates, m, v = {}, {}, {}
        for name, p in params.items():
            u, m[name], v[name] = adam_flat(
                grads[name].float(), p.float(), state.exp_avg[name],
                state.exp_avg_sq[name], bc1, bc2, **kw)
            updates[name] = u.to(p.dtype)
        return updates, FusedAdamState(step, m, v)

    @torch.no_grad()
    def init_flat(params: Tensors) -> FusedAdamState:
        # the padded length from shapes alone, as flatten_pytree pads
        total = sum(p.numel() for p in params.values())
        padded = max(CHUNK_SIZE, -(-total // CHUNK_SIZE) * CHUNK_SIZE)
        dev = device_of(params)
        return FusedAdamState(
            step0(params),
            torch.zeros(padded, dtype=torch.float32, device=dev),
            torch.zeros(padded, dtype=torch.float32, device=dev))

    @torch.no_grad()
    def update_flat(grads: Tensors, state: FusedAdamState, params=None):
        if params is None:
            raise ValueError("fused_adam requires params")
        step = state.step + 1
        bc1, bc2 = bias_corrections(step, betas, bias_correction)
        g_flat, _ = flatten_pytree(grads, dtype=torch.float32)
        p_flat, spec = flatten_pytree(params, dtype=torch.float32)
        upd, m, v = adam_flat(g_flat, p_flat, state.exp_avg,
                              state.exp_avg_sq, bc1, bc2, **kw)
        # spec carries the params' dtypes, so updates cast back per leaf
        return unflatten_pytree(upd, spec), FusedAdamState(step, m, v)

    if fuse == "flat":
        return AdamTransform(init_flat, update_flat)
    return AdamTransform(init_tree, update_tree)


class FusedAdam:
    """Class-style constructor with the reference's signature; returns
    :func:`fused_adam`'s transform."""

    def __new__(cls, lr: float = 1e-3, bias_correction: bool = True,
                betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                adam_w_mode: bool = True, weight_decay: float = 0.0,
                amsgrad: bool = False, capturable: bool = False,
                master_weights: bool = False, **_unused):
        if amsgrad:
            raise RuntimeError("FusedAdam does not support the AMSGrad variant.")
        del capturable, master_weights  # the state already lives on the card
        return fused_adam(lr=lr, bias_correction=bias_correction, betas=betas,
                          eps=eps, adam_w_mode=adam_w_mode,
                          weight_decay=weight_decay)
