"""ZeRO-2 fused Adam at a data-parallel world of one (counterpart of
apex_tpu/optimizers/distributed_fused_adam.py).

The JAX optimizer shards the optimizer state over the ``dp`` mesh axis:
it reduce-scatters the flat gradient, clips it by the global norm (one
``sumsq_flat`` per rank and a scalar psum), runs Adam on its shard of
the fp32 master and the moments, and all-gathers the new master. At a
world of one the reduce-scatter and the all-gather are the identity and
the psum sums one term, so the port writes them as such: the shard is
the whole flat buffer. The clip runs on the hand-written sum-of-squares
kernel (``sumsq_flat``) on a CUDA buffer.

The transform has the optax shape of :func:`~apex_tpu_torch.optimizers.
fused_adam`: ``init(params)`` and ``update(grads, state, params) ->
(updates, state)`` over dicts from parameter names to tensors, in the
JAX leaf order (``ops.multi_tensor``), so the flat master and moments
are element for element the JAX package's at dp = 1. The updates are
``new - old`` differenced in fp32 and cast to each parameter's dtype;
the caller applies ``p += update``.

Memory: the Adam math runs out of place over the flat buffers, as JAX
writes it, but each intermediate is freed as soon as the next one is
made, and the flat gradient is dropped before the updates are built.

Not ported: a world larger than one (``torch.distributed`` collectives),
``compression`` and ``store_param_remainders`` raise
``NotImplementedError``. ``param_gather_buckets`` is accepted and
ignored: the bucketed gather is bit-identical to the whole-shard one,
and at a world of one there is no gather to overlap.
"""

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from apex_tpu_torch.ops.multi_tensor import flatten_pytree, unflatten_pytree
from apex_tpu_torch.optimizers._fused_kernels import sumsq_flat
from apex_tpu_torch.optimizers.fused_adam import AdamTransform, Tensors

__all__ = ["DistributedFusedAdam", "DistributedFusedAdamState",
           "distributed_fused_adam"]


class DistributedFusedAdamState(NamedTuple):
    step: torch.Tensor  # 0-d int32
    master_shard: torch.Tensor  # fp32 (padded_total,): the whole buffer
    exp_avg: torch.Tensor
    exp_avg_sq: torch.Tensor
    # error-feedback residual of the compressed reduce-scatter; a 0-d zero,
    # as in JAX with compression off
    ef_residual: torch.Tensor


def _world_of_one(axis_size: Optional[int]) -> None:
    if axis_size is None and torch.distributed.is_available() \
            and torch.distributed.is_initialized():
        axis_size = torch.distributed.get_world_size()
    if axis_size not in (None, 1):
        raise NotImplementedError(
            f"distributed_fused_adam is ported for a data-parallel world "
            f"of one; got {axis_size} (the collectives over "
            f"torch.distributed are not ported yet)")


def zero_updates_from_flat(new_flat, params: Tensors, spec) -> Tensors:
    """The ZeRO update-dtype rule: unflatten the gathered buffer with the
    params' dtypes and return ``new - old`` differenced in fp32, cast to
    each parameter's dtype."""
    spec = dataclasses.replace(
        spec, dtypes=tuple(params[n].dtype for n in spec.names))
    new = unflatten_pytree(new_flat, spec)
    return {n: (new[n].float() - params[n].float()).to(params[n].dtype)
            for n in spec.names}


def distributed_fused_adam(
    lr: float = 1e-3,
    bias_correction: bool = True,
    betas: Tuple[float, float] = (0.9, 0.999),
    eps: float = 1e-8,
    adam_w_mode: bool = True,
    weight_decay: float = 0.0,
    axis_name: str = "dp",
    axis_size: Optional[int] = None,
    average_grads: bool = True,
    max_grad_norm: Optional[float] = None,
    store_param_remainders: bool = False,
    compression=None,
    param_gather_buckets: Optional[int] = None,
) -> AdamTransform:
    """ZeRO-2 Adam (ref: apex.contrib DistributedFusedAdam) at dp = 1.

    ``max_grad_norm``: clip the global gradient norm before the Adam
    math, ``min(1, max_grad_norm / (norm + 1e-6))`` (the torch
    convention), with the norm from ``sumsq_flat`` on the flat gradient.
    ``axis_name`` and ``average_grads`` keep the JAX signature; at a
    world of one neither changes a value. See the module docstring for
    what raises.
    """
    del axis_name, average_grads, param_gather_buckets
    _world_of_one(axis_size)
    if compression is not None:
        raise NotImplementedError(
            "distributed_fused_adam: compressed reduce-scatter is not "
            "ported yet")
    if store_param_remainders:
        raise NotImplementedError(
            "distributed_fused_adam: store_param_remainders is not ported "
            "yet")
    beta1, beta2 = betas

    @torch.no_grad()
    def init_fn(params: Tensors) -> DistributedFusedAdamState:
        master, _ = flatten_pytree(params, dtype=torch.float32)
        dev = master.device
        return DistributedFusedAdamState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            master_shard=master,
            exp_avg=torch.zeros_like(master),
            exp_avg_sq=torch.zeros_like(master),
            ef_residual=torch.zeros((), dtype=torch.float32, device=dev),
        )

    @torch.no_grad()
    def update_fn(grads: Tensors, state: DistributedFusedAdamState,
                  params: Optional[Tensors] = None):
        if params is None:
            raise ValueError("distributed_fused_adam requires params")
        # the reduce-scattered gradient shard: at a world of one,
        # psum_scatter of the flat buffer is the buffer itself and the dp
        # mean divides by one, which is exact, so neither is computed
        g, spec = flatten_pytree(grads, dtype=torch.float32)
        if g.shape != state.master_shard.shape:
            raise ValueError(f"the flat gradient ({g.shape[0]}) does not "
                             f"match the master ({state.master_shard.shape[0]})")
        if max_grad_norm is not None:
            # the psum over a world of one is the local sum itself
            total = sumsq_flat(g)
            clip = torch.clamp(max_grad_norm / (torch.sqrt(total) + 1e-6),
                               max=1.0)
            g.mul_(clip)  # g is this call's own flat buffer

        step = state.step + 1
        stepf = step.to(torch.float32)
        if bias_correction:
            bc1, bc2 = 1.0 - beta1 ** stepf, 1.0 - beta2 ** stepf
        else:
            bc1 = bc2 = torch.ones((), dtype=torch.float32, device=g.device)
        p = state.master_shard

        # adam_math of the JAX module, one rounded operation at a time in
        # its order, with each intermediate freed when it is consumed
        if not adam_w_mode and weight_decay != 0.0:
            g = g + weight_decay * p
        m = state.exp_avg * beta1
        m += g * (1.0 - beta1)
        v = state.exp_avg_sq * beta2
        t = g * (1.0 - beta2)
        t *= g
        v += t
        del g, t
        upd = m / bc1
        den = v / bc2
        den.sqrt_()
        den += eps
        upd /= den
        del den
        if adam_w_mode and weight_decay != 0.0:
            upd += weight_decay * p
        upd *= lr
        new_master = p - upd
        del upd

        # the all-gather over a world of one is the shard itself
        updates = zero_updates_from_flat(new_master, params, spec)
        return updates, DistributedFusedAdamState(
            step=step, master_shard=new_master, exp_avg=m, exp_avg_sq=v,
            ef_residual=state.ef_residual)

    return AdamTransform(init_fn, update_fn)


class DistributedFusedAdam:
    """Class-style constructor with the reference's signature; returns
    :func:`distributed_fused_adam`'s transform (the bucket and pipeline
    tuning knobs are accepted and ignored, as in JAX)."""

    def __new__(cls, lr: float = 1e-3, bias_correction: bool = True,
                betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                adam_w_mode: bool = True, weight_decay: float = 0.0,
                axis_name: str = "dp", axis_size: Optional[int] = None,
                average_grads: bool = True,
                max_grad_norm: Optional[float] = None,
                store_param_remainders: bool = False, compression=None,
                param_gather_buckets: Optional[int] = None, **_unused):
        return distributed_fused_adam(
            lr=lr, bias_correction=bias_correction, betas=betas, eps=eps,
            adam_w_mode=adam_w_mode, weight_decay=weight_decay,
            axis_name=axis_name, axis_size=axis_size,
            average_grads=average_grads, max_grad_norm=max_grad_norm,
            store_param_remainders=store_param_remainders,
            compression=compression,
            param_gather_buckets=param_gather_buckets)
