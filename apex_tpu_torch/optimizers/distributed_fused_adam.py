"""ZeRO-2 fused Adam (counterpart of
apex_tpu/optimizers/distributed_fused_adam.py).

The optimizer state is sharded over the data-parallel group (``group``,
by default ``parallel_state``'s, whose size is the JAX ``axis_size``):
the flat fp32 gradient, zero-padded to a multiple of the group's size
(:func:`_padded_flatten`), is reduce-scattered in one collective and
divided by N (:func:`zero_scatter_grads`, which takes each rank's own,
un-averaged gradients, the JAX function's per-rank regime), clipped by
the global norm (the hand-written sum-of-squares kernel, ``sumsq_flat``,
on the rank's shard, then an all-reduce of the scalar), and Adam runs on
this rank's shard of the fp32 master and the moments in plain torch ops,
as the JAX ``adam_math`` does; the new master shards are all-gathered
(:func:`zero_gather_updates`). :func:`zero_state_specs` says which rank
holds which slice. With no group (a world of one) the shard is the whole
buffer and no collective runs.

The transform has the optax shape of :func:`~apex_tpu_torch.optimizers.
fused_adam`: ``init(params)`` and ``update(grads, state, params) ->
(updates, state)`` over dicts from parameter names to tensors, in the
JAX leaf order (``ops.multi_tensor``), so the flat master and moments
are element for element the JAX package's. The updates are ``new -
old`` differenced in fp32 and cast to each parameter's dtype; the
caller applies ``p += update``.

Memory: the Adam math runs out of place over the shard, as JAX writes
it, but each intermediate is freed as soon as the next one is made, and
the gradient shard is dropped before the updates are built.

Not ported: ``compression`` and ``store_param_remainders`` raise
``NotImplementedError``. ``param_gather_buckets`` is accepted and
ignored: the bucketed gather is bit-identical to the whole-shard one.
"""

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from apex_tpu_torch.ops.multi_tensor import (
    FlatSpec,
    flatten_pytree,
    unflatten_pytree,
)
from apex_tpu_torch.optimizers._fused_kernels import sumsq_flat
from apex_tpu_torch.optimizers.fused_adam import AdamTransform, Tensors
from apex_tpu_torch.parallel import parallel_state as ps

__all__ = ["DistributedFusedAdam", "DistributedFusedAdamState",
           "ZeroStateSpecs", "distributed_fused_adam", "zero_state_specs"]


class DistributedFusedAdamState(NamedTuple):
    step: torch.Tensor  # 0-d int32, the same on every rank
    master_shard: torch.Tensor  # fp32 (padded_total / N,): this rank's
    exp_avg: torch.Tensor
    exp_avg_sq: torch.Tensor
    # error-feedback residual of the compressed reduce-scatter; a 0-d zero,
    # as in JAX with compression off
    ef_residual: torch.Tensor


class ZeroStateSpecs(NamedTuple):
    """Where the ZeRO state lives (the counterpart of the JAX
    ``zero_state_specs``' PartitionSpecs): ``step`` and ``ef_residual``
    are replicated, and each of ``master_shard``, ``exp_avg`` and
    ``exp_avg_sq`` is data-parallel rank d's slice ``[d * shard_len, (d +
    1) * shard_len)`` of one global flat buffer of ``spec.padded_total``
    elements in the JAX leaf order, zero past ``spec.total``."""

    axis_size: int
    shard_len: int
    spec: FlatSpec

    def shard_range(self, rank: int) -> Tuple[int, int]:
        return rank * self.shard_len, (rank + 1) * self.shard_len


def _padded_flatten(tree: Tensors, axis_size: int):
    """The fp32 flat buffer of ``tree`` (``flatten_pytree``), zero-padded
    to a multiple of ``axis_size``, and its spec."""
    flat, spec = flatten_pytree(tree, dtype=torch.float32)
    pad = -flat.shape[0] % axis_size
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
        spec = dataclasses.replace(spec, padded_total=flat.shape[0])
    return flat, spec


def zero_state_specs(params: Tensors, axis_size: int) -> ZeroStateSpecs:
    """The layout of the ZeRO state of ``params`` over ``axis_size``
    data-parallel ranks (worked out on meta tensors: nothing is
    allocated)."""
    _, spec = _padded_flatten({n: p.detach().to("meta")
                               for n, p in params.items()}, axis_size)
    return ZeroStateSpecs(axis_size, spec.padded_total // axis_size, spec)


def _rank(group) -> int:
    return 0 if group is None else torch.distributed.get_rank(group)


def zero_init_master_shard(params: Tensors, group):
    """This rank's fp32 shard of the flattened, padded params, and the
    shard's length."""
    n = ps.group_size(group)
    flat, _ = _padded_flatten(params, n)
    shard = flat.shape[0] // n
    r = _rank(group)
    return flat[r * shard:(r + 1) * shard].clone(), shard


def zero_scatter_grads(grads: Tensors, group, average: bool = True):
    """This rank's shard of the group's sum of the ranks' own gradients
    (one fused reduce-scatter of the flat buffer), divided by N with
    ``average``; and the flat spec. A gradient that is already the dp
    mean would be divided twice: pass each rank's own."""
    n = ps.group_size(group)
    gflat, spec = _padded_flatten(grads, n)
    gshard = ps.reduce_scatter(gflat, group)
    if average and n > 1:
        gshard = gshard / n
    return gshard, spec


def zero_gather_updates(new_master: torch.Tensor, params: Tensors,
                        spec: FlatSpec, group) -> Tensors:
    """All-gathers the new master shards and returns the updates (new -
    old) in the params' dtypes."""
    return zero_updates_from_flat(ps.all_gather(new_master, group), params,
                                  spec)


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
    group=None,
) -> AdamTransform:
    """ZeRO-2 Adam (ref: apex.contrib DistributedFusedAdam) over the
    data-parallel group ``group`` (``parallel_state``'s group of the axis
    ``axis_name`` when None).

    ``axis_size``, where given, must be the group's size; the group is
    read when the transform is made.
    ``average_grads`` divides the reduce-scattered sum by N.
    ``max_grad_norm``: clip the global gradient norm before the Adam
    math, ``min(1, max_grad_norm / (norm + 1e-6))`` (the torch
    convention), the norm from ``sumsq_flat`` on this rank's shard and an
    all-reduce of the sum. See the module docstring for what raises.
    """
    del param_gather_buckets
    if compression is not None:
        raise NotImplementedError(
            "distributed_fused_adam: compressed reduce-scatter is not "
            "ported yet")
    if store_param_remainders:
        raise NotImplementedError(
            "distributed_fused_adam: store_param_remainders is not ported "
            "yet")
    beta1, beta2 = betas
    grp = group if group is not None else ps.get_group(axis_name)
    if axis_size is not None and axis_size != ps.group_size(grp):
        raise ValueError(f"axis_size {axis_size} is not the size of the "
                         f"group ({ps.group_size(grp)})")

    @torch.no_grad()
    def init_fn(params: Tensors) -> DistributedFusedAdamState:
        master, _ = zero_init_master_shard(params, grp)
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
        g, spec = zero_scatter_grads(grads, grp, average_grads)
        if g.shape != state.master_shard.shape:
            raise ValueError(f"the gradient shard ({g.shape[0]}) does not "
                             f"match the master "
                             f"({state.master_shard.shape[0]})")
        if max_grad_norm is not None:
            total = ps.all_reduce(sumsq_flat(g), grp)
            clip = torch.clamp(max_grad_norm / (torch.sqrt(total) + 1e-6),
                               max=1.0)
            g = g * clip

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

        updates = zero_gather_updates(new_master, params, spec, grp)
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
                param_gather_buckets: Optional[int] = None, group=None,
                **_unused):
        return distributed_fused_adam(
            lr=lr, bias_correction=bias_correction, betas=betas, eps=eps,
            adam_w_mode=adam_w_mode, weight_decay=weight_decay,
            axis_name=axis_name, axis_size=axis_size,
            average_grads=average_grads, max_grad_norm=max_grad_norm,
            store_param_remainders=store_param_remainders,
            compression=compression,
            param_gather_buckets=param_gather_buckets, group=group)
