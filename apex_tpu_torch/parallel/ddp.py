"""Data-parallel gradient synchronization (counterpart of
apex_tpu/parallel/ddp.py; ref: apex.parallel.DistributedDataParallel,
parallel/distributed.py:131, and Reducer, :91).

Torch's autograd gives each rank the gradient of its own loss, so the
gradients here are always the JAX function's per-rank local regime: the
sum over the data-parallel group, with the reference's order of
``gradient_predivide_factor`` (divide by f before the sum, multiply by
f / N after it, distributed.py:439-455), which trades fp16 overflow
headroom. The gradients of a collection travel as one flat buffer per
dtype (``ops.multi_tensor.flatten_pytree``), one collective each, not
one collective per tensor.

Collections are dicts from names to tensors (``dict(model
.named_parameters())``); ``group`` defaults to ``parallel_state``'s
data-parallel group, and with no group every function is the identity
(a world of one). ``compression`` (the JAX package's quantized
collectives, ``parallel/compress.py``) is not ported yet and raises.
"""

from collections import defaultdict
from typing import Callable, Dict, Optional

import torch

from apex_tpu_torch.ops.multi_tensor import flatten_pytree, unflatten_pytree
from apex_tpu_torch.parallel import parallel_state as ps

__all__ = ["DistributedDataParallel", "Reducer", "all_reduce_gradients",
           "broadcast_params"]

Tensors = Dict[str, torch.Tensor]


def _dp_group(group):
    return ps.get_data_parallel_group() if group is None else group


def _no_compression(compression) -> None:
    if compression is not None:
        raise NotImplementedError(
            "compressed gradient collectives (parallel/compress.py) are not "
            "ported yet")


def _by_flat_buffer(tree: Tensors, dtype_of: Callable, collective: Callable
                    ) -> Tensors:
    """Runs ``collective(flat)`` over one flat buffer of the tensors that
    share ``dtype_of(t)``, for each such dtype, and returns the tensors by
    name in their own dtypes."""
    buckets = defaultdict(dict)
    for name, t in tree.items():
        buckets[dtype_of(t)][name] = t
    out = {}
    for dtype, part in buckets.items():
        flat, spec = flatten_pytree(part, dtype=dtype)
        out.update(unflatten_pytree(collective(flat), spec))
    return {name: out[name] for name in tree}


def all_reduce_gradients(grads: Tensors, group=None,
                         gradient_average: bool = True,
                         gradient_predivide_factor: float = 1.0,
                         allreduce_always_fp32: bool = False,
                         compression=None) -> Tensors:
    """The data-parallel sum (mean with ``gradient_average``) of each
    rank's gradients, in each gradient's dtype (summed in fp32 with
    ``allreduce_always_fp32``)."""
    _no_compression(compression)
    group = _dp_group(group)
    if group is None:
        return grads
    n = ps.group_size(group)

    def reduce(flat):
        if gradient_predivide_factor != 1.0:
            flat = flat / gradient_predivide_factor
        flat = ps.all_reduce(flat, group)
        if gradient_average:
            flat = flat * (gradient_predivide_factor / n)
        return flat

    return _by_flat_buffer(
        grads, (lambda t: torch.float32) if allreduce_always_fp32
        else (lambda t: t.dtype), reduce)


@torch.no_grad()
def broadcast_params(params: Tensors, group=None) -> Tensors:
    """Makes the group's first rank's parameters everyone's (ref:
    distributed.py:257 broadcasts at wrap time): written into ``params``
    in place, which is returned."""
    group = _dp_group(group)
    if group is None:
        return params
    got = _by_flat_buffer(params, lambda t: t.dtype,
                          lambda flat: ps.broadcast(flat, group))
    for name, p in params.items():
        p.copy_(got[name])
    return params


class DistributedDataParallel:
    """Functional DDP (ref: parallel/distributed.py:131): carries the
    reduction options; ``reduce`` syncs gradients and ``value_and_grad``
    wraps ``loss_fn(params, *args)`` so that its gradients come back
    synced. There is no module to wrap, as in the JAX class."""

    def __init__(self, loss_fn: Optional[Callable] = None, group=None,
                 gradient_average: bool = True,
                 gradient_predivide_factor: float = 1.0,
                 allreduce_always_fp32: bool = False, compression=None):
        _no_compression(compression)
        self.loss_fn, self.group = loss_fn, group
        self.gradient_average = gradient_average
        self.gradient_predivide_factor = gradient_predivide_factor
        self.allreduce_always_fp32 = allreduce_always_fp32

    def reduce(self, grads: Tensors) -> Tensors:
        return all_reduce_gradients(
            grads, self.group, self.gradient_average,
            self.gradient_predivide_factor, self.allreduce_always_fp32)

    def value_and_grad(self) -> Callable:
        """``f(params, *args, **kw) -> (loss, synced grads)`` of
        ``loss_fn``, with gradients by ``torch.autograd.grad`` over the
        dict ``params``."""
        def wrapped(params: Tensors, *args, **kw):
            loss = self.loss_fn(params, *args, **kw)
            names = list(params)
            grads = torch.autograd.grad(loss, [params[n] for n in names])
            return loss, self.reduce(dict(zip(names, grads)))
        return wrapped


class Reducer:
    """Manual sync (ref: parallel/distributed.py:91): ``reduce`` returns
    the group's mean of each rank's tensors."""

    def __init__(self, group=None):
        self.group = group

    def reduce(self, tree: Tensors) -> Tensors:
        return all_reduce_gradients(tree, self.group)
