"""Tensor- and sequence-parallel regions (counterpart of
apex_tpu/parallel/mappings.py).

The seven ``torch.autograd.Function``s of Megatron tensor and sequence
parallelism, each with the forward and backward collective of its JAX
``custom_vjp`` (ref: apex/transformer/tensor_parallel/mappings.py):

| region (``..._region``)                | forward          | backward       |
|----------------------------------------|------------------|----------------|
| copy_to_tensor_model_parallel          | identity         | all-reduce     |
| reduce_from_tensor_model_parallel      | all-reduce       | identity       |
| scatter_to_tensor_model_parallel       | split last dim   | all-gather     |
| gather_from_tensor_model_parallel      | all-gather last  | split          |
| scatter_to_sequence_parallel           | split first dim  | all-gather     |
| gather_from_sequence_parallel          | all-gather first | reduce-scatter |
| reduce_scatter_to_sequence_parallel    | reduce-scatter   | all-gather     |

Each takes the process group of its axis (``group``, default the
tensor-parallel group of ``parallel_state``) where the JAX functions take
an axis name. The callers (the parallel layers) skip them at tp = 1, as
the JAX layers do; over a group of one the collectives are the identity.
The collectives are ``parallel_state``'s.
"""

import torch

from apex_tpu_torch.parallel import parallel_state as ps

__all__ = [
    "copy_to_tensor_model_parallel_region",
    "gather_from_sequence_parallel_region",
    "gather_from_tensor_model_parallel_region",
    "reduce_from_tensor_model_parallel_region",
    "reduce_scatter_to_sequence_parallel_region",
    "scatter_to_sequence_parallel_region",
    "scatter_to_tensor_model_parallel_region",
]


def _group(group):
    return ps.get_tensor_model_parallel_group() if group is None else group


def _split(x, group, dim):
    """This rank's slice of ``dim`` (ref: utils.py
    split_tensor_along_last_dim)."""
    n = ps.group_size(group)
    if n == 1:
        return x
    rank = torch.distributed.get_rank(group)
    return x.chunk(n, dim=dim)[rank].contiguous()


class _CopyToTP(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ps.all_reduce(g, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        return ps.all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScatterToTP(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _split(x, group, x.ndim - 1)

    @staticmethod
    def backward(ctx, g):
        return ps.all_gather(g, ctx.group, g.ndim - 1).contiguous(), None


class _GatherFromTP(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return ps.all_gather(x, group, x.ndim - 1).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _split(g, ctx.group, g.ndim - 1), None


class _ScatterToSP(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _split(x, group, 0)

    @staticmethod
    def backward(ctx, g):
        return ps.all_gather(g, ctx.group, 0), None


class _GatherFromSP(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, to_model_parallel):
        ctx.group, ctx.to_model_parallel = group, to_model_parallel
        return ps.all_gather(x, group, 0)

    @staticmethod
    def backward(ctx, g):
        if ctx.to_model_parallel:
            return ps.reduce_scatter(g, ctx.group, 0), None, None
        return _split(g, ctx.group, 0), None, None


class _ReduceScatterToSP(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return ps.reduce_scatter(x, group, 0)

    @staticmethod
    def backward(ctx, g):
        return ps.all_gather(g, ctx.group, 0), None


def copy_to_tensor_model_parallel_region(x, group=None):
    """Identity forward, all-reduce backward."""
    return _CopyToTP.apply(x, _group(group))


def reduce_from_tensor_model_parallel_region(x, group=None):
    """All-reduce forward, identity backward."""
    return _ReduceFromTP.apply(x, _group(group))


def scatter_to_tensor_model_parallel_region(x, group=None):
    """This rank's slice of the last dim; all-gather backward."""
    return _ScatterToTP.apply(x, _group(group))


def gather_from_tensor_model_parallel_region(x, group=None):
    """All-gather along the last dim; split backward."""
    return _GatherFromTP.apply(x, _group(group))


def scatter_to_sequence_parallel_region(x, group=None):
    """This rank's slice of the first (sequence) dim; all-gather
    backward."""
    return _ScatterToSP.apply(x, _group(group))


def gather_from_sequence_parallel_region(x, group=None,
                                         to_model_parallel: bool = True):
    """All-gather along the sequence dim; the backward reduce-scatters
    (``to_model_parallel``: the gathered activation feeds tp-sharded
    weights, whose partial gradients are summed) or keeps this rank's
    slice. The JAX function's experimental ``defer_sync`` is not
    ported."""
    return _GatherFromSP.apply(x, _group(group), to_model_parallel)


def reduce_scatter_to_sequence_parallel_region(x, group=None):
    """Reduce-scatter along the sequence dim; all-gather backward."""
    return _ReduceScatterToSP.apply(x, _group(group))
