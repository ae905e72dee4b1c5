"""Tensor-parallel linear and embedding layers (counterpart of
apex_tpu/parallel/layers.py).

The kernels keep the flax layout ``(in, out)`` so that a JAX parameter
tree loads without transposes (models/convert.py). The dtype rules are
the JAX package's: the weight is cast to the activation's dtype, the
product accumulates in fp32, the output is rounded to the activation's
dtype (or to ``output_dtype``), and the bias is added after. ``attend``
gives fp32 logits. The products go to ``torch.matmul``, as the JAX
package leaves them to XLA.

At tensor-parallel size tp (``parallel_state``, read when a layer is
built and at each call) each rank holds its shard:
- :class:`ColumnParallelLinear`: the kernel's and bias's columns
  ``[t * out / tp, (t + 1) * out / tp)``; the input passes the copy-to
  region, or under sequence parallelism the sequence all-gather;
- :class:`RowParallelLinear`: the kernel's rows of the same range; the
  product is all-reduced, or reduce-scattered to the sequence-parallel
  region, and the (replicated) bias is added after the reduction, through
  the copy-to region under sequence parallelism, whose partial gradient
  the tp ranks sum;
- :class:`VocabParallelEmbedding`: the table's rows of this rank's vocab
  range; ids outside it look up zeros, and the lookups are all-reduced.
Tp-sharded parameters carry ``tensor_model_parallel = True`` (Megatron's
attribute): the initialisation draws them from the tp rank's own stream
(``models.gpt.init_params``, ``parallel.random``).

Under :func:`sequence_parallel_suspended` the linears run the plain-TP
layout although built for sequence parallelism: a KV-cache decode step's
single token cannot be split along the sequence (JAX replaces the
config's ``sequence_parallel`` with False for such a step).
"""

import contextlib
from typing import Optional

import torch
from torch import nn

from apex_tpu_torch.parallel import parallel_state as ps
from apex_tpu_torch.parallel.mappings import (
    copy_to_tensor_model_parallel_region,
    gather_from_sequence_parallel_region,
    gather_from_tensor_model_parallel_region,
    reduce_from_tensor_model_parallel_region,
    reduce_scatter_to_sequence_parallel_region,
    scatter_to_tensor_model_parallel_region,
)

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "sequence_parallel_active",
           "sequence_parallel_suspended"]

_SP_SUSPENDED = False


@contextlib.contextmanager
def sequence_parallel_suspended():
    """Within the block the column and row linears take and give
    tp-replicated activations (copy-to and all-reduce), and
    :func:`sequence_parallel_active` is False, whatever the config."""
    global _SP_SUSPENDED
    before, _SP_SUSPENDED = _SP_SUSPENDED, True
    try:
        yield
    finally:
        _SP_SUSPENDED = before


def sequence_parallel_active(enabled: bool) -> bool:
    """``enabled``, unless inside :func:`sequence_parallel_suspended`."""
    return enabled and not _SP_SUSPENDED


def _dot(x, w, out_dtype):
    """x @ w with w cast to x's dtype and fp32 accumulation, rounded to
    ``out_dtype``. A wider ``out_dtype`` upcasts both operands, which is
    exact, so the result is the fp32 accumulator itself."""
    w = w.to(x.dtype)
    if out_dtype == x.dtype:
        return torch.matmul(x, w)
    return torch.matmul(x.to(out_dtype), w.to(out_dtype))


def _local(size: int, tp: int, what: str) -> int:
    if size % tp:
        raise ValueError(f"{what} ({size}) is not divisible by tp ({tp})")
    return size // tp


def _sharded(t: torch.Tensor, dim: int) -> nn.Parameter:
    """A tp-sharded parameter split along ``dim`` of the whole one
    (``partition_dim``, Megatron's name; a checkpoint's global leaf is
    the tp ranks' shards concatenated along it)."""
    p = nn.Parameter(t)
    p.tensor_model_parallel = True
    p.partition_dim = dim
    return p


class ColumnParallelLinear(nn.Module):
    """Y = X A + b with A split along its output columns (ref: layers.py
    ColumnParallelLinear). ``gather_output`` all-gathers Y's columns
    (not under sequence parallelism)."""

    def __init__(self, input_size: int, output_size: int,
                 use_bias: bool = True, params_dtype=torch.float32,
                 output_dtype: Optional[torch.dtype] = None, device=None,
                 gather_output: bool = False,
                 sequence_parallel_enabled: bool = False):
        super().__init__()
        self.tp = ps.get_tensor_model_parallel_world_size()
        self.output_dtype = output_dtype
        self.gather_output = gather_output
        self.sequence_parallel = sequence_parallel_enabled and self.tp > 1
        if self.gather_output and self.sequence_parallel:
            raise ValueError("gather_output under sequence parallelism")
        out = _local(output_size, self.tp, "output_size")
        self.kernel = _sharded(torch.empty(
            input_size, out, dtype=params_dtype, device=device), 1)
        self.bias = _sharded(torch.zeros(
            out, dtype=params_dtype, device=device), 0) if use_bias else None

    def forward(self, x):
        if self.tp > 1:
            x = (gather_from_sequence_parallel_region(x)
                 if sequence_parallel_active(self.sequence_parallel)
                 else copy_to_tensor_model_parallel_region(x))
        y = _dot(x, self.kernel, self.output_dtype or x.dtype)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        if self.gather_output and self.tp > 1:
            y = gather_from_tensor_model_parallel_region(y)
        return y


class RowParallelLinear(nn.Module):
    """Y = X A + b with A split along its input rows (ref: layers.py
    RowParallelLinear); ``input_is_parallel=False`` takes a replicated X
    and keeps this rank's columns of it."""

    def __init__(self, input_size: int, output_size: int,
                 use_bias: bool = True, params_dtype=torch.float32,
                 device=None, input_is_parallel: bool = True,
                 sequence_parallel_enabled: bool = False):
        super().__init__()
        self.tp = ps.get_tensor_model_parallel_world_size()
        self.input_is_parallel = input_is_parallel
        self.sequence_parallel = sequence_parallel_enabled and self.tp > 1
        self.kernel = _sharded(torch.empty(
            _local(input_size, self.tp, "input_size"), output_size,
            dtype=params_dtype, device=device), 0)
        self.bias = nn.Parameter(torch.zeros(
            output_size, dtype=params_dtype,
            device=device)) if use_bias else None

    def forward(self, x):
        if self.tp > 1 and not self.input_is_parallel:
            x = scatter_to_tensor_model_parallel_region(x)
        y = _dot(x, self.kernel, x.dtype)
        sp = sequence_parallel_active(self.sequence_parallel)
        if self.tp > 1:
            y = (reduce_scatter_to_sequence_parallel_region(y) if sp
                 else reduce_from_tensor_model_parallel_region(y))
        if self.bias is not None:
            b = self.bias
            if sp:
                b = copy_to_tensor_model_parallel_region(b)
            y = y + b.to(y.dtype)
        return y


class VocabParallelEmbedding(nn.Module):
    """Embedding table split along the vocabulary (ref: layers.py
    VocabParallelEmbedding)."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 params_dtype=torch.float32, device=None):
        super().__init__()
        self.tp = ps.get_tensor_model_parallel_world_size()
        self.vocab_local = _local(num_embeddings, self.tp, "num_embeddings")
        self.embedding = _sharded(torch.empty(
            self.vocab_local, embedding_dim, dtype=params_dtype,
            device=device), 0)

    def forward(self, ids):
        if self.tp == 1:
            return self.embedding[ids]
        start = ps.get_tensor_model_parallel_rank() * self.vocab_local
        local = ids - start
        in_range = (local >= 0) & (local < self.vocab_local)
        out = self.embedding[local.clamp(0, self.vocab_local - 1)]
        out = torch.where(in_range[..., None], out,
                          torch.zeros((), dtype=out.dtype, device=out.device))
        return reduce_from_tensor_model_parallel_region(out)

    def attend(self, x, parallel_input: bool = False):
        """fp32 logits of ``x`` against this rank's rows of the (tied)
        table: vocab-sharded at tp > 1. ``parallel_input`` skips the
        copy-to region where the caller's sequence gather already carries
        the gradient's reduction (ref: layers.py attend)."""
        if self.tp > 1 and not parallel_input:
            x = copy_to_tensor_model_parallel_region(x)
        return _dot(x, self.embedding.t(), torch.float32)
