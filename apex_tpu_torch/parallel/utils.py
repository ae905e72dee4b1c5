"""Tensor-parallel utilities (counterpart of apex_tpu/parallel/utils.py):
``split_tensor_along_last_dim``, ``VocabUtility`` and ``broadcast_data``
(ref: apex/transformer/tensor_parallel/utils.py:22, :46 and data.py:80).

The JAX module's varying-manual-axes helpers (``pcast_varying``,
``promote_to_vma``, ``pvary_params``, ``vma_cond``,
``scan_carry_fixed_point``) type values inside ``shard_map``; eager
PyTorch has no such types, so they have no counterpart here.
"""

from typing import Dict, Sequence, Tuple

import torch

from apex_tpu_torch.parallel import parallel_state as ps

__all__ = ["VocabUtility", "broadcast_data", "split_tensor_along_last_dim"]


def split_tensor_along_last_dim(x: torch.Tensor, num_partitions: int
                                ) -> Sequence[torch.Tensor]:
    """``num_partitions`` equal views of ``x`` along its last dim."""
    return torch.chunk(x, num_partitions, dim=-1)


class VocabUtility:
    """The ``[first, last)`` vocabulary range of a tp rank."""

    @staticmethod
    def vocab_range_from_per_partition_vocab_size(
            per_partition_vocab_size: int, rank: int,
            world_size: int) -> Tuple[int, int]:
        start = rank * per_partition_vocab_size
        return start, start + per_partition_vocab_size

    @staticmethod
    def vocab_range_from_global_vocab_size(
            global_vocab_size: int, rank: int,
            world_size: int) -> Tuple[int, int]:
        return VocabUtility.vocab_range_from_per_partition_vocab_size(
            global_vocab_size // world_size, rank, world_size)


def broadcast_data(keys, data: Dict[str, torch.Tensor], dtype=None
                   ) -> Dict[str, torch.Tensor]:
    """The tensors of ``keys`` as tp rank 0 holds them, on every rank of
    its tensor-parallel group (ref: data.py:80); each is cast to ``dtype``
    when one is given. The JAX function is the identity, since every
    device of one controller sees the same host arrays; here each process
    loads its own, so tp rank 0's are sent. Every rank passes tensors of
    the same shapes and dtypes."""
    group = ps.get_tensor_model_parallel_group()
    out = {}
    for k in keys:
        t = data[k] if dtype is None else data[k].to(dtype)
        out[k] = ps.broadcast(t.contiguous().clone(), group)
    return out
