"""Tensor-parallel layers at tp = 1, BatchNorm's statistics as moments
at a data-parallel world of one, the parallel RNG seeds
(``parallel.random``) and the no-pipelining schedule
(``parallel.pipeline``)."""

from apex_tpu_torch.parallel.layers import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
)
from apex_tpu_torch.parallel.sync_batch_norm import SyncBatchNorm

__all__ = [
    "ColumnParallelLinear", "RowParallelLinear", "SyncBatchNorm",
    "VocabParallelEmbedding",
]
