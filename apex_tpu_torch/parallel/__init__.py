"""Tensor, sequence and data parallelism over ``torch.distributed``: the
process groups (``parallel.parallel_state``), the tensor- and
sequence-parallel regions (``parallel.mappings``) and layers, the
data-parallel gradient sync (``parallel.ddp``), BatchNorm synchronized
over a group, the parallel RNG seeds (``parallel.random``) and the
no-pipelining schedule (``parallel.pipeline``)."""

from apex_tpu_torch.parallel.ddp import (
    DistributedDataParallel,
    Reducer,
    all_reduce_gradients,
    broadcast_params,
)
from apex_tpu_torch.parallel.layers import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
)
from apex_tpu_torch.parallel.sync_batch_norm import (
    SyncBatchNorm,
    convert_syncbn_model,
)

__all__ = [
    "ColumnParallelLinear", "DistributedDataParallel", "Reducer",
    "RowParallelLinear", "SyncBatchNorm", "VocabParallelEmbedding",
    "all_reduce_gradients", "broadcast_params", "convert_syncbn_model",
]
