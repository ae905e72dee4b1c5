"""Tensor, sequence and data parallelism over ``torch.distributed``: the
process groups (``parallel.parallel_state``), the tensor- and
sequence-parallel regions (``parallel.mappings``) and layers, the
data-parallel gradient sync (``parallel.ddp``) and its quantized
collectives with error feedback (``parallel.compress``), BatchNorm
synchronized
over a group, the parallel RNG seeds (``parallel.random``), pipeline
parallelism (``parallel.pipeline``: stage edges, micro-batch calculators
and the schedules) and context parallelism (``parallel.ring_attention``:
ring and Ulysses attention, the zigzag layout, decode over a sharded
cache)."""

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
from apex_tpu_torch.parallel.ring_attention import (
    cp_decode_attention,
    ring_attention,
    ulysses_attention,
    zigzag_shard,
    zigzag_unshard,
)
from apex_tpu_torch.parallel.sync_batch_norm import (
    SyncBatchNorm,
    convert_syncbn_model,
)

__all__ = [
    "ColumnParallelLinear", "DistributedDataParallel", "Reducer",
    "RowParallelLinear", "SyncBatchNorm", "VocabParallelEmbedding",
    "all_reduce_gradients", "broadcast_params", "convert_syncbn_model",
    "cp_decode_attention", "ring_attention", "ulysses_attention",
    "zigzag_shard", "zigzag_unshard",
]
