"""``apex.transformer.tensor_parallel`` import surface (counterpart of
apex_tpu/transformer/tensor_parallel.py).

The names Megatron-style user code imports from
``apex.transformer.tensor_parallel``, re-exported from
``apex_tpu_torch.parallel`` under the JAX module's names. JAX's
``model_parallel_rng_key`` folds the tp rank into a key; here it is
``parallel.random``'s generator of this tp rank's model-parallel region
(seed ``seed + 2718 + tp_rank``).
"""

from apex_tpu_torch.parallel import parallel_state as _ps
from apex_tpu_torch.parallel.cross_entropy import vocab_parallel_cross_entropy
from apex_tpu_torch.parallel.layers import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
)
from apex_tpu_torch.parallel.mappings import (
    copy_to_tensor_model_parallel_region,
    gather_from_sequence_parallel_region,
    gather_from_tensor_model_parallel_region,
    reduce_from_tensor_model_parallel_region,
    reduce_scatter_to_sequence_parallel_region,
    scatter_to_sequence_parallel_region,
    scatter_to_tensor_model_parallel_region,
)
from apex_tpu_torch.parallel.random import (
    checkpoint,
    model_parallel_generator,
    model_parallel_seed,
)
from apex_tpu_torch.parallel.utils import (
    VocabUtility,
    broadcast_data,
    split_tensor_along_last_dim,
)

__all__ = [
    "vocab_parallel_cross_entropy",
    "broadcast_data",
    "ColumnParallelLinear",
    "RowParallelLinear",
    "VocabParallelEmbedding",
    "copy_to_tensor_model_parallel_region",
    "gather_from_tensor_model_parallel_region",
    "reduce_from_tensor_model_parallel_region",
    "scatter_to_tensor_model_parallel_region",
    "gather_from_sequence_parallel_region",
    "reduce_scatter_to_sequence_parallel_region",
    "scatter_to_sequence_parallel_region",
    "checkpoint",
    "model_parallel_rng_key",
    "model_parallel_seed",
    "split_tensor_along_last_dim",
    "VocabUtility",
]


def model_parallel_rng_key(seed: int, device="cpu"):
    """The model-parallel region's generator of this tp rank, from
    ``seed`` (``parallel.random.model_parallel_generator``)."""
    return model_parallel_generator(
        seed, _ps.get_tensor_model_parallel_rank(), device)
