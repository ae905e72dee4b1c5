"""Memory-mapped token datasets, the Megatron pretraining samplers and the
bounded skip-and-log loader."""

from apex_tpu_torch.data.batchsampler import (
    MegatronPretrainingRandomSampler,
    MegatronPretrainingSampler,
)
from apex_tpu_torch.data.indexed_dataset import (
    IndexedTokenDataset,
    LMDataset,
    write_token_file,
)
from apex_tpu_torch.data.robust import RobustBatches, SkipBudgetExceeded

__all__ = ["IndexedTokenDataset", "LMDataset",
           "MegatronPretrainingRandomSampler", "MegatronPretrainingSampler",
           "RobustBatches", "SkipBudgetExceeded", "write_token_file"]
