"""Token datasets, the Megatron pretraining samplers and the bounded
skip-and-log loader."""

from apex_tpu_torch.data.batchsampler import (
    MegatronPretrainingRandomSampler,
    MegatronPretrainingSampler,
)
from apex_tpu_torch.data.indexed_dataset import LMDataset
from apex_tpu_torch.data.robust import RobustBatches, SkipBudgetExceeded

__all__ = ["LMDataset", "MegatronPretrainingRandomSampler",
           "MegatronPretrainingSampler", "RobustBatches",
           "SkipBudgetExceeded"]
