"""Token datasets."""

from apex_tpu_torch.data.indexed_dataset import LMDataset

__all__ = ["LMDataset"]
