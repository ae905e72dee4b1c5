"""``apex.contrib.cudnn_gbn`` import surface (counterpart of
apex_tpu/contrib/cudnn_gbn.py): the cudnn flavour of group BatchNorm is
the same module as ``contrib.groupbn``'s, re-exported under its path."""

from apex_tpu_torch.contrib.groupbn import GroupBatchNorm2d

__all__ = ["GroupBatchNorm2d"]
