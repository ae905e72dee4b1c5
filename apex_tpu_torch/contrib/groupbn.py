"""Group BatchNorm with an optional fused ReLU or residual add-ReLU
(counterpart of apex_tpu/contrib/groupbn.py; ref:
apex.contrib.groupbn.BatchNorm2d_NHWC and
apex.contrib.cudnn_gbn.GroupBatchNorm2d).

"A BatchNorm whose statistics span a group of ranks" is the port's
``parallel.sync_batch_norm.SyncBatchNorm`` over the process groups of
``axis_names`` (``parallel_state``'s mesh axes, resolved when the module
is built; ``()`` is a local BatchNorm, and an axis of size one has no
group). Input NCHW, the port's image convention.
"""

from typing import Sequence

import torch
from torch import nn

from apex_tpu_torch._kernels import resolve_device
from apex_tpu_torch.parallel import parallel_state as ps
from apex_tpu_torch.parallel.sync_batch_norm import SyncBatchNorm

__all__ = ["GroupBatchNorm2d", "axis_groups"]


def axis_groups(axis_names: Sequence[str]):
    """The process groups of ``axis_names`` that hold more than one rank,
    as a tuple for ``SyncBatchNorm``'s ``process_group`` (None when there
    is none)."""
    groups = tuple(g for g in (ps.get_group(a) for a in axis_names)
                   if ps.group_size(g) > 1)
    return groups or None


class GroupBatchNorm2d(nn.Module):
    """(ref: groupbn/batch_norm.py:101's num_features, eps, momentum,
    fuse_relu, bn_group). ``axis_names`` names the axes the statistics
    span (the bn_group). The BatchNorm is the submodule ``bn``."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, fuse_relu: bool = False,
                 axis_names: Sequence[str] = ("dp",), device="cuda"):
        super().__init__()
        self.num_features, self.fuse_relu = num_features, fuse_relu
        self.bn = SyncBatchNorm(num_features, momentum=momentum,
                                epsilon=eps,
                                process_group=axis_groups(axis_names),
                                device=resolve_device(device))

    def forward(self, x, z=None, train: bool = False):
        """``z``: a residual fused as add-ReLU (ref: the bn_addrelu
        kernels), which requires ``fuse_relu``."""
        if x.shape[1] != self.num_features:
            raise ValueError(f"expected {self.num_features} channels, got "
                             f"{x.shape[1]}")
        y = self.bn(x, use_running_average=not train)
        if z is not None:
            # the reference asserts fuse_relu for the add-relu path
            assert self.fuse_relu, "residual add requires fuse_relu=True"
            return torch.relu(y + z)
        if self.fuse_relu:
            return torch.relu(y)
        return y
