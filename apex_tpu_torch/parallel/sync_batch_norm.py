"""BatchNorm with its statistics as count-weighted moments (counterpart of
apex_tpu/parallel/sync_batch_norm.py's ``SyncBatchNorm``), at a
data-parallel world of one.

The batch statistics are the triple (n, sum x, sum x^2) in fp32, then
``mean = sum x / n`` and ``var = sum x^2 / n - mean^2``: the moments that a
data-parallel group adds up (the JAX module's ``psum`` over its mesh
axes), kept explicit so that the all-reduce drops in between the two
steps. So the statistics are plain torch ops, not ``F.batch_norm``, which
hides them. A process group of more than one rank raises for now.

Channels are dim 1, as in ``torch.nn.BatchNorm2d``: an NHWC array is a
channels-last NCHW tensor, so the JAX module's last axis is this module's
dim 1 after ``x.permute(0, 3, 1, 2)``, with the same memory.
"""

from typing import Optional

import torch
from torch import nn

__all__ = ["SyncBatchNorm"]


class SyncBatchNorm(nn.Module):
    """BatchNorm over every dim but 1. ``momentum`` is torch's
    (``new = (1 - momentum) * running + momentum * batch``), and the running
    variance is the unbiased ``var * n / max(n - 1, 1)``. The output is
    computed in fp32 and cast to ``dtype`` (x's dtype when None); the
    parameters ``scale`` and ``bias`` and the buffers ``mean`` and ``var``
    are fp32 (the flax names)."""

    def __init__(self, features: int,
                 use_running_average: Optional[bool] = None,
                 momentum: float = 0.1, epsilon: float = 1e-5,
                 use_scale: bool = True, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None, scale_init: float = 1.0,
                 process_group=None, device=None):
        super().__init__()
        if process_group is not None and \
                torch.distributed.get_world_size(process_group) > 1:
            raise NotImplementedError(
                "SyncBatchNorm over more than one rank is not ported yet; "
                "the batch moments (n, sum x, sum x^2) are what it will "
                "all-reduce")
        self.use_running_average = use_running_average
        self.momentum, self.epsilon, self.dtype = momentum, epsilon, dtype
        f32 = dict(dtype=torch.float32, device=device)
        self.scale = nn.Parameter(torch.full((features,), scale_init, **f32)) \
            if use_scale else None
        self.bias = nn.Parameter(torch.zeros(features, **f32)) \
            if use_bias else None
        self.register_buffer("mean", torch.zeros(features, **f32))
        self.register_buffer("var", torch.ones(features, **f32))

    def forward(self, x: torch.Tensor,
                use_running_average: Optional[bool] = None) -> torch.Tensor:
        use_ra = self.use_running_average if use_running_average is None \
            else use_running_average
        if use_ra is None:
            raise ValueError("SyncBatchNorm: pass use_running_average to the "
                             "constructor or the call")
        xf = x.float()
        shape = (1, -1) + (1,) * (x.ndim - 2)
        if use_ra:
            mean, var = self.mean, self.var
        else:
            dims = [d for d in range(x.ndim) if d != 1]
            n = x.numel() // x.shape[1]
            s1, s2 = xf.sum(dims), xf.square().sum(dims)
            mean = s1 / n
            var = s2 / n - mean.square()
            with torch.no_grad():
                m = self.momentum
                self.mean.mul_(1.0 - m).add_(m * mean)
                self.var.mul_(1.0 - m).add_(m * (var * n / max(n - 1, 1)))
        y = (xf - mean.view(shape)) * torch.rsqrt(var + self.epsilon).view(shape)
        if self.scale is not None:
            y = y * self.scale.view(shape)
        if self.bias is not None:
            y = y + self.bias.view(shape)
        return y.to(self.dtype or x.dtype)
