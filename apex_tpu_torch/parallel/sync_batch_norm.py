"""BatchNorm with its statistics synchronized over a process group
(counterpart of apex_tpu/parallel/sync_batch_norm.py's ``SyncBatchNorm``
and ``convert_syncbn_model``; ref: apex.parallel.SyncBatchNorm).

The batch statistics are the triple (n, sum x, sum x^2) in fp32, summed
over ``process_group`` by one all-reduce (the JAX module's ``psum`` over
its mesh axes; exact for unequal per-rank batches), then ``mean = sum x
/ n`` and ``var = sum x^2 / n - mean^2``. The all-reduce is an autograd
Function whose backward all-reduces the moments' gradients, so each
rank's backward of its own loss gives its input the gradient of the sum
of the ranks' losses, as torch's SyncBatchNorm does. So the statistics
are plain torch ops, not ``F.batch_norm``, which hides them.

Channels are dim 1, as in ``torch.nn.BatchNorm2d``: an NHWC array is a
channels-last NCHW tensor, so the JAX module's last axis is this module's
dim 1 after ``x.permute(0, 3, 1, 2)``, with the same memory.
"""

from typing import Optional

import torch
from torch import nn

from apex_tpu_torch.parallel import parallel_state as ps

__all__ = ["SyncBatchNorm", "convert_syncbn_model"]


def _sum_over(x, groups):
    """``x`` summed over ``groups``, one group or a tuple of groups of
    different mesh axes (summed over each in turn: the sum over their
    product)."""
    for group in groups if isinstance(groups, (tuple, list)) else (groups,):
        x = ps.all_reduce(x, group)
    return x


class _AllReduceSum(torch.autograd.Function):
    """Sum over ``group`` forward; the same sum of the gradients
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum_over(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum_over(g, ctx.group), None


class SyncBatchNorm(nn.Module):
    """BatchNorm over every dim but 1. ``momentum`` is torch's
    (``new = (1 - momentum) * running + momentum * batch``), and the running
    variance is the unbiased ``var * n / max(n - 1, 1)``. The output is
    computed in fp32 and cast to ``dtype`` (x's dtype when None); the
    parameters ``scale`` and ``bias`` and the buffers ``mean`` and ``var``
    are fp32 (the flax names). ``process_group``: the group whose
    moments are summed, or a tuple of groups of different mesh axes (the
    JAX module's several ``axis_names``; None: this rank's alone)."""

    def __init__(self, features: int,
                 use_running_average: Optional[bool] = None,
                 momentum: float = 0.1, epsilon: float = 1e-5,
                 use_scale: bool = True, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None, scale_init: float = 1.0,
                 process_group=None, device=None):
        super().__init__()
        self.process_group = process_group
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
            c = x.shape[1]
            n = xf.new_full((1,), x.numel() // c)
            s1, s2 = xf.sum(dims), xf.square().sum(dims)
            if self.process_group is not None:
                n, s1, s2 = _AllReduceSum.apply(
                    torch.cat([n, s1, s2]), self.process_group
                ).split([1, c, c])
            n = n[0]
            mean = s1 / n
            var = s2 / n - mean.square()
            with torch.no_grad():
                m = self.momentum
                self.mean.mul_(1.0 - m).add_(m * mean)
                self.var.mul_(1.0 - m).add_(
                    m * (var * n / torch.clamp_min(n - 1.0, 1.0)))
        y = (xf - mean.view(shape)) * torch.rsqrt(var + self.epsilon).view(shape)
        if self.scale is not None:
            y = y * self.scale.view(shape)
        if self.bias is not None:
            y = y + self.bias.view(shape)
        return y.to(self.dtype or x.dtype)


class _TorchBatchNorm(SyncBatchNorm):
    """A converted torch BatchNorm: unless the call says otherwise, batch
    statistics in training mode and the running ones in eval mode, as
    torch's module chooses them."""

    def forward(self, x, use_running_average=None):
        if use_running_average is None and self.use_running_average is None:
            use_running_average = not self.training
        return super().forward(x, use_running_average)


@torch.no_grad()
def convert_syncbn_model(module: nn.Module, process_group=None) -> nn.Module:
    """Module surgery (ref: apex.parallel.convert_syncbn_model,
    parallel/__init__.py:21): every ``torch.nn`` BatchNorm under ``module``
    becomes a :class:`SyncBatchNorm` over ``process_group`` (None:
    ``parallel_state``'s data-parallel group) with its hyperparameters,
    affine parameters and running statistics (torch's momentum is
    already this module's convention), choosing batch or running
    statistics by the training flag as torch's does; every
    ``SyncBatchNorm`` is
    re-pointed at the group. Returns the converted module (a new one
    when ``module`` itself is a BatchNorm)."""
    if process_group is None:
        process_group = ps.get_data_parallel_group()
    if isinstance(module, SyncBatchNorm):
        module.process_group = process_group
        return module
    if isinstance(module, nn.modules.batchnorm._BatchNorm):
        if module.momentum is None:
            raise NotImplementedError(
                "convert_syncbn_model: a cumulative moving average "
                "(momentum=None) has no SyncBatchNorm counterpart")
        ref = module.weight if module.weight is not None else \
            module.running_mean
        out = _TorchBatchNorm(
            module.num_features,
            use_running_average=None if module.track_running_stats
            else False,
            momentum=module.momentum, epsilon=module.eps,
            use_scale=module.affine, use_bias=module.affine,
            process_group=process_group,
            device=None if ref is None else ref.device)
        if module.affine:
            out.scale.copy_(module.weight)
            out.bias.copy_(module.bias)
        if module.running_mean is not None:
            out.mean.copy_(module.running_mean)
            out.var.copy_(module.running_var)
        out.train(module.training)
        return out
    for name, child in module.named_children():
        new = convert_syncbn_model(child, process_group)
        if new is not child:
            setattr(module, name, new)
    return module
