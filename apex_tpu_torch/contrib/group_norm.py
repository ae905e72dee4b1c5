"""GroupNorm with a fused Swish/SiLU epilogue (counterpart of
apex_tpu/contrib/group_norm.py; ref: apex.contrib.group_norm.GroupNorm,
the NHWC GroupNorm + Swish of diffusion UNets).

Layout: the port's image convention (``models/resnet.py``), which is the
reference's and torch's: channels at dim 1, ``(N, C, *spatial)``, best
in ``torch.channels_last`` memory. The JAX function takes ``(..., C)``
and reshapes to ``(N, -1, G, C/G)``; here the channel axis is moved last
first (``x.movedim(1, -1)``, a view of a channels-last tensor), so the
groups run over the *logical* channel axis and the same reshape applies.
The statistics are fp32 whatever the input's dtype, the output is cast
back to it, and the math is plain torch (the JAX package leaves it to
XLA, with no Pallas kernel).
"""

import torch
from torch import nn

from apex_tpu_torch._kernels import resolve_device

__all__ = ["GroupNorm", "group_norm"]


def group_norm(x, num_groups: int, weight=None, bias=None,
               eps: float = 1e-5, act: str = ""):
    """Functional group norm; ``x``: (N, C, *spatial) with C divisible by
    ``num_groups``. ``act``: "" or "swish"/"silu" (the reference's fused
    epilogue set)."""
    c = x.shape[1]
    if c % num_groups != 0:
        raise ValueError(f"channels ({c}) not divisible by groups "
                         f"({num_groups})")
    if act not in ("", "swish", "silu"):
        raise ValueError(f"unsupported act {act!r} (reference supports "
                         "swish)")
    xf = x.movedim(1, -1).float()  # (N, *spatial, C)
    shape = xf.shape
    grouped = xf.reshape(shape[0], -1, num_groups, c // num_groups)
    mean = grouped.mean(dim=(1, 3), keepdim=True)
    var = (grouped - mean).square().mean(dim=(1, 3), keepdim=True)
    y = ((grouped - mean) * torch.rsqrt(var + eps)).reshape(shape)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    if act:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype).movedim(-1, 1)


class GroupNorm(nn.Module):
    """Module form (ref: group_norm.py:127's num_groups, num_channels,
    eps, affine, act); parameters ``scale`` (ones) and ``bias`` (zeros),
    the flax names, in ``params_dtype``."""

    def __init__(self, num_groups: int, num_channels: int,
                 eps: float = 1e-5, affine: bool = True, act: str = "",
                 params_dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        self.num_groups, self.num_channels = num_groups, num_channels
        self.eps, self.act = eps, act
        dev = resolve_device(device)
        self.scale = self.bias = None
        if affine:
            self.scale = nn.Parameter(torch.ones(
                num_channels, dtype=params_dtype, device=dev))
            self.bias = nn.Parameter(torch.zeros(
                num_channels, dtype=params_dtype, device=dev))

    def forward(self, x):
        if x.shape[1] != self.num_channels:
            raise ValueError(f"expected {self.num_channels} channels, got "
                             f"{x.shape[1]}")
        return group_norm(x, self.num_groups, self.scale, self.bias,
                          eps=self.eps, act=self.act)
