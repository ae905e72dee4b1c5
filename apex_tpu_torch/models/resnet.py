"""ResNet for ImageNet (counterpart of apex_tpu/models/resnet.py).

The model takes NHWC images, as the JAX module does, and runs them as a
channels-last NCHW tensor (``x.permute(0, 3, 1, 2)`` keeps the memory),
which is the layout of cuDNN's fastest convolutions on the card. The
convolutions and the head are ``F.conv2d`` and ``torch.matmul``: the JAX
package leaves them to XLA, outside any Pallas kernel.

Parameters are fp32 and each forward casts them to the compute dtype
(amp O2 as the JAX module does it: bf16 compute, fp32 master weights;
BatchNorm statistics are fp32 whatever the dtype). The submodules carry
flax's scope names (``conv_init``, ``bn_init``, ``BottleneckBlock_<i>``
with ``Conv_<j>`` and ``SyncBatchNorm_<k>``, ``conv_proj``, ``norm_proj``,
``head``), so ``models.convert.resnet_params_from_jax`` is a walk over the
JAX trees; a convolution's ``weight`` is flax's HWIO kernel as OIHW, the
head's is its (in, out) kernel transposed.
"""

import math
from functools import partial
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch._kernels import resolve_device
from apex_tpu_torch.ops.xentropy import softmax_cross_entropy_loss
from apex_tpu_torch.parallel.sync_batch_norm import SyncBatchNorm

__all__ = ["BasicBlock", "BottleneckBlock", "Conv", "ResNet", "ResNet18",
           "ResNet34", "ResNet50", "ResNet101", "ResNet152",
           "cross_entropy_loss", "lecun_normal", "same_padding"]


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """flax's ``'SAME'`` padding of one spatial dim: ``total = max((ceil(
    size / stride) - 1) * stride + kernel - size, 0)`` as ``(total // 2,
    total - total // 2)``. At stride 2 on an even size it is asymmetric
    ((0, 1) for a 3x3 kernel), which no symmetric ``padding=`` gives."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def lecun_normal(shape, fan_in: int, gen: torch.Generator) -> torch.Tensor:
    """flax's default kernel init: a normal of variance 1 / fan_in
    truncated at two standard deviations (and rescaled for it)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    t = torch.empty(shape)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t * std


class Conv(nn.Module):
    """flax ``nn.Conv`` without bias: ``weight`` (out, in, kh, kw) fp32,
    cast to ``dtype`` per call; ``padding`` is ``"SAME"`` or a pair of
    (low, high) pads per spatial dim."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Tuple[int, int],
                 strides: Tuple[int, int] = (1, 1), padding="SAME",
                 dtype: torch.dtype = torch.float32, device=None,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        kh, kw = kernel_size
        self.strides, self.padding, self.dtype = tuple(strides), padding, dtype
        w = lecun_normal((features, in_features, kh, kw),
                          in_features * kh * kw, gen).to(device)
        if w.is_cuda:
            w = w.contiguous(memory_format=torch.channels_last)
        self.weight = nn.Parameter(w)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kernel = self.weight.shape[2:]
        if self.padding == "SAME":
            pads = [same_padding(n, k, s)
                    for n, k, s in zip(x.shape[2:], kernel, self.strides)]
        else:
            pads = [tuple(p) for p in self.padding]
        w = self.weight.to(self.dtype)
        if all(lo == hi for lo, hi in pads):
            return F.conv2d(x, w, stride=self.strides,
                            padding=tuple(lo for lo, _ in pads))
        (top, bottom), (left, right) = pads
        return F.conv2d(F.pad(x, (left, right, top, bottom)), w,
                        stride=self.strides)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck with a projection shortcut where the
    shape changes; the last BatchNorm's scale starts at zero."""

    expansion = 4

    def __init__(self, in_features: int, features: int,
                 strides: Tuple[int, int], conv, norm):
        super().__init__()
        out = features * self.expansion
        self.Conv_0 = conv(in_features, features, (1, 1))
        self.SyncBatchNorm_0 = norm(features)
        self.Conv_1 = conv(features, features, (3, 3), strides)
        self.SyncBatchNorm_1 = norm(features)
        self.Conv_2 = conv(features, out, (1, 1))
        self.SyncBatchNorm_2 = norm(out, scale_init=0.0)
        self.conv_proj = self.norm_proj = None
        # flax projects where residual.shape != y.shape: in ResNet every
        # strided block also changes the width, so that is this test
        if in_features != out or tuple(strides) != (1, 1):
            self.conv_proj = conv(in_features, out, (1, 1), strides)
            self.norm_proj = norm(out)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        ra = not train
        y = F.relu(self.SyncBatchNorm_0(self.Conv_0(x), ra))
        y = F.relu(self.SyncBatchNorm_1(self.Conv_1(y), ra))
        y = self.SyncBatchNorm_2(self.Conv_2(y), ra)
        if self.conv_proj is not None:
            x = self.norm_proj(self.conv_proj(x), ra)
        return F.relu(x + y)


class BasicBlock(nn.Module):
    """3x3 -> 3x3 residual block (ResNet-18/34)."""

    expansion = 1

    def __init__(self, in_features: int, features: int,
                 strides: Tuple[int, int], conv, norm):
        super().__init__()
        self.Conv_0 = conv(in_features, features, (3, 3), strides)
        self.SyncBatchNorm_0 = norm(features)
        self.Conv_1 = conv(features, features, (3, 3))
        self.SyncBatchNorm_1 = norm(features, scale_init=0.0)
        self.conv_proj = self.norm_proj = None
        if in_features != features or tuple(strides) != (1, 1):
            self.conv_proj = conv(in_features, features, (1, 1), strides)
            self.norm_proj = norm(features)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        ra = not train
        y = F.relu(self.SyncBatchNorm_0(self.Conv_0(x), ra))
        y = self.SyncBatchNorm_1(self.Conv_1(y), ra)
        if self.conv_proj is not None:
            x = self.norm_proj(self.conv_proj(x), ra)
        return F.relu(x + y)


class ResNet(nn.Module):
    """ResNet over NHWC images, fp32 logits. ``dtype`` is the compute
    dtype (bf16 for amp O2); parameters are fp32, made from ``seed``."""

    def __init__(self, stage_sizes: Sequence[int], block_cls=BottleneckBlock,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype: torch.dtype = torch.float32, bn_momentum: float = 0.1,
                 bn_epsilon: float = 1e-5, device="cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.dtype = dtype

        def conv(cin, cout, kernel, strides=(1, 1), padding="SAME"):
            return Conv(cin, cout, kernel, strides, padding, dtype, dev, gen)

        def norm(features, scale_init=1.0):
            return SyncBatchNorm(features, momentum=bn_momentum,
                                 epsilon=bn_epsilon, dtype=dtype,
                                 scale_init=scale_init, device=dev)

        self.conv_init = conv(3, num_filters, (7, 7), (2, 2),
                              ((3, 3), (3, 3)))
        self.bn_init = norm(num_filters)
        self.block_names = []
        width = num_filters
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                name = f"{block_cls.__name__}_{len(self.block_names)}"
                block = block_cls(width, num_filters * 2 ** i,
                                  (2, 2) if i > 0 and j == 0 else (1, 1),
                                  conv, norm)
                self.add_module(name, block)
                self.block_names.append(name)
                width = num_filters * 2 ** i * block_cls.expansion
        self.head = nn.Linear(width, num_classes, device=dev)
        with torch.no_grad():
            self.head.weight.copy_(lecun_normal((width, num_classes), width,
                                                 gen).t())
            self.head.bias.zero_()

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """``x``: (batch, height, width, 3) images; returns fp32 logits.
        With ``train``, BatchNorm uses the batch's statistics and updates
        its running ones."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # channels-last NCHW
        x = F.relu(self.bn_init(self.conv_init(x), not train))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for name in self.block_names:
            x = getattr(self, name)(x, train)
        x = x.mean(dim=(2, 3))
        w, b = self.head.weight.to(self.dtype), self.head.bias.to(self.dtype)
        return (torch.matmul(x, w.t()) + b).float()


ResNet18 = partial(ResNet, [2, 2, 2, 2], BasicBlock)
ResNet34 = partial(ResNet, [3, 4, 6, 3], BasicBlock)
ResNet50 = partial(ResNet, [3, 4, 6, 3], BottleneckBlock)
ResNet101 = partial(ResNet, [3, 4, 23, 3], BottleneckBlock)
ResNet152 = partial(ResNet, [3, 8, 36, 3], BottleneckBlock)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean softmax cross-entropy over class logits."""
    return softmax_cross_entropy_loss(logits, labels, label_smoothing).mean()
