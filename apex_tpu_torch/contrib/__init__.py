"""Apex's contrib zoo (counterpart of apex_tpu/contrib; ref:
apex/contrib).

Each module ports its JAX counterpart at the same path. No module here
adds a kernel: the fused multi-head attention runs the flash kernels
(#5-#7) and, with ``include_norm_add``, the LayerNorm kernels (#1, #2)
on CUDA tensors; the rest (group norm, the transducer, focal loss, ASP,
the bottleneck's convolutions and halo exchange) is plain torch, as the
JAX package leaves it to XLA. Images are NCHW (best in
``torch.channels_last`` memory), the port's convention; dropout draws
from a ``torch.Generator`` the caller hands in.
"""

from apex_tpu_torch.contrib import sparsity
from apex_tpu_torch.contrib.bottleneck import (
    Bottleneck,
    SpatialBottleneck,
    halo_exchange_1d,
)
from apex_tpu_torch.contrib.conv_bias_relu import (
    conv_bias,
    conv_bias_mask_relu,
    conv_bias_relu,
    conv_frozen_scale_bias_relu,
)
from apex_tpu_torch.contrib.focal_loss import focal_loss
from apex_tpu_torch.contrib.group_norm import GroupNorm, group_norm
from apex_tpu_torch.contrib.groupbn import GroupBatchNorm2d
from apex_tpu_torch.contrib.index_mul_2d import index_mul_2d
from apex_tpu_torch.contrib.multihead_attn import (
    EncdecMultiheadAttn,
    SelfMultiheadAttn,
)
from apex_tpu_torch.contrib.transducer import (
    TransducerJoint,
    TransducerLoss,
    transducer_joint,
    transducer_loss,
)
from apex_tpu_torch.contrib.xentropy import SoftmaxCrossEntropyLoss

__all__ = [
    "conv_bias",
    "conv_bias_mask_relu",
    "conv_bias_relu",
    "conv_frozen_scale_bias_relu",
    "GroupBatchNorm2d",
    "Bottleneck",
    "SpatialBottleneck",
    "halo_exchange_1d",
    "EncdecMultiheadAttn",
    "SelfMultiheadAttn",
    "sparsity",
    "focal_loss",
    "GroupNorm",
    "group_norm",
    "index_mul_2d",
    "TransducerJoint",
    "TransducerLoss",
    "transducer_joint",
    "transducer_loss",
    "SoftmaxCrossEntropyLoss",
]
