"""Convolution + bias (+ mask) (+ ReLU) (counterpart of
apex_tpu/contrib/conv_bias_relu.py; ref: apex.contrib.conv_bias_relu's
ConvBiasReLU_, ConvBias_, ConvBiasMaskReLU_ and ConvFrozenScaleBiasReLU_,
cudnn-frontend fusion graphs).

Layout: the port's image convention, NCHW tensors (best in
``torch.channels_last`` memory) and OIHW weights; the JAX package's are
NHWC and HWIO (``models.convert`` moves them). The convolution is
``F.conv2d``, as the JAX package's is ``lax.conv_general_dilated``,
outside any Pallas kernel. It runs on fp32 copies of the input and the
weight (cast to the input's dtype first): the products of bf16 values
are exact in fp32 and the sums are fp32, which is JAX's
``preferred_element_type=float32``. The epilogue is fp32 too, and the
result is cast back to the input's dtype; autograd gives the backward.
"""

import torch
import torch.nn.functional as F

__all__ = ["conv_bias", "conv_bias_mask_relu", "conv_bias_relu",
           "conv_frozen_scale_bias_relu"]


def _conv(x, weight, stride, padding):
    """fp32 (N, O, H', W') of the NCHW input and the OIHW weight."""
    return F.conv2d(x.float(), weight.to(x.dtype).float(), stride=stride,
                    padding=padding)


def conv_bias(x, weight, bias, padding: int = 0, stride: int = 1):
    """(ref: ConvBias_)"""
    y = _conv(x, weight, stride, padding) + bias.float()[:, None, None]
    return y.to(x.dtype)


def conv_bias_relu(x, weight, bias, padding: int = 0, stride: int = 1):
    """(ref: ConvBiasReLU_)"""
    y = _conv(x, weight, stride, padding) + bias.float()[:, None, None]
    return torch.relu(y).to(x.dtype)


def conv_bias_mask_relu(x, weight, bias, mask, padding: int = 0,
                        stride: int = 1):
    """(ref: ConvBiasMaskReLU_) ``mask`` multiplies the pre-activation."""
    y = _conv(x, weight, stride, padding) + bias.float()[:, None, None]
    return torch.relu(y * mask.float()).to(x.dtype)


def conv_frozen_scale_bias_relu(x, weight, scale, bias, padding: int = 0,
                                stride: int = 1):
    """(ref: ConvFrozenScaleBiasReLU_) ``relu(conv(x) * scale + bias)``, a
    folded frozen BatchNorm: ``scale`` and ``bias`` get no gradient."""
    scale = scale.detach().float()[:, None, None]
    bias = bias.detach().float()[:, None, None]
    return torch.relu(_conv(x, weight, stride, padding) * scale
                      + bias).to(x.dtype)
