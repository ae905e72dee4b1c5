"""The contrib API of the softmax cross-entropy (counterpart of
apex_tpu/contrib/xentropy.py; ref: apex.contrib.xentropy.
SoftmaxCrossEntropyLoss).

The math is the port's ``ops.xentropy`` (fp32, plain torch: the JAX
package leaves it to XLA, with no Pallas kernel); this class keeps the
reference's autograd-Function call signature and zeroes the loss where
the label is ``padding_idx``."""

import torch

from apex_tpu_torch.ops.xentropy import softmax_cross_entropy_loss

__all__ = ["SoftmaxCrossEntropyLoss"]


class SoftmaxCrossEntropyLoss:
    @staticmethod
    def apply(logits, labels, smoothing=0.0, padding_idx=0,
              half_to_float=False):
        losses = softmax_cross_entropy_loss(
            logits, labels, smoothing=smoothing, half_to_float=half_to_float)
        return torch.where(labels == padding_idx, 0.0, losses)
