"""Sigmoid focal loss of a detection head (counterpart of
apex_tpu/contrib/focal_loss.py; ref: apex.contrib.focal_loss.focal_loss
over focal_loss_cuda).

- ``cls_output``: (N, K_pad) per-anchor class logits; classes at or past
  ``num_real_classes`` (padding) contribute nothing;
- ``cls_targets``: (N,) int, the class of a positive anchor, ``-1`` for a
  negative anchor (every class a negative), ``-2`` for an ignored anchor
  (contributes nothing);
- label smoothing is binary: each (anchor, class) cell is its own
  two-class problem, so the positive target is ``1 - s/2`` and the
  negative one ``s/2`` (the CUDA kernel's K = 2);
- the scalar loss is the sum over every cell divided by
  ``num_positives_sum``.

fp32 throughout, plain torch (the JAX package leaves it to XLA, with no
Pallas kernel); autograd gives the gradient."""

import torch

__all__ = ["focal_loss"]


def focal_loss(cls_output, cls_targets, num_positives_sum,
               num_real_classes: int, alpha: float, gamma: float,
               label_smoothing: float = 0.0):
    """Scalar focal loss over anchor logits; see the module docstring."""
    logits = cls_output.float()
    _, k_pad = logits.shape
    y = cls_targets.long()
    classes = torch.arange(k_pad, device=logits.device)
    is_pos = (y[:, None] >= 0) & (classes[None, :] == y[:, None])
    valid = (y[:, None] != -2) & (classes[None, :] < num_real_classes)
    if label_smoothing > 0.0:
        t_pos, t_neg = 1.0 - label_smoothing / 2.0, label_smoothing / 2.0
    else:
        t_pos, t_neg = 1.0, 0.0
    t = torch.where(is_pos, t_pos, t_neg)
    sigma = torch.sigmoid(logits)
    # stable soft-target BCE: max(p, 0) - p * t + log(1 + exp(-|p|))
    bce = (torch.clamp_min(logits, 0.0) - logits * t
           + torch.log1p(torch.exp(-logits.abs())))
    weight = torch.where(is_pos, alpha * torch.pow(1.0 - sigma, gamma),
                         (1.0 - alpha) * torch.pow(sigma, gamma))
    cells = torch.where(valid, weight * bce, 0.0)
    npos = torch.as_tensor(num_positives_sum, dtype=torch.float32,
                           device=logits.device).reshape(())
    return cells.sum() / npos
