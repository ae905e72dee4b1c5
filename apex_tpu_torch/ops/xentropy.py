"""Softmax cross-entropy with label smoothing (counterpart of
apex_tpu/ops/xentropy.py).

Plain PyTorch: the JAX package leaves this to XLA, which fuses it; no
Pallas kernel stands behind it. The loss is fp32 whatever the logits'
dtype (the reference's ``half_to_float=True``), and autograd gives the
usual ``softmax - onehot`` backward.
"""

import torch

__all__ = ["softmax_cross_entropy_loss"]


def softmax_cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                               smoothing: float = 0.0,
                               half_to_float: bool = False) -> torch.Tensor:
    """Per-example loss shaped like ``labels`` (``logits``: (..., vocab);
    ``labels``: (...) int), in fp32. Uniform label smoothing ``s`` gives
    ``(1 - s) * nll + s * (lse - mean(logits))``. ``half_to_float`` is
    accepted for parity: the loss is always fp32."""
    del half_to_float
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    nll = lse - lf.gather(-1, labels.long()[..., None])[..., 0]
    if smoothing > 0.0:
        nll = (1.0 - smoothing) * nll + smoothing * (lse - lf.mean(dim=-1))
    return nll
