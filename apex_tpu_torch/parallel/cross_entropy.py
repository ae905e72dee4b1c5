"""Vocab-parallel cross entropy at tensor-parallel size 1 (counterpart of
apex_tpu/parallel/cross_entropy.py).

Per-token fp32 losses from logits over the whole vocabulary, as a
``torch.autograd.Function`` with the JAX package's hand-written
backward: d loss / d logit_j = softmax_j - (1 - ls) * onehot_j - ls / V.
Label smoothing is the JAX package's global-vocab formulation,
``(1 - ls) * ce + ls * (lse - mean_logit)``, not the reference's
K/(K-1) rescaling. The forward saves the fp32 softmax, as the JAX
forward does. The sharded (tp > 1) form comes with tensor parallelism.
"""

import torch

__all__ = ["vocab_parallel_cross_entropy"]


class _VocabParallelCE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, logits, target, label_smoothing):
        lf = logits.float()
        lse = torch.logsumexp(lf, dim=-1)
        tlogit = torch.gather(lf, -1, target[..., None]).squeeze(-1)
        loss = lse - tlogit
        if label_smoothing > 0.0:
            smooth = lse - lf.mean(dim=-1)
            loss = (1.0 - label_smoothing) * loss + label_smoothing * smooth
        ctx.save_for_backward(torch.exp(lf - lse[..., None]), target)
        ctx.label_smoothing = label_smoothing
        ctx.logits_dtype = logits.dtype
        return loss

    @staticmethod
    def backward(ctx, ct):
        softmax, target = ctx.saved_tensors
        ls = ctx.label_smoothing
        # softmax - (1 - ls) * onehot, written at the targets only
        g = softmax.scatter_add(
            -1, target[..., None],
            torch.full(target.shape + (1,), -(1.0 - ls), dtype=softmax.dtype,
                       device=softmax.device))
        if ls > 0.0:
            g = g - ls / softmax.shape[-1]
        return (g * ct[..., None].float()).to(ctx.logits_dtype), None, None


def vocab_parallel_cross_entropy(logits, target, label_smoothing: float = 0.0):
    """Per-token fp32 CE losses shaped like ``target`` from logits
    (..., vocab)."""
    return _VocabParallelCE.apply(logits, target.long(), float(label_smoothing))
