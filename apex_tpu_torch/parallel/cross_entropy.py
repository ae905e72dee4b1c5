"""Vocab-parallel cross entropy (counterpart of
apex_tpu/parallel/cross_entropy.py).

Per-token fp32 losses from logits sharded along the vocabulary over the
tensor-parallel group, as a ``torch.autograd.Function`` with the JAX
package's hand-written backward: d loss / d logit_j = softmax_j - (1 -
ls) * onehot_j - ls / V, shard-local, with no collective. At tp > 1 the
forward takes the max over tp (an all-reduce of max) and then the sums
over tp (the sum of exponentials, the target logit from the rank that
owns it, and the sum of the logits for label smoothing) in one
all-reduce. Label smoothing is the JAX package's global-vocab
formulation, ``(1 - ls) * ce + ls * (lse - mean_logit)``, not the
reference's K/(K-1) rescaling. The forward saves the fp32 softmax of this
rank's shard, as the JAX forward does.
"""

import torch

from apex_tpu_torch.parallel import parallel_state as ps

__all__ = ["vocab_parallel_cross_entropy"]


class _VocabParallelCE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, logits, target, label_smoothing, group):
        lf = logits.float()
        v_local = lf.shape[-1]
        tp = ps.group_size(group)
        if tp == 1:
            lse = torch.logsumexp(lf, dim=-1)
            local, in_range = target, None
            tlogit = torch.gather(lf, -1, target[..., None]).squeeze(-1)
            mean_logit = lf.mean(dim=-1) if label_smoothing > 0.0 else None
        else:
            start = torch.distributed.get_rank(group) * v_local
            local = target - start
            in_range = (local >= 0) & (local < v_local)
            local = local.clamp(0, v_local - 1)
            gmax = ps.all_reduce(lf.max(dim=-1).values, group, op="max")
            partial = torch.gather(lf, -1, local[..., None]).squeeze(-1)
            sums = ps.all_reduce(torch.stack([
                torch.exp(lf - gmax[..., None]).sum(dim=-1),
                torch.where(in_range, partial, torch.zeros_like(partial)),
                lf.sum(dim=-1)]), group)
            lse = torch.log(sums[0]) + gmax
            tlogit = sums[1]
            mean_logit = sums[2] / (v_local * tp)
        loss = lse - tlogit
        if label_smoothing > 0.0:
            smooth = lse - mean_logit
            loss = (1.0 - label_smoothing) * loss + label_smoothing * smooth
        ctx.save_for_backward(torch.exp(lf - lse[..., None]), local,
                              in_range)
        ctx.label_smoothing = label_smoothing
        ctx.vocab = v_local * tp
        ctx.logits_dtype = logits.dtype
        return loss

    @staticmethod
    def backward(ctx, ct):
        softmax, local, in_range = ctx.saved_tensors
        ls = ctx.label_smoothing
        # softmax - (1 - ls) * onehot, written at the targets this rank's
        # shard holds only
        hit = torch.full(local.shape + (1,), -(1.0 - ls), dtype=softmax.dtype,
                         device=softmax.device)
        if in_range is not None:
            hit = hit * in_range[..., None]
        g = softmax.scatter_add(-1, local[..., None], hit)
        if ls > 0.0:
            g = g - ls / ctx.vocab
        return (g * ct[..., None].float()).to(ctx.logits_dtype), None, None, \
            None


def vocab_parallel_cross_entropy(logits, target, label_smoothing: float = 0.0,
                                 group=None):
    """Per-token fp32 CE losses shaped like ``target`` from this rank's
    logits (..., vocab / tp) and the global target ids; ``group`` defaults
    to ``parallel_state``'s tensor-parallel group."""
    if group is None:
        group = ps.get_tensor_model_parallel_group()
    return _VocabParallelCE.apply(logits, target.long(),
                                  float(label_smoothing), group)
