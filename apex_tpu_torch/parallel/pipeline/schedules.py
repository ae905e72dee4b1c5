"""Gradient accumulation without a pipeline (counterpart of
``forward_backward_no_pipelining`` in
apex_tpu/parallel/pipeline/schedules.py).

The pipelined schedules come with pipeline parallelism.
"""

from typing import Any, Callable, Dict, Optional, Tuple

import torch

__all__ = ["forward_backward_no_pipelining"]

Tensors = Dict[str, torch.Tensor]


def _micro(tree: Any, i: int) -> Any:
    """Micro-batch ``i`` of a tensor collection stacked on dim 0."""
    if isinstance(tree, torch.Tensor):
        return tree[i]
    if isinstance(tree, dict):
        return {k: _micro(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_micro(v, i) for v in tree)
    raise TypeError(f"not a tensor collection: {type(tree).__name__}")


def _leading_dim(tree: Any) -> int:
    while not isinstance(tree, torch.Tensor):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree.shape[0]


def forward_backward_no_pipelining(
        forward_step_fn: Callable[[Tensors, Any], torch.Tensor],
        params: Tensors, microbatches: Any, *,
        grad_sync_fn: Optional[Callable[[Tensors], Tensors]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Tensors]:
    """``forward_step_fn(params, microbatch)`` gives a scalar loss that
    depends on ``params`` (name: tensor requiring grad, e.g.
    ``dict(model.named_parameters())``); ``microbatches`` is a tensor
    collection whose leaves stack the micro-batches on dim 0. The
    gradients are summed over the micro-batches in the parameters' dtype
    (a parameter the loss does not reach gets zeros), divided by their
    number and handed once to ``grad_sync_fn`` (the reference's no_sync on
    all but the last). Returns ``(mean_loss, losses, grads)``; the losses
    are detached.

    The first micro-batch's gradients are the running sum, and the sums
    and the division are multi-tensor operations (``torch._foreach_*``): a
    few launches a step, not one per tensor."""
    num_micro = _leading_dim(microbatches)
    names = list(params)
    acc, losses = None, []
    for i in range(num_micro):
        loss = forward_step_fn(params, _micro(microbatches, i))
        grads = torch.autograd.grad(loss, [params[n] for n in names],
                                    allow_unused=True)
        grads = [torch.zeros_like(params[n]) if g is None else g
                 for n, g in zip(names, grads)]
        acc = grads if acc is None else torch._foreach_add(acc, grads)
        losses.append(loss.detach())
    if num_micro > 1:
        acc = torch._foreach_div(acc, num_micro)
    grads = dict(zip(names, acc))
    if grad_sync_fn is not None:
        grads = grad_sync_fn(grads)
    losses = torch.stack(losses)
    return losses.mean(), losses, grads
