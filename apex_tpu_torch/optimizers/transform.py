"""The optax shape of an optimizer in the port: ``init(params)`` and
``update(grads, state, params) -> (updates, state)`` over dicts of named
tensors, :func:`chain` of several (optax's ``chain``), and the Adam-family
bias corrections."""

from typing import Any, Callable, NamedTuple, Tuple

import torch

__all__ = ["Transform", "bias_corrections", "chain"]


class Transform(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Tuple[Any, Any]]


def chain(*transforms) -> Transform:
    """Each transform's updates feed the next as its grads; the state is
    the tuple of their states."""

    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params=None):
        new = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params)
            new.append(s)
        return grads, tuple(new)

    return Transform(init, update)


def bias_corrections(step: torch.Tensor, betas: Tuple[float, float],
                     bias_correction: bool = True):
    """``(1 - beta1**step, 1 - beta2**step)`` in fp32 on the 0-d step
    tensor's device (no host sync), or ones."""
    stepf = step.to(torch.float32)
    if bias_correction:
        return 1.0 - betas[0] ** stepf, 1.0 - betas[1] ** stepf
    one = torch.ones((), dtype=torch.float32, device=step.device)
    return one, one
