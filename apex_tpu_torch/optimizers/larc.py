"""LARC, layer-wise adaptive rate clipping or scaling (counterpart of
apex_tpu/optimizers/larc.py; ref apex.parallel.LARC): before the inner
step each gradient is scaled by ``local_lr / lr``, where ``local_lr =
trust_coefficient * ||p|| / (||g|| + weight_decay * ||p|| + eps)``,
capped at 1 in clip mode. A transform chained before the inner one, as
in JAX. Plain torch."""

import dataclasses
from typing import Dict

import torch

from apex_tpu_torch.optimizers.transform import Transform, chain

__all__ = ["LARC", "LARCState", "larc", "larc_scaling"]


@dataclasses.dataclass
class LARCState:
    pass


def larc_scaling(lr: float, trust_coefficient: float = 0.02,
                 clip: bool = True, eps: float = 1e-8,
                 weight_decay: float = 0.0) -> Transform:
    """The gradient-rescaling stage of LARC, as a transform."""

    def init(params):
        return LARCState()

    @torch.no_grad()
    def update(grads: Dict[str, torch.Tensor], state: LARCState,
               params=None):
        if params is None:
            raise ValueError("larc requires params")
        out = {}
        for n, g in grads.items():
            gf, pf = g.float(), params[n].float()
            p_norm = torch.sqrt((pf * pf).sum())
            g_norm = torch.sqrt((gf * gf).sum())
            local_lr = trust_coefficient * p_norm / (
                g_norm + weight_decay * p_norm + eps)
            ok = (p_norm > 0) & (g_norm > 0)
            factor = local_lr / lr
            if clip:
                factor = torch.clamp_max(factor, 1.0)
            factor = torch.where(ok, factor, torch.ones_like(factor))
            out[n] = (gf * factor).to(g.dtype)
        return out, state

    return Transform(init, update)


def larc(inner: Transform, lr: float, trust_coefficient: float = 0.02,
         clip: bool = True, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Transform:
    """LARC around ``inner``: rescale the gradients, then run it."""
    return chain(larc_scaling(lr, trust_coefficient, clip, eps,
                              weight_decay), inner)


class LARC:
    """``apex.parallel.LARC(optimizer, ...)``."""

    def __new__(cls, optimizer: Transform, lr: float = 1e-3,
                trust_coefficient: float = 0.02, clip: bool = True,
                eps: float = 1e-8, **_unused):
        return larc(optimizer, lr=lr, trust_coefficient=trust_coefficient,
                    clip=clip, eps=eps)
