"""Model-parallel-aware grad scaler (counterpart of
apex_tpu/amp/grad_scaler.py) at model-parallel size 1.

The JAX GradScaler sums the overflow flag over the model-parallel mesh
axes so that every rank skips or steps together. The port runs on one
device with no process group, so the sync is the identity; the axes are
accepted and kept, as in JAX, for the multi-GPU slice.
"""

from typing import Sequence

import torch

from apex_tpu_torch.amp.scaler import LossScaler, LossScalerState

__all__ = ["GradScaler"]


class GradScaler(LossScaler):
    """LossScaler whose found_inf would be synced over model-parallel
    axes; at size 1 there is nothing to sync."""

    def __init__(self, *args,
                 model_parallel_axes: Sequence[str] = ("tp", "pp"), **kw):
        super().__init__(*args, **kw)
        self.model_parallel_axes = tuple(model_parallel_axes)

    def sync_found_inf(self, found_inf) -> torch.Tensor:
        return torch.as_tensor(found_inf).bool()

    def unscale(self, state: LossScalerState, grads):
        grads, found_inf = super().unscale(state, grads)
        return grads, self.sync_found_inf(found_inf)
