"""Model-parallel-aware grad scaler (counterpart of
apex_tpu/amp/grad_scaler.py).

The overflow flag of one rank's gradients is summed over the process
groups of ``model_parallel_axes`` (``parallel_state``), so that every rank
of them skips or steps together: ``("tp", "pp")`` by default, and with
``"dp"`` under ZeRO, where each data-parallel rank unscales its own
partial gradients (``resilience/replay/targets.py``). Without a process
group the flag is the rank's own.
"""

from typing import Sequence

import torch

from apex_tpu_torch.amp.scaler import LossScaler, LossScalerState
from apex_tpu_torch.parallel import parallel_state as ps

__all__ = ["GradScaler"]


class GradScaler(LossScaler):
    """LossScaler whose found_inf is summed over the model-parallel
    axes."""

    def __init__(self, *args,
                 model_parallel_axes: Sequence[str] = ("tp", "pp"), **kw):
        super().__init__(*args, **kw)
        self.model_parallel_axes = tuple(model_parallel_axes)

    def sync_found_inf(self, found_inf) -> torch.Tensor:
        f = torch.as_tensor(found_inf).float()
        for axis in self.model_parallel_axes:
            f = ps.all_reduce(f, ps.get_group(axis))
        return f > 0

    def unscale(self, state: LossScalerState, grads):
        grads, found_inf = super().unscale(state, grads)
        return grads, self.sync_found_inf(found_inf)
