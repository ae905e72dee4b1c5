"""``apex.transformer.amp`` import surface (counterpart of
apex_tpu/transformer/amp.py): the ``GradScaler`` whose overflow flag is
summed over the model-parallel groups."""

from apex_tpu_torch.amp.grad_scaler import GradScaler

__all__ = ["GradScaler"]
