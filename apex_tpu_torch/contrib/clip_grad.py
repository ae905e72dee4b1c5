"""``apex.contrib.clip_grad`` import surface (counterpart of
apex_tpu/contrib/clip_grad.py): ``clip_grad_norm_`` is the port's
``optimizers.clip_grad.clip_grad_norm``. As in JAX it is functional:
it RETURNS ``(clipped_tree, total_norm)`` instead of mutating ``.grad``
in place; the underscore name is kept for import parity."""

from apex_tpu_torch.optimizers.clip_grad import clip_grad_norm

clip_grad_norm_ = clip_grad_norm

__all__ = ["clip_grad_norm_", "clip_grad_norm"]
