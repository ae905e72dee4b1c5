"""``apex.contrib.layer_norm`` import surface (counterpart of
apex_tpu/contrib/layer_norm.py): ``FastLayerNorm`` is the port's
``normalization.FusedLayerNorm``, which runs the hand-written LayerNorm
kernels (#1, #2) on CUDA tensors at any hidden size."""

from apex_tpu_torch.normalization import FusedLayerNorm as FastLayerNorm

__all__ = ["FastLayerNorm"]
