"""``apex.contrib.openfold_triton`` import surface (counterpart of
apex_tpu/contrib/openfold_triton.py; the reference ships
AlphaFold-shape-specialised Triton kernels: a small-shape LayerNorm, a
small fused MHA and ``FusedAdamSWA``).

- ``FusedAdamSWA`` is the port's ``optimizers.fused_adam_swa``;
- ``LayerNormSmallShapeOptImpl`` is ``normalization.FusedLayerNorm``
  (kernels #1, #2) and ``AttnTri`` is ``ops.attention.flash_attention``
  (kernels #5-#7): the port's general kernels serve the small shapes too.
"""

from apex_tpu_torch.normalization import (
    FusedLayerNorm as LayerNormSmallShapeOptImpl,
)
from apex_tpu_torch.ops.attention import flash_attention as AttnTri
from apex_tpu_torch.optimizers.fused_adam_swa import FusedAdamSWA

__all__ = ["FusedAdamSWA", "LayerNormSmallShapeOptImpl", "AttnTri"]
