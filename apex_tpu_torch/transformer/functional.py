"""``apex.transformer.functional`` import surface (counterpart of
apex_tpu/transformer/functional.py): ``FusedScaleMaskSoftmax`` and the
two rotary-embedding functions, from ``ops.softmax`` and ``ops.rope``."""

from apex_tpu_torch.ops.rope import (
    apply_rotary_pos_emb as fused_apply_rotary_pos_emb,
)
from apex_tpu_torch.ops.rope import (
    apply_rotary_pos_emb_cached as fused_apply_rotary_pos_emb_cached,
)
from apex_tpu_torch.ops.softmax import FusedScaleMaskSoftmax

__all__ = ["FusedScaleMaskSoftmax", "fused_apply_rotary_pos_emb",
           "fused_apply_rotary_pos_emb_cached"]
