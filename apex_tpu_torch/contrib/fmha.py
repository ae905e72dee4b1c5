"""``apex.contrib.fmha`` import surface (counterpart of
apex_tpu/contrib/fmha.py; the reference is the seq <= 512 MLPerf-BERT
fused MHA over packed variable-length QKV).

``fmha`` is the port's ``ops.attention.flash_attention``: on CUDA
tensors the hand-written flash kernels (forward #5, backward #6 and #7),
with no sequence cap, and variable lengths through ``key_padding_mask``
instead of the packed ``cu_seqlens`` layout."""

from apex_tpu_torch.ops.attention import flash_attention
from apex_tpu_torch.ops.attention import flash_attention as fmha

__all__ = ["fmha", "flash_attention"]
