"""Dense layers with an fp32 result (counterpart of
apex_tpu/ops/fused_dense.py; ref ``fused_dense_cuda``): ``y = x @ W^T +
b`` with the GEMM accumulated in fp32 (``ops.mlp.dense_f32``), the bias
added in fp32 and the output cast to x's dtype; and the GEMM + bias +
tanh-GeLU (fp32) + GEMM + bias chain. There is no Pallas site here."""

import torch
import torch.nn.functional as F

from apex_tpu_torch.ops.mlp import dense_f32

__all__ = ["fused_dense", "fused_dense_gelu_dense"]


def fused_dense(x, weight, bias=None):
    """``x @ weight.T + bias``; ``weight`` is (out, in)."""
    y = dense_f32(x, weight)
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def fused_dense_gelu_dense(x, weight1, bias1, weight2, bias2):
    """``GeLU(x @ W1^T + b1) @ W2^T + b2``, the GeLU's tanh form in
    fp32."""
    h = fused_dense(x, weight1, bias1)
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return fused_dense(h, weight2, bias2)
