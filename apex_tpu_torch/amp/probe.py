"""A probe of O1's cast engine: a handful of listed, unlisted and fused
ops whose output dtypes show which casts ran. The CPU tests hold the
dtypes to the JAX engine's on the same probe, and ``chip_smoke.py``
holds the card's to the CPU's, so a CUDA-only branch of an op cannot
see casts that its plain version does not."""

from typing import Dict

import torch
import torch.nn.functional as F

from apex_tpu_torch.ops.attention import flash_attention
from apex_tpu_torch.ops.layer_norm import layer_norm, rms_norm
from apex_tpu_torch.ops.softmax import scaled_masked_softmax

__all__ = ["o1_probe"]


def o1_probe(x: torch.Tensor, w: torch.Tensor, ln_w: torch.Tensor
             ) -> Dict[str, torch.Tensor]:
    """x (rows, k) and w (k, n) fp32 with k >= n, ln_w (n,) fp32; rows
    and n multiples of 4. Every stage's output, by name."""
    out = {}
    h = torch.matmul(x, w)
    out["matmul"] = h
    out["linear"] = F.linear(x, w.t())
    out["operator_matmul"] = x @ w
    out["layer_norm"] = layer_norm(h, ln_w, torch.zeros_like(ln_w))
    out["rms_norm"] = rms_norm(h, ln_w)
    out["softmax"] = F.softmax(h, dim=-1)
    out["sum"] = torch.sum(h)
    out["exp"] = torch.exp(h)
    out["relu"] = torch.relu(h)
    out["add_0d_fp32"] = torch.add(h, torch.tensor(1.0))
    rows, n = h.shape
    out["cat_mixed"] = torch.cat([h, x[:, :n]])
    q = h.reshape(1, 1, rows, n)
    out["flash_attention"] = flash_attention(q, q, q, causal=True)
    out["scaled_masked_softmax"] = scaled_masked_softmax(q, None, 0.5)
    return out
