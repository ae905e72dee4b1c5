"""Analytic model-FLOPs counters and MFU / throughput arithmetic
(counterpart of apex_tpu/monitor/flops.py).

MFU is ``(model FLOPs per second) / (hardware peak FLOPs per second)``
where the numerator counts only the FLOPs the MODEL requires (the
PaLM/Chinchilla convention): matmuls at 2*m*n*k, backward at 2x forward,
and nothing for recomputation. The counters are the JAX package's closed
forms over ``TransformerConfig``, copied as they are; the per-second
numerator must come from a timing that ends in a device synchronize.

The peak table holds the cards the port runs on: an H100 SXM ("NVIDIA
H100 80GB HBM3") at 989e12 dense bf16 FLOP/s and an H100 PCIe at 756e12,
NVIDIA's data-sheet figures at the full power limit. Any other device,
the CPU included, has no peak, so :func:`mfu` returns None rather than a
number against a guessed one. ``APEX_TPU_PEAK_FLOPS`` overrides.
"""

import os
from typing import Optional

__all__ = [
    "transformer_layer_flops_per_token",
    "gpt_flops_per_token",
    "bert_flops_per_token",
    "training_flops_per_step",
    "tokens_per_second",
    "mfu",
    "peak_flops_per_device",
]

#: dense bf16 peak per card: (substrings the device name must all hold,
#: FLOP/s), first match wins
_PEAK_FLOPS = (
    (("H100", "HBM3"), 989e12),  # SXM5: "NVIDIA H100 80GB HBM3"
    (("H100", "PCIe"), 756e12),  # "NVIDIA H100 PCIe"
)


def _peak_for_name(name: str) -> Optional[float]:
    for subs, peak in _PEAK_FLOPS:
        if all(s in name for s in subs):
            return peak
    return None


def peak_flops_per_device(device=None) -> Optional[float]:
    """Peak dense bf16 FLOP/s of one card, or None when unknown (any
    device outside the table, the CPU included).

    ``device`` is a ``torch.device``, a card index, or None for the
    current card. ``APEX_TPU_PEAK_FLOPS`` overrides (benchmarks pinning a
    number, tests, and cards missing from the table).
    """
    env = os.environ.get("APEX_TPU_PEAK_FLOPS")
    if env:
        return float(env)
    import torch

    if device is not None and not isinstance(device, int):
        device = torch.device(device)
        if device.type != "cuda":
            return None
    if not torch.cuda.is_available():
        return None
    return _peak_for_name(torch.cuda.get_device_name(device))


def _cfg_dims(cfg):
    h = cfg.hidden_size
    heads = cfg.num_attention_heads
    kv_heads = cfg.num_query_groups or heads
    head_dim = cfg.kv_channels or h // heads
    ffn = cfg.ffn_hidden_size or 4 * h
    return h, heads, kv_heads, head_dim, ffn


def transformer_layer_flops_per_token(cfg, seq_len: int) -> float:
    """Forward matmul FLOPs per token for ONE ParallelTransformerLayer.

    Counts (2*m*n*k per matmul, per token):

    - QKV projection: ``2*h*(q + 2*kv)`` where q = heads*head_dim and
      kv = kv_heads*head_dim (GQA shrinks the K/V columns);
    - attention scores + context: ``2*s*q`` each — every query token
      multiplies against s keys and weights s values (causal masking
      halves the REACHABLE area, but the dense kernels here compute the
      full s x s product, and MFU counts the math the model runs);
    - output projection: ``2*q*h``;
    - dense MLP: ``2*h*ffn + 2*ffn*h``, plus ``2*h*ffn`` more for the
      extra gate matmul of geglu/swiglu;
    - MoE MLP (``cfg.num_moe_experts`` set — the MLP block is MoEMLP):
      router ``2*h*E`` plus ``moe_top_k`` expert-FFN passes of
      ``2*h*ffn + 2*ffn*h`` each (MoEMLP experts are ungated two-matmul
      FFNs). Each token mathematically runs top_k experts, so a top-2
      MoE spends ~2x the dense MLP FLOPs — the dense formula both
      under-counts top-2 and ignores the router, which is exactly how
      MoE MFU went wrong before. Capacity-dropped tokens still count
      (the convention counts the model's assignment math; drops are a
      lossy implementation detail, and counting them would make MFU
      improve when the router overflows).

    Element-wise work (norms, softmax, residuals, gating combines) is
    O(h) per token and omitted, per the standard model-FLOPs convention.
    """
    h, heads, kv_heads, head_dim, ffn = _cfg_dims(cfg)
    q = heads * head_dim
    kv = kv_heads * head_dim
    qkv_proj = 2 * h * (q + 2 * kv)
    attn = 2 * seq_len * q + 2 * seq_len * q
    out_proj = 2 * q * h
    num_experts = getattr(cfg, "num_moe_experts", None)
    if num_experts:
        top_k = getattr(cfg, "moe_top_k", 1) or 1
        router = 2 * h * num_experts
        mlp = router + top_k * (2 * h * ffn + 2 * ffn * h)
    else:
        n_mats = 3 if cfg.activation in ("geglu", "swiglu") else 2
        mlp = n_mats * 2 * h * ffn
    return float(qkv_proj + attn + out_proj + mlp)


def gpt_flops_per_token(cfg, seq_len: Optional[int] = None) -> float:
    """Forward FLOPs per token of the GPT testing model: the layer stack
    plus the tied-embedding logit matmul ``2*h*vocab``. Embedding lookups
    are gathers (0 matmul FLOPs)."""
    s = seq_len if seq_len is not None else cfg.max_position_embeddings
    layers = cfg.num_layers * transformer_layer_flops_per_token(cfg, s)
    head = 2 * cfg.hidden_size * cfg.vocab_size
    return float(layers + head)


def bert_flops_per_token(cfg, seq_len: Optional[int] = None) -> float:
    """Forward FLOPs per token of the BERT testing model: layer stack +
    LM head (dense h->h + vocab projection) — the binary head is O(h)
    per SEQUENCE and ignored."""
    s = seq_len if seq_len is not None else cfg.max_position_embeddings
    h = cfg.hidden_size
    layers = cfg.num_layers * transformer_layer_flops_per_token(cfg, s)
    lm_head = 2 * h * h + 2 * h * cfg.vocab_size
    return float(layers + lm_head)


def training_flops_per_step(
    flops_per_token_fwd: float, tokens_per_step: int
) -> float:
    """Model FLOPs of one optimizer step: forward + backward = 3x forward
    (backward costs ~2x: one matmul each for input and weight grads)."""
    return 3.0 * flops_per_token_fwd * tokens_per_step


def tokens_per_second(tokens_per_step: int, seconds_per_step: float) -> float:
    if seconds_per_step <= 0:
        raise ValueError(f"seconds_per_step must be > 0, got {seconds_per_step}")
    return tokens_per_step / seconds_per_step


def mfu(
    flops_per_step: float,
    seconds_per_step: float,
    num_devices: int,
    peak_flops: Optional[float] = None,
) -> Optional[float]:
    """Model-FLOPs utilization in [0, 1]-ish, or None when the peak is
    unknown (see :func:`peak_flops_per_device`). > 1 means the timing or
    the peak table is wrong — callers should surface it, not clamp it."""
    if peak_flops is None:
        peak_flops = peak_flops_per_device()
    if peak_flops is None or seconds_per_step <= 0:
        return None
    return flops_per_step / (seconds_per_step * num_devices * peak_flops)
