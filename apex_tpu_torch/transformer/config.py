"""Transformer configuration (counterpart of apex_tpu/transformer/config.py).

The same frozen dataclass and field names as the JAX package, with torch
dtypes: parameters live in fp32 and compute runs in bf16 by default. Of
the mesh-axis names, ``context_axis`` is kept (the name of the group
that ring and Ulysses attention run over, ``parallel_state.get_group``);
the tp group is always ``"tp"``. The ``attention_impl`` switch has no
counterpart: the device of the tensors picks kernel or plain code
(``apex_tpu_torch._kernels``). ``moe_expert_axis`` names the group the
experts are split over (``parallel_state.get_group``); None keeps every
expert on every rank.
"""

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Architecture knobs for the Megatron-style stack."""

    num_layers: int
    hidden_size: int
    num_attention_heads: int
    vocab_size: int = 0
    max_position_embeddings: int = 0
    ffn_hidden_size: Optional[int] = None  # defaults to 4*hidden_size
    kv_channels: Optional[int] = None  # defaults to hidden_size // heads
    # GQA: number of KV heads (None = MHA); must divide num_attention_heads
    num_query_groups: Optional[int] = None
    # sliding-window attention (mistral-style); causal self-attention only
    attention_window: Optional[int] = None

    # dropout runs in training mode only (transformer/layer.py); attention
    # dropout takes the unfused CoreAttention path
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    layernorm_epsilon: float = 1e-5
    normalization: str = "layernorm"  # "layernorm" | "rmsnorm"
    add_bias_linear: bool = True
    activation: str = "gelu"  # "gelu" | "geglu" | "relu" | "swiglu"
    apply_residual_connection_post_layernorm: bool = False
    fp32_residual_connection: bool = False
    # cancels in the fp32 softmax: the flash path ignores it (as the JAX
    # flash path does), CoreAttention moves num_layers into its softmax scale
    apply_query_key_layer_scaling: bool = False

    position_embedding_type: str = "learned"  # "learned" | "rope" | "none"
    rotary_percent: float = 1.0
    rotary_base: float = 10000.0

    sequence_parallel: bool = False
    # "ring" | "ulysses": attention over the cp group at cp > 1
    context_parallel_mode: Optional[str] = None
    context_axis: str = "cp"
    # mixture of experts: num_moe_experts switches the MLP to
    # transformer.moe.MoEMLP; experts split over moe_expert_axis's group
    num_moe_experts: Optional[int] = None
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.25
    moe_expert_axis: Optional[str] = None
    moe_aux_loss_coeff: float = 0.01
    recompute_granularity: Optional[str] = None  # None | "full" | "selective"
    # each ParallelTransformerLayer keeps the fp32 RMS of its output as
    # ``layer_out_rms`` (JAX sows it under "intermediates")
    collect_layer_metrics: bool = False

    params_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16

    share_embeddings_and_output_weights: bool = True

    def __post_init__(self):
        if self.context_parallel_mode not in (None, "ring", "ulysses"):
            raise ValueError(
                f"context_parallel_mode must be None, 'ring', or 'ulysses'; "
                f"got {self.context_parallel_mode!r}"
            )
        if self.ffn_hidden_size is None:
            object.__setattr__(self, "ffn_hidden_size", 4 * self.hidden_size)
        if self.kv_channels is None:
            if self.hidden_size % self.num_attention_heads:
                raise ValueError(
                    f"hidden_size ({self.hidden_size}) is not a multiple of "
                    f"num_attention_heads ({self.num_attention_heads})")
            object.__setattr__(
                self, "kv_channels", self.hidden_size // self.num_attention_heads
            )
