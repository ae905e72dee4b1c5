"""Pre-LN transformer stack (counterpart of apex_tpu/transformer/layer.py).

Same modules, parameter names and layout as the JAX package: hidden
states are (seq, batch, hidden), the fused QKV projection is interleaved
per head as ``[q_h | k_h | v_h]`` (the JAX reshape to (s, b, heads,
3 * hn) and split), and module names match the flax ones, so a JAX
parameter tree maps onto ``state_dict`` keys by joining its path with
dots (models/convert.py).

Only tensor-, sequence- and context-parallel size 1: dropout (a nonzero
rate in training mode), ``CoreAttention``, MoE, sequence and context
parallelism and recompute raise ``NotImplementedError`` where a config
asks for them. Attention always takes the flash path; LayerNorm, RMSNorm
and attention differentiate through their backward kernels.

Rotary positions (``position_embedding_type="rope"``): the model hands
every attention layer the cos and sin rows of its tokens' positions,
(s, b or 1, 1, rot_dim), which rotate q and k after the projection
split and before the heads move forward, as in JAX. A prefill or
training call takes positions ``[0, s)``; a decode step takes each
row's own position.

KV-cache decoding follows ParallelAttention's cache mode at cp = 1: a
prefill call writes the prompt's K/V into the cache, and a decode step
writes one new token per row at that row's own position and attends to
the cache with the unwritten tail padded out. The JAX engine ``vmap``s a
single-sequence decode over lanes; here the batch dimension is written
out, so each row of the cache carries its own position
(:attr:`KVCache.index`).
"""

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.ops.attention import flash_attention
from apex_tpu_torch.ops.layer_norm import layer_norm, rms_norm
from apex_tpu_torch.ops.rope import (
    apply_rotary_pos_emb_cached,
    rope_frequencies,
)
from apex_tpu_torch.parallel.layers import (
    ColumnParallelLinear,
    RowParallelLinear,
)
from apex_tpu_torch.transformer.config import TransformerConfig
from apex_tpu_torch.transformer.enums import AttnMaskType

__all__ = [
    "KVCache", "Norm", "ParallelAttention", "ParallelMLP",
    "ParallelTransformer", "ParallelTransformerLayer",
    "rotary_embedding_for",
]


def check_supported(cfg: TransformerConfig) -> None:
    """Refuses configs that ask for what the port does not have yet."""
    missing = []
    if cfg.sequence_parallel:
        missing.append("sequence_parallel")
    if cfg.context_parallel_mode is not None:
        missing.append("context parallelism")
    if cfg.num_moe_experts is not None:
        missing.append("MoE")
    if cfg.recompute_granularity is not None:
        missing.append("recompute")
    if missing:
        raise NotImplementedError(
            f"not ported to apex_tpu_torch yet: {', '.join(missing)}")


def rotary_embedding_for(config: TransformerConfig, seq_len: int,
                         dtype=torch.float32):
    """(q_freqs, k_freqs), the (seq_len, 1, 1, rot_dim) angles of the
    rotary path, with ``rot_dim = int(kv_channels * rotary_percent)``."""
    rot_dim = int(config.kv_channels * config.rotary_percent)
    f = rope_frequencies(rot_dim, seq_len, base=config.rotary_base,
                         dtype=dtype)
    return f, f


class KVCache:
    """Contiguous K/V cache: ``(batch, h_kv, slots, head_dim)`` per layer.

    The counterpart of the flax "cache" collection (``cached_key``,
    ``cached_value``, ``cache_index``). ``index`` holds each row's next
    position. A prefill forward writes slots ``[0, s)`` and sets
    ``index`` to ``s``; a decode step writes row ``r``'s token at slot
    ``index[r]`` and advances ``index`` by one. As in JAX, the caller
    keeps ``index`` below ``slots`` (``models.generate`` sizes it so).
    """

    def __init__(self, num_layers: int, batch: int, num_kv_heads: int,
                 slots: int, head_dim: int, dtype, device):
        shape = (num_layers, batch, num_kv_heads, slots, head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=device)
        self.v = torch.zeros(shape, dtype=dtype, device=device)
        self.index = torch.zeros(batch, dtype=torch.long, device=device)

    def prefill(self, layer: int, k, v) -> None:
        s = k.shape[2]
        if s > self.k.shape[3]:
            raise ValueError(f"prompt ({s}) exceeds the cache "
                             f"({self.k.shape[3]} slots)")
        self.k[layer, :, :, :s] = k
        self.v[layer, :, :, :s] = v

    def append(self, layer: int, k, v):
        """Writes the (b, h_kv, 1, hd) step at each row's position and
        returns the layer's whole (b, h_kv, slots, hd) K and V."""
        rows = torch.arange(k.shape[0], device=k.device)
        kl, vl = self.k[layer], self.v[layer]
        kl[rows, :, self.index] = k[:, :, 0]
        vl[rows, :, self.index] = v[:, :, 0]
        return kl, vl


class Norm(nn.Module):
    """LayerNorm/RMSNorm with fp32 parameters applied in fp32."""

    def __init__(self, config: TransformerConfig, device=None):
        super().__init__()
        self.config = config
        h, dt = config.hidden_size, config.params_dtype
        self.scale = nn.Parameter(torch.ones(h, dtype=dt, device=device))
        self.bias = None
        if config.normalization != "rmsnorm":
            self.bias = nn.Parameter(torch.zeros(h, dtype=dt, device=device))

    def forward(self, x):
        eps = self.config.layernorm_epsilon
        if self.bias is None:
            return rms_norm(x, self.scale.float(), eps=eps)
        return layer_norm(x, self.scale.float(), self.bias.float(), eps=eps)


def _activate(h, activation: str):
    # in h's dtype, as in JAX: pointwise and bf16-stable
    if activation == "gelu":
        return F.gelu(h, approximate="tanh")
    if activation == "relu":
        return F.relu(h)
    if activation in ("geglu", "swiglu"):
        a, b = h.chunk(2, dim=-1)
        gate = F.gelu(a, approximate="tanh") if activation == "geglu" else F.silu(a)
        return gate * b
    raise ValueError(f"unknown activation {activation!r}")


class ParallelMLP(nn.Module):
    """Column(h -> ffn) -> activation -> Row(ffn -> h)."""

    def __init__(self, config: TransformerConfig, device=None):
        super().__init__()
        self.config = config
        gated = config.activation in ("geglu", "swiglu")
        width = config.ffn_hidden_size * (2 if gated else 1)
        kw = dict(use_bias=config.add_bias_linear,
                  params_dtype=config.params_dtype, device=device)
        self.dense_h_to_4h = ColumnParallelLinear(config.hidden_size, width, **kw)
        self.dense_4h_to_h = RowParallelLinear(
            config.ffn_hidden_size, config.hidden_size, **kw)

    def forward(self, hidden_states):
        h = _activate(self.dense_h_to_4h(hidden_states), self.config.activation)
        return self.dense_4h_to_h(h)


class ParallelAttention(nn.Module):
    """Self-attention (MHA or GQA) over the flash kernel, with KV-cache
    prefill and decode."""

    def __init__(self, config: TransformerConfig, layer_number: int = 0,
                 attn_mask_type: AttnMaskType = AttnMaskType.causal,
                 device=None):
        super().__init__()
        self.config, self.layer_number = config, layer_number
        self.attn_mask_type = attn_mask_type
        heads, hn = config.num_attention_heads, config.kv_channels
        groups = config.num_query_groups or heads
        if heads % groups:
            raise ValueError(f"num_query_groups ({groups}) must divide "
                             f"num_attention_heads ({heads})")
        self.groups = groups
        kw = dict(use_bias=config.add_bias_linear,
                  params_dtype=config.params_dtype, device=device)
        h = config.hidden_size
        if groups != heads:
            # separate Q and fused-KV projections (llama convention)
            self.query = ColumnParallelLinear(h, heads * hn, **kw)
            self.key_value = ColumnParallelLinear(h, 2 * groups * hn, **kw)
        else:
            self.query_key_value = ColumnParallelLinear(h, 3 * heads * hn, **kw)
        self.dense = RowParallelLinear(heads * hn, h, **kw)

    def forward(self, hidden_states, key_padding_mask=None,
                cache: Optional[KVCache] = None, decode_step: bool = False,
                rotary=None):
        """``rotary``: the (cos, sin) rows of the tokens' positions, each
        (s, b or 1, 1, rot_dim), or None for no rotary positions."""
        cfg = self.config
        s, b, _ = hidden_states.shape
        heads, hn = cfg.num_attention_heads, cfg.kv_channels
        if self.groups != heads:
            q = self.query(hidden_states).reshape(s, b, heads, hn)
            kv = self.key_value(hidden_states).reshape(s, b, self.groups, 2 * hn)
            k, v = kv.split(hn, dim=-1)
        else:
            qkv = self.query_key_value(hidden_states).reshape(s, b, heads, 3 * hn)
            q, k, v = qkv.split(hn, dim=-1)  # per-head [q | k | v]
        if rotary is not None:
            q = apply_rotary_pos_emb_cached(q, *rotary)
            k = apply_rotary_pos_emb_cached(k, *rotary)
        # (s, b, np, hn) -> (b, np, s, hn)
        qb, kb, vb = (t.permute(1, 2, 0, 3) for t in (q, k, v))

        causal = self.attn_mask_type == AttnMaskType.causal
        window = cfg.attention_window if causal else None
        if cache is not None and key_padding_mask is not None:
            raise NotImplementedError("KV-cache decode computes its own masks")
        if decode_step:
            if cache is None:
                raise ValueError("decode_step needs the cache a prefill filled")
            if s != 1:
                raise NotImplementedError(
                    "decode_step appends one token at a time; use a prefill "
                    "call for multi-token blocks")
            keys, values = cache.append(self.layer_number, kb, vb)
            j = torch.arange(keys.shape[2], device=keys.device)[None, :]
            idx = cache.index[:, None]
            padded = j > idx  # the unwritten future
            if cfg.attention_window is not None:
                padded = padded | (j <= idx - cfg.attention_window)
            ctx = flash_attention(qb, keys, values, causal=False,
                                  key_padding_mask=padded)
        else:
            if cache is not None:
                cache.prefill(self.layer_number, kb, vb)
            ctx = flash_attention(qb, kb, vb, causal=causal,
                                  key_padding_mask=key_padding_mask,
                                  window=window)
        # (b, np, s, hn) -> (s, b, np * hn)
        ctx = ctx.permute(2, 0, 1, 3).reshape(s, b, heads * hn)
        return self.dense(ctx)


class ParallelTransformerLayer(nn.Module):
    """Pre-LN block: LN -> attention -> residual -> LN -> MLP -> residual."""

    def __init__(self, config: TransformerConfig, layer_number: int = 0,
                 attn_mask_type: AttnMaskType = AttnMaskType.causal,
                 device=None):
        super().__init__()
        check_supported(config)
        self.config = config
        self.input_layernorm = Norm(config, device)
        self.self_attention = ParallelAttention(
            config, layer_number, attn_mask_type, device)
        self.post_attention_layernorm = Norm(config, device)
        self.mlp = ParallelMLP(config, device)

    def forward(self, hidden_states, key_padding_mask=None, cache=None,
                decode_step: bool = False, rotary=None):
        cfg = self.config
        if self.training and (cfg.hidden_dropout > 0 or cfg.attention_dropout > 0):
            raise NotImplementedError(
                "dropout is not ported yet: call .eval() or set "
                "hidden_dropout = attention_dropout = 0")
        dtype = hidden_states.dtype
        rdtype = torch.float32 if cfg.fp32_residual_connection else dtype
        post_ln = cfg.apply_residual_connection_post_layernorm

        ln_out = self.input_layernorm(hidden_states)
        attn_out = self.self_attention(ln_out, key_padding_mask, cache,
                                       decode_step, rotary)
        residual = ln_out if post_ln else hidden_states
        h = (residual.to(rdtype) + attn_out.to(rdtype)).to(dtype)

        ln2 = self.post_attention_layernorm(h)
        mlp_out = self.mlp(ln2)
        residual = ln2 if post_ln else h
        return (residual.to(rdtype) + mlp_out.to(rdtype)).to(dtype)


class ParallelTransformer(nn.Module):
    """Stack of layers named ``layer_{i}`` (the flax names) + final LN."""

    def __init__(self, config: TransformerConfig, post_layer_norm: bool = True,
                 attn_mask_type: AttnMaskType = AttnMaskType.causal,
                 device=None):
        super().__init__()
        self.num_layers = config.num_layers
        for i in range(config.num_layers):
            self.add_module(f"layer_{i}", ParallelTransformerLayer(
                config, i, attn_mask_type, device))
        self.final_layernorm = Norm(config, device) if post_layer_norm else None

    def forward(self, hidden_states, key_padding_mask=None, cache=None,
                decode_step: bool = False, rotary=None):
        for i in range(self.num_layers):
            hidden_states = getattr(self, f"layer_{i}")(
                hidden_states, key_padding_mask, cache, decode_step, rotary)
        if self.final_layernorm is not None:
            hidden_states = self.final_layernorm(hidden_states)
        return hidden_states
