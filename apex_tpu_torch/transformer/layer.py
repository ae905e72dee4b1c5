"""Pre-LN transformer stack (counterpart of apex_tpu/transformer/layer.py).

Same modules, parameter names and layout as the JAX package: hidden
states are (seq, batch, hidden), the fused QKV projection is interleaved
per head as ``[q_h | k_h | v_h]`` (the JAX reshape to (s, b, heads,
3 * hn) and split), and module names match the flax ones, so a JAX
parameter tree maps onto ``state_dict`` keys by joining its path with
dots (models/convert.py).

Tensor parallelism takes ``parallel_state``'s tp size: attention runs
``heads / tp`` local heads (and ``groups / tp`` KV groups under GQA), each
rank's column of the fused QKV kernel holding its heads' per-head ``[q |
k | v]``, and the MLP ``ffn / tp`` columns. Under sequence parallelism
(``sequence_parallel`` at tp > 1) the hidden states between the column
and row products are split along the sequence; each norm then sees only
its rank's rows, so its weight and bias pass the copy-to region, which
all-reduces their gradients over tp (the JAX ``Norm``'s rule). MoE and
recompute raise ``NotImplementedError`` where a config asks for them.
LayerNorm, RMSNorm and flash attention differentiate through their
backward kernels.

Context parallelism (``context_parallel_mode`` "ring" or "ulysses" at a
cp size above one, :func:`context_parallel_size`): each rank holds a
contiguous chunk of every sequence, and attention runs over the cp group
through ``parallel.ring_attention``'s ``ring_attention`` or
``ulysses_attention``, the window passed only when causal; a dense mask
or attention dropout in training raises JAX's ``NotImplementedError``.
The key-padding mask is the rank's chunk of the global one.

Attention dispatch is the JAX package's: the flash kernel when there is
no dense ``attention_mask`` and no attention dropout in training (a
(b, s) key-padding row goes to the kernel as it is); otherwise the
unfused :class:`CoreAttention` (fp32 scores, the scaled-softmax family of
``ops.softmax``, attention dropout on the fp32 probabilities), with the
key-padding row folded into the dense mask, GQA's K/V repeated per query
head and a sliding window's lower edge folded in.

Dropout (``ShardAwareDropout``) runs in training mode only, in JAX's
order: the embedding's, then in each layer the attention probabilities'
(``CoreAttention``), after attention and after the MLP. Its masks come
from ``torch.Generator`` objects the modules are handed
(:func:`seed_dropout`, with ``parallel.random``'s seeds), never from the
global RNG; one mask draw, :func:`keep_mask`, serves every module.

Rotary positions (``position_embedding_type="rope"``): the model hands
every attention layer the cos and sin rows of its tokens' positions,
(s, b or 1, 1, rot_dim), which rotate q and k after the projection
split and before the heads move forward, as in JAX. A prefill or
training call takes positions ``[0, s)``; a decode step takes each
row's own position.

KV-cache decoding follows ParallelAttention's cache mode: a prefill call
writes the prompt's K/V into the cache, and a decode step writes one new
token per row at that row's own position and attends to the cache with
the unwritten tail padded out. The JAX engine ``vmap``s a single-sequence
decode over lanes; here the batch dimension is written out, so each row
of the cache carries its own position (:attr:`KVCache.index`). At cp > 1
each rank caches only the positions it computed, JAX's slot map: its
contiguous prompt chunk in slots ``[0, p)``, then decode token t on rank
``t % cp`` (:meth:`KVCache.append_cp`); each step merges the ranks'
partial softmax statistics through ``cp_decode_attention``. JAX's cache
index is one number, so at cp > 1 every row must sit at the same
position (``models.gpt`` checks it once a step).
"""

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.ops.attention import (
    causal_mask,
    flash_attention,
    window_mask,
)
from apex_tpu_torch.ops.layer_norm import layer_norm, rms_norm
from apex_tpu_torch.ops.rope import (
    apply_rotary_pos_emb_cached,
    rope_frequencies,
)
from apex_tpu_torch.ops.softmax import fused_scale_mask_softmax
from apex_tpu_torch.parallel import parallel_state as ps
from apex_tpu_torch.parallel.layers import (
    ColumnParallelLinear,
    RowParallelLinear,
)
from apex_tpu_torch.parallel.mappings import (
    copy_to_tensor_model_parallel_region,
)
from apex_tpu_torch.parallel.ring_attention import (
    cp_decode_attention,
    ring_attention,
    ulysses_attention,
)
from apex_tpu_torch.parallel.random import (
    data_parallel_generator,
    model_parallel_generator,
    shard_aware_generator,
)
from apex_tpu_torch.transformer.config import TransformerConfig
from apex_tpu_torch.transformer.enums import AttnMaskType

__all__ = [
    "CoreAttention", "KVCache", "Norm", "ParallelAttention", "ParallelMLP",
    "ParallelTransformer", "ParallelTransformerLayer", "ShardAwareDropout",
    "context_parallel_size", "keep_mask", "rotary_embedding_for",
    "seed_dropout",
]


def check_supported(cfg: TransformerConfig) -> None:
    """Refuses configs that ask for what the port does not have yet."""
    missing = []
    if cfg.num_moe_experts is not None:
        missing.append("MoE")
    if cfg.recompute_granularity is not None:
        missing.append("recompute")
    if missing:
        raise NotImplementedError(
            f"not ported to apex_tpu_torch yet: {', '.join(missing)}")


def context_parallel_size(config: TransformerConfig) -> int:
    """The cp size attention runs over: the cp group's size when the
    config names a ``context_parallel_mode``, else 1 (as in JAX, a config
    without a mode attends to its own rows only)."""
    if config.context_parallel_mode is None:
        return 1
    return ps.get_context_parallel_world_size()


def _hidden_dropout_axes(config: TransformerConfig) -> tuple:
    """Axes over which hidden-state dropout masks must differ: tp when the
    sequence is SP-sharded, cp when context-parallel."""
    axes = ()
    if config.sequence_parallel:
        axes += ("tp",)
    if config.context_parallel_mode is not None:
        axes += (config.context_axis,)
    return axes


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
        # at cp > 1: the prompt positions this rank holds (JAX's
        # prompt_len_local), set by a prefill
        self.prompt_local: Optional[int] = None
        # at cp > 1: whether the rows' positions were found equal since
        # the last prefill (decode steps advance them together)
        self.rows_checked = False

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

    def append_cp(self, layer: int, k, v, rank: int, cp: int):
        """The decode step at cp > 1 (every row at position ``index[0]``):
        token t = index - p cp of the decode, p the prompt positions a rank
        holds, lands on rank ``t % cp`` in slot ``p + t // cp``. Returns
        the layer's K and V and each slot's global position (slot j < p:
        ``rank p + j``; else ``p cp + (j - p) cp + rank``)."""
        p = self.prompt_local
        if p is None:
            raise ValueError("a decode step at cp > 1 needs a prefill at "
                             "cp > 1 first")
        t = self.index[0] - p * cp
        slot = p + torch.div(t, cp, rounding_mode="floor")
        here = (t % cp) == rank
        kl, vl = self.k[layer], self.v[layer]
        kl[:, :, slot] = torch.where(here, k[:, :, 0], kl[:, :, slot])
        vl[:, :, slot] = torch.where(here, v[:, :, 0], vl[:, :, slot])
        j = torch.arange(kl.shape[2], device=kl.device)
        gpos = torch.where(j < p, rank * p + j, p * cp + (j - p) * cp + rank)
        return kl, vl, gpos


def sequence_parallel(config: TransformerConfig) -> bool:
    """Is the sequence split over tp? (``sequence_parallel`` at tp > 1)"""
    return (config.sequence_parallel
            and ps.get_tensor_model_parallel_world_size() > 1)


class Norm(nn.Module):
    """LayerNorm/RMSNorm with fp32 parameters applied in fp32. Under
    sequence parallelism the parameters pass the copy-to region: this
    rank's rows give a partial gradient, which the tp ranks sum."""

    def __init__(self, config: TransformerConfig, device=None):
        super().__init__()
        self.config = config
        self.sequence_parallel = sequence_parallel(config)
        h, dt = config.hidden_size, config.params_dtype
        self.scale = nn.Parameter(torch.ones(h, dtype=dt, device=device))
        self.bias = None
        if config.normalization != "rmsnorm":
            self.bias = nn.Parameter(torch.zeros(h, dtype=dt, device=device))

    def _param(self, p):
        if self.sequence_parallel:
            p = copy_to_tensor_model_parallel_region(p)
        return p.float()

    def forward(self, x):
        eps = self.config.layernorm_epsilon
        if self.bias is None:
            return rms_norm(x, self._param(self.scale), eps=eps)
        return layer_norm(x, self._param(self.scale), self._param(self.bias),
                          eps=eps)


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
                  params_dtype=config.params_dtype, device=device,
                  sequence_parallel_enabled=config.sequence_parallel)
        self.dense_h_to_4h = ColumnParallelLinear(config.hidden_size, width, **kw)
        self.dense_4h_to_h = RowParallelLinear(
            config.ffn_hidden_size, config.hidden_size, **kw)

    def forward(self, hidden_states):
        h = _activate(self.dense_h_to_4h(hidden_states), self.config.activation)
        return self.dense_4h_to_h(h)


def keep_mask(generator: torch.Generator, keep_prob: float, shape,
              device) -> torch.Tensor:
    """The dropout mask: bool, True with probability ``keep_prob``
    (``uniform < keep_prob``, as ``jax.random.bernoulli`` draws it)."""
    return torch.rand(shape, generator=generator, device=device) < keep_prob


class ShardAwareDropout(nn.Module):
    """Dropout in training mode at a nonzero rate (else the identity):
    ``where(keep, x / (1 - rate), 0)`` in x's dtype, the divisor rounded to
    that dtype as JAX rounds its weak-typed scalar. ``model_parallel`` marks a region whose shards hold different
    slices (tp-sharded heads), which draws from the model-parallel
    generator. ``generator`` is handed in (:func:`seed_dropout`); a draw
    without one raises. With ``"tp"`` (hidden dropout under sequence
    parallelism) or ``"cp"`` named at a size above one the module folds
    those ranks in once, at its first draw after ``generator`` or the
    groups change (:func:`shard_aware_generator`: one draw of the shared
    generator and one host read), and draws from that generator after. A
    model-parallel region folds no tp rank: its generator's seed holds
    it already."""

    def __init__(self, rate: float, axis_names=(),
                 model_parallel: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rate, self.axis_names = rate, tuple(axis_names)
        self.model_parallel = model_parallel
        self.generator = generator
        self._folded = None  # ((generator, tp, tp rank, cp, cp rank), folded)

    def _draw_generator(self) -> torch.Generator:
        key = (ps.get_tensor_model_parallel_world_size(),
               ps.get_tensor_model_parallel_rank(),
               ps.get_context_parallel_world_size(),
               ps.get_context_parallel_rank())
        if (self._folded is None or self._folded[0][0] is not self.generator
                or self._folded[0][1:] != key):
            axes = tuple(a for a in self.axis_names
                         if not (self.model_parallel and a == "tp"))
            self._folded = ((self.generator,) + key, shard_aware_generator(
                self.generator, axes))
        return self._folded[1]

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        if self.generator is None:
            raise ValueError("ShardAwareDropout has no generator: hand it "
                             "one (transformer.layer.seed_dropout)")
        keep = keep_mask(self._draw_generator(), 1.0 - self.rate, x.shape,
                         x.device)
        scale = torch.tensor(1.0 - self.rate, dtype=x.dtype, device=x.device)
        return torch.where(keep, x / scale, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


def seed_dropout(module: nn.Module, seed: int, device) -> None:
    """Hands every ShardAwareDropout under ``module`` its generator: the
    data-parallel one of ``seed``, or, for a model-parallel region, the
    model-parallel one of this tp rank (``parallel.random``)."""
    dp = data_parallel_generator(seed, device)
    mp = model_parallel_generator(
        seed, ps.get_tensor_model_parallel_rank(), device)
    for m in module.modules():
        if isinstance(m, ShardAwareDropout):
            m.generator = mp if m.model_parallel else dp


class CoreAttention(nn.Module):
    """Unfused attention for a dense mask or attention dropout: fp32
    scores of q and k times ``1 / sqrt(kv_channels)`` (with the layer
    scaling coefficient ``num_layers`` moved into the softmax's scale when
    ``apply_query_key_layer_scaling``), ``fused_scale_mask_softmax``
    (a padding mask is folded into the causal one), attention dropout on
    the fp32 probabilities in training, and the product with v at fp32
    accumulation, cast to q's dtype. q, k, v: (b, np, s, hn)."""

    def __init__(self, config: TransformerConfig,
                 attn_mask_type: AttnMaskType = AttnMaskType.causal):
        super().__init__()
        self.config, self.attn_mask_type = config, attn_mask_type
        # heads are tp-sharded: the masks differ per tp rank
        self.attention_dropout = ShardAwareDropout(
            config.attention_dropout, axis_names=("tp",),
            model_parallel=True)

    def forward(self, q, k, v, attention_mask=None):
        cfg = self.config
        norm = 1.0 / math.sqrt(cfg.kv_channels)
        scale, softmax_scale = norm, 1.0
        if cfg.apply_query_key_layer_scaling:
            coeff = max(1, cfg.num_layers)
            scale, softmax_scale = norm / coeff, coeff
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
        causal = self.attn_mask_type == AttnMaskType.causal
        if causal and attention_mask is not None:
            future = causal_mask(s.shape[-2], s.shape[-1], s.device)
            attention_mask = torch.logical_or(attention_mask, future)
            causal = False
        probs = fused_scale_mask_softmax(s, attention_mask,
                                         scale=softmax_scale, causal=causal)
        probs = self.attention_dropout(probs)  # identity in eval or at 0
        ctx = torch.matmul(probs.to(q.dtype).float(), v.float())
        return ctx.to(q.dtype)


class ParallelAttention(nn.Module):
    """Self-attention (MHA or GQA) over the flash kernel or
    :class:`CoreAttention`, with KV-cache prefill and decode."""

    def __init__(self, config: TransformerConfig, layer_number: int = 0,
                 attn_mask_type: AttnMaskType = AttnMaskType.causal,
                 device=None):
        super().__init__()
        self.config, self.layer_number = config, layer_number
        self.attn_mask_type = attn_mask_type
        heads, hn = config.num_attention_heads, config.kv_channels
        groups = config.num_query_groups or heads
        tp = ps.get_tensor_model_parallel_world_size()
        if heads % groups or groups % tp:
            raise ValueError(f"num_query_groups ({groups}) must divide "
                             f"num_attention_heads ({heads}) and be "
                             f"divisible by tp ({tp})")
        self.groups = groups
        self.heads_local, self.groups_local = heads // tp, groups // tp
        kw = dict(use_bias=config.add_bias_linear,
                  params_dtype=config.params_dtype, device=device,
                  sequence_parallel_enabled=config.sequence_parallel)
        h = config.hidden_size
        if groups != heads:
            # separate Q and fused-KV projections (llama convention)
            self.query = ColumnParallelLinear(h, heads * hn, **kw)
            self.key_value = ColumnParallelLinear(h, 2 * groups * hn, **kw)
        else:
            self.query_key_value = ColumnParallelLinear(h, 3 * heads * hn, **kw)
        self.dense = RowParallelLinear(heads * hn, h, **kw)
        self.core_attention = CoreAttention(config, attn_mask_type)

    def forward(self, hidden_states, key_padding_mask=None,
                cache: Optional[KVCache] = None, decode_step: bool = False,
                rotary=None, attention_mask=None):
        """``rotary``: the (cos, sin) rows of the tokens' positions, each
        (s, b or 1, 1, rot_dim), or None for no rotary positions.
        ``key_padding_mask``: (b, s) bool, True = padded-out key.
        ``attention_mask``: bool broadcastable to (b, np, sq, sk), True =
        masked out; it takes the unfused path."""
        cfg = self.config
        b = hidden_states.shape[1]
        heads, hn = self.heads_local, cfg.kv_channels
        # s is the whole sequence: under sequence parallelism the column
        # products have gathered it
        if self.groups != cfg.num_attention_heads:
            q = self.query(hidden_states)
            s = q.shape[0]
            q = q.reshape(s, b, heads, hn)
            kv = self.key_value(hidden_states).reshape(
                s, b, self.groups_local, 2 * hn)
            k, v = kv.split(hn, dim=-1)
        else:
            qkv = self.query_key_value(hidden_states)
            s = qkv.shape[0]
            # this rank's heads, each [q | k | v]
            q, k, v = qkv.reshape(s, b, heads, 3 * hn).split(hn, dim=-1)
        if rotary is not None:
            q = apply_rotary_pos_emb_cached(q, *rotary)
            k = apply_rotary_pos_emb_cached(k, *rotary)
        # (s, b, np, hn) -> (b, np, s, hn)
        qb, kb, vb = (t.permute(1, 2, 0, 3) for t in (q, k, v))

        causal = self.attn_mask_type == AttnMaskType.causal
        window = cfg.attention_window if causal else None
        cp = context_parallel_size(cfg)
        if cache is not None and (key_padding_mask is not None
                                  or attention_mask is not None):
            raise NotImplementedError("KV-cache decode computes its own masks")
        use_flash = attention_mask is None and (
            cfg.attention_dropout == 0.0 or not self.training)
        if key_padding_mask is not None and not use_flash:
            # fold the (b, sk) padding row into the dense mask for the
            # unfused path (True = masked out)
            kp = key_padding_mask.bool()[:, None, None, :]
            attention_mask = (kp if attention_mask is None
                              else torch.logical_or(attention_mask, kp))
            key_padding_mask = None
        if decode_step:
            if cache is None:
                raise ValueError("decode_step needs the cache a prefill filled")
            if s != 1:
                raise NotImplementedError(
                    "decode_step appends one token at a time; use a prefill "
                    "call for multi-token blocks")
            if cp > 1:
                keys, values, gpos = cache.append_cp(
                    self.layer_number, kb, vb,
                    ps.get_context_parallel_rank(), cp)
                gpos = gpos[None, :]
            else:
                keys, values = cache.append(self.layer_number, kb, vb)
                gpos = torch.arange(keys.shape[2], device=keys.device)[None]
            idx = cache.index[:, None]
            padded = gpos > idx  # the unwritten future
            if cfg.attention_window is not None:
                padded = padded | (gpos <= idx - cfg.attention_window)
            if cp > 1:
                ctx = cp_decode_attention(
                    qb, keys, values, padded.expand(b, -1),
                    axis_name=cfg.context_axis)
            else:
                ctx = flash_attention(qb, keys, values, causal=False,
                                      key_padding_mask=padded)
        else:
            if cache is not None:
                cache.prefill(self.layer_number, kb, vb)
            if cp > 1:
                if not use_flash:
                    raise NotImplementedError(
                        "context parallelism requires the flash path: no "
                        "dense attention_mask and no attention dropout "
                        "(like the reference's fused paths); GQA and "
                        "key-padding masks are supported")
                attend = (ring_attention
                          if cfg.context_parallel_mode == "ring"
                          else ulysses_attention)
                ctx = attend(qb, kb, vb, axis_name=cfg.context_axis,
                             causal=causal, window=window,
                             key_padding_mask=key_padding_mask)
            elif use_flash:
                ctx = flash_attention(qb, kb, vb, causal=causal,
                                      key_padding_mask=key_padding_mask,
                                      window=window)
            else:
                if kb.shape[1] != qb.shape[1]:  # GQA through the unfused path
                    rep = qb.shape[1] // kb.shape[1]
                    kb = kb.repeat_interleave(rep, dim=1)
                    vb = vb.repeat_interleave(rep, dim=1)
                if window is not None:
                    # the band's lower edge; the causal upper edge stays
                    # with CoreAttention's own mask handling
                    below = window_mask(qb.shape[2], kb.shape[2], window,
                                        qb.device)[None, None]
                    attention_mask = (
                        below if attention_mask is None
                        else torch.logical_or(attention_mask, below))
                ctx = self.core_attention(qb, kb, vb, attention_mask)
        # (b, np, s, hn) -> (s, b, np * hn)
        ctx = ctx.permute(2, 0, 1, 3).reshape(s, b, heads * hn)
        return self.dense(ctx)


class ParallelTransformerLayer(nn.Module):
    """Pre-LN block: LN -> attention -> (dropout) residual -> LN -> MLP ->
    (dropout) residual."""

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
        self.hidden_dropout = ShardAwareDropout(
            config.hidden_dropout, axis_names=_hidden_dropout_axes(config))

    def forward(self, hidden_states, key_padding_mask=None, cache=None,
                decode_step: bool = False, rotary=None, attention_mask=None):
        cfg = self.config
        dtype = hidden_states.dtype
        rdtype = torch.float32 if cfg.fp32_residual_connection else dtype
        post_ln = cfg.apply_residual_connection_post_layernorm

        ln_out = self.input_layernorm(hidden_states)
        attn_out = self.self_attention(ln_out, key_padding_mask, cache,
                                       decode_step, rotary, attention_mask)
        residual = ln_out if post_ln else hidden_states
        # the module is the identity in eval or at rate 0: no call on the
        # decode path's per-layer host time
        drop = self.training and cfg.hidden_dropout > 0.0
        if drop:
            attn_out = self.hidden_dropout(attn_out)
        h = (residual.to(rdtype) + attn_out.to(rdtype)).to(dtype)

        ln2 = self.post_attention_layernorm(h)
        mlp_out = self.mlp(ln2)
        residual = ln2 if post_ln else h
        if drop:
            mlp_out = self.hidden_dropout(mlp_out)
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
                decode_step: bool = False, rotary=None, attention_mask=None):
        for i in range(self.num_layers):
            hidden_states = getattr(self, f"layer_{i}")(
                hidden_states, key_padding_mask, cache, decode_step, rotary,
                attention_mask)
        if self.final_layernorm is not None:
            hidden_states = self.final_layernorm(hidden_states)
        return hidden_states
