"""GPT language model (counterpart of apex_tpu/models/gpt.py).

Tokens are (batch, seq); hidden states run (seq, batch, hidden) through
the stack; the output is fp32 logits (batch, seq, vocab) from the tied
embedding (or an untied ``output_layer``), or, given ``labels``, the
per-token fp32 cross-entropy losses that :func:`gpt_loss_fn` averages.

Weights are random, drawn from ``torch.Generator``s seeded by ``seed``
with the JAX package's initializer scales (normal 0.02 for the tables,
lecun scale 1/sqrt(fan_in) for the kernels, ones and zeros for the
norms and biases), or are loaded from a JAX tree with
``models.convert.gpt_params_from_jax`` (``gpt_tp_params_from_jax`` for
one tp rank's shards) or from a transformers Llama with
``models.hf_import``.

At tensor-parallel size tp > 1 (``parallel_state``) the vocabulary, the
heads and the FFN are split over tp; the logits are the rank's vocab
shard, and the loss is tp-replicated after the vocab-parallel cross
entropy's reductions. Under sequence parallelism the embedding's output
is split along the sequence and gathered again before the head. The KV
cache at tp > 1 holds each rank's heads (its KV groups under GQA), and a
decode step's logits are the rank's vocab shard. Under sequence
parallelism a cached prefill keeps it, while a decode step skips the
embedding's sequence split and the head's gather and runs the layers in
the plain-TP layout (one token cannot be split along the sequence), as
JAX does.

Under context parallelism (a ``context_parallel_mode`` at cp > 1) the
tokens are this rank's contiguous chunk of each sequence: the default
positions are offset by cp rank x chunk length (learned and rotary
positions alike), the embedding's dropout folds the cp rank in, and the
losses are the chunk's. A cached prefill writes the rank's chunk and
sets every row's position to chunk x cp; decode steps then run the
same token on every rank (``transformer.layer``'s CP slot map).

A model with rotary positions (the Llama family) keeps fp32 cos and sin
tables of :func:`~apex_tpu_torch.transformer.layer.rotary_embedding_for`'s
angles on its device, computed once on the CPU for
``max_position_embeddings`` positions (the JAX model's cache-length
table). Each call gathers the rows of its tokens' positions: ``[0, s)``
for a prefill or a training call, each row's cache position for a
decode step. A position past the table fails at the gather, the bound
that ``generate`` and the engine check before they run a model.
"""

import contextlib
import math
from typing import Optional

import torch
from torch import nn

from apex_tpu_torch._kernels import resolve_device
from apex_tpu_torch.parallel import parallel_state as ps
from apex_tpu_torch.parallel.cross_entropy import vocab_parallel_cross_entropy
from apex_tpu_torch.parallel.layers import (
    ColumnParallelLinear,
    VocabParallelEmbedding,
    sequence_parallel_suspended,
)
from apex_tpu_torch.parallel.mappings import (
    gather_from_sequence_parallel_region,
    scatter_to_sequence_parallel_region,
)
from apex_tpu_torch.parallel.random import (
    data_parallel_generator,
    model_parallel_generator,
)
from apex_tpu_torch.transformer.config import TransformerConfig
from apex_tpu_torch.transformer.enums import AttnMaskType
from apex_tpu_torch.transformer.moe import MoEMLP, draw_experts
from apex_tpu_torch.transformer.layer import (
    KVCache,
    ParallelTransformer,
    ShardAwareDropout,
    check_supported,
    context_parallel_size,
    rotary_embedding_for,
    seed_dropout,
    sequence_parallel,
)

__all__ = ["Embedding", "GPTModel", "default_positions", "gpt2_small_config",
           "gpt_loss_fn", "megatron_bert_345m_config",
           "tinyllama_1_1b_config"]


def gpt2_small_config(**overrides) -> TransformerConfig:
    """GPT-2 small (124M) at full width, as the JAX package's
    ``config_from_hf_gpt2`` maps the published config: 12 layers, hidden
    768, 12 heads, FFN 3072, vocab 50257, 1024 learned positions,
    LayerNorm eps 1e-5, tanh-GELU, biased linears, tied embeddings, no
    dropout. Params fp32, compute bf16 unless overridden."""
    kw = dict(
        num_layers=12, hidden_size=768, num_attention_heads=12,
        vocab_size=50257, max_position_embeddings=1024,
        layernorm_epsilon=1e-5, hidden_dropout=0.0, attention_dropout=0.0,
        activation="gelu", position_embedding_type="learned",
        share_embeddings_and_output_weights=True,
    )
    kw.update(overrides)
    return TransformerConfig(**kw)


def tinyllama_1_1b_config(**overrides) -> TransformerConfig:
    """TinyLlama-1.1B (``TinyLlama/TinyLlama-1.1B-intermediate-step-1431k-3T``,
    a Llama-2 architecture) at full width, as the JAX package's
    ``config_from_hf_llama`` maps its published config.json: 22 layers,
    hidden 2048, 32 heads over 4 KV heads (head_dim 64), SwiGLU FFN 5632,
    vocab 32000, 2048 positions, RMSNorm eps 1e-5, rotate-half RoPE with
    base 10000, bias-free linears, untied fp32 head, no dropout:
    1,100,048,384 parameters in 157 tensors. Params fp32, compute bf16
    unless overridden."""
    kw = dict(
        num_layers=22, hidden_size=2048, num_attention_heads=32,
        num_query_groups=4, ffn_hidden_size=5632, vocab_size=32000,
        max_position_embeddings=2048, layernorm_epsilon=1e-5,
        hidden_dropout=0.0, attention_dropout=0.0, normalization="rmsnorm",
        activation="swiglu", add_bias_linear=False,
        position_embedding_type="rope", rotary_base=10000.0,
        share_embeddings_and_output_weights=False,
        apply_query_key_layer_scaling=False,
    )
    kw.update(overrides)
    return TransformerConfig(**kw)


def megatron_bert_345m_config(**overrides) -> TransformerConfig:
    """Megatron BERT-345M at full width, the configuration of NVIDIA
    Megatron-LM's ``examples/pretrain_bert.sh``: 24 layers, hidden 1024,
    16 heads (head_dim 64), FFN 4096, 512 positions, bert-large-uncased's
    vocabulary of 30522 padded to a multiple of 128 (30592), LayerNorm
    eps 1e-5, tanh-GELU, biased linears, tied embeddings, hidden and
    attention dropout 0.1. With two tokentypes and the binary head,
    ``BertModel`` holds 336,267,266 parameters in 301 tensors. Params
    fp32, compute bf16 unless overridden."""
    kw = dict(
        num_layers=24, hidden_size=1024, num_attention_heads=16,
        ffn_hidden_size=4096, vocab_size=30592, max_position_embeddings=512,
        layernorm_epsilon=1e-5, hidden_dropout=0.1, attention_dropout=0.1,
        activation="gelu", position_embedding_type="learned",
        share_embeddings_and_output_weights=True,
    )
    kw.update(overrides)
    return TransformerConfig(**kw)


def default_positions(config: TransformerConfig, seq: int, device):
    """(1, seq) positions of a call without position ids: ``[0, seq)``,
    offset by cp rank x ``seq`` under context parallelism (JAX
    ``gpt.py:89-98``)."""
    pos = torch.arange(seq, device=device)[None, :]
    if context_parallel_size(config) > 1:
        pos = pos + ps.get_context_parallel_rank() * seq
    return pos


class Embedding(nn.Module):
    """Word + learned-position (+ tokentype) embeddings, cast to the
    compute dtype, then hidden dropout in training (its masks differ over
    cp); under sequence parallelism, this rank's slice of the sequence."""

    def __init__(self, config: TransformerConfig, num_tokentypes: int = 0,
                 device=None):
        super().__init__()
        self.config, self.num_tokentypes = config, num_tokentypes
        self.word_embeddings = VocabParallelEmbedding(
            config.vocab_size, config.hidden_size, config.params_dtype, device)
        self.position_embeddings = None
        if config.position_embedding_type == "learned":
            self.position_embeddings = nn.Parameter(torch.empty(
                config.max_position_embeddings, config.hidden_size,
                dtype=config.params_dtype, device=device))
        self.tokentype_embeddings = None
        if num_tokentypes > 0:
            self.tokentype_embeddings = nn.Parameter(torch.empty(
                num_tokentypes, config.hidden_size,
                dtype=config.params_dtype, device=device))
        self.dropout = ShardAwareDropout(
            config.hidden_dropout,
            axis_names=((config.context_axis,)
                        if config.context_parallel_mode else ()))

    def forward(self, tokens, position_ids=None, tokentype_ids=None):
        h = self.word_embeddings(tokens)  # (b, s, h)
        if self.position_embeddings is not None:
            if position_ids is None:
                position_ids = default_positions(
                    self.config, tokens.shape[1], tokens.device)
            h = h + self.position_embeddings[position_ids]
        if tokentype_ids is not None:
            if self.num_tokentypes <= 0:
                raise ValueError(
                    "tokentype_ids passed but num_tokentypes == 0 "
                    "(ref: Megatron Embedding raises on this mismatch)")
            h = h + self.tokentype_embeddings[tokentype_ids]
        elif self.num_tokentypes > 0:
            raise ValueError(
                "num_tokentypes > 0 but no tokentype_ids passed: the "
                "tokentype table would silently train as dead weight")
        h = h.transpose(0, 1).to(self.config.compute_dtype)  # (s, b, h)
        h = self.dropout(h)
        if sequence_parallel(self.config):
            h = scatter_to_sequence_parallel_region(h)
        return h


@torch.no_grad()
def init_params(model: nn.Module, seed: int) -> None:
    """Draws ``model``'s parameters, in ``named_parameters`` order, on
    their device: normal 0.02 for the tables and the untied head, normal
    1/sqrt(fan_in) of the local shape for the kernels (JAX's initializers
    see the shard), ones for the norm scales and zeros for the biases;
    an MoE layer's router and experts by ``transformer.moe.draw_experts``
    from the data-parallel generator (every rank draws all E experts and
    keeps its own).
    Tp-sharded parameters (``tensor_model_parallel``) draw from this tp
    rank's model-parallel generator, the others from the data-parallel
    one of ``seed``, the same on every rank (``parallel.random``)."""
    params = list(model.named_parameters())
    device = params[0][1].device
    shared = data_parallel_generator(seed, device)
    own = model_parallel_generator(
        seed, ps.get_tensor_model_parallel_rank(), device)
    moe = {id(p) for m in model.modules() if isinstance(m, MoEMLP)
           for p in m.parameters()}
    for name, p in params:
        if id(p) in moe:
            draw_experts(p, shared)
            continue
        gen = own if getattr(p, "tensor_model_parallel", False) else shared
        leaf = name.rsplit(".", 1)[-1]
        if (leaf in ("embedding", "position_embeddings",
                     "tokentype_embeddings")
                or name.startswith("output_layer.")):
            std = 0.02
        elif leaf == "kernel":
            std = 1.0 / math.sqrt(p.shape[0])
        else:  # norm scales are ones, biases zeros
            p.fill_(1.0 if leaf.endswith("scale") else 0.0)
            continue
        p.copy_(torch.randn(p.shape, generator=gen, device=p.device,
                            dtype=torch.float32) * std)


class GPTModel(nn.Module):
    """Causal LM over the transformer stack, on ``device`` (CUDA unless
    the caller names another; see ``_kernels.resolve_device``)."""

    def __init__(self, config: TransformerConfig, device="cuda",
                 seed: int = 0):
        super().__init__()
        check_supported(config)
        device = resolve_device(device)
        self.config = config
        self.embedding = Embedding(config, device=device)
        self.output_layer = None
        if not config.share_embeddings_and_output_weights:
            # its own sequence gather under sequence parallelism, whose
            # backward reduce-scatters
            self.output_layer = ColumnParallelLinear(
                config.hidden_size, config.vocab_size, use_bias=False,
                params_dtype=config.params_dtype,
                output_dtype=torch.float32, device=device,
                sequence_parallel_enabled=config.sequence_parallel)
        self.transformer = ParallelTransformer(
            config, post_layer_norm=True,
            attn_mask_type=AttnMaskType.causal, device=device)
        self.rope_cos = self.rope_sin = None
        if config.position_embedding_type == "rope":
            if config.max_position_embeddings < 1:
                raise ValueError("a rope model needs max_position_embeddings"
                                 ", the length of its cos/sin table")
            f, _ = rotary_embedding_for(  # on the CPU
                config, config.max_position_embeddings)
            f = f[:, 0, 0, :]
            self.rope_cos = torch.cos(f).to(device)
            self.rope_sin = torch.sin(f).to(device)
        self.init_weights(seed)
        seed_dropout(self, seed, device)

    @property
    def device(self) -> torch.device:
        return self.embedding.word_embeddings.embedding.device

    def init_weights(self, seed: int) -> None:
        init_params(self, seed)

    def _rotary(self, positions):
        """(cos, sin), each (s, b, 1, rot_dim), for (b, s) positions."""
        return tuple(t[positions].transpose(0, 1)[:, :, None, :]
                     for t in (self.rope_cos, self.rope_sin))

    def new_cache(self, batch: int, slots: int) -> KVCache:
        """An empty KV cache for ``batch`` rows of ``slots`` positions (a
        cp rank's slots at cp > 1: JAX's cache length / cp) of this tp
        rank's KV heads."""
        cfg = self.config
        return KVCache(
            cfg.num_layers, batch,
            (cfg.num_query_groups or cfg.num_attention_heads)
            // ps.get_tensor_model_parallel_world_size(), slots,
            cfg.kv_channels, cfg.compute_dtype, self.device)

    def hidden_states(self, tokens, position_ids=None, key_padding_mask=None,
                      cache: Optional[KVCache] = None,
                      decode_step: bool = False):
        """The final-LN hidden states (s, b, h) in the compute dtype.
        With ``cache``: a prefill writes the prompt's K/V and sets the
        cache's positions to the prompt length (the rank's chunk x cp
        under context parallelism); ``decode_step`` runs one token per row
        at the cache's per-row positions (the default position ids) and
        advances them by one. At cp > 1 every row must sit at one
        position, which the first step after a prefill checks."""
        cp = context_parallel_size(self.config)
        if decode_step:
            if cache is None:
                raise ValueError("decode_step needs the cache a prefill filled")
            if cp > 1 and not cache.rows_checked:
                # once after each prefill: the steps advance every row
                if bool((cache.index != cache.index[0]).any()):
                    raise ValueError(
                        "a decode step at cp > 1 takes one position for "
                        "every row (JAX's cache index is one number); rows "
                        f"sit at {cache.index.tolist()}")
                cache.rows_checked = True
            if position_ids is None:
                position_ids = cache.index[:, None]
        with _decode_layout(decode_step):
            h = self.embedding(tokens, position_ids)
            rotary = None
            if self.rope_cos is not None:
                if position_ids is None:
                    position_ids = default_positions(
                        self.config, tokens.shape[1], tokens.device)
                rotary = self._rotary(position_ids)
            h = self.transformer(h, key_padding_mask, cache, decode_step,
                                 rotary)
        if cache is not None:
            if decode_step:
                cache.index += 1
            else:
                cache.index.fill_(tokens.shape[1] * cp)
                cache.prompt_local = tokens.shape[1] if cp > 1 else None
                cache.rows_checked = False
        return h

    def logits(self, h):
        """fp32 logits (b, s, vocab / tp) of (s, b, h) hidden states (this
        rank's sequence slice under sequence parallelism)."""
        if self.output_layer is not None:
            return self.output_layer(h).transpose(0, 1)
        sp = sequence_parallel(self.config)
        if sp:
            # the gather's backward reduce-scatters the partial gradients
            # of the vocab shards, so attend takes no copy-to region
            h = gather_from_sequence_parallel_region(h)
        return self.embedding.word_embeddings.attend(
            h, parallel_input=sp).transpose(0, 1)

    def forward(self, tokens, position_ids=None, key_padding_mask=None,
                cache: Optional[KVCache] = None, decode_step: bool = False,
                labels=None, loss_mask=None):
        """fp32 logits (b, s, vocab) of (b, s) tokens (see
        :meth:`hidden_states` for the cache arguments); with ``labels``
        (b, s), the fp32 per-token losses instead, times ``loss_mask``
        where one is given."""
        with _decode_layout(decode_step):
            logits = self.logits(self.hidden_states(
                tokens, position_ids, key_padding_mask, cache, decode_step))
        if labels is None:
            return logits
        losses = vocab_parallel_cross_entropy(logits, labels)
        if loss_mask is not None:
            losses = losses * loss_mask
        return losses


def _decode_layout(decode_step: bool):
    """A decode step runs the plain-TP layout: one token cannot be split
    along the sequence (JAX replaces ``sequence_parallel`` for it)."""
    return (sequence_parallel_suspended() if decode_step
            else contextlib.nullcontext())


def gpt_loss_fn(losses, loss_mask=None):
    """Mean loss over the unmasked tokens."""
    if loss_mask is None:
        return losses.mean()
    m = loss_mask.float()
    return (losses * m).sum() / torch.clamp_min(m.sum(), 1.0)
