"""BERT (counterpart of apex_tpu/models/bert.py).

Megatron's BERT: pre-LN layers with a final LayerNorm and tanh-GELU over
a bidirectional (padding-mask) stack, tokentype embeddings, an LM head
(dense, GELU, LayerNorm, tied-embedding logits) and a binary (NSP) head
off a tanh pooler of the first token. Tokens are (batch, seq); hidden
states run (seq, batch, hidden).

A (b, s) ``attention_mask`` (1 = keep) reaches the flash kernel as its
key-padding row; with attention dropout in training it becomes the dense
extended mask (:func:`bert_extended_attention_mask`) of the unfused
``CoreAttention`` path instead, as in JAX. Either way a padded query's
output is not a kept position's business: its loss is the caller's to
mask.

The heads' dtypes are flax's promotion, not the compute dtype: the
pooler's dense layer, the binary head and the LM head's dense layer take
the bf16 hidden states against fp32 kernels and compute in fp32; tanh,
GELU and the LM head's LayerNorm (kernel #1 in fp32) run in fp32, and
the result is cast back to the hidden dtype before the tied logits.

Parameter names are the flax ones (``pooler.Dense_0``,
``lm_head_dense``, ``lm_head_norm_scale`` ...), so
``models.convert.bert_params_from_jax`` carries a JAX tree across
(``bert_tp_params_from_jax`` one tp rank's shards).

At tp > 1 the stack, the embedding and the tied LM logits are split over
tp as GPT's are, and the logits stay vocab-sharded into
``vocab_parallel_cross_entropy``; the pooler, the binary head and the LM
head's dense layer and norm are flax ``nn.Dense`` layers, replicated on
every tp rank. Under sequence parallelism the final hidden states are
gathered along the sequence before the heads with
``to_model_parallel=False``, whose backward is a split, not a
reduce-scatter: two heads read the gathered states, the binary head's
cotangent is the same on every tp rank while the LM head's partial one
is summed by the logits' copy-to region, so their sum is replicated and
a reduce-scatter would count the binary path tp times. Random
weights come from ``seed`` as ``GPTModel``'s do; the dropout generators
from the same seed (``transformer.layer.seed_dropout``). JAX's
``deterministic`` is ``not self.training``.
"""

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch._kernels import resolve_device
from apex_tpu_torch.models.gpt import Embedding, init_params
from apex_tpu_torch.ops.layer_norm import layer_norm
from apex_tpu_torch.parallel.cross_entropy import vocab_parallel_cross_entropy
from apex_tpu_torch.parallel.layers import _dot
from apex_tpu_torch.parallel.mappings import (
    gather_from_sequence_parallel_region,
)
from apex_tpu_torch.transformer.config import TransformerConfig
from apex_tpu_torch.transformer.enums import AttnMaskType
from apex_tpu_torch.transformer.layer import (
    ParallelTransformer,
    check_supported,
    seed_dropout,
    sequence_parallel,
)

__all__ = ["BertModel", "Dense", "Pooler", "bert_extended_attention_mask"]


def bert_extended_attention_mask(attention_mask):
    """(b, s) with 1 = keep -> (b, 1, s, s) bool with True = masked out:
    a pair is kept when both its query and its key are."""
    m = attention_mask.bool()
    ext = m[:, None, :] & m[:, :, None]  # (b, s, s)
    return ~ext[:, None, :, :]


class Dense(nn.Module):
    """flax ``nn.Dense`` without a dtype, the same on every tp rank: a
    ``kernel`` (in, out) and a ``bias`` in the params dtype, and an fp32
    product of the promoted input (the parallel linears' product rule)."""

    def __init__(self, in_features, out_features, config, device):
        super().__init__()
        dt = config.params_dtype
        self.kernel = nn.Parameter(torch.empty(in_features, out_features,
                                               dtype=dt, device=device))
        self.bias = nn.Parameter(torch.zeros(out_features, dtype=dt,
                                             device=device))

    def forward(self, x):
        y = _dot(x, self.kernel, torch.float32)
        return y + self.bias.to(y.dtype)


class Pooler(nn.Module):
    """tanh of a dense layer over the first token, cast to the hidden
    dtype."""

    def __init__(self, config: TransformerConfig, device=None):
        super().__init__()
        self.Dense_0 = Dense(config.hidden_size, config.hidden_size, config,
                              device)

    def forward(self, hidden_states):  # (s, b, h)
        d = self.Dense_0(hidden_states[0])
        return torch.tanh(d.float()).to(hidden_states.dtype)


class BertModel(nn.Module):
    """BERT with the LM head and, with ``add_binary_head``, the binary
    head, on ``device`` (CUDA unless the caller names another).

    ``forward`` returns ``(lm, binary_logits)``: ``lm`` is the fp32 logits
    (b, s, vocab), or the per-token fp32 losses (b, s) given ``lm_labels``;
    ``binary_logits`` is fp32 (b, 2), or None without the binary head.
    ``pre_process=False`` takes (s, b, h) hidden states for tokens;
    ``post_process=False`` returns the stack's hidden states, without the
    final LayerNorm and the heads."""

    def __init__(self, config: TransformerConfig, num_tokentypes: int = 2,
                 add_binary_head: bool = True, pre_process: bool = True,
                 post_process: bool = True, device="cuda", seed: int = 0):
        super().__init__()
        check_supported(config)
        device = resolve_device(device)
        self.config, self.num_tokentypes = config, num_tokentypes
        self.add_binary_head = add_binary_head
        self.pre_process, self.post_process = pre_process, post_process
        self.embedding = None
        if pre_process or (post_process
                           and config.share_embeddings_and_output_weights):
            self.embedding = Embedding(config, num_tokentypes, device)
        self.transformer = ParallelTransformer(
            config, post_layer_norm=post_process,
            attn_mask_type=AttnMaskType.padding, device=device)
        if post_process:
            h = config.hidden_size
            self.lm_head_dense = Dense(h, h, config, device)
            self.lm_head_norm_scale = nn.Parameter(
                torch.ones(h, device=device))
            self.lm_head_norm_bias = nn.Parameter(
                torch.zeros(h, device=device))
            if add_binary_head:
                self.pooler = Pooler(config, device)
                self.binary_head = Dense(h, 2, config, device)
        init_params(self, seed)
        seed_dropout(self, seed, device)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def forward(self, tokens, attention_mask=None, tokentype_ids=None,
                lm_labels=None):
        cfg = self.config
        ext_mask = key_padding_mask = None
        if attention_mask is not None:
            if cfg.attention_dropout > 0.0 and self.training:
                ext_mask = bert_extended_attention_mask(attention_mask)
            else:
                key_padding_mask = ~attention_mask.bool()
        if self.pre_process:
            if tokentype_ids is None and self.num_tokentypes > 0:
                tokentype_ids = torch.zeros_like(tokens)  # segment 0
            h = self.embedding(tokens, tokentype_ids=tokentype_ids)
        else:
            h = tokens
        h = self.transformer(h, key_padding_mask, attention_mask=ext_mask)
        if not self.post_process:
            return h
        if sequence_parallel(cfg):
            # the heads need the whole sequence (token 0 lives on tp rank
            # 0); the backward is a split (module docstring)
            h = gather_from_sequence_parallel_region(h,
                                                     to_model_parallel=False)

        binary_logits = None
        if self.add_binary_head:
            binary_logits = self.binary_head(self.pooler(h)).float()
        lm = F.gelu(self.lm_head_dense(h).float(), approximate="tanh")
        lm = layer_norm(lm, self.lm_head_norm_scale, self.lm_head_norm_bias,
                        eps=cfg.layernorm_epsilon).to(h.dtype)
        logits = self.embedding.word_embeddings.attend(lm).transpose(0, 1)
        if lm_labels is None:
            return logits, binary_logits
        return vocab_parallel_cross_entropy(logits, lm_labels), binary_logits
