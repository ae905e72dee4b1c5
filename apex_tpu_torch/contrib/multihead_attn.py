"""Fused multi-head attention modules (counterpart of
apex_tpu/contrib/multihead_attn.py; ref: apex.contrib.multihead_attn's
``SelfMultiheadAttn`` and ``EncdecMultiheadAttn``).

Layout (seq, batch, embed), the reference's. The feature matrix is the
JAX modules': packed or separate QKV projections (``separate_qkv_params``),
biases, scaled dot products with 1/sqrt(head_dim), ``include_norm_add``
(a pre-LayerNorm through ``ops.layer_norm.layer_norm`` and the residual
add with the output dropout), ``mask_additive`` (additive masks against
boolean ones), causal attention, and attention and output dropout drawn
from a ``torch.Generator`` the caller hands in. Parameters keep the flax
names and the flax ``(in, out)`` layout, in ``params_dtype``, and each call
casts them to the input's dtype.

Routing (``_attend``, as JAX's): with no additive mask and no active
dropout, and ``impl != "xla"``, the call goes to
``ops.attention.flash_attention``, key padding included, so on CUDA
tensors it runs the hand-written flash kernels (#5 forward; #6 and #7
backward through its autograd Function) and on CPU tensors their plain
versions. Any other case takes the unfused composition over
``ops.softmax.fused_scale_mask_softmax`` in fp32, with the causal mask
folded into the padding mask. ``impl``: "auto" (that routing), "pallas"
(the fused path or raise, as in JAX; in the port it means the
hand-written kernel), "xla" (the unfused composition, the reference's
'default'). With ``include_norm_add`` the LayerNorm runs kernels #1 and
#2 on CUDA tensors. A key whose ``key_padding_mask`` entry is True is
masked; a query whose keys are all masked outputs zeros on the fused path
(and a uniform average on the unfused one, whose fill is -10000), as in
JAX.
"""

import math

import torch
from torch import nn

from apex_tpu_torch._kernels import resolve_device
from apex_tpu_torch.ops.attention import causal_mask, flash_attention
from apex_tpu_torch.ops.layer_norm import layer_norm
from apex_tpu_torch.ops.softmax import fused_scale_mask_softmax
from apex_tpu_torch.transformer.layer import keep_mask

__all__ = ["EncdecMultiheadAttn", "SelfMultiheadAttn"]

_IMPLS = ("auto", "pallas", "xla")


def _dropout(x, rate: float, generator):
    """``where(keep, x / (1 - rate), 0)``, the flax ``nn.Dropout``."""
    if generator is None:
        raise ValueError("dropout in training mode needs a generator")
    keep = keep_mask(generator, 1.0 - rate, x.shape, x.device)
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


def _attend(q, k, v, mask_additive_bias, key_padding_mask, dropout, scaling,
            deterministic, generator, causal=False, impl="auto"):
    """q, k, v: (b, h, s, d) -> (b, h, sq, d); see the module docstring."""
    if (mask_additive_bias is None and (dropout == 0.0 or deterministic)
            and impl != "xla"):
        return flash_attention(q, k, v, causal=causal, scale=scaling,
                               key_padding_mask=key_padding_mask)
    if impl == "pallas":
        # forcing the kernel must not quietly take the unfused path
        raise ValueError(
            "impl='pallas' requires the fused path: additive masks and "
            "active attention dropout only run on the unfused composition")
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scaling
    if mask_additive_bias is not None:
        s = s + mask_additive_bias.float()
    mask = None
    if key_padding_mask is not None:
        # (b, sk) True = masked, broadcast over heads and queries
        mask = key_padding_mask.bool()[:, None, None, :]
    if causal and mask is not None:
        # the causal softmax takes no explicit mask: fold it in
        mask = mask | causal_mask(s.shape[-2], s.shape[-1], s.device)
        causal = False
    probs = fused_scale_mask_softmax(s, mask, scale=1.0, causal=causal)
    if dropout > 0.0 and not deterministic:
        probs = _dropout(probs, dropout, generator)
    return torch.matmul(probs.to(q.dtype).float(), v.float()).to(q.dtype)


def _xavier_uniform(shape, gen):
    """flax's ``xavier_uniform`` of an (in, out) kernel."""
    bound = math.sqrt(6.0 / (shape[0] + shape[1]))
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound


class _MultiheadBase(nn.Module):
    """Parameters and the pieces both modules share."""

    def __init__(self, embed_dim, num_heads, dropout, bias,
                 include_norm_add, params_dtype, impl, device, seed):
        super().__init__()
        assert embed_dim % num_heads == 0, (
            "embed_dim must be divisible by num_heads")
        if impl not in _IMPLS:
            raise ValueError(f"unknown impl {impl!r}; expected one of "
                             f"{_IMPLS}")
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.dropout, self.bias = dropout, bias
        self.include_norm_add, self.impl = include_norm_add, impl
        self._dev = resolve_device(device)
        self._dtype = params_dtype
        self._gen = torch.Generator().manual_seed(seed)

    def _param(self, name, shape, init="xavier"):
        if init == "xavier":
            t = _xavier_uniform(shape, self._gen)
        else:
            t = torch.full(shape, 1.0 if init == "ones" else 0.0)
        self.register_parameter(name, nn.Parameter(
            t.to(device=self._dev, dtype=self._dtype)))

    def _norm_params(self):
        if self.include_norm_add:
            self._param("lyr_nrm_gamma", (self.embed_dim,), "ones")
            self._param("lyr_nrm_beta", (self.embed_dim,), "zeros")

    def _pre_norm(self, query):
        if not self.include_norm_add:
            return query
        return layer_norm(query, self.lyr_nrm_gamma.float(),
                          self.lyr_nrm_beta.float()).to(query.dtype)

    def _heads(self, t, b):
        """(s, b, e) -> (b, heads, s, head_dim)."""
        hd = self.embed_dim // self.num_heads
        return t.reshape(t.shape[0], b, self.num_heads, hd).permute(1, 2, 0,
                                                                    3)

    def _finish(self, ctx, residual, deterministic, generator):
        """(b, h, sq, hd) -> (sq, b, e), the output projection and the
        norm-add epilogue."""
        b, _, sq, _ = ctx.shape
        out = ctx.permute(2, 0, 1, 3).reshape(sq, b, self.embed_dim)
        out = out @ self.out_proj_weight.to(out.dtype)
        if self.bias:
            out = out + self.out_proj_bias.to(out.dtype)
        if self.include_norm_add:
            # the fused dropout-add epilogue (ref: jit_dropout_add); the
            # plain path returns the projection undropped, as the
            # reference does
            if self.dropout > 0.0 and not deterministic:
                out = _dropout(out, self.dropout, generator)
            out = residual + out
        return out


class SelfMultiheadAttn(_MultiheadBase):
    """(ref: self_multihead_attn.py:21) Input (seq, batch, embed_dim);
    parameters from ``seed`` on ``device``."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 bias: bool = False, include_norm_add: bool = False,
                 separate_qkv_params: bool = False,
                 mask_additive: bool = False, causal: bool = False,
                 params_dtype: torch.dtype = torch.float32,
                 impl: str = "auto", device="cuda", seed: int = 0):
        super().__init__(embed_dim, num_heads, dropout, bias,
                         include_norm_add, params_dtype, impl, device, seed)
        if mask_additive:
            assert not include_norm_add, (
                "additive mask not supported with layer norm")
        self.separate_qkv_params = separate_qkv_params
        self.mask_additive, self.causal = mask_additive, causal
        e = embed_dim
        if separate_qkv_params:
            for n in ("q", "k", "v"):
                self._param(f"{n}_weight", (e, e))
        else:
            self._param("in_proj_weight", (e, 3 * e))
        self._param("out_proj_weight", (e, e))
        if bias:
            if separate_qkv_params:
                for n in ("q", "k", "v"):
                    self._param(f"{n}_bias", (e,), "zeros")
            else:
                self._param("in_proj_bias", (3 * e,), "zeros")
            self._param("out_proj_bias", (e,), "zeros")
        self._norm_params()

    def forward(self, query, key_padding_mask=None, attn_mask=None,
                deterministic: bool = True, generator=None):
        """``key_padding_mask``: (batch, seq) bool, True = masked key;
        ``attn_mask``: (seq, seq) or broadcastable to (b, h, sq, sk), bool
        (True = masked) or, with ``mask_additive``, additive."""
        _, b, _ = query.shape
        hd = self.embed_dim // self.num_heads
        x = self._pre_norm(query)
        if self.separate_qkv_params:
            q, k, v = (x @ getattr(self, f"{n}_weight").to(x.dtype)
                       for n in ("q", "k", "v"))
            if self.bias:
                q, k, v = (t + getattr(self, f"{n}_bias").to(x.dtype)
                           for t, n in zip((q, k, v), ("q", "k", "v")))
        else:
            qkv = x @ self.in_proj_weight.to(x.dtype)
            if self.bias:
                qkv = qkv + self.in_proj_bias.to(x.dtype)
            q, k, v = qkv.chunk(3, dim=-1)
        additive = None
        if attn_mask is not None:
            additive = (attn_mask if self.mask_additive else torch.where(
                attn_mask.bool(), -1e30, 0.0))
            if additive.dim() == 2:
                additive = additive[None, None]
        kpm = None
        if key_padding_mask is not None:
            if self.mask_additive:
                pad = torch.where(key_padding_mask.bool(), -1e30,
                                  0.0)[:, None, None, :]
                additive = pad if additive is None else additive + pad
            else:
                kpm = key_padding_mask
        ctx = _attend(self._heads(q, b), self._heads(k, b),
                      self._heads(v, b), additive, kpm, self.dropout,
                      hd ** -0.5, deterministic, generator,
                      causal=self.causal, impl=self.impl)
        return self._finish(ctx, query, deterministic, generator)


class EncdecMultiheadAttn(_MultiheadBase):
    """(ref: encdec_multihead_attn.py) The query from the decoder, keys
    and values from the encoder through one packed KV projection; the two
    sequence lengths may differ."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 bias: bool = False, include_norm_add: bool = False,
                 params_dtype: torch.dtype = torch.float32,
                 impl: str = "auto", device="cuda", seed: int = 0):
        super().__init__(embed_dim, num_heads, dropout, bias,
                         include_norm_add, params_dtype, impl, device, seed)
        e = embed_dim
        self._param("q_weight", (e, e))
        self._param("kv_weight", (e, 2 * e))
        self._param("out_proj_weight", (e, e))
        if bias:
            self._param("q_bias", (e,), "zeros")
            self._param("kv_bias", (2 * e,), "zeros")
            self._param("out_proj_bias", (e,), "zeros")
        self._norm_params()

    def forward(self, query, key, key_padding_mask=None,
                deterministic: bool = True, generator=None):
        """``query``: (sq, batch, embed); ``key``: (sk, batch, embed), the
        encoder's output; ``key_padding_mask``: (batch, sk) bool."""
        _, b, _ = query.shape
        hd = self.embed_dim // self.num_heads
        x = self._pre_norm(query)
        q = x @ self.q_weight.to(x.dtype)
        kv = key @ self.kv_weight.to(key.dtype)
        if self.bias:
            q = q + self.q_bias.to(x.dtype)
            kv = kv + self.kv_bias.to(kv.dtype)
        k, v = kv.chunk(2, dim=-1)
        ctx = _attend(self._heads(q, b), self._heads(k, b),
                      self._heads(v, b), None, key_padding_mask,
                      self.dropout, hd ** -0.5, deterministic, generator,
                      impl=self.impl)
        return self._finish(ctx, query, deterministic, generator)
