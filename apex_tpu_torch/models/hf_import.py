"""transformers Llama / Mistral weight import and export (counterpart of
the Llama half of apex_tpu/models/hf_import.py).

A Llama is the port's ``GPTModel`` with RMSNorm, rotate-half RoPE (the
convention of ``ops/rope.py``, so the weights map with no head
permutation), SwiGLU, bias-free linears, GQA and an untied head. The
inputs are duck-typed, so nothing here imports ``transformers``: a
config object with ``LlamaConfig``'s attribute names, and a torch
``state_dict`` with the transformers key names (or a model that has
``.config`` and ``.state_dict()``).

Packing, as in the JAX package (torch ``Linear`` stores ``(out, in)``,
the port's kernels ``(in, out)``):
- ``k_proj``/``v_proj`` -> one ``key_value`` kernel packed per KV group
  as ``[k_g | v_g]``, the (s, b, g, 2 * hn) split of ``ParallelAttention``;
  a config with as many KV heads as heads has no separate ``query``
  projection in the port, so its q/k/v go into ``query_key_value``
  packed per head as ``[q_h | k_h | v_h]``;
- ``gate_proj``/``up_proj`` -> one ``dense_h_to_4h`` kernel ``[gate | up]``.
"""

from typing import Dict

import torch

__all__ = ["config_from_hf_llama", "llama_from_hf", "mistral_from_hf",
           "params_from_hf_llama", "params_to_hf_llama"]

Tensors = Dict[str, torch.Tensor]


def config_from_hf_llama(hf_config, **overrides):
    """The port's TransformerConfig matching a transformers LlamaConfig
    (fp32 compute, for checkpoint parity, unless overridden)."""
    from apex_tpu_torch.transformer import TransformerConfig

    kw = dict(
        num_layers=hf_config.num_hidden_layers,
        hidden_size=hf_config.hidden_size,
        num_attention_heads=hf_config.num_attention_heads,
        num_query_groups=hf_config.num_key_value_heads,
        # an explicit head_dim (Mistral-Nemo style) may differ from
        # hidden / heads
        kv_channels=getattr(hf_config, "head_dim", None),
        ffn_hidden_size=hf_config.intermediate_size,
        vocab_size=hf_config.vocab_size,
        max_position_embeddings=hf_config.max_position_embeddings,
        layernorm_epsilon=hf_config.rms_norm_eps,
        hidden_dropout=0.0,
        attention_dropout=0.0,
        normalization="rmsnorm",
        activation="swiglu",
        add_bias_linear=False,
        position_embedding_type="rope",
        rotary_base=getattr(hf_config, "rope_theta", 10000.0),
        share_embeddings_and_output_weights=bool(
            getattr(hf_config, "tie_word_embeddings", False)),
        apply_query_key_layer_scaling=False,
        compute_dtype=torch.float32,
    )
    kw.update(overrides)
    return TransformerConfig(**kw)


def _heads(hf_config):
    heads, g = hf_config.num_attention_heads, hf_config.num_key_value_heads
    hn = getattr(hf_config, "head_dim", None) or hf_config.hidden_size // heads
    return heads, g, hn


def _lin(w):  # torch Linear (out, in) -> kernel (in, out), and back
    return w.t().contiguous()


def params_from_hf_llama(state_dict: Tensors, hf_config) -> Tensors:
    """The port's ``GPTModel`` state_dict from a transformers Llama
    ``state_dict`` and its config."""
    heads, g, hn = _heads(hf_config)
    sd = {k: v.detach() for k, v in state_dict.items()}
    kw = sd["model.layers.0.self_attn.k_proj.weight"]
    if kw.shape[0] != g * hn:
        raise ValueError(
            f"k_proj out dim {kw.shape[0]} != kv_heads*head_dim {g}*{hn}: "
            "unexpected head layout for the llama/mistral mapping")
    out = {
        "embedding.word_embeddings.embedding": sd["model.embed_tokens.weight"],
        "transformer.final_layernorm.scale": sd["model.norm.weight"],
    }
    if not getattr(hf_config, "tie_word_embeddings", False):
        out["output_layer.kernel"] = _lin(sd["lm_head.weight"])
    for i in range(hf_config.num_hidden_layers):
        src, dst = f"model.layers.{i}.", f"transformer.layer_{i}."
        wq, wk, wv = (sd[src + f"self_attn.{n}_proj.weight"].t()
                      for n in ("q", "k", "v"))
        if g == heads:
            out[dst + "self_attention.query_key_value.kernel"] = torch.stack(
                [w.reshape(-1, heads, hn) for w in (wq, wk, wv)], dim=2
            ).reshape(-1, 3 * heads * hn)
        else:
            out[dst + "self_attention.query.kernel"] = wq.contiguous()
            out[dst + "self_attention.key_value.kernel"] = torch.stack(
                [wk.reshape(-1, g, hn), wv.reshape(-1, g, hn)], dim=2
            ).reshape(-1, 2 * g * hn)  # per group [k_g | v_g]
        out[dst + "self_attention.dense.kernel"] = _lin(
            sd[src + "self_attn.o_proj.weight"])
        out[dst + "input_layernorm.scale"] = sd[src + "input_layernorm.weight"]
        out[dst + "post_attention_layernorm.scale"] = sd[
            src + "post_attention_layernorm.weight"]
        out[dst + "mlp.dense_h_to_4h.kernel"] = torch.cat(
            [_lin(sd[src + "mlp.gate_proj.weight"]),
             _lin(sd[src + "mlp.up_proj.weight"])], dim=1)
        out[dst + "mlp.dense_4h_to_h.kernel"] = _lin(
            sd[src + "mlp.down_proj.weight"])
    return out


def llama_from_hf(hf_model, device="cuda", seed: int = 0,
                  **config_overrides):
    """A ``GPTModel`` on ``device`` functionally equal to the given
    transformers Llama (or Mistral: the same weights, plus sliding-window
    attention when its config carries a ``sliding_window``)."""
    from apex_tpu_torch.models.gpt import GPTModel

    window = getattr(hf_model.config, "sliding_window", None)
    if window is not None:
        config_overrides.setdefault("attention_window", window)
    cfg = config_from_hf_llama(hf_model.config, **config_overrides)
    model = GPTModel(cfg, device=device, seed=seed)
    model.load_state_dict(
        params_from_hf_llama(hf_model.state_dict(), hf_model.config))
    return model


# the same schema (mistral = llama weights + sliding window)
mistral_from_hf = llama_from_hf


def params_to_hf_llama(params, hf_model) -> None:
    """Load the port's Llama ``state_dict`` (or a ``GPTModel``) back INTO
    ``hf_model``, in place: the inverse of :func:`params_from_hf_llama`."""
    p = params.state_dict() if hasattr(params, "state_dict") else params
    cfg = hf_model.config
    heads, g, hn = _heads(cfg)
    ffn = cfg.intermediate_size
    sd = {
        "model.embed_tokens.weight": p["embedding.word_embeddings.embedding"],
        "model.norm.weight": p["transformer.final_layernorm.scale"],
    }
    if "output_layer.kernel" in p:
        sd["lm_head.weight"] = _lin(p["output_layer.kernel"])
    for i in range(cfg.num_hidden_layers):
        src, dst = f"transformer.layer_{i}.", f"model.layers.{i}."
        if g == heads:
            qkv = p[src + "self_attention.query_key_value.kernel"]
            qkv = qkv.reshape(-1, heads, 3, hn)
            q, k, v = (qkv[:, :, j].reshape(-1, heads * hn) for j in range(3))
        else:
            q = p[src + "self_attention.query.kernel"]
            kv = p[src + "self_attention.key_value.kernel"].reshape(-1, g, 2, hn)
            k, v = (kv[:, :, j].reshape(-1, g * hn) for j in range(2))
        for name, w in (("q", q), ("k", k), ("v", v)):
            sd[dst + f"self_attn.{name}_proj.weight"] = _lin(w)
        sd[dst + "self_attn.o_proj.weight"] = _lin(
            p[src + "self_attention.dense.kernel"])
        sd[dst + "input_layernorm.weight"] = p[src + "input_layernorm.scale"]
        sd[dst + "post_attention_layernorm.weight"] = p[
            src + "post_attention_layernorm.scale"]
        h4 = p[src + "mlp.dense_h_to_4h.kernel"]  # (h, 2 * ffn)
        sd[dst + "mlp.gate_proj.weight"] = _lin(h4[:, :ffn])
        sd[dst + "mlp.up_proj.weight"] = _lin(h4[:, ffn:])
        sd[dst + "mlp.down_proj.weight"] = _lin(
            p[src + "mlp.dense_4h_to_h.kernel"])
    sd = {k: v.detach().cpu() for k, v in sd.items()}
    _, unexpected = hf_model.load_state_dict(sd, strict=False)
    # rotary inv_freq buffers and the like may be "missing" (they are
    # derived); anything unexpected means the mapping drifted
    if unexpected:
        raise ValueError(f"unexpected keys in export: {unexpected}")
