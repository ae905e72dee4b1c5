"""Autoregressive decoding (counterpart of apex_tpu/models/generate.py).

``use_cache=True`` (default): one prefill fills a :class:`KVCache`, then
each new token runs the model at sequence length 1 against it through
the flash kernel's key-padding path. ``use_cache=False`` recomputes the
prefix every step and is the reference the cache is tested against.

Sampling draws from an explicit ``torch.Generator`` on the model's
device; greedy decoding needs none. ``beam_search`` is fixed-width beam
search over the same cache, reordering its rows to follow the beams.
"""

from typing import Optional

import torch

from apex_tpu_torch._kernels import resolve_device

__all__ = ["beam_search", "generate", "sample_next_token"]


def _filter_logits(next_logits, top_k, top_p):
    """Top-k / nucleus truncation: logits outside the kept set become
    -inf. ``top_k >= vocab`` and ``top_p >= 1`` are exact no-ops;
    ``top_k < 1`` and ``top_p <= 0`` are refused (the JAX contract)."""
    if top_k is not None:
        if top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k}")
        if top_k >= next_logits.shape[-1]:
            top_k = None
    if top_p is not None:
        if top_p <= 0.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if top_p >= 1.0:
            top_p = None
    if top_k is not None:
        kth = torch.topk(next_logits, top_k, dim=-1).values[:, -1:]
        next_logits = next_logits.masked_fill(next_logits < kth, -torch.inf)
    if top_p is not None:
        sorted_desc = torch.sort(next_logits, dim=-1, descending=True).values
        csum = torch.cumsum(torch.softmax(sorted_desc, dim=-1), dim=-1)
        # keep the smallest prefix with cumulative prob >= top_p; the
        # shifted comparison always keeps the top token
        keep = torch.roll(csum < top_p, 1, dims=-1)
        keep[:, 0] = True
        kept = keep.sum(dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_desc, -1, kept - 1)
        next_logits = next_logits.masked_fill(next_logits < cutoff, -torch.inf)
    return next_logits


def _sample(logits, generator):
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _select_next(next_logits, temperature: float, generator, top_k=None,
                 top_p=None):
    if temperature > 0.0:
        # temperature before truncation (the HF warper order)
        return _sample(_filter_logits(next_logits / temperature, top_k, top_p),
                       generator)
    return torch.argmax(next_logits, dim=-1)


def sample_next_token(next_logits, temperature, generator, top_k=None,
                      top_p=None):
    """One token per row with a per-row ``temperature`` tensor (0 =
    greedy): both the greedy argmax and the tempered, filtered sample
    are computed and picked per row, as the JAX engine's batched step
    does. ``next_logits``: (b, v); returns (b,) token ids."""
    logits = next_logits.float()
    temperature = torch.as_tensor(temperature, dtype=torch.float32,
                                  device=logits.device).reshape(-1)
    safe_t = temperature.clamp_min(1e-6)[:, None]
    sampled = _sample(_filter_logits(logits / safe_t, top_k, top_p), generator)
    greedy = torch.argmax(logits, dim=-1)
    return torch.where(temperature > 0.0, sampled, greedy)


def _check_position_bound(model, s, max_new_tokens):
    max_pos = model.config.max_position_embeddings
    if max_pos and s + max_new_tokens > max_pos:
        raise ValueError(
            f"prompt ({s}) + max_new_tokens ({max_new_tokens}) exceeds the "
            f"model's max_position_embeddings ({max_pos})"
        )


@torch.no_grad()
def generate(model, prompt_tokens, max_new_tokens: int,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             use_cache: bool = True, top_k: Optional[int] = None,
             top_p: Optional[float] = None, device="cuda"):
    """Continue ``prompt_tokens`` ((b, s) ints) by ``max_new_tokens`` on
    ``device`` (where ``model`` must live). ``temperature == 0``: greedy.
    Otherwise sampling from ``generator``, optionally truncated to
    ``top_k`` / ``top_p``. Returns (b, s + max_new_tokens) int64."""
    device = resolve_device(device)
    if model.device != device:
        raise ValueError(f"model is on {model.device}, generate asked for "
                         f"{device}")
    prompt = torch.as_tensor(prompt_tokens, device=device).long()
    b, s = prompt.shape
    if max_new_tokens <= 0:
        return prompt
    _check_position_bound(model, s, max_new_tokens)
    if temperature > 0.0 and generator is None:
        raise ValueError("sampling (temperature > 0) requires a generator")
    total = s + max_new_tokens
    buf = torch.zeros((b, total), dtype=torch.long, device=device)
    buf[:, :s] = prompt

    def pick(logits):
        return _select_next(logits.float(), temperature, generator, top_k, top_p)

    if use_cache:
        cache = model.new_cache(b, total)
        nxt = pick(model(prompt, cache=cache)[:, s - 1])
        buf[:, s] = nxt
        for cur in range(s + 1, total):
            nxt = pick(model(nxt[:, None], cache=cache, decode_step=True)[:, 0])
            buf[:, cur] = nxt
        return buf
    for cur in range(s, total):
        # causal: the prefix alone gives position cur - 1's logits
        buf[:, cur] = pick(model(buf[:, :cur])[:, cur - 1])
    return buf


def _top_k(x, k: int):
    """``(values, indices)`` of the ``k`` largest entries of each row,
    best first, an exact tie broken toward the lower index as
    ``jax.lax.top_k`` breaks it (``torch.topk`` leaves the order of ties
    unspecified, and the card's and the CPU's differ)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


@torch.no_grad()
def beam_search(model, prompt_tokens, max_new_tokens: int, num_beams: int,
                length_penalty: float = 1.0, device="cuda"):
    """Beam-search decoding over the KV cache, on ``device`` (where
    ``model`` must live).

    The prompt is prefilled once per batch row and the cache's rows are
    tiled to ``b * num_beams`` beams (``repeat_interleave``: row r ->
    beams r k .. r k + k - 1). Every step scores the (b, k * vocab) joint
    log-probs, keeps the top ``num_beams`` per row (an exact tie goes to
    the lower index, as in JAX), and reorders the
    cache's ``k``, ``v`` and ``index`` rows to follow the winning beams
    (``index_select``, HF's ``_reorder_cache``). Returns ``(tokens,
    scores)``: tokens (b, num_beams, s + max_new_tokens) int64 sorted
    best-first, scores (b, num_beams) fp32, the sequence log-probs over
    ``(s + max_new_tokens) ** length_penalty`` (HF's BeamHypotheses
    divides by the FULL length, prompt included). No early stopping and
    no EOS: generation always runs ``max_new_tokens`` steps.
    """
    if num_beams < 1:
        raise ValueError(f"num_beams must be >= 1, got {num_beams}")
    device = resolve_device(device)
    if model.device != device:
        raise ValueError(f"model is on {model.device}, beam_search asked "
                         f"for {device}")
    prompt = torch.as_tensor(prompt_tokens, device=device).long()
    b, s = prompt.shape
    k = num_beams
    if max_new_tokens <= 0:
        return (prompt[:, None, :].expand(b, k, s).clone(),
                torch.zeros((b, k), dtype=torch.float32, device=device))
    _check_position_bound(model, s, max_new_tokens)
    total = s + max_new_tokens

    cache = model.new_cache(b, total)
    logp0 = torch.log_softmax(model(prompt, cache=cache)[:, s - 1].float(),
                              dim=-1)
    vocab = logp0.shape[-1]
    first_scores, first_tokens = _top_k(logp0, k)  # (b, k), best first
    cache.k = cache.k.repeat_interleave(k, dim=1)
    cache.v = cache.v.repeat_interleave(k, dim=1)
    cache.index = cache.index.repeat_interleave(k)
    buf = torch.zeros((b * k, total), dtype=torch.long, device=device)
    buf[:, :s] = prompt.repeat_interleave(k, dim=0)
    tok = first_tokens.reshape(b * k)
    buf[:, s] = tok
    scores = first_scores.reshape(b * k)  # cumulative log-prob per beam
    base = (torch.arange(b, device=device) * k)[:, None]
    for cur in range(s + 1, total):
        logits = model(tok[:, None], cache=cache, decode_step=True)[:, 0]
        logp = torch.log_softmax(logits.float(), dim=-1)
        joint = (scores[:, None] + logp).reshape(b, k * vocab)
        best, flat = _top_k(joint, k)  # (b, k)
        rows = (base + torch.div(flat, vocab, rounding_mode="floor")
                ).reshape(b * k)
        tok = (flat % vocab).reshape(b * k)
        # follow the winning beams: history, cache rows and scores
        buf = buf.index_select(0, rows)
        cache.k = cache.k.index_select(1, rows)
        cache.v = cache.v.index_select(1, rows)
        cache.index = cache.index.index_select(0, rows)
        buf[:, cur] = tok
        scores = best.reshape(b * k)
    norm = scores / (total ** length_penalty)
    return buf.reshape(b, k, total), norm.reshape(b, k)
