"""Rotary position embedding (counterpart of apex_tpu/ops/rope.py).

The same functions and rules as the JAX package: ``t`` is (seq, batch,
heads, head_dim), the angles are (seq, 1, 1, rot_dim) with the two
halves duplicated (rotate-half convention), the math is fp32 and the
output keeps t's dtype, and channels past ``rot_dim`` pass through.

The JAX package has no Pallas kernel here (XLA fuses the elementwise
chain into the projections around it), so this stays plain PyTorch and
autograd differentiates it. The model applies the cached form: it
builds cos and sin tables of :func:`rope_frequencies`' angles once and
gathers each call's rows by position, so the rows of one batch may sit
at different positions (the engine's lanes).
"""

import torch

__all__ = ["apply_rotary_pos_emb", "apply_rotary_pos_emb_cached",
           "rope_frequencies"]


def rope_frequencies(dim: int, seq_len: int, base: float = 10000.0,
                     dtype=torch.float32, device=None):
    """The (seq, 1, 1, dim) angle tensor: position t times the fp32
    inverse frequencies ``1 / base ** (arange(0, dim, 2) / dim)``,
    duplicated across the halves."""
    inv_freq = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                            device=device) / dim))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)  # (seq, dim/2)
    emb = torch.cat([freqs, freqs], dim=-1)  # (seq, dim)
    return emb[:, None, None, :].to(dtype)


def _rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rotary_pos_emb_cached(t, cos_, sin_):
    """RoPE from precomputed cos/sin (ref: fused_apply_rotary_pos_emb_cached):
    ``cos_``/``sin_`` broadcast against t's first ``rot_dim`` channels,
    (s, 1, 1, rot_dim) or, with a position per row, (s, b, 1, rot_dim)."""
    rot_dim = cos_.shape[-1]
    t_rot, t_pass = t[..., :rot_dim], t[..., rot_dim:]
    tr = t_rot.float()
    out = (tr * cos_.float() + _rotate_half(tr) * sin_.float()).to(t.dtype)
    if t_pass.shape[-1] == 0:
        return out
    return torch.cat([out, t_pass], dim=-1)


def apply_rotary_pos_emb(t, freqs):
    """Apply RoPE with angles ``freqs`` to the first ``rot_dim =
    freqs.shape[-1]`` channels of ``t``; cos and sin are taken here in
    fp32, as the JAX function takes them."""
    f = freqs.float()
    return apply_rotary_pos_emb_cached(t, torch.cos(f), torch.sin(f))
