"""RNN-Transducer joint and loss (counterpart of
apex_tpu/contrib/transducer.py; ref: apex.contrib.transducer's
TransducerJoint and TransducerLoss, whose numerical oracle is
contrib/transducer/_transducer_ref.py).

The loss takes RAW logits ``x: (B, T, U, V)``, applies ``log_softmax`` in
fp32 and runs the Graves alpha recursion

    alpha[t, u] = logaddexp(alpha[t-1, u] + log P(blank | t-1, u),
                            alpha[t, u-1] + log P(y_u   | t, u-1))

from ``alpha[0, 0] = 0``, with -1e30 for minus infinity as in JAX, and
returns ``loss[b] = -(alpha[f_len-1, y_len] + log P(blank | f_len-1,
y_len))``.

The JAX function scans over T with a nested scan over U: T x U steps of
a (B,) vector, which XLA compiles into one loop. Eager torch would launch
each of them. So the recursion here runs by **anti-diagonals**: cell
(t, u) reads only (t-1, u) and (t, u-1), which lie on the diagonal
before its own, so each of the T + U - 1 diagonals is one vectorised
``logaddexp`` over (B, T) cells (the diagonal indexed by t, its cells
past the grid held at -1e30). Both terms are the ones JAX adds, in the
same order, so the values agree with the scan's to rounding. Autograd
through the wavefront is the beta recursion, as JAX's autodiff through
the scan is. Cells past (f_len, y_len) are computed but never gathered,
so their gradients are zero. The math is plain torch (no Pallas kernel
in JAX).

``pack_output`` and ``packed_input`` (the reference's compaction of the
don't-care region) stay non-goals, as in JAX: the joint zeroes that
region instead, from ``f_len``/``g_len``.
"""

import torch

from apex_tpu_torch.transformer.layer import keep_mask

__all__ = ["TransducerJoint", "TransducerLoss", "transducer_joint",
           "transducer_loss"]

_NEG_INF = -1e30


def transducer_joint(f, g, f_len=None, g_len=None, relu: bool = False,
                     dropout_prob: float = 0.0, generator=None):
    """Broadcast-add joint: f (B, T, H) + g (B, U, H) -> (B, T, U, H).

    ``relu`` and dropout (drawn from ``generator``, a ``torch.Generator``
    on the tensors' device) are the reference's fused epilogues; with
    ``f_len``/``g_len`` the don't-care region is zeroed."""
    h = f[:, :, None, :] + g[:, None, :, :]
    if relu:
        h = torch.relu(h)
    if dropout_prob > 0.0:
        if generator is None:
            raise ValueError("dropout_prob > 0 requires a generator")
        keep = keep_mask(generator, 1.0 - dropout_prob, h.shape, h.device)
        h = torch.where(keep, h / (1.0 - dropout_prob), 0.0)
    if f_len is not None:
        t = torch.arange(h.shape[1], device=h.device)
        h = torch.where((t[None, :] < f_len[:, None])[:, :, None, None], h,
                        0.0)
    if g_len is not None:
        u = torch.arange(h.shape[2], device=h.device)
        h = torch.where((u[None, :] < g_len[:, None])[:, None, :, None], h,
                        0.0)
    return h


def _diagonals(t_max: int, u_max: int, device):
    """(t index (1, T), u = d - t (D, T) clamped into the grid, valid
    (D, T)) of the D = T + U - 1 anti-diagonals."""
    t = torch.arange(t_max, device=device)[None, :]
    u = torch.arange(t_max + u_max - 1, device=device)[:, None] - t
    valid = (u >= 0) & (u < u_max)
    return t, u.clamp(0, u_max - 1), valid


def transducer_loss(x, label, f_len, y_len, blank_idx: int):
    """Per-batch RNN-T negative log-likelihood; see the module docstring.

    x: (B, T, U, V) raw logits; label: (B, U-1) int; f_len, y_len: (B,)
    int. Returns (B,) fp32 losses."""
    b, t_max, u_max, _ = x.shape
    lp = torch.log_softmax(x.float(), dim=-1)
    blank_lp = lp[..., blank_idx]  # (B, T, U)
    # y_lp[b, t, u] = log P(label[b, u] | t, u); u = U-1 is never read
    label_pad = torch.cat([label.long(), label.new_zeros((b, 1)).long()],
                          dim=1)
    y_lp = lp.gather(-1, label_pad[:, None, :, None].expand(
        b, t_max, u_max, 1))[..., 0]

    t_idx, u_idx, valid = _diagonals(t_max, u_max, x.device)
    # skewed onto the diagonals: (B, D, T), diagonal d at position t
    blank_d = blank_lp[:, t_idx, u_idx]
    y_d = y_lp[:, t_idx, (u_idx - 1).clamp_min(0)]
    neg = torch.full((b, 1), _NEG_INF, device=x.device)
    # diagonal 0 holds alpha[0, 0] = 0 alone
    alpha = torch.where(valid[0] & (t_idx[0] == 0), 0.0,
                        _NEG_INF).expand(b, t_max)
    diagonals = [alpha]
    for d in range(1, t_max + u_max - 1):
        # from below: alpha[t-1, u] + blank[t-1, u], the previous diagonal
        # one position back; from the left: alpha[t, u-1] + y[t, u-1]
        below = torch.cat([neg, alpha[:, :-1] + blank_d[:, d - 1, :-1]],
                          dim=1)
        # the left term exists where u = d - t >= 1; at u = 0 JAX adds its
        # -1e30 carry to its -1e30 shifted label term
        left = torch.where(u_idx[d] >= 1, alpha + y_d[:, d],
                           2 * _NEG_INF)
        alpha = torch.where(valid[d], torch.logaddexp(below, left),
                            _NEG_INF)
        diagonals.append(alpha)
    alpha = torch.stack(diagonals, dim=1)  # (B, D, T)
    batch = torch.arange(b, device=x.device)
    t_end = (f_len - 1).long()
    u_end = y_len.long()
    final_alpha = alpha[batch, t_end + u_end, t_end]
    final_blank = blank_lp[batch, t_end, u_end]
    return -(final_alpha + final_blank)


class TransducerJoint:
    """Module-form parity (ref: transducer.py:5). ``pack_output`` is
    refused (see the module docstring); relu and dropout mirror the fused
    epilogues."""

    def __init__(self, pack_output: bool = False, relu: bool = False,
                 dropout: bool = False, dropout_prob: float = 0.0):
        if pack_output:
            raise NotImplementedError(
                "pack_output is a CUDA-memory-layout optimization; use "
                "f_len/g_len masking instead")
        self.relu, self.dropout = relu, dropout
        self.dropout_prob = dropout_prob

    def __call__(self, f, g, f_len=None, g_len=None, generator=None):
        return transducer_joint(
            f, g, f_len=f_len, g_len=g_len, relu=self.relu,
            dropout_prob=self.dropout_prob if self.dropout else 0.0,
            generator=generator)


class TransducerLoss:
    """Module-form parity (ref: transducer.py:68)."""

    def __init__(self, packed_input: bool = False):
        if packed_input:
            raise NotImplementedError(
                "packed_input is a CUDA-memory-layout optimization; the "
                "loss ignores cells beyond (f_len, y_len) at no extra cost")

    def __call__(self, x, label, f_len, y_len, blank_idx: int):
        return transducer_loss(x, label, f_len, y_len, blank_idx)
