"""Flash attention (counterpart of apex_tpu/ops/attention.py).

``flash_attention(q, k, v)`` takes (batch, heads, seq, head_dim) tensors,
with causal masking, a (b, sk) key-padding mask, a sliding window, GQA
(k/v with fewer heads) and an explicit scale, like the JAX function.
Device rule instead of the JAX ``impl=`` switch: on CUDA tensors it
launches the hand-written kernels (``csrc/flash_attention.cu`` forward,
with a split-KV decode kernel for sq = 1 whose split count
:func:`_decode_splits` picks, ``csrc/flash_attention_bwd.cu`` dq and
dk/dv), on CPU tensors it runs their plain versions
:func:`_flash_fwd_ref` and :func:`_flash_bwd_ref`.
A dense ``mask`` goes to :func:`_attn_ref` on either device, as it goes
to ``_attn_ref`` in JAX, and autograd differentiates it there.

When a gradient is wanted, the kernels run inside :class:`_FlashFn`
(the JAX ``custom_vjp`` around ``_flash``): the forward saves q, k, v,
the key-padding mask, o and the fp32 log-sum-exp; the backward computes
delta = rowsum(dO * o) in plain torch, as ``_flash_bwd`` does outside
its kernels, then launches the dq and the dk/dv kernel. The mask gets no
gradient.

The JAX package's ``_attn_blockwise`` has no counterpart: it routes
around the TPU kernel's K/V residency limit, and the CUDA kernel streams
K/V tiles through shared memory, so it has no such limit.
"""

import math

import torch

from apex_tpu_torch import _kernels
from apex_tpu_torch._cast_state import casts_disabled

__all__ = ["causal_mask", "flash_attention", "window_mask"]

_NEG_INF = -1e30


def window_mask(sq: int, sk: int, window: int, device=None):
    """(sq, sk) bool mask, True = beyond the sliding window's lower edge
    (bottom-right aligned like :func:`causal_mask`)."""
    col = torch.arange(sk, device=device)[None, :]
    row = torch.arange(sq, device=device)[:, None]
    return col <= row + (sk - sq) - window


def causal_mask(sq: int, sk: int, device=None):
    """(sq, sk) bool mask, True = masked out. Bottom-right aligned: with
    sk > sq the queries sit at the end of the key sequence."""
    col = torch.arange(sk, device=device)[None, :]
    row = torch.arange(sq, device=device)[:, None]
    return col > row + (sk - sq)


def _attn_ref(q, k, v, scale, causal, mask=None, window=None):
    """Plain attention, the JAX package's ``_attn_ref``: scores in fp32,
    P cast to q's dtype before P.V, and a row whose keys are all masked
    outputs 0."""
    h, h_kv = q.shape[1], k.shape[1]
    if h_kv != h:
        k = k.repeat_interleave(h // h_kv, dim=1)
        v = v.repeat_interleave(h // h_kv, dim=1)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    sq, sk = s.shape[-2], s.shape[-1]
    if causal:
        s = s.masked_fill(causal_mask(sq, sk, s.device), _NEG_INF)
    if window is not None:
        s = s.masked_fill(window_mask(sq, sk, window, s.device), _NEG_INF)
    if mask is not None:
        s = s.masked_fill(mask, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.matmul(p.to(q.dtype).float(), v.float()).to(q.dtype)
    dead = (s <= _NEG_INF * 0.5).all(dim=-1, keepdim=True)
    return out.masked_fill(dead, 0)


def _keep_mask(sq, sk, causal, window, key_padding_mask, device):
    """Bool (b or 1, 1, sq, sk), True where a query attends a key."""
    keep = torch.ones((1, 1, sq, sk), dtype=torch.bool, device=device)
    if causal:
        keep = keep & ~causal_mask(sq, sk, device)
    if window is not None:
        keep = keep & ~window_mask(sq, sk, window, device)
    if key_padding_mask is not None:
        keep = keep & ~key_padding_mask.bool()[:, None, None, :]
    return keep


def _flash_fwd_ref(q, k, v, scale, causal, key_padding_mask=None,
                   window=None):
    """Plain (o, lse): o from :func:`_flash_ref`, lse the fp32
    log-sum-exp of the kept scaled scores, +1e30 on a row whose keys are
    all masked (the kernel's dead-row sentinel)."""
    o = _flash_ref(q, k, v, scale, causal, None, key_padding_mask, window)
    group = q.shape[1] // k.shape[1]
    s = torch.matmul(q.float(), k.repeat_interleave(group, dim=1).float()
                     .transpose(-1, -2)) * scale
    keep = _keep_mask(s.shape[-2], s.shape[-1], causal, window,
                      key_padding_mask, s.device)
    lse = torch.logsumexp(s.masked_fill(~keep, -math.inf), dim=-1)
    return o, lse.masked_fill(~keep.any(dim=-1), -_NEG_INF)


def _flash_bwd_ref(q, k, v, do, lse, delta, scale, causal,
                   key_padding_mask=None, window=None):
    """Plain (dq, dk, dv), the recompute formulas of the dq and dk/dv
    kernels with the whole score matrix: p = exp(s * scale - lse) where
    kept, ds = p * (dp - delta) * scale; p and ds are rounded to q's
    dtype before the products, as the TPU kernels round them. GQA sums
    dk and dv over each kv head's query group."""
    b, h, sq, d = q.shape
    h_kv, sk = k.shape[1], k.shape[2]
    group = h // h_kv
    kf = k.repeat_interleave(group, dim=1).float()
    vf = v.repeat_interleave(group, dim=1).float()
    qf, dof = q.float(), do.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    keep = _keep_mask(sq, sk, causal, window, key_padding_mask, s.device)
    p = torch.where(keep, torch.exp(s - lse[..., None]), 0.0)
    dv = torch.matmul(p.to(q.dtype).float().transpose(-1, -2), dof)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype).float()
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    if group > 1:
        dk = dk.reshape(b, h_kv, group, sk, d).sum(dim=2)
        dv = dv.reshape(b, h_kv, group, sk, d).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# What the CUDA kernels take: any head_dim (64, 128 and 256 have kernels of
# their own, a smaller one is zero-padded to the next, and one past 256
# takes the wide route of csrc/flash_wide.cuh), and any number of query or
# key tiles: the grids hold at most 65535 on y and z, past which each block
# walks several. batch * heads rides x, which holds 2^31 - 1 blocks.


def _check_kernel_args(q, k, v, key_padding_mask):
    """Raises on what the CUDA kernels do not take; returns the int32
    (b, sk) key-padding row or None."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    _kernels.dtype_code(q)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (k.is_cuda and v.is_cuda):
        raise ValueError("q, k and v must all be CUDA tensors")
    if key_padding_mask is None:
        return None
    if tuple(key_padding_mask.shape) != (b, sk):
        raise ValueError(f"key_padding_mask shape "
                         f"{tuple(key_padding_mask.shape)} is not "
                         f"({b}, {sk})")
    return key_padding_mask.to(device=q.device, dtype=torch.int32).contiguous()


# The bf16 decode kernel (sq = 1) gives each (batch, kv head) pair a block
# whose rows are the pair's query heads (16 a block), so each K/V tile is
# read once for the whole GQA group. At small batch those blocks are too few
# to fill the card, so the pair's 64-key tiles are split over more blocks
# until there are at least _MIN_DECODE_BLOCKS (three on each of the H100's
# 132 SMs: the fastest of 264, 396 and 528 at the GPT-2 and Llama serving
# shapes, PERF.md), at most _MAX_DECODE_SPLITS (the portable cluster size:
# a pair's splits run as one cluster, whose blocks merge their partials
# from each other's shared memory in split order, so repeated calls stay
# bit-equal).
_MIN_DECODE_BLOCKS = 396
_MAX_DECODE_SPLITS = 8


def _decode_splits(q, k) -> int:
    """The number of blocks that share one (batch, kv head) pair's keys in
    the decode kernel, from the shapes alone; 1 outside bf16 decode (sq = 1),
    which the prefill and fp32 kernels serve."""
    b, h, sq, _ = q.shape
    h_kv, sk = k.shape[1], k.shape[2]
    if q.dtype != torch.bfloat16 or sq != 1 or sk == 0:
        return 1
    blocks = b * h_kv * -(-(h // h_kv) // 16)
    tiles = -(-sk // 64)
    want = min(-(-_MIN_DECODE_BLOCKS // blocks), _MAX_DECODE_SPLITS, tiles)
    per = -(-tiles // want)  # tiles a split holds
    return -(-tiles // per)


def _flash_decode_split_ref(q, k, v, scale, causal, key_padding_mask=None,
                            window=None, splits=1):
    """Plain (o, lse) of a decode step (sq = 1) computed as the split
    kernel computes it: each split's 64-key tiles give partials (the row max
    m, the row sum l, the unnormalised o) over the keys the masks keep, and
    the splits merge in split order. A split with no kept key adds nothing;
    a row with none anywhere is o = 0, lse = +1e30."""
    b, h, sq, d = q.shape
    h_kv, sk = k.shape[1], k.shape[2]
    group = h // h_kv
    s = torch.matmul(q.float(), k.repeat_interleave(group, dim=1).float()
                     .transpose(-1, -2)) * scale  # (b, h, 1, sk)
    keep = _keep_mask(sq, sk, causal, window, key_padding_mask, s.device)
    keep = keep.expand(b, h, sq, sk)
    vf = v.repeat_interleave(group, dim=1).float()
    tiles = -(-sk // 64)
    per = -(-tiles // splits) * 64  # keys a split holds, as in the kernel
    m = torch.full((b, h, sq, 1), _NEG_INF, device=s.device)
    l = torch.zeros((b, h, sq, 1), device=s.device)
    acc = torch.zeros((b, h, sq, d), device=s.device)
    for lo in range(0, sk, per):
        ks = keep[..., lo:lo + per]
        live = ks.any(dim=-1, keepdim=True)
        ss = s[..., lo:lo + per].masked_fill(~ks, -math.inf)
        ms = torch.where(live, ss.amax(dim=-1, keepdim=True), _NEG_INF)
        p = torch.exp(ss - ms).masked_fill(~ks, 0.0)
        ls = p.sum(dim=-1, keepdim=True)
        os = torch.matmul(p.to(v.dtype).float(), vf[..., lo:lo + per, :])
        m_new = torch.maximum(m, ms)
        a_old = torch.where(m > _NEG_INF * 0.5, torch.exp(m - m_new), 0.0)
        a_new = torch.where(live, torch.exp(ms - m_new), 0.0)
        l = l * a_old + ls * a_new
        acc = acc * a_old + os * a_new
        m = m_new
    dead = m <= _NEG_INF * 0.5
    o = torch.where(dead, 0.0, acc / l.clamp_min(1e-30)).to(q.dtype)
    lse = torch.where(dead, -_NEG_INF, m + torch.log(l.clamp_min(1e-30)))
    return o, lse[..., 0]


def _flash_kernel(q, k, v, scale, causal, key_padding_mask=None,
                  window=None):
    """(o, lse) from the CUDA kernel; o like q, lse fp32 (b, h, sq)."""
    b, h, sq, d = q.shape
    h_kv, sk = k.shape[1], k.shape[2]
    kpm = _check_kernel_args(q, k, v, key_padding_mask)
    code = _kernels.dtype_code(q)
    q3 = q.reshape(b * h, sq, d).contiguous()
    k3 = k.reshape(b * h_kv, sk, d).contiguous()
    v3 = v.reshape(b * h_kv, sk, d).contiguous()
    o = torch.empty_like(q3)
    lse = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    _kernels.FLASH_FWD(
        q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
        None if kpm is None else kpm.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b * h, sq, sk, d, h, h // h_kv, _decode_splits(q, k),
        float(scale), int(causal), int(window or 0), code,
    )
    return o.reshape(b, h, sq, d), lse.reshape(b, h, sq)


# The bf16 dk/dv kernel's blocks each own 64 keys of one kv head and loop
# over its query heads. Under a causal mask the first keys' blocks run
# longest, and with few blocks the card waits on them at the end; so the
# group is split over more blocks until there are at least
# _MIN_DKV_BLOCKS (about two waves of four blocks on the H100's 132 SMs).
# Each split writes fp32 partials of dk and dv that the kernel's last
# pass sums in split order: a fixed order, so repeated calls stay
# bit-equal.
_MIN_DKV_BLOCKS = 1024


def _dkv_splits(q, k) -> int:
    """The number of blocks that share one GQA group in the dk/dv kernel:
    the smallest divisor of the group that gives _MIN_DKV_BLOCKS blocks,
    or the whole group; 1 for fp32, whose scalar kernel does not split."""
    b, h, _, _ = q.shape
    h_kv, sk = k.shape[1], k.shape[2]
    group = h // h_kv
    if q.dtype != torch.bfloat16:
        return 1
    blocks = b * h_kv * -(-sk // 64)
    return next(s for s in range(1, group + 1)
                if group % s == 0 and (blocks * s >= _MIN_DKV_BLOCKS
                                       or s == group))


def _flash_bwd_kernel(q, k, v, do, lse, delta, scale, causal,
                      key_padding_mask=None, window=None):
    """(dq, dk, dv) from the dq and dk/dv CUDA kernels; dk and dv come
    out already summed over each kv head's query group."""
    b, h, sq, d = q.shape
    h_kv, sk = k.shape[1], k.shape[2]
    kpm = _check_kernel_args(q, k, v, key_padding_mask)
    code = _kernels.dtype_code(q)
    q3 = q.reshape(b * h, sq, d).contiguous()
    k3 = k.reshape(b * h_kv, sk, d).contiguous()
    v3 = v.reshape(b * h_kv, sk, d).contiguous()
    do3 = do.to(q.dtype).reshape(b * h, sq, d).contiguous()
    lse3 = lse.float().reshape(b * h, sq).contiguous()
    delta3 = delta.float().reshape(b * h, sq).contiguous()
    dq, dk, dv = (torch.empty_like(t) for t in (q3, k3, v3))
    splits = _dkv_splits(q, k)
    # fp32 partials of dk and dv, one pair per split
    work = (torch.empty(2 * splits * k3.numel(), dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    kpm_ptr = None if kpm is None else kpm.data_ptr()
    shape = (b * h, sq, sk, d, h, h // h_kv)
    tail = (float(scale), int(causal), int(window or 0), code)
    ins = (q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), do3.data_ptr(),
           lse3.data_ptr(), delta3.data_ptr(), kpm_ptr)
    _kernels.FLASH_BWD_DQ(*ins, dq.data_ptr(), *shape, *tail)
    _kernels.FLASH_BWD_DKV(*ins, dk.data_ptr(), dv.data_ptr(),
                           None if work is None else work.data_ptr(), *shape,
                           splits, *tail)
    return dq.reshape(q.shape), dk.reshape(k.shape), dv.reshape(v.shape)


class _FlashFn(torch.autograd.Function):
    """Flash attention whose backward is the dq and dk/dv kernels on the
    card and :func:`_flash_bwd_ref` on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, key_padding_mask, scale, causal, window):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        fwd = _flash_kernel if q.is_cuda else _flash_fwd_ref
        o, lse = fwd(q, k, v, scale, causal, key_padding_mask, window)
        ctx.save_for_backward(q, k, v, key_padding_mask, o, lse)
        ctx.cfg = (scale, causal, window)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, kpm, o, lse = ctx.saved_tensors
        scale, causal, window = ctx.cfg
        delta = (do.float() * o.float()).sum(dim=-1)  # (b, h, sq) fp32
        bwd = _flash_bwd_kernel if q.is_cuda else _flash_bwd_ref
        dq, dk, dv = bwd(q, k, v, do, lse, delta, scale, causal, kpm, window)
        return dq, dk, dv, None, None, None, None


@casts_disabled
def flash_attention(q, k, v, causal: bool = False, scale: float = None,
                    mask=None, key_padding_mask=None, window: int = None):
    """Multi-head attention; q: (b, h, sq, d), k/v: (b, h_kv, sk, d).

    ``key_padding_mask``: (b, sk) bool, True = padded-out key. ``mask``:
    bool broadcastable to (b, h, sq, sk), True = masked out. ``window``
    (requires ``causal``): each query attends only to the last ``window``
    keys. GQA: query head ``g * (h // h_kv) + j`` attends through kv head
    ``g``. A query whose keys are all masked outputs zeros.
    """
    b, h, sq, d = q.shape
    h_kv = k.shape[1]
    if h % h_kv != 0:
        raise ValueError(f"q heads ({h}) not a multiple of kv heads ({h_kv})")
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True (mistral semantics)")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if mask is None:
        if _kernels.wants_grad(q, k, v):
            return _FlashFn.apply(q, k, v, key_padding_mask, scale, causal,
                                  window)
        if q.is_cuda:
            return _flash_kernel(q, k, v, scale, causal, key_padding_mask,
                                 window)[0]
    return _flash_ref(q, k, v, scale, causal, mask, key_padding_mask, window)


def _flash_ref(q, k, v, scale, causal, mask=None, key_padding_mask=None,
               window=None):
    """The plain version of :func:`flash_attention` (after its argument
    checks): the key-padding row folded into the dense mask, then
    :func:`_attn_ref`, whose dead-row rule zeroes fully padded rows."""
    if key_padding_mask is not None:
        kp = key_padding_mask.bool()[:, None, None, :]
        mask = kp if mask is None else torch.logical_or(mask, kp)
    return _attn_ref(q, k, v, scale, causal, mask, window)
