"""The flat-buffer optimizer kernels and their plain versions
(counterpart of apex_tpu/optimizers/_fused_kernels.py): ``adam_flat``
and ``sumsq_flat`` / ``l2norm_flat``.

Device rule: on CUDA tensors :func:`adam_flat` launches the hand-written
kernel (``csrc/adam.cu``), on CPU tensors it runs :func:`_adam_flat_ref`.
The kernel evaluates the same operations in the same order with every
rounding explicit, so on the card the two agree bit for bit.

Contract, as in the JAX package: fp32 g, p, m, v of one length in, the
update ``-lr * u`` and the new m and v out; p is never written. ``bc1``
and ``bc2`` (``1 - beta**step``) are 0-d fp32 tensors on the buffers'
device, read by the kernel where they lie. Unlike the TPU kernel, any
length works (no CHUNK_SIZE padding), so ``fused_adam``'s tree engine
launches it once per parameter tensor.

``sumsq_flat(x)`` is the fp32 sum of squares of a 1-D buffer of any
length, as a 0-d fp32 tensor on x's device (the ZeRO optimizers clip
with it). On a CUDA tensor it launches ``csrc/l2norm.cu``: per-block
partials over a fixed grid, then one block sums them in a fixed order,
so a repeat call is bit-equal. It adds in another order than
:func:`_sumsq_flat_ref`'s ``torch.sum``, so the two differ in their
last bits. A buffer of another dtype is read as fp32, as the
JAX function casts it.
"""

import torch

from apex_tpu_torch import _kernels

__all__ = ["adam_flat", "l2norm_flat", "sumsq_flat"]

# the partial-sum grid of csrc/l2norm.cu: 256 threads, 4 elements each per
# round, at most 1024 blocks
_SUMSQ_PER_BLOCK = 256 * 4
_SUMSQ_MAX_BLOCKS = 1024


def _adam_flat_ref(g, p, m, v, bc1, bc2, *, lr, beta1, beta2, eps,
                   weight_decay, adam_w_mode):
    """Plain PyTorch Adam step, the JAX package's ``_adam_flat_ref``."""
    if not adam_w_mode and weight_decay != 0.0:
        g = g + weight_decay * p
    m = beta1 * m + (1.0 - beta1) * g
    v = beta2 * v + (1.0 - beta2) * g * g
    upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
    if adam_w_mode and weight_decay != 0.0:
        upd = upd + weight_decay * p
    return -lr * upd, m, v


def _adam_kernel(g, p, m, v, bc1, bc2, *, lr, beta1, beta2, eps,
                 weight_decay, adam_w_mode):
    """(update, m, v) from the CUDA kernel, shaped like g."""
    for name, t in (("g", g), ("p", p), ("m", m), ("v", v), ("bc1", bc1),
                    ("bc2", bc2)):
        if t.dtype != torch.float32 or not t.is_cuda:
            raise TypeError(f"adam kernel: {name} must be a float32 CUDA "
                            f"tensor, got {t.dtype} on {t.device}")
    if not (g.shape == p.shape == m.shape == v.shape):
        raise ValueError(f"adam kernel: shapes differ: {tuple(g.shape)}, "
                         f"{tuple(p.shape)}, {tuple(m.shape)}, "
                         f"{tuple(v.shape)}")
    if bc1.numel() != 1 or bc2.numel() != 1:
        raise ValueError("adam kernel: bc1 and bc2 are scalars")
    g, p, m, v = (t.contiguous() for t in (g, p, m, v))
    bc1, bc2 = bc1.contiguous(), bc2.contiguous()
    upd, m_out, v_out = (torch.empty_like(g) for _ in range(3))
    _kernels.ADAM(
        g.data_ptr(), p.data_ptr(), m.data_ptr(), v.data_ptr(),
        bc1.data_ptr(), bc2.data_ptr(), upd.data_ptr(), m_out.data_ptr(),
        v_out.data_ptr(), g.numel(), -lr, beta1, 1.0 - beta1, beta2,
        1.0 - beta2, eps, weight_decay, int(bool(adam_w_mode)),
    )
    return upd, m_out, v_out


def adam_flat(g, p, m, v, bc1, bc2, *, lr, beta1, beta2, eps, weight_decay,
              adam_w_mode):
    """One Adam/AdamW step over fp32 buffers of one shape (any length);
    returns ``(-lr * update, m, v)`` and leaves p unwritten.
    ``adam_w_mode``: decoupled decay (AdamW) or L2 into the gradient."""
    kw = dict(lr=lr, beta1=beta1, beta2=beta2, eps=eps,
              weight_decay=weight_decay, adam_w_mode=adam_w_mode)
    if g.is_cuda:
        return _adam_kernel(g, p, m, v, bc1, bc2, **kw)
    return _adam_flat_ref(g, p, m, v, bc1, bc2, **kw)


def _sumsq_flat_ref(x):
    """Plain PyTorch sum of squares in fp32, a 0-d tensor."""
    return (x.float() ** 2).sum()


def _sumsq_kernel(x):
    """The fp32 sum of squares of a 1-D CUDA tensor from the kernel."""
    if x.dim() != 1:
        raise ValueError(f"sumsq_flat takes a 1-D buffer, got shape "
                         f"{tuple(x.shape)}")
    x = x.float().contiguous()
    n = x.numel()
    blocks = max(1, min(_SUMSQ_MAX_BLOCKS, -(-n // _SUMSQ_PER_BLOCK)))
    part = torch.empty(blocks, dtype=torch.float32, device=x.device)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    _kernels.SUMSQ_FLAT(x.data_ptr(), n, part.data_ptr(), blocks,
                        out.data_ptr())
    return out


def sumsq_flat(x):
    """Sum of squares of a flat buffer of any length: a 0-d fp32 tensor
    on x's device."""
    if x.is_cuda:
        return _sumsq_kernel(x)
    return _sumsq_flat_ref(x)


def l2norm_flat(x):
    """Global L2 norm of a flat buffer (padding zeros contribute 0)."""
    return torch.sqrt(sumsq_flat(x))
