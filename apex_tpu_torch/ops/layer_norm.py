"""LayerNorm / RMSNorm (counterpart of apex_tpu/ops/layer_norm.py).

Statistics are fp32, the output keeps the input's dtype, and the
parameters may have any dtype (the reference's "mixed" variants need no
separate path). Device rule instead of the JAX ``impl=`` switch: on a
CUDA tensor ``layer_norm`` and ``rms_norm`` launch the hand-written
kernels (``csrc/layer_norm.cu``) for any hidden size, with or without a
weight, and on a CPU tensor they run their plain versions
:func:`_ln_ref`, :func:`_ln_bwd_ref`, :func:`_rms_ref` and
:func:`_rms_bwd_ref`.

When a gradient is wanted, ``layer_norm`` goes through
:class:`_LayerNormFn` and ``rms_norm`` through :class:`_RMSNormFn`, whose
backward is the backward kernel (the JAX ``custom_vjp`` around
``_ln_pallas`` / ``_rms_pallas``): it recomputes the row statistics from
the saved x, as the TPU kernel does. ``memory_efficient=True`` runs the
call under ``torch.utils.checkpoint`` (JAX's ``jax.checkpoint``): only
the inputs are kept and the backward runs the forward again (one more
forward kernel launch a backward); the values are unchanged. A norm draws
no random numbers, so the plain checkpoint is the whole of it.
"""

import torch
import torch.utils.checkpoint

from apex_tpu_torch import _kernels
from apex_tpu_torch._cast_state import casts_disabled

__all__ = ["layer_norm", "rms_norm"]

# rows per block of the backward kernel (kBwdRows in csrc/layer_norm.cu)
_LN_BWD_ROWS = 32


def _ln_ref(x, w, b, eps):
    """Plain PyTorch LayerNorm, the JAX package's ``_ln_ref``."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if w is not None:
        y = y * w.float()
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def _ln_bwd_ref(x2, w, dy2, eps):
    """Plain PyTorch LayerNorm backward of (rows, hidden) x and dy, the
    math of the JAX package's ``_ln_bwd_kernel``: the statistics are
    recomputed from x in fp32; returns dx in x's dtype and the fp32
    (hidden,) sums dgamma = sum(dy * xhat), dbeta = sum(dy)."""
    xf, dyf = x2.float(), dy2.float()
    mean = xf.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((xf - mean).square().mean(dim=-1, keepdim=True) + eps)
    xhat = (xf - mean) * rstd
    dyw = dyf * w.float() if w is not None else dyf
    m1 = dyw.mean(dim=-1, keepdim=True)
    m2 = (dyw * xhat).mean(dim=-1, keepdim=True)
    dx = ((dyw - m1 - xhat * m2) * rstd).to(x2.dtype)
    return dx, (dyf * xhat).sum(dim=0), dyf.sum(dim=0)


def _rms_ref(x, w, eps):
    """Plain PyTorch RMSNorm, the JAX package's ``_rms_ref``."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    if w is not None:
        y = y * w.float()
    return y.to(x.dtype)


def _rms_bwd_ref(x2, w, dy2, eps):
    """Plain PyTorch RMSNorm backward of (rows, hidden) x and dy, the
    math of the JAX package's ``_rms_bwd_kernel``: rstd recomputed from
    x in fp32; returns dx in x's dtype and the fp32 (hidden,) sum
    dgamma = sum(dy * xhat)."""
    xf, dyf = x2.float(), dy2.float()
    rstd = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    xhat = xf * rstd
    dyw = dyf * w.float() if w is not None else dyf
    m2 = (dyw * xhat).mean(dim=-1, keepdim=True)
    dx = ((dyw - xhat * m2) * rstd).to(x2.dtype)
    return dx, (dyf * xhat).sum(dim=0)


def _param(p, hidden, device):
    if p is None:
        return None
    if p.shape != (hidden,):
        raise ValueError(f"norm parameter shape {tuple(p.shape)} is not "
                         f"({hidden},)")
    return p.to(device=device, dtype=torch.float32).contiguous()


def _ln_kernel(x, w, b, eps):
    """LayerNorm through the CUDA kernel; x on the card, any shape."""
    hidden = x.shape[-1]
    code = _kernels.dtype_code(x)
    x2 = x.contiguous()
    wf, bf = _param(w, hidden, x.device), _param(b, hidden, x.device)
    y = torch.empty_like(x2)
    rows = x2.numel() // hidden if hidden else 0
    _kernels.LAYER_NORM_FWD(
        x2.data_ptr(), None if wf is None else wf.data_ptr(),
        None if bf is None else bf.data_ptr(), y.data_ptr(),
        rows, hidden, float(eps), code,
    )
    return y


def _norm_fwd_loop(x, w, b, eps, rms=False):
    """LayerNorm (or, with ``rms``, RMSNorm: b unused) through the
    forward's loop kernel whatever the shape, where ``layer_norm`` and
    ``rms_norm`` take the register-resident row when they can: the card
    checks hold the row bit-equal to it."""
    hidden = x.shape[-1]
    x2 = x.contiguous()
    wf, bf = _param(w, hidden, x.device), _param(b, hidden, x.device)
    y = torch.empty_like(x2)
    _kernels.NORM_FWD_LOOP(
        x2.data_ptr(), None if wf is None else wf.data_ptr(),
        None if bf is None or rms else bf.data_ptr(), y.data_ptr(),
        x2.numel() // hidden if hidden else 0, hidden, float(eps), int(rms),
        _kernels.dtype_code(x),
    )
    return y


def _ln_bwd_kernel(x2, w, dy2, eps, loop=False):
    """(dx, dgamma, dbeta) through the CUDA backward kernel; x2 and dy2
    are (rows, hidden) on the card. With ``loop``, through the loop kernel
    whatever the shape, where the kernel takes the register-resident rows
    when it can: the card checks compare the two."""
    rows, hidden = x2.shape
    code = _kernels.dtype_code(x2)
    x2 = x2.contiguous()
    dy2 = dy2.to(x2.dtype).contiguous()
    wf = _param(w, hidden, x2.device)
    dx = torch.empty_like(x2)
    blocks = -(-rows // _LN_BWD_ROWS)
    part = torch.empty((2, blocks, hidden), dtype=torch.float32,
                       device=x2.device)
    out = torch.empty((2, hidden), dtype=torch.float32, device=x2.device)
    kernel = _kernels.LAYER_NORM_BWD_LOOP if loop else _kernels.LAYER_NORM_BWD
    kernel(
        x2.data_ptr(), None if wf is None else wf.data_ptr(), dy2.data_ptr(),
        dx.data_ptr(), part.data_ptr(), out.data_ptr(), rows, hidden, blocks,
        float(eps), code,
    )
    return dx, out[0], out[1]


class _LayerNormFn(torch.autograd.Function):
    """LayerNorm whose backward is the backward kernel on the card and
    :func:`_ln_bwd_ref` on the CPU. Saves x, w and b, not the statistics."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.save_for_backward(x, weight, bias)
        ctx.eps = eps
        if x.is_cuda:
            return _ln_kernel(x, weight, bias, eps)
        return _ln_ref(x, weight, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        x, w, b = ctx.saved_tensors
        hidden = x.shape[-1]
        bwd = _ln_bwd_kernel if x.is_cuda else _ln_bwd_ref
        dx, dg, db = bwd(x.reshape(-1, hidden), w, dy.reshape(-1, hidden),
                         ctx.eps)
        need_w, need_b = ctx.needs_input_grad[1:3]
        dw = dg.to(w.dtype) if w is not None and need_w else None
        dbias = db.to(b.dtype) if b is not None and need_b else None
        return dx.reshape(x.shape), dw, dbias, None


def _rms_kernel(x, w, eps):
    """RMSNorm through the CUDA kernel; x on the card, any shape."""
    hidden = x.shape[-1]
    code = _kernels.dtype_code(x)
    x2 = x.contiguous()
    wf = _param(w, hidden, x.device)
    y = torch.empty_like(x2)
    rows = x2.numel() // hidden if hidden else 0
    _kernels.RMS_NORM_FWD(
        x2.data_ptr(), None if wf is None else wf.data_ptr(), y.data_ptr(),
        rows, hidden, float(eps), code,
    )
    return y


def _rms_bwd_kernel(x2, w, dy2, eps):
    """(dx, dgamma) through the CUDA backward kernel; x2 and dy2 are
    (rows, hidden) on the card."""
    rows, hidden = x2.shape
    code = _kernels.dtype_code(x2)
    x2 = x2.contiguous()
    dy2 = dy2.to(x2.dtype).contiguous()
    wf = _param(w, hidden, x2.device)
    dx = torch.empty_like(x2)
    blocks = -(-rows // _LN_BWD_ROWS)
    part = torch.empty((blocks, hidden), dtype=torch.float32,
                       device=x2.device)
    dg = torch.empty((hidden,), dtype=torch.float32, device=x2.device)
    _kernels.RMS_NORM_BWD(
        x2.data_ptr(), None if wf is None else wf.data_ptr(), dy2.data_ptr(),
        dx.data_ptr(), part.data_ptr(), dg.data_ptr(), rows, hidden, blocks,
        float(eps), code,
    )
    return dx, dg


class _RMSNormFn(torch.autograd.Function):
    """RMSNorm whose backward is the backward kernel on the card and
    :func:`_rms_bwd_ref` on the CPU. Saves x and w, not rstd."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        if x.is_cuda:
            return _rms_kernel(x, weight, eps)
        return _rms_ref(x, weight, eps)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        hidden = x.shape[-1]
        bwd = _rms_bwd_kernel if x.is_cuda else _rms_bwd_ref
        dx, dg = bwd(x.reshape(-1, hidden), w, dy.reshape(-1, hidden),
                     ctx.eps)
        dw = dg.to(w.dtype) if w is not None and ctx.needs_input_grad[1] \
            else None
        return dx.reshape(x.shape), dw, None


def _checkpointed(fn, *args):
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


@casts_disabled
def layer_norm(x, weight=None, bias=None, eps: float = 1e-5,
               memory_efficient: bool = False):
    """LayerNorm over the last dimension (ref: FusedLayerNorm)."""
    if memory_efficient and _kernels.wants_grad(x, weight, bias):
        return _checkpointed(layer_norm, x, weight, bias, eps)
    if _kernels.wants_grad(x, weight, bias):
        return _LayerNormFn.apply(x, weight, bias, eps)
    if x.is_cuda:
        return _ln_kernel(x, weight, bias, eps)
    return _ln_ref(x, weight, bias, eps)


@casts_disabled
def rms_norm(x, weight=None, eps: float = 1e-5,
             memory_efficient: bool = False):
    """RMSNorm over the last dimension (ref: FusedRMSNorm)."""
    if memory_efficient and _kernels.wants_grad(x, weight):
        return _checkpointed(rms_norm, x, weight, eps)
    if _kernels.wants_grad(x, weight):
        return _RMSNormFn.apply(x, weight, eps)
    if x.is_cuda:
        return _rms_kernel(x, weight, eps)
    return _rms_ref(x, weight, eps)
