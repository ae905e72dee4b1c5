"""FP8 delayed scaling (counterpart of apex_tpu/amp/fp8.py).

The reference exposes the amax-reduction process groups for FP8
training (apex/transformer/parallel_state.py:280-292) but no recipe; the
recipe is transformer-engine's delayed scaling, as in the JAX module:

- per-tensor :class:`Fp8TensorState`: an amax history window and the
  scale derived from it, ``2^-margin * fp8_max / max(history)``;
- :func:`quantize` / :func:`dequantize` into torch's fp8 dtypes,
  ``float8_e4m3fn`` (forward operands) and ``float8_e5m2`` (gradients'
  range), with saturation at the format's largest finite value;
- :func:`fp8_dense`: a linear layer whose operands go through quantize
  then dequantize with DELAYED scales (this step quantizes with the
  earlier steps' statistics), the product in ``compute_dtype`` on the
  dequantized operands (QDQ, as JAX), and this step's amaxes, reduced
  over the amax group (``parallel_state.amax_reduction``: dp x cp x tp),
  pushed into the returned states.

The casts stay inside autograd, as in JAX: the gradient that flows back
through ``.to(float8)`` is rounded to that format too (at scale 3 the
gradient of x is 1.03125, not 1.0). The H100's FP8 GEMM
(``torch._scaled_mm``) computes another function (no dequantized
operands) and is not on this path.
"""

from typing import NamedTuple, Tuple

import torch

from apex_tpu_torch._kernels import resolve_device

__all__ = [
    "FP8_MAX",
    "Fp8TensorState",
    "init_fp8_state",
    "update_fp8_state",
    "quantize",
    "dequantize",
    "fp8_dense",
]

# largest finite magnitudes of the two OCP fp8 formats
FP8_MAX = {
    "e4m3": 448.0,
    "e5m2": 57344.0,
}
_DTYPES = {
    "e4m3": torch.float8_e4m3fn,
    "e5m2": torch.float8_e5m2,
}


class Fp8TensorState(NamedTuple):
    """Delayed-scaling state of one tensor role (x, weight or grad)."""

    amax_history: torch.Tensor  # (history_len,) fp32, most recent at [0]
    scale: torch.Tensor  # () fp32, applied before the cast to fp8


def init_fp8_state(history_len: int = 16, device="cuda") -> Fp8TensorState:
    """A zero history and scale 1 on ``device`` (CUDA unless the caller
    names another)."""
    dev = resolve_device(device)
    return Fp8TensorState(
        amax_history=torch.zeros(history_len, dtype=torch.float32,
                                 device=dev),
        scale=torch.ones((), dtype=torch.float32, device=dev))


def update_fp8_state(state: Fp8TensorState, amax_new, fmt: str = "e4m3",
                     margin: int = 0) -> Fp8TensorState:
    """Pushes ``amax_new`` into the history and derives the scale from the
    window's max: ``2^-margin * fp8_max / amax``. A zero window (nothing
    seen yet) keeps scale 1."""
    hist = state.amax_history
    new = torch.as_tensor(amax_new, dtype=torch.float32,
                          device=hist.device).reshape(1)
    hist = torch.cat([new, hist[:-1]])
    amax = hist.max()
    scale = torch.where(amax > 0.0, (2.0 ** (-margin)) * FP8_MAX[fmt] / amax,
                        torch.ones((), dtype=torch.float32,
                                   device=hist.device))
    return Fp8TensorState(amax_history=hist, scale=scale)


def quantize(x, scale, fmt: str = "e4m3"):
    """x -> fp8 with saturation: ``clamp(x * scale, +-fp8_max)`` in fp32,
    cast with round-to-nearest-even."""
    lim = FP8_MAX[fmt]
    return torch.clamp(x.float() * scale, -lim, lim).to(_DTYPES[fmt])


def dequantize(qx, scale, dtype=torch.float32):
    return (qx.float() / scale).to(dtype)


def _synced_amax(x):
    """|x| max, reduced over the amax group where one is live."""
    from apex_tpu_torch.parallel import parallel_state

    return parallel_state.amax_reduction(x.detach().abs().max().float())


def fp8_dense(x, w, state_x: Fp8TensorState, state_w: Fp8TensorState,
              bias=None, fmt: str = "e4m3", margin: int = 0,
              compute_dtype=torch.float32
              ) -> Tuple[torch.Tensor, Tuple[Fp8TensorState,
                                             Fp8TensorState]]:
    """``y = dequant(q(x)) @ dequant(q(w)) (+ bias)`` with delayed scales:
    the operands are quantized with the scales ``state_x`` and
    ``state_w`` carry (earlier steps' statistics), and this step's
    group-synced amaxes only enter the returned states. Returns ``(y,
    (state_x', state_w'))``; thread the states through the loop as an
    optimizer's state."""
    qx = quantize(x, state_x.scale, fmt)
    qw = quantize(w, state_w.scale, fmt)
    y = torch.matmul(dequantize(qx, state_x.scale, compute_dtype),
                     dequantize(qw, state_w.scale, compute_dtype))
    if bias is not None:
        y = y + bias.to(y.dtype)
    new_x = update_fp8_state(state_x, _synced_amax(x), fmt, margin)
    new_w = update_fp8_state(state_w, _synced_amax(w), fmt, margin)
    return y, (new_x, new_w)
