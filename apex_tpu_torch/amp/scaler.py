"""Dynamic loss scaling (counterpart of apex_tpu/amp/scaler.py).

The scaler is a state machine over :class:`LossScalerState`, a small
dataclass of 0-d tensors on the training device, with the JAX package's
exact dynamic schedule: growth by ``growth_factor`` after
``growth_interval`` clean steps, backoff by ``backoff_factor`` on an
overflow once the ``hysteresis`` allowance is spent (refilled by any
clean step), clamped to [min, max]. Nothing here syncs with the host;
the caller decides when to read the overflow flag. The free functions
:func:`scale_loss` and :func:`unscale_grads` are the JAX package's: a
default dynamic scaler's ``scale`` and ``unscale``.
"""

import dataclasses
from typing import Any, Tuple

import torch

from apex_tpu_torch._kernels import resolve_device
from apex_tpu_torch.utils.pytree import tree_any_non_finite, tree_map

__all__ = ["LossScaler", "LossScalerState", "scale_loss", "unscale_grads"]


@dataclasses.dataclass
class LossScalerState:
    scale: torch.Tensor  # 0-d fp32
    growth_tracker: torch.Tensor  # 0-d int32: consecutive clean steps
    skipped: torch.Tensor  # 0-d int32: overflowed steps so far
    # overflows tolerated before the next backoff
    hysteresis_tracker: torch.Tensor  # 0-d int32

    def replace(self, **changes) -> "LossScalerState":
        return dataclasses.replace(self, **changes)


class LossScaler:
    """Loss scaler with the reference's dynamic schedule;
    ``loss_scale="dynamic"`` or a fixed float (static mode)."""

    def __init__(self, loss_scale="dynamic", init_scale: float = 2.0**16,
                 growth_factor: float = 2.0, backoff_factor: float = 0.5,
                 growth_interval: int = 2000, min_loss_scale: float = 1.0,
                 max_loss_scale: float = 2.0**24, hysteresis: int = 1):
        self.dynamic = loss_scale == "dynamic"
        self._static_scale = 1.0 if self.dynamic else float(loss_scale)
        self.init_scale = init_scale if self.dynamic else self._static_scale
        self.growth_factor = growth_factor
        self.backoff_factor = backoff_factor
        self.growth_interval = growth_interval
        self.min_loss_scale = min_loss_scale
        self.max_loss_scale = max_loss_scale
        self.hysteresis = int(hysteresis)

    def init(self, device="cuda") -> LossScalerState:
        dev = resolve_device(device)

        def i32(x):
            return torch.tensor(x, dtype=torch.int32, device=dev)

        return LossScalerState(
            scale=torch.tensor(self.init_scale, dtype=torch.float32,
                               device=dev),
            growth_tracker=i32(0), skipped=i32(0),
            hysteresis_tracker=i32(self.hysteresis))

    # -- core ops ---------------------------------------------------------

    def scale(self, state: LossScalerState, loss):
        """loss * scale, in fp32."""
        return loss.float() * state.scale

    def unscale(self, state: LossScalerState, grads: Any
                ) -> Tuple[Any, torch.Tensor]:
        """(grads * (1 / scale), found_inf) over any tensor collection, the
        flag taken on the SCALED grads; a multiplication by the fp32
        reciprocal, as in JAX."""
        inv = 1.0 / state.scale
        found_inf = tree_any_non_finite(grads)
        out = tree_map(lambda g: (g.float() * inv).to(g.dtype), grads)
        return out, found_inf

    def update(self, state: LossScalerState, found_inf) -> LossScalerState:
        """The next state after a step whose grads did (not) overflow."""
        found = torch.as_tensor(found_inf, device=state.scale.device).bool()
        skipped = state.skipped + found.to(torch.int32)
        if not self.dynamic:
            return state.replace(skipped=skipped)
        hys = torch.where(found, (state.hysteresis_tracker - 1).clamp_min(0),
                          torch.full_like(state.hysteresis_tracker,
                                          self.hysteresis))
        backoff = found & (hys <= 0)
        backed_off = torch.clamp_min(state.scale * self.backoff_factor,
                                     self.min_loss_scale)
        tracker = torch.where(found, torch.zeros_like(state.growth_tracker),
                              state.growth_tracker + 1)
        grow = ~found & (tracker >= self.growth_interval)
        scale = torch.where(backoff, backed_off, state.scale)
        scale = torch.where(
            grow, torch.clamp_max(scale * self.growth_factor,
                                  self.max_loss_scale), scale)
        tracker = torch.where(grow, torch.zeros_like(tracker), tracker)
        return LossScalerState(scale=scale, growth_tracker=tracker,
                               skipped=skipped, hysteresis_tracker=hys)

    # -- checkpointing ----------------------------------------------------

    def state_dict(self, state: LossScalerState) -> dict:
        return {
            "loss_scale": float(state.scale),
            "unskipped": int(state.growth_tracker),
            "skipped": int(state.skipped),
            "hysteresis_tracker": int(state.hysteresis_tracker),
            "dynamic": self.dynamic,
        }

    def load_state_dict(self, d: dict, device="cuda") -> LossScalerState:
        dev = resolve_device(device)

        def i32(x):
            return torch.tensor(x, dtype=torch.int32, device=dev)

        return LossScalerState(
            scale=torch.tensor(d["loss_scale"], dtype=torch.float32,
                               device=dev),
            growth_tracker=i32(d.get("unskipped", 0)),
            skipped=i32(d.get("skipped", 0)),
            hysteresis_tracker=i32(d.get("hysteresis_tracker",
                                         self.hysteresis)))


_DEFAULT_SCALER = LossScaler()


def scale_loss(loss, state: LossScalerState):
    """The scaled loss to differentiate: ``loss`` in fp32 times the scale
    (the entry half of the reference's ``with amp.scale_loss(...)``)."""
    return _DEFAULT_SCALER.scale(state, loss)


def unscale_grads(grads, state: LossScalerState):
    """(grads unscaled, found_inf): the exit half of ``scale_loss``."""
    return _DEFAULT_SCALER.unscale(state, grads)
