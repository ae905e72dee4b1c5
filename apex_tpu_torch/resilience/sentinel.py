"""Anomaly sentinel (counterpart of apex_tpu/resilience/sentinel.py).

The training-health monitor over :class:`SentinelState`, a small
dataclass of 0-d tensors on the training device: an EMA of the loss and
of its squared deviation give a running z-score; a non-finite loss, a
spike beyond ``z_threshold`` after ``warmup_steps`` clean steps, or
non-finite params after the update is an anomaly, and the consecutive
count escalates the verdict:

    0 OK        clean step, update applied
    1 SKIP      anomalous batch, update was suppressed; keep going
    2 ROLLBACK  state is (or repeatedly risks being) corrupt
    3 HALT      anomaly persisted past every budget

Everything stays on the device; the caller reads the verdict.
"""

import dataclasses
from typing import Any, Optional, Tuple

import torch

from apex_tpu_torch._kernels import resolve_device
from apex_tpu_torch.utils.pytree import tree_any_non_finite

__all__ = [
    "AnomalySentinel", "SentinelState", "VERDICT_HALT", "VERDICT_OK",
    "VERDICT_ROLLBACK", "VERDICT_SKIP", "verdict_name",
]

VERDICT_OK = 0
VERDICT_SKIP = 1
VERDICT_ROLLBACK = 2
VERDICT_HALT = 3

_NAMES = {
    VERDICT_OK: "ok",
    VERDICT_SKIP: "skip",
    VERDICT_ROLLBACK: "rollback",
    VERDICT_HALT: "halt",
}


def verdict_name(verdict) -> str:
    """Human name for a verdict code (an int or a 0-d tensor)."""
    return _NAMES.get(int(verdict), f"unknown({int(verdict)})")


@dataclasses.dataclass
class SentinelState:
    ema: torch.Tensor          # fp32: EMA of the (unscaled) loss
    var: torch.Tensor          # fp32: EMA of squared deviation from the EMA
    count: torch.Tensor        # int32: clean steps folded into the EMA
    consecutive: torch.Tensor  # int32: consecutive anomalous steps
    anomalies: torch.Tensor    # int32: total anomalous steps this run


class AnomalySentinel:
    """Stateless config over :class:`SentinelState`; the arguments mean
    what they mean in the JAX package."""

    def __init__(self, ema_decay: float = 0.98, z_threshold: float = 6.0,
                 warmup_steps: int = 20, skip_budget: int = 2,
                 rollback_budget: int = 2, min_spike_loss: float = 0.0,
                 eps: float = 1e-12):
        if not 0.0 < ema_decay < 1.0:
            raise ValueError(f"ema_decay must be in (0, 1), got {ema_decay}")
        if skip_budget < 0 or rollback_budget < 0:
            raise ValueError("budgets must be >= 0")
        self.ema_decay = float(ema_decay)
        self.z_threshold = float(z_threshold)
        self.warmup_steps = int(warmup_steps)
        self.skip_budget = int(skip_budget)
        self.rollback_budget = int(rollback_budget)
        self.min_spike_loss = float(min_spike_loss)
        self.eps = float(eps)

    def init(self, device="cuda") -> SentinelState:
        dev = resolve_device(device)

        def t(x, dtype):
            return torch.tensor(x, dtype=dtype, device=dev)

        return SentinelState(ema=t(0.0, torch.float32),
                             var=t(0.0, torch.float32),
                             count=t(0, torch.int32),
                             consecutive=t(0, torch.int32),
                             anomalies=t(0, torch.int32))

    def is_anomalous_loss(self, state: SentinelState, loss) -> torch.Tensor:
        """0-d bool: is this (unscaled) loss non-finite or a spike?"""
        loss = torch.as_tensor(loss, device=state.ema.device).float()
        nonfinite = ~torch.isfinite(loss)
        z = (loss - state.ema) * torch.rsqrt(state.var + self.eps)
        spike = ((state.count >= self.warmup_steps)
                 & (z > self.z_threshold) & (loss > self.min_spike_loss))
        return nonfinite | spike

    def update(self, state: SentinelState, loss, anomaly, bad_params=False
               ) -> Tuple[SentinelState, torch.Tensor]:
        """Advance the state; returns ``(new_state, verdict)``, verdict a
        0-d int32 tensor. ``anomaly`` is the flag the step gated its
        update on; ``bad_params`` (non-finite params after the update)
        forces at least ROLLBACK."""
        dev = state.ema.device
        loss = torch.as_tensor(loss, device=dev).float()
        bad = torch.as_tensor(bad_params, device=dev).bool()
        anomaly = torch.as_tensor(anomaly, device=dev).bool() | bad
        d = self.ema_decay
        first = state.count == 0
        ema_clean = torch.where(first, loss, d * state.ema + (1.0 - d) * loss)
        dev_ = loss - state.ema
        var_clean = torch.where(first, torch.zeros_like(state.var),
                                d * state.var + (1.0 - d) * dev_ * dev_)
        clean = ~anomaly
        consecutive = torch.where(anomaly, state.consecutive + 1,
                                  torch.zeros_like(state.consecutive))
        new_state = SentinelState(
            ema=torch.where(clean, ema_clean, state.ema),
            var=torch.where(clean, var_clean, state.var),
            count=torch.where(clean, state.count + 1, state.count),
            consecutive=consecutive,
            anomalies=state.anomalies + anomaly.to(torch.int32),
        )

        def code(v):
            return torch.tensor(v, dtype=torch.int32, device=dev)

        escalated = torch.where(
            consecutive <= self.skip_budget, code(VERDICT_SKIP),
            torch.where(consecutive <= self.skip_budget + self.rollback_budget,
                        code(VERDICT_ROLLBACK), code(VERDICT_HALT)))
        verdict = torch.where(anomaly, escalated, code(VERDICT_OK))
        verdict = torch.where(bad, torch.clamp_min(verdict, VERDICT_ROLLBACK),
                              verdict)
        return new_state, verdict

    def check_params(self, params: Any) -> torch.Tensor:
        """0-d bool: any non-finite leaf in the post-update params."""
        return tree_any_non_finite(params)

    def check(self, state: SentinelState, loss, found_inf=False,
              params: Optional[Any] = None):
        """One-call form: the caller's ``found_inf``, the loss check and
        (optionally) the params check folded into the verdict."""
        dev = state.ema.device
        anomaly = (torch.as_tensor(found_inf, device=dev).bool()
                   | self.is_anomalous_loss(state, loss))
        bad = self.check_params(params) if params is not None else False
        return self.update(state, loss, anomaly, bad_params=bad)
