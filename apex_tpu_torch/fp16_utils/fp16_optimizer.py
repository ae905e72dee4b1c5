"""``FP16_Optimizer`` (counterpart of apex_tpu/fp16_utils/fp16_optimizer.py;
ref fp16_utils/fp16_optimizer.py): any optimizer transform with fp32
masters, static or dynamic loss scaling and overflow skips, as a legacy
facade over ``amp.AmpOptimizer`` at an O2 fp16 policy."""

import dataclasses

import torch

from apex_tpu_torch.amp.optimizer import AmpOptimizer
from apex_tpu_torch.amp.policy import O2

__all__ = ["FP16_Optimizer"]


class FP16_Optimizer:
    def __init__(self, tx, static_loss_scale: float = 1.0,
                 dynamic_loss_scale: bool = False, verbose: bool = False):
        policy = dataclasses.replace(
            O2(half_dtype=torch.float16),
            loss_scale="dynamic" if dynamic_loss_scale
            else float(static_loss_scale))
        self._amp = AmpOptimizer(tx, policy)
        self.verbose = verbose

    def init(self, params):
        return self._amp.init(params)

    def scale_loss(self, loss, state):
        """``loss.float() * loss_scale`` (ref backward :376)."""
        return self._amp.scale_loss(loss, state)

    def step(self, grads, state, params):
        """Unscale, skip on overflow, update the masters, write back."""
        return self._amp.step(grads, state, params)

    @property
    def loss_scale(self):
        return self._amp.scaler

    def state_dict(self, state) -> dict:
        return self._amp.state_dict(state)

    def load_state_dict(self, state, d: dict):
        return self._amp.load_state_dict(state, d)
