"""The legacy loss scalers (counterpart of
apex_tpu/fp16_utils/loss_scaler.py; ref fp16_utils/loss_scaler.py):
host-side classes with the legacy method names, for loops driven by
hand. The functional scaler is ``amp.scaler``."""

from apex_tpu_torch.utils.pytree import tree_any_non_finite, tree_map

__all__ = ["DynamicLossScaler", "LossScaler"]


class LossScaler:
    """Static scaler: ``loss_scale`` constant, never overflows."""

    def __init__(self, scale: float = 1.0):
        self.cur_scale = float(scale)

    @property
    def loss_scale(self) -> float:
        return self.cur_scale

    def has_overflow(self, params_or_grads) -> bool:
        return False

    def scale_gradient(self, grads):
        return tree_map(lambda g: g * self.cur_scale, grads)

    def unscale(self, grads):
        inv = 1.0 / self.cur_scale
        return tree_map(lambda g: g * inv, grads)

    def update_scale(self, overflow: bool) -> None:
        pass

    def state_dict(self) -> dict:
        return {"cur_scale": self.cur_scale}

    def load_state_dict(self, d: dict) -> None:
        self.cur_scale = d["cur_scale"]


class DynamicLossScaler(LossScaler):
    """Dynamic scaler: halved on an overflow, doubled after
    ``scale_window`` clean iterations."""

    def __init__(self, init_scale: float = 2.0**32, scale_factor: float = 2.0,
                 scale_window: int = 1000, min_scale: float = 1.0):
        super().__init__(init_scale)
        self.scale_factor = scale_factor
        self.scale_window = scale_window
        self.min_scale = min_scale
        self.last_overflow_iter = -1
        self.cur_iter = 0

    def has_overflow(self, grads) -> bool:
        return bool(tree_any_non_finite(grads))

    def update_scale(self, overflow: bool) -> None:
        if overflow:
            self.cur_scale = max(self.cur_scale / self.scale_factor,
                                 self.min_scale)
            self.last_overflow_iter = self.cur_iter
        elif (self.cur_iter - self.last_overflow_iter) % \
                self.scale_window == 0:
            self.cur_scale *= self.scale_factor
        self.cur_iter += 1

    def state_dict(self) -> dict:
        return {"cur_scale": self.cur_scale, "cur_iter": self.cur_iter,
                "last_overflow_iter": self.last_overflow_iter}

    def load_state_dict(self, d: dict) -> None:
        self.cur_scale = d["cur_scale"]
        self.cur_iter = d["cur_iter"]
        self.last_overflow_iter = d["last_overflow_iter"]
