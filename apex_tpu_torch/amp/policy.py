"""Opt levels O0-O3 and ``amp.initialize`` (counterpart of
apex_tpu/amp/policy.py; ref apex/amp/frontend.py).

- O0: fp32 everything (the training baseline);
- O1: parameters fp32, per-op casts from the cast lists
  (``amp.cast_engine``, a ``TorchFunctionMode``), dynamic scaling in fp16;
- O2: the model cast to half with its norms kept fp32, fp32 master
  weights, dynamic scaling in fp16;
- O3: pure half.

The levels' fields are the JAX package's exactly; the half dtype is
bf16 by default (``loss_scale`` 1.0) and fp16 on request (``"dynamic"``
under O1 and O2).

``initialize`` takes a dict of named tensors (cast into a new dict) or an
``nn.Module``, whose floating parameters and buffers are cast in place.
The keep-fp32 rule reads the torch name (``"bn1.weight"``,
``"SyncBatchNorm_0.scale"``, ``"ln"``) with the JAX tokens ``norm``,
``bn``, ``batchnorm`` and ``batch_stats``, and with ``running_mean`` and
``running_var``, the torch spelling of ``batch_stats``.
"""

import contextlib
import dataclasses
from typing import Any, Callable, Optional

import torch
from torch import nn

from apex_tpu_torch.amp.scaler import LossScaler
from apex_tpu_torch.utils.pytree import map_floats

__all__ = ["O0", "O1", "O2", "O3", "Policy", "cast_named",
           "default_keep_fp32_predicate", "initialize", "opt_levels"]

_NORM_TOKENS = ("norm", "bn", "batchnorm", "batch_stats", "running_mean",
                "running_var")


def default_keep_fp32_predicate(name: str) -> bool:
    """True for the tensors that stay fp32 under ``keep_batchnorm_fp32``:
    those whose name holds a norm token (any case)."""
    low = name.lower()
    return any(tok in low for tok in _NORM_TOKENS)


def cast_named(params, dtype_of: Callable[[str, torch.Tensor], Any]):
    """Cast each floating tensor of a dict of named tensors or of a
    module (parameters and buffers, in place) to ``dtype_of(name, t)``
    (None: unchanged). A dict comes back as a new dict, a module as
    itself."""
    if isinstance(params, nn.Module):
        with torch.no_grad():
            named = list(params.named_parameters()) + list(
                params.named_buffers())
            for name, t in named:
                dt = dtype_of(name, t) if t.is_floating_point() else None
                if dt is not None and t.dtype != dt:
                    t.data = t.data.to(dt)
        return params
    out = {}
    for name, t in params.items():
        dt = dtype_of(name, t) if t.is_floating_point() else None
        out[name] = t.to(dt) if dt is not None else t
    return out


@dataclasses.dataclass(frozen=True)
class Policy:
    """Resolved amp properties (ref: amp/frontend.py Properties)."""

    opt_level: str
    enabled: bool = True
    cast_model_type: Optional[torch.dtype] = None  # dtype params are stored in
    compute_dtype: Optional[torch.dtype] = None  # dtype compute runs in
    keep_batchnorm_fp32: bool = False
    master_weights: bool = False
    loss_scale: Any = 1.0  # "dynamic" or a float
    keep_fp32_predicate: Callable[[str], bool] = default_keep_fp32_predicate
    patch_functions: bool = False  # O1's cast lists

    # -- casting helpers --------------------------------------------------

    def cast_params(self, params):
        """Cast a dict of named tensors (into a new dict) or a module (in
        place) by the policy: norms kept fp32 under
        ``keep_batchnorm_fp32``, the rest to ``cast_model_type``."""
        if not self.enabled or self.cast_model_type is None:
            return params

        def dtype_of(name, t):
            if self.keep_batchnorm_fp32 and self.keep_fp32_predicate(name):
                return torch.float32
            return self.cast_model_type

        return cast_named(params, dtype_of)

    def cast_inputs(self, tree):
        """Floating tensors of ``tree`` to the compute dtype; ints and
        non-tensors pass through."""
        if not self.enabled or self.compute_dtype is None:
            return tree
        return map_floats(lambda x: x.to(self.compute_dtype), tree)

    def cast_outputs(self, tree):
        """Floating tensors of ``tree`` back to fp32."""
        if not self.enabled or self.compute_dtype is None:
            return tree
        return map_floats(lambda x: x.float(), tree)

    def cast_context(self):
        """O1's per-op casts (``amp.cast_engine.cast_ops``) for the body of
        a ``with``; a null context at every other level."""
        if not self.enabled or not self.patch_functions or \
                self.compute_dtype is None:
            return contextlib.nullcontext()
        from apex_tpu_torch.amp.cast_engine import cast_ops

        return cast_ops(self.compute_dtype)

    def wrap_apply(self, apply_fn: Callable) -> Callable:
        """``apply_fn`` (a module, or a function of tensors) with its
        floating arguments cast to the compute dtype, its body under
        :meth:`cast_context` and its floating outputs cast to fp32. A
        function that takes its parameters as an argument has them cast
        too: close over them instead."""
        if not self.enabled or self.compute_dtype is None:
            return apply_fn

        def wrapped(*args, **kwargs):
            args = self.cast_inputs(args)
            kwargs = self.cast_inputs(kwargs)
            with self.cast_context():
                out = apply_fn(*args, **kwargs)
            return self.cast_outputs(out)

        return wrapped

    def make_scaler(self, **kw) -> LossScaler:
        return LossScaler(loss_scale=self.loss_scale, **kw)


def _mk_level(opt_level, half_dtype):
    dynamic = "dynamic" if half_dtype == torch.float16 else 1.0
    if opt_level == "O0":
        return Policy("O0", cast_model_type=torch.float32, compute_dtype=None,
                      keep_batchnorm_fp32=False, master_weights=False,
                      loss_scale=1.0)
    if opt_level == "O1":
        return Policy("O1", cast_model_type=None, compute_dtype=half_dtype,
                      keep_batchnorm_fp32=True, master_weights=False,
                      loss_scale=dynamic, patch_functions=True)
    if opt_level == "O2":
        return Policy("O2", cast_model_type=half_dtype,
                      compute_dtype=half_dtype, keep_batchnorm_fp32=True,
                      master_weights=True, loss_scale=dynamic)
    if opt_level == "O3":
        return Policy("O3", cast_model_type=half_dtype,
                      compute_dtype=half_dtype, keep_batchnorm_fp32=False,
                      master_weights=False, loss_scale=1.0)
    raise ValueError(f"Unexpected optimization level {opt_level!r}")


def O0(half_dtype=torch.bfloat16):
    return _mk_level("O0", half_dtype)


def O1(half_dtype=torch.bfloat16):
    return _mk_level("O1", half_dtype)


def O2(half_dtype=torch.bfloat16):
    return _mk_level("O2", half_dtype)


def O3(half_dtype=torch.bfloat16):
    return _mk_level("O3", half_dtype)


opt_levels = {"O0": O0, "O1": O1, "O2": O2, "O3": O3}


def initialize(params=None, tx=None, opt_level: str = "O1",
               half_dtype=torch.bfloat16, num_losses: int = 1, **overrides):
    """``apex.amp.initialize`` over a dict of named tensors or a module,
    and optionally an optimizer transform (``init``/``update``, as
    ``optimizers.fused_adam`` returns): ``(cast params, AmpOptimizer or
    None, policy)``. Keyword overrides replace the level's fields
    (``cast_model_type``, ``keep_batchnorm_fp32``, ``master_weights``,
    ``loss_scale``, ...)."""
    if opt_level not in opt_levels:
        raise ValueError(f"Unexpected optimization level {opt_level!r} "
                         f"(options: O0, O1, O2, O3)")
    policy = opt_levels[opt_level](half_dtype)
    if overrides:
        policy = dataclasses.replace(policy, **overrides)
    casted = policy.cast_params(params) if params is not None else None
    amp_opt = None
    if tx is not None:
        from apex_tpu_torch.amp.optimizer import AmpOptimizer

        amp_opt = AmpOptimizer(tx, policy, num_losses=num_losses)
    return casted, amp_opt, policy
