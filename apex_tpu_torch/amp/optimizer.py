"""Master weights and skip-on-overflow around an optimizer transform
(counterpart of apex_tpu/amp/optimizer.py; ref
apex/amp/_process_optimizer.py and fp16_utils/fp16_optimizer.py).

``AmpOptimizer`` keeps the port's optimizer contract: ``init(params)`` and
``update(grads, state, params) -> (updates, state)`` over dicts of named
tensors (``dict(model.named_parameters())``), as ``optimizers.fused_adam``
has it. Its state holds the fp32 masters (under O2; at the other levels
the masters are the caller's tensors themselves), the inner transform's
state over them and one loss scaler state, or a tuple of ``num_losses``
of them.

A step decides whether to skip with one host read of its gate (as
``resilience/replay/targets.py`` reads its own), so a skipped step runs
no optimizer update at all, as JAX's ``vma_cond`` runs one branch only,
and leaves the parameters, the masters and the inner state untouched.
An applied step writes each parameter's new value, in its own dtype,
into the caller's tensors in place under ``torch.no_grad()``, so a loop
over a module's parameters needs nothing else.
"""

import dataclasses
from typing import Any, Dict, Optional

import torch

from apex_tpu_torch.amp.policy import Policy
from apex_tpu_torch.amp.scaler import LossScalerState

__all__ = ["AmpOptimizer", "AmpOptimizerState", "master_params"]

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass
class AmpOptimizerState:
    master: Tensors  # fp32 masters, or the caller's tensors
    inner: Any  # the inner transform's state over the masters
    # one LossScalerState, or a tuple of num_losses of them (one per loss,
    # as the reference creates one scaler per loss_id)
    scaler: Any

    def replace(self, **changes) -> "AmpOptimizerState":
        return dataclasses.replace(self, **changes)


def _named(params) -> Tensors:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return params


class AmpOptimizer:
    """An optimizer transform with amp semantics::

        model, amp_opt, policy = amp.initialize(model, fused_adam(),
                                                opt_level="O2")
        params = dict(model.named_parameters())
        state = amp_opt.init(params)
        loss = loss_fn(model, batch)
        grads = torch.autograd.grad(amp_opt.scale_loss(loss, state),
                                    list(params.values()))
        params, state, info = amp_opt.step(dict(zip(params, grads)),
                                           state, params)
    """

    def __init__(self, tx, policy: Policy, num_losses: int = 1):
        self.tx = tx
        self.policy = policy
        self.scaler = policy.make_scaler()
        self.num_losses = int(num_losses)

    def init(self, params) -> AmpOptimizerState:
        """Masters (fp32 copies under O2), the inner state over them and
        the scaler state(s), on the parameters' device."""
        params = _named(params)
        device = next(iter(params.values())).device
        with torch.no_grad():
            if self.policy.master_weights:
                master = {n: p.detach().float().clone()
                          for n, p in params.items()}
            else:
                master = params
        if self.num_losses > 1:
            scaler = tuple(self.scaler.init(device)
                           for _ in range(self.num_losses))
        else:
            scaler = self.scaler.init(device)
        return AmpOptimizerState(master=master, inner=self.tx.init(master),
                                 scaler=scaler)

    def _scaler_state(self, state: AmpOptimizerState, loss_id: int
                      ) -> LossScalerState:
        if isinstance(state.scaler, tuple):
            if not 0 <= loss_id < len(state.scaler):
                raise ValueError(f"loss_id={loss_id} out of range for "
                                 f"num_losses={len(state.scaler)}")
            return state.scaler[loss_id]
        if loss_id != 0:
            raise ValueError(f"loss_id={loss_id} but this AmpOptimizer was "
                             f"initialized with num_losses={self.num_losses}")
        return state.scaler

    def scale_loss(self, loss, state: AmpOptimizerState, loss_id: int = 0):
        """``loss`` in fp32 times the scale of loss ``loss_id``."""
        return self.scaler.scale(self._scaler_state(state, loss_id), loss)

    def unscale_grads(self, grads: Tensors, state: AmpOptimizerState,
                      loss_id: int = 0):
        """(grads in fp32 over the scale of loss ``loss_id``, found_inf):
        the building block of several backwards, one per loss, summed and
        handed to :meth:`step_unscaled` with their flags. The flag is
        taken on the scaled grads and each is multiplied by the fp32
        reciprocal of the scale, as ``LossScaler.unscale`` does, here by
        torch's fused multi-tensor check-and-unscale over fp32 copies."""
        scaler = self._scaler_state(state, loss_id)
        names = list(grads)
        f32 = [torch.empty_like(grads[n], dtype=torch.float32)
               for n in names]
        torch._foreach_copy_(f32, [grads[n] for n in names])
        found = torch.zeros(1, device=scaler.scale.device)
        torch._amp_foreach_non_finite_check_and_unscale_(
            f32, found, (1.0 / scaler.scale).reshape(1))
        return dict(zip(names, f32)), found[0] > 0

    def step(self, grads, state: AmpOptimizerState, params,
             found_inf_extra=None, loss_id: int = 0, sentinel=None,
             sentinel_state=None, unscaled_loss=None,
             collect_metrics: bool = False):
        """Unscale, gate on overflow, update, write back; returns
        ``(params, state, info)``, ``info`` holding ``found_inf``,
        ``loss_scale`` and ``skipped``. With a ``sentinel``
        (``resilience.sentinel.AnomalySentinel``), its state and the
        step's unscaled loss, an anomalous loss also gates the update
        (without touching the scaler), and ``info`` carries the advanced
        ``sentinel_state`` and the ``verdict``. ``collect_metrics`` adds
        ``grad_norm``, the L2 norm of the unscaled fp32 grads."""
        grads_f32, found_inf = self.unscale_grads(grads, state, loss_id)
        if found_inf_extra is not None:
            found_inf = found_inf | torch.as_tensor(
                found_inf_extra, device=found_inf.device).bool()
        gate_extra = None
        if sentinel is not None:
            if sentinel_state is None or unscaled_loss is None:
                raise ValueError(
                    "sentinel wiring needs sentinel_state and unscaled_loss")
            gate_extra = sentinel.is_anomalous_loss(sentinel_state,
                                                    unscaled_loss)
        params, new_state, info = self.step_unscaled(
            grads_f32, state, params, {loss_id: found_inf},
            gate_extra=gate_extra, collect_metrics=collect_metrics)
        if sentinel is not None:
            new_sent, verdict = sentinel.update(
                sentinel_state, unscaled_loss, anomaly=info["skipped"],
                bad_params=sentinel.check_params(params))
            info["sentinel_state"] = new_sent
            info["verdict"] = verdict
        return params, new_state, info

    def step_unscaled(self, grads_f32, state: AmpOptimizerState, params,
                      found_infs: Dict[int, Any], gate_extra=None,
                      collect_metrics: bool = False):
        """Apply already-unscaled fp32 grads (the sum of one
        :meth:`unscale_grads` per contributing loss). ``found_infs`` maps
        each contributing loss_id to its overflow flag: the step is
        skipped if any of them overflowed, each scaler advances on its own
        flag, and the scalers of losses that did not contribute stay
        untouched. ``gate_extra`` suppresses the update without touching
        any scaler (the sentinel's hook)."""
        params = _named(params)
        n = len(state.scaler) if isinstance(state.scaler, tuple) else 1
        bad = [i for i in found_infs if not 0 <= i < n]
        if bad or not found_infs:
            raise ValueError(f"found_infs keys {sorted(found_infs)} invalid "
                             f"for num_losses={n}")
        flags = [torch.as_tensor(f).bool() for f in found_infs.values()]
        found_inf = flags[0]
        for f in flags[1:]:
            found_inf = found_inf | f.to(found_inf.device)
        gate = found_inf
        if gate_extra is not None:
            gate = gate | torch.as_tensor(gate_extra,
                                          device=gate.device).bool()
        master, inner = state.master, state.inner
        if not bool(gate):  # the step's one host read
            with torch.no_grad():
                updates, inner = self.tx.update(grads_f32, inner, master)
                keys = list(master)
                ms = [master[k] for k in keys]
                us = [updates[k] for k in keys]
                if all(u.dtype == m.dtype for m, u in zip(ms, us)):
                    new = torch._foreach_add(ms, us)
                else:  # promote, add, round back (optax.apply_updates)
                    new = [(m + u).to(m.dtype) for m, u in zip(ms, us)]
                torch._foreach_copy_([params[k] for k in keys], new)
                master = (dict(zip(keys, new)) if self.policy.master_weights
                          else params)
        if isinstance(state.scaler, tuple):
            scaler = tuple(
                self.scaler.update(s, found_infs[i]) if i in found_infs
                else s for i, s in enumerate(state.scaler))
            scale_now = scaler[min(found_infs)].scale
        else:
            scaler = self.scaler.update(state.scaler, found_inf)
            scale_now = scaler.scale
        new_state = AmpOptimizerState(master=master, inner=inner,
                                      scaler=scaler)
        info = {"found_inf": found_inf, "loss_scale": scale_now,
                "skipped": gate}
        if collect_metrics:
            from apex_tpu_torch.ops.multi_tensor import multi_tensor_l2norm

            info["grad_norm"] = multi_tensor_l2norm(grads_f32)
        return params, new_state, info

    @staticmethod
    def journal_fields(info: dict) -> dict:
        """The flight-recorder slice of a :meth:`step` ``info`` as host
        scalars: loss scale, the overflow and skip gates, the verdict and
        the grad norm where present."""
        out = {}
        for key in ("loss_scale", "found_inf", "skipped", "verdict",
                    "grad_norm"):
            if key in info:
                v = info[key]
                out[key] = (int(v) if key == "verdict"
                            else bool(v) if key in ("found_inf", "skipped")
                            else float(v))
        return out

    # -- checkpointing (amp.state_dict, ref frontend.py:367-404) ----------

    def state_dict(self, state: AmpOptimizerState) -> dict:
        if isinstance(state.scaler, tuple):
            return {"scalers": [self.scaler.state_dict(s)
                                for s in state.scaler]}
        return {"scaler": self.scaler.state_dict(state.scaler)}

    def load_state_dict(self, state: AmpOptimizerState, d: dict
                        ) -> AmpOptimizerState:
        """Restore the scaler states; a checkpoint of another
        ``num_losses`` is refused."""
        first = (state.scaler[0] if isinstance(state.scaler, tuple)
                 else state.scaler)
        device = first.scale.device
        if "scalers" in d:
            if len(d["scalers"]) != self.num_losses:
                raise ValueError(
                    f"checkpoint has {len(d['scalers'])} scalers but this "
                    f"AmpOptimizer was initialized with "
                    f"num_losses={self.num_losses}")
            return state.replace(scaler=tuple(
                self.scaler.load_state_dict(s, device)
                for s in d["scalers"]))
        if self.num_losses > 1:
            raise ValueError("single-scaler checkpoint but this AmpOptimizer "
                             f"was initialized with "
                             f"num_losses={self.num_losses}")
        return state.replace(
            scaler=self.scaler.load_state_dict(d["scaler"], device))


def master_params(state: AmpOptimizerState) -> Optional[Tensors]:
    """The masters an ``AmpOptimizer`` state owns (ref
    ``apex.amp.master_params``): fp32 copies under O2, else the model's
    own tensors."""
    return state.master
