"""The GPT training step (counterpart of
apex_tpu/resilience/replay/targets.py's ``build_gpt_training``).

One home for the GPT step, as in the JAX package: the bf16 GPT model,
``fused_adam`` behind the data-parallel gradient all-reduce, or ZeRO-2's
``distributed_fused_adam`` (``zero``), dynamic loss scaling with
``GradScaler``, the anomaly-sentinel gate, the chaos ``poison_loss`` arm
and the escalation ``lr_scale`` input, in the JAX step's order.

``build_gpt_training(cfg)`` returns a :class:`GPTTraining` with
``init_state``, ``reshape_batch`` and ``train_step``;
``examples/gpt/pretrain_gpt.py`` drives it, folding each step's scalars
into a ``monitor.MetricBag`` of :data:`METRIC_SPEC` (``init_bag``) on the
device.

Each process is one rank: tensor-parallel size ``tp`` (with sequence
parallelism under ``sequence_parallel``), and data-parallel size the
world's size over tp (``parallel_state`` over the initialized
``torch.distributed`` world; a world of one without it). Every rank takes
the whole ``(num_micro, micro_batch * dp, seq)`` batch and trains on its
columns ``[d * micro_batch, (d + 1) * micro_batch)``, the JAX step's
``P(None, "dp")``.

``compression`` ("int8" or "fp8", ``compression_block`` elements a
scale) sends the data-parallel gradient sync through
``parallel.compress``: under ZeRO the optimizer owns the quantized
reduce-scatter and its error-feedback residual (a state field); under
DDP each gradient takes the quantized all-reduce and the residuals ride
in the optimizer-state slot as ``{"opt", "ef_residual"}``, updated on
gated steps too (a poisoned residual resets to zero). The scaler's
``found_inf`` consensus stays exact. ``collect_layer_rms`` appends to the
step's outputs the (layers,) fp32 RMS of each layer's output in depth
order: each micro-batch's per-layer RMS (the layers'
``layer_out_rms``) squared, averaged over the micro-batches, all-reduced
to the mean over tp and then over dp, and its square root.
"""

import dataclasses
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from apex_tpu_torch._kernels import resolve_device
from apex_tpu_torch.amp import GradScaler, LossScalerState
from apex_tpu_torch.models.gpt import GPTModel, gpt_loss_fn
from apex_tpu_torch.monitor.metrics import metric_bag
from apex_tpu_torch.optimizers import (
    DistributedFusedAdamState,
    FusedAdamState,
    distributed_fused_adam,
    fused_adam,
)
from apex_tpu_torch.parallel import compress
from apex_tpu_torch.parallel import parallel_state as ps
from apex_tpu_torch.parallel.ddp import all_reduce_gradients
from apex_tpu_torch.resilience.chaos import poison_loss
from apex_tpu_torch.resilience.sentinel import AnomalySentinel, SentinelState
from apex_tpu_torch.transformer import TransformerConfig
from apex_tpu_torch.transformer.utils import calc_params_l2_norm
from apex_tpu_torch.utils.pytree import tree_any_non_finite

__all__ = ["GPTTargetConfig", "GPTTrainState", "GPTTraining",
           "METRIC_SPEC", "build_gpt_training", "synthetic_corpus",
           "tp_duplicated"]

#: the step's in-step metric taps and their bag modes (the JAX step's
#: ``metric_spec``): the scalars the host wants to SEE accumulate on the
#: device and cross once per log interval
METRIC_SPEC = {
    "loss": "mean",          # unscaled, dp-averaged
    "grad_norm": "mean",     # global L2 of the unscaled grads
    "loss_scale": "last",    # dynamic-scaler gauge
    "loss_z": "last",        # sentinel z-score of this loss
    "skipped": "sum",        # updates suppressed this interval
    "anomalies": "last",     # sentinel's running total this run
}


def synthetic_corpus(vocab: int, n_tokens: int = 200_000) -> np.ndarray:
    """The JAX package's deterministic synthetic token stream (a seeded
    markov-ish walk, so the LM has structure to learn), as an int32
    array; no file is written."""
    rng = np.random.RandomState(0)
    toks = np.cumsum(rng.randint(1, 5, size=(n_tokens,)), dtype=np.int64) % vocab
    return toks.astype(np.int32)


@dataclasses.dataclass(frozen=True)
class GPTTargetConfig:
    """Everything the GPT step depends on; the JAX package's fields and
    defaults."""

    vocab: int = 512
    seq_len: int = 128
    layers: int = 4
    hidden: int = 256
    heads: int = 8
    tp: int = 1
    sequence_parallel: bool = True
    micro_batch: int = 4
    global_batch: int = 16
    lr: float = 3e-4
    weight_decay: float = 0.01
    seed: int = 0
    zero: bool = False
    compression: str = "none"
    compression_block: int = 128
    spike_z: float = 6.0
    spike_warmup: int = 10
    skip_budget: int = 1
    rollback_budget: int = 2
    collect_layer_rms: bool = False
    max_devices: Optional[int] = None


@dataclasses.dataclass
class GPTTrainState:
    """The state a step carries. ``params`` are the model's own
    parameters (by name), so updating them updates the model."""

    params: Dict[str, torch.nn.Parameter]
    # under DDP with compression: {"opt": FusedAdamState, "ef_residual":
    # fp32 residuals by parameter name}
    opt: Union[FusedAdamState, DistributedFusedAdamState, Dict[str, Any]]
    scaler: LossScalerState
    sentinel: SentinelState


@dataclasses.dataclass
class GPTTraining:
    """The built pieces :func:`build_gpt_training` returns."""

    cfg: GPTTargetConfig
    device: torch.device
    dp: int
    num_micro: int
    model: GPTModel
    transformer_config: TransformerConfig
    opt: Any
    scaler: GradScaler
    sentinel: AnomalySentinel
    compression: Optional[compress.CompressionConfig] = None

    @property
    def ddp_compressed(self) -> bool:
        """Does the residual ride in the optimizer-state slot (DDP with
        compression)?"""
        return self.compression is not None and not self.cfg.zero

    def init_state(self) -> GPTTrainState:
        """Re-draws the model's weights from ``cfg.seed`` and returns
        fresh optimizer, scaler and sentinel states."""
        self.model.init_weights(self.cfg.seed)
        params = dict(self.model.named_parameters())
        opt = self.opt.init(params)
        if self.ddp_compressed:
            opt = {"opt": opt, "ef_residual": compress.ef_init(params)}
        return GPTTrainState(params, opt, self.scaler.init(self.device),
                             self.sentinel.init(self.device))

    def init_bag(self):
        """A fresh ``monitor.MetricBag`` of :data:`METRIC_SPEC` on this
        rank's device, for :meth:`train_step`'s ``bag``."""
        return metric_bag(METRIC_SPEC, device=self.device)

    def layer_rms(self) -> torch.Tensor:
        """The layers' last ``layer_out_rms``, (layers,) in depth order."""
        tr = self.model.transformer
        return torch.stack([getattr(tr, f"layer_{i}").layer_out_rms
                            for i in range(tr.num_layers)])

    def reshape_batch(self, x, y):
        """(global_batch, seq) arrays -> the step's (num_micro,
        micro_batch * dp, seq) layout."""
        shape = (self.num_micro, self.cfg.micro_batch * self.dp,
                 self.cfg.seq_len)
        return x.reshape(shape), y.reshape(shape)

    def train_step(self, state: GPTTrainState, tokens, labels,
                   inject_nan=0.0, lr_scale=1.0, bag=None):
        """One step: ``(state, loss, verdict, metrics)``, and with
        ``collect_layer_rms`` the (layers,) RMS vector (a list of floats)
        fifth.

        ``tokens`` and ``labels`` are (num_micro, micro_batch * dp, seq)
        integer arrays or tensors, the same on every rank; this rank
        takes its dp columns. The order is the JAX step's: each
        microbatch's mean loss, times ``scale / num_micro`` (and poisoned
        when ``inject_nan``), is backpropagated and the grads accumulate;
        without ZeRO they are averaged over dp (ZeRO's reduce-scatter in
        the optimizer takes each rank's own); then unscale with the
        overflow flag of the scaled grads, summed over tp and pp (and dp
        under ZeRO, so that no rank steps while another skips), the
        scaler update, ``unscaled`` = the dp mean of ``loss / scale``
        (tp-replicated already), and the gate ``found_inf |
        sentinel.is_anomalous_loss(unscaled)``, the same on every rank.
        On a clean step Adam runs and ``p += lr_scale * update``; on a
        gated step params and Adam state stay as they were. Last the
        sentinel update, with ``bad_params`` from the post-update params.
        ``grad_norm`` is the tp-aware norm of the unscaled grads the
        optimizer takes. With ``bag`` (from :meth:`init_bag`) the six
        metrics are folded into it on the device before the transfer.

        Parameters are updated IN PLACE and ``state`` is updated and
        returned; after the step each ``p.grad`` holds this rank's scaled
        grads. The gate costs one host sync per step (the JAX step keeps
        it on the device with ``vma_cond``), and the loss, verdict and the
        six quantities of the JAX step's ``metric_spec`` come back in one
        transfer at the end as plain floats.
        """
        dev = self.device
        cols = slice(ps.get_data_parallel_rank() * self.cfg.micro_batch,
                     (ps.get_data_parallel_rank() + 1) * self.cfg.micro_batch)
        tokens = torch.as_tensor(tokens)[:, cols].to(dev).long()
        labels = torch.as_tensor(labels)[:, cols].to(dev).long()
        params = state.params
        scale = state.scaler.scale
        for p in params.values():
            p.grad = None
        micro_losses, rms_sq = [], None
        for i in range(self.num_micro):
            li = gpt_loss_fn(self.model(tokens[i], labels=labels[i]))
            micro_losses.append(li.detach())
            if self.cfg.collect_layer_rms:
                sq = self.layer_rms().square()
                rms_sq = sq if rms_sq is None else rms_sq + sq
            poison_loss(li * (scale / self.num_micro), inject_nan).backward()

        with torch.no_grad():
            loss = poison_loss(
                self.scaler.scale(state.scaler,
                                  torch.stack(micro_losses).mean()),
                inject_nan)
            grads = {n: p.grad for n, p in params.items()}
            opt_state, new_ef = state.opt, None
            if self.ddp_compressed:
                opt_state = state.opt["opt"]
                grads, new_ef = all_reduce_gradients(
                    grads, compression=self.compression,
                    ef_state=state.opt["ef_residual"])
            elif not self.cfg.zero:
                grads = all_reduce_gradients(grads)
            grads, found_inf = self.scaler.unscale(state.scaler, grads)
            new_scaler = self.scaler.update(state.scaler, found_inf)
            unscaled = ps.all_reduce(loss / scale,
                                     ps.get_data_parallel_group()) / self.dp
            gate = found_inf | self.sentinel.is_anomalous_loss(
                state.sentinel, unscaled)
            if not bool(gate):  # the step's one host sync
                updates, opt_state = self.opt.update(grads, opt_state, params)
                for n, p in params.items():
                    p.add_(updates[n] * lr_scale)
            # the residual updates on gated steps too (ef_update resets
            # poisoned elements)
            state.opt = (opt_state if new_ef is None
                         else {"opt": opt_state, "ef_residual": new_ef})
            layer_rms = None
            if rms_sq is not None:
                mean_sq = rms_sq / self.num_micro
                for group in (ps.get_tensor_model_parallel_group(),
                              ps.get_data_parallel_group()):
                    mean_sq = ps.all_reduce(mean_sq, group) / ps.group_size(
                        group)
                layer_rms = torch.sqrt(mean_sq)
            sent = state.sentinel
            new_sent, verdict = self.sentinel.update(
                sent, unscaled, anomaly=gate,
                bad_params=tree_any_non_finite(params))
            loss_z = torch.where(
                sent.count > 0,
                (unscaled - sent.ema) * torch.rsqrt(sent.var + 1e-12),
                torch.zeros_like(unscaled))
            grad_norm = calc_params_l2_norm(
                grads, tp_duplicate_predicate=tp_duplicated,
                group=ps.get_tensor_model_parallel_group())
            if bag is not None:
                bag.add(loss=unscaled, grad_norm=grad_norm,
                        loss_scale=new_scaler.scale, loss_z=loss_z,
                        skipped=gate, anomalies=new_sent.anomalies)
            vals = torch.stack([
                unscaled, grad_norm, new_scaler.scale,
                loss_z, gate.float(), new_sent.anomalies.float(),
                verdict.float(),
            ]).tolist()
        state.scaler, state.sentinel = new_scaler, new_sent
        metrics = dict(zip(("loss", "grad_norm", "loss_scale", "loss_z",
                            "skipped", "anomalies"), vals[:6]))
        if layer_rms is not None:
            return state, vals[0], int(vals[6]), metrics, layer_rms.tolist()
        return state, vals[0], int(vals[6]), metrics


def tp_duplicated(path: str) -> bool:
    """Tp-replicated parameters, counted once in the tp-aware grad norm:
    norms, the position table and row-parallel biases (the JAX step's
    predicate, on ``/``-joined paths)."""
    return ("layernorm" in path or "position_embeddings" in path
            or path.endswith("dense/bias")
            or path.endswith("dense_4h_to_h/bias"))


def build_gpt_training(cfg: GPTTargetConfig, device="cuda") -> GPTTraining:
    """The GPT training step of ``cfg`` on this rank's device (CUDA unless
    the caller names another), with the JAX package's batch-geometry
    checks and its model, optimizer, scaler and sentinel settings.
    Initializes ``parallel_state`` for ``cfg.tp`` over the initialized
    world (process-global, as in JAX); ``max_devices``, where set, must
    be the world's size."""
    dev = resolve_device(device)
    world = (torch.distributed.get_world_size()
             if torch.distributed.is_initialized() else 1)
    if cfg.max_devices is not None and cfg.max_devices != world:
        raise ValueError(f"max_devices={cfg.max_devices}, but the world "
                         f"has {world} process(es), one a device")
    ps.initialize_model_parallel(tensor_model_parallel_size=cfg.tp)
    dp = ps.get_data_parallel_world_size()
    num_micro = cfg.global_batch // (cfg.micro_batch * dp)
    assert num_micro >= 1, "global batch too small for micro batch x dp"
    assert cfg.global_batch % (cfg.micro_batch * dp) == 0, (
        f"global batch {cfg.global_batch} must divide evenly into "
        f"micro_batch ({cfg.micro_batch}) x dp ({dp}) microbatches"
    )
    tcfg = TransformerConfig(
        num_layers=cfg.layers, hidden_size=cfg.hidden,
        num_attention_heads=cfg.heads, vocab_size=cfg.vocab,
        max_position_embeddings=cfg.seq_len, hidden_dropout=0.0,
        attention_dropout=0.0,
        sequence_parallel=cfg.sequence_parallel and cfg.tp > 1,
        compute_dtype=torch.bfloat16,
        collect_layer_metrics=cfg.collect_layer_rms)
    model = GPTModel(tcfg, device=dev, seed=cfg.seed)
    compression = None
    if cfg.compression != "none":
        compression = compress.CompressionConfig(
            dtype=cfg.compression, block_size=cfg.compression_block)
    if cfg.zero:
        # its reduce-scatter is the dp gradient sync (average_grads
        # completes the mean); with compression it owns the residual
        opt = distributed_fused_adam(lr=cfg.lr, weight_decay=cfg.weight_decay,
                                     axis_name="dp", average_grads=True,
                                     compression=compression)
    else:
        opt = fused_adam(lr=cfg.lr, weight_decay=cfg.weight_decay)
    return GPTTraining(
        cfg=cfg, device=dev, dp=dp, num_micro=num_micro, model=model,
        transformer_config=tcfg, opt=opt,
        # under ZeRO each rank's grads are its own until the optimizer's
        # reduce-scatter: the overflow flag joins the dp consensus too
        scaler=GradScaler(loss_scale="dynamic", model_parallel_axes=(
            ("tp", "pp", "dp") if cfg.zero else ("tp", "pp"))),
        sentinel=AnomalySentinel(z_threshold=cfg.spike_z,
                                 warmup_steps=cfg.spike_warmup,
                                 skip_budget=cfg.skip_budget,
                                 rollback_budget=cfg.rollback_budget),
        compression=compression,
    )
