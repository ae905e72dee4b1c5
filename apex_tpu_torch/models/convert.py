"""Weights and training state from the JAX package's trees.

The port's GPT and BERT modules carry the flax names and the flax
``(in, out)`` kernel layout, so a flax ``params`` tree maps onto the
port's ``state_dict`` by joining each path with dots: nothing is
transposed or regrouped (the fused QKV kernel is per-head interleaved on
both sides).
The ResNet's modules carry the flax names too, with torch's layouts: a
convolution's HWIO kernel becomes an OIHW ``weight``, the head's (in,
out) kernel a transposed one, and ``batch_stats`` become the BatchNorm
buffers.
The same naming carries the JAX ``fused_adam`` moments (per leaf, or one
flat buffer already in the shared leaf order) and the loss scaler's
state, so both frameworks can start from one mid-training state. Inputs
are trees of numpy arrays (``jax.tree_util.tree_map(np.asarray, ...)``).
"""

from typing import Any, Dict

import numpy as np
import torch

from apex_tpu_torch._kernels import resolve_device
from apex_tpu_torch.amp.scaler import LossScalerState
from apex_tpu_torch.optimizers.fused_adam import FusedAdamState

__all__ = ["bert_params_from_jax", "fused_adam_state_from_jax",
           "gpt_params_from_jax", "gpt_pipeline_params_from_jax",
           "gpt_tp_params_from_jax",
           "resnet_params_from_jax", "scaler_state_from_jax"]


def gpt_params_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's ``GPTModel`` state_dict from a JAX ``GPTModel`` params
    tree (nested dicts of numpy arrays, e.g. ``variables["params"]``); any
    tree, keyed by its paths joined with dots."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (str(k),))
        else:
            out[".".join(path)] = torch.from_numpy(np.array(node))

    walk(params, ())
    return out


def gpt_tp_params_from_jax(params: Dict[str, Any], rank: int
                           ) -> Dict[str, torch.Tensor]:
    """Port rank ``rank``'s ``GPTModel`` state_dict from a JAX params tree
    built inside ``shard_map`` at tp > 1 with ``out_specs=P()`` and
    ``check_vma=False`` (the JAX ``GPTTraining.init_state``): each device
    holds its own shards under a sharding that claims replication, so a
    plain ``np.asarray`` reads device 0's. Each leaf is read from the
    buffer of device ``rank`` (its ``addressable_shards`` by device id),
    the device that mesh position ``rank`` holds on the CPU mesh, as port
    rank ``rank`` does (``parallel.parallel_state``)."""
    def shard(leaf):
        shards = sorted(leaf.addressable_shards, key=lambda s: s.device.id)
        return np.asarray(shards[rank].data)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return shard(node)

    return gpt_params_from_jax(walk(params))


def gpt_pipeline_params_from_jax(params: Dict[str, Any], rank: int,
                                 tensor_model_parallel_size: int = 1
                                 ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Port rank ``rank``'s ``{"pre", "stages", "post"}`` (each a dict of
    dotted names, as ``models.gpt_pipeline``'s functions take them) from
    the JAX pipelined GPT's params tree, in either form:

    - built inside ``shard_map`` with ``out_specs=P()`` (``run_gpt``):
      each device holds its own stage (and tp shards) under a sharding
      that claims replication, so every leaf is read from device
      ``rank``'s buffer, as :func:`gpt_tp_params_from_jax` reads them;
    - the stacked host tree of numpy arrays (``tests/test_pipeline_gpt.py``
      ``init_all``): ``stages`` leaves lead with the pp dim (then V when
      interleaved), and port rank ``rank`` is pp rank ``rank //
      tensor_model_parallel_size mod pp``; ``pre`` and ``post`` are
      replicated."""
    def read(leaf, stage):
        if hasattr(leaf, "addressable_shards"):
            shards = sorted(leaf.addressable_shards,
                            key=lambda s: s.device.id)
            return np.asarray(shards[rank].data)
        leaf = np.asarray(leaf)
        if stage:
            leaf = leaf[rank // tensor_model_parallel_size % leaf.shape[0]]
        return leaf

    def walk(node, stage):
        if isinstance(node, dict):
            return {k: walk(v, stage) for k, v in node.items()}
        return read(node, stage)

    return {part: gpt_params_from_jax(walk(params[part], part == "stages"))
            for part in ("pre", "stages", "post")}


def bert_params_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's ``BertModel`` state_dict from a JAX ``BertModel`` params
    tree: the same path join as :func:`gpt_params_from_jax` (the LM head's
    norm parameters are direct parameters of the model on both sides)."""
    return gpt_params_from_jax(params)


def resnet_params_from_jax(params: Dict[str, Any],
                           batch_stats: Dict[str, Any]
                           ) -> Dict[str, torch.Tensor]:
    """The port's ``ResNet`` state_dict from a JAX ``ResNet``'s
    ``params`` and ``batch_stats`` trees (nested dicts of numpy arrays)."""
    out = gpt_params_from_jax(batch_stats)
    for key, v in gpt_params_from_jax(params).items():
        scope, dot, leaf = key.rpartition(".")
        if leaf == "kernel":  # HWIO -> OIHW; the head's (in, out) -> (out, in)
            v = v.permute(3, 2, 0, 1) if v.ndim == 4 else v.t()
            key = scope + dot + "weight"
        out[key] = v.contiguous()
    return out


def _tensor(x, device, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def fused_adam_state_from_jax(state, device="cuda") -> FusedAdamState:
    """The port's ``FusedAdamState`` from a JAX ``FusedAdamState`` of
    either engine: tree moments become dicts keyed like the port's
    parameters (a leading ``{"params": ...}`` level of a flax variables
    tree is dropped), flat moments stay one fp32 buffer, whose order the
    two frameworks share."""
    dev = resolve_device(device)

    def moments(tree):
        if isinstance(tree, dict):
            if set(tree) == {"params"}:
                tree = tree["params"]
            return {k: v.to(dev) for k, v in gpt_params_from_jax(tree).items()}
        return _tensor(tree, dev, torch.float32)

    step, exp_avg, exp_avg_sq = state
    return FusedAdamState(_tensor(step, dev, torch.int32), moments(exp_avg),
                          moments(exp_avg_sq))


def scaler_state_from_jax(state, device="cuda") -> LossScalerState:
    """The port's ``LossScalerState`` from a JAX ``LossScalerState``."""
    dev = resolve_device(device)
    return LossScalerState(
        scale=_tensor(state.scale, dev, torch.float32),
        growth_tracker=_tensor(state.growth_tracker, dev, torch.int32),
        skipped=_tensor(state.skipped, dev, torch.int32),
        hysteresis_tracker=_tensor(state.hysteresis_tracker, dev,
                                   torch.int32))
