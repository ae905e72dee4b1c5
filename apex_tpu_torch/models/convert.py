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

An MoE layer's ``mlp/router`` (h, E), ``mlp/w_in`` (E, h, ffn) and
``mlp/w_out`` (E, ffn, h) carry the flax names too; under expert
parallelism a rank keeps its slice of the experts
(:func:`moe_params_from_jax`).

The amp slice adds the MLP's list tree (``weights.<i>``), the modules
whose flax parameters already have torch's layout (``mlp.MLP``,
``fused_dense``, ``normalization``: a path join), the DCGAN example's G
and D (Dense kernels transposed, Conv kernels HWIO -> OIHW,
ConvTranspose kernels flipped in both spatial dims as HWIO -> IOHW),
any optimizer state whose fields the port's dataclass shares, and
``AmpOptimizerState`` (masters, inner state, scaler states).
"""

from typing import Any, Dict

import numpy as np
import torch

from apex_tpu_torch._kernels import resolve_device
from apex_tpu_torch.amp.optimizer import AmpOptimizerState
from apex_tpu_torch.amp.scaler import LossScalerState
from apex_tpu_torch.optimizers.fused_adam import FusedAdamState

__all__ = ["amp_state_from_jax", "bert_params_from_jax",
           "bert_tp_params_from_jax",
           "dcgan_params_from_jax", "fused_adam_state_from_jax",
           "gpt_params_from_jax", "gpt_pipeline_params_from_jax",
           "gpt_tp_params_from_jax", "mlp_params_from_jax",
           "module_params_from_jax", "moe_params_from_jax",
           "optimizer_state_from_jax",
           "resnet_params_from_jax", "scaler_state_from_jax"]


def _from_numpy(a) -> torch.Tensor:
    """A numpy array as a tensor; numpy's bfloat16 (``ml_dtypes``), which
    torch cannot read, goes through fp32 exactly."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def gpt_params_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's ``GPTModel`` state_dict from a JAX ``GPTModel`` params
    tree (nested dicts of numpy arrays, e.g. ``variables["params"]``); any
    tree, keyed by its paths joined with dots (a list's items by their
    index)."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        else:
            out[".".join(path)] = _from_numpy(node)

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


def moe_params_from_jax(params: Dict[str, Any], num_experts: int,
                        rank: int = 0, ep: int = 1
                        ) -> Dict[str, torch.Tensor]:
    """A ``GPTModel`` (or ``MoEMLP``) state_dict from a JAX tree with MoE
    layers, for expert-parallel rank ``rank`` of ``ep``: the path join of
    :func:`gpt_params_from_jax`, with every ``w_in`` and ``w_out`` that
    holds all ``num_experts`` experts (a tree built outside ``shard_map``)
    cut to the rank's ``num_experts / ep``; one that already holds a
    rank's experts (read per device, :func:`gpt_tp_params_from_jax`)
    stays as it is."""
    if num_experts % ep:
        raise ValueError(f"num_experts ({num_experts}) not divisible by "
                         f"ep ({ep})")
    local = num_experts // ep
    out = gpt_params_from_jax(params)
    for name, t in out.items():
        if (name.rsplit(".", 1)[-1] in ("w_in", "w_out")
                and t.shape[0] == num_experts and local != num_experts):
            out[name] = t[rank * local:(rank + 1) * local].clone()
    return out


def bert_params_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's ``BertModel`` state_dict from a JAX ``BertModel`` params
    tree: the same path join as :func:`gpt_params_from_jax` (the LM head's
    norm parameters are direct parameters of the model on both sides)."""
    return gpt_params_from_jax(params)


def bert_tp_params_from_jax(params: Dict[str, Any], rank: int
                            ) -> Dict[str, torch.Tensor]:
    """Port rank ``rank``'s ``BertModel`` state_dict from a JAX BERT params
    tree built inside ``shard_map`` at tp > 1 (each device holding its own
    shards under a sharding that claims replication): each leaf from
    device ``rank``'s buffer, as :func:`gpt_tp_params_from_jax` reads a
    GPT's; the replicated heads read the same on every device."""
    return gpt_tp_params_from_jax(params, rank)


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


def module_params_from_jax(params: Dict[str, Any]
                           ) -> Dict[str, torch.Tensor]:
    """The state_dict of a module whose flax parameters have torch's
    layout already (``mlp.MLP``: ``weight_<i>`` (out, in), ``bias_<i>``;
    ``fused_dense``; ``normalization``): the path join."""
    return gpt_params_from_jax(params)


def mlp_params_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``ops.mlp``'s dict from the JAX ``mlp_init`` tree ``{"weights":
    [...], "biases": [...]}``: ``weights.<i>``, ``biases.<i>``."""
    return gpt_params_from_jax(params)


def dcgan_params_from_jax(params: Dict[str, Any]
                          ) -> Dict[str, torch.Tensor]:
    """The DCGAN example's G or D state_dict from its flax params:
    ``Dense_*`` kernels (in, out) transposed, ``Conv_*`` kernels HWIO ->
    OIHW, ``ConvTranspose_*`` kernels flipped in both spatial dims and
    HWIO -> IOHW (``examples.dcgan.main_amp.ConvTranspose``), GroupNorm
    scales and every bias as they are."""
    out = {}
    for key, v in gpt_params_from_jax(params).items():
        scope, dot, leaf = key.rpartition(".")
        if leaf == "kernel":
            if scope.startswith("ConvTranspose"):
                v = v.flip(0, 1).permute(2, 3, 0, 1)
            elif scope.startswith("Conv"):
                v = v.permute(3, 2, 0, 1)
            else:
                v = v.t()
            key = scope + dot + "weight"
        out[key] = v.contiguous()
    return out


def optimizer_state_from_jax(state, state_cls, device="cuda",
                             params_from_jax=None):
    """A port optimizer state (the dataclass ``state_cls``) from the JAX
    transform's NamedTuple state with the same field names: each tree of
    parameters through ``params_from_jax`` (the path join by default),
    each scalar a tensor of its dtype. A tree of per-tensor scalars
    (NovoGrad's second moment) takes the path join."""
    import dataclasses

    dev = resolve_device(device)
    convert = params_from_jax or gpt_params_from_jax
    fields = {}
    for f in dataclasses.fields(state_cls):
        v = getattr(state, f.name)
        if isinstance(v, dict):
            scalars = all(np.ndim(x) == 0 for x in
                          gpt_params_from_jax(v).values())
            tree = (gpt_params_from_jax if scalars else convert)(v)
            fields[f.name] = {k: t.to(dev) for k, t in tree.items()}
        else:
            fields[f.name] = torch.as_tensor(np.array(v), device=dev)
    return state_cls(**fields)


def amp_state_from_jax(state, inner_from_jax, device="cuda",
                       params_from_jax=None) -> AmpOptimizerState:
    """The port's ``AmpOptimizerState`` from a JAX one: the masters
    through ``params_from_jax`` (the path join by default), the inner
    state through ``inner_from_jax(inner, device)``, and the scaler state
    or tuple of them. Without master weights (O0, O3) the port's masters
    are the model's own tensors: hand those in after loading the
    parameters (``state.replace(master=params)``)."""
    dev = resolve_device(device)
    convert = params_from_jax or gpt_params_from_jax
    master = {k: v.to(dev) for k, v in convert(state.master).items()}
    scaler = (tuple(scaler_state_from_jax(s, dev) for s in state.scaler)
              if isinstance(state.scaler, tuple)
              else scaler_state_from_jax(state.scaler, dev))
    return AmpOptimizerState(master=master,
                             inner=inner_from_jax(state.inner, dev),
                             scaler=scaler)
