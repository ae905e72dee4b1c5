"""Pipelined-GPT building blocks for ``forward_backward_with_pre_post``
(counterpart of apex_tpu/models/gpt_pipeline.py).

GPT is split as: the ``Embedding`` (pre, replicated over pp) →
``num_layers / pp`` transformer layers a stage (``ParallelTransformer``
without its final norm, layers named ``layer_0 ..`` on every stage) →
the final LayerNorm, an untied vocabulary head and the token-mean cross
entropy (post, replicated over pp). The functions take their parameters
as dicts of tensors (``torch.func.functional_call`` on the modules), so
the schedules differentiate with respect to exactly what they are
given. The JAX module's two sequence-parallel rules hold:

- the ``Embedding`` already scatters its output to the sequence-parallel
  region, so ``pre_fn`` does not scatter again;
- under sequence parallelism each tp rank scores its own sequence shard,
  so the post parameters go through
  ``copy_to_tensor_model_parallel_region`` (identity forward, all-reduce
  backward) to complete their tp-partial gradients, the labels are
  sliced to the rank's shard, and the loss is divided by tp (the sum
  over tp is the token mean).

The post norm runs the LayerNorm kernel with fp32 scale and bias, as
JAX casts them, and the head's product is fp32 (JAX promotes the
compute-dtype hidden states against the fp32 head).
"""

import dataclasses
from typing import Any, Callable, NamedTuple

import torch
from torch.func import functional_call

from apex_tpu_torch._kernels import resolve_device
from apex_tpu_torch.models.gpt import Embedding, init_params
from apex_tpu_torch.ops.layer_norm import layer_norm
from apex_tpu_torch.ops.xentropy import softmax_cross_entropy_loss
from apex_tpu_torch.parallel import parallel_state as ps
from apex_tpu_torch.parallel.mappings import (
    copy_to_tensor_model_parallel_region,
)
from apex_tpu_torch.transformer.config import TransformerConfig
from apex_tpu_torch.transformer.layer import (
    ParallelTransformer,
    check_supported,
    sequence_parallel,
)

__all__ = ["GPTPipelineParts", "HEAD_STD", "build_gpt_pipeline"]

# the untied head's initial std, JAX's ``init_post``'s: at hidden h the
# initial logits have variance h HEAD_STD^2 (the final norm's rows have
# unit variance), so the first loss is about ln(vocab) + h HEAD_STD^2 / 2
HEAD_STD = 0.05


class GPTPipelineParts(NamedTuple):
    embed: Any
    chunk: Any
    pre_fn: Callable
    stage_fn: Callable
    post_loss_fn: Callable
    init_post: Callable


def build_gpt_pipeline(cfg: TransformerConfig, pp: int,
                       device="cuda") -> GPTPipelineParts:
    """The modules (on ``device``, CUDA unless the caller names another)
    and the functions of the pipelined GPT. ``init_post(seed)`` draws the
    post parameters: norm ones and zeros, head ``HEAD_STD N(0, 1)`` (JAX's
    0.05) from a CPU generator of ``seed``, the same on every rank. The modules' weights are drawn as ``GPTModel``'s
    (``models.gpt.init_params``, seed 0); a run draws or loads its own."""
    if cfg.num_layers % pp != 0:
        raise ValueError(
            f"num_layers ({cfg.num_layers}) not divisible by pp ({pp})")
    check_supported(cfg)
    device = resolve_device(device)
    embed = Embedding(cfg, device=device)
    chunk = ParallelTransformer(
        dataclasses.replace(cfg, num_layers=cfg.num_layers // pp),
        post_layer_norm=False, device=device)
    for m in (embed, chunk):
        init_params(m, 0)

    def pre_fn(pre_params, tokens_mb):
        # Embedding scatters to the sequence-parallel region itself
        return functional_call(embed, pre_params, (tokens_mb,))

    def stage_fn(chunk_params, h):
        return functional_call(chunk, chunk_params, (h,))

    def post_loss_fn(post_params, y, labels_mb):
        tp = ps.get_tensor_model_parallel_world_size()
        sp = sequence_parallel(cfg)
        scale, bias, head = (post_params["norm_scale"],
                             post_params["norm_bias"], post_params["head"])
        lab = labels_mb
        if sp:
            scale, bias, head = (copy_to_tensor_model_parallel_region(t)
                                 for t in (scale, bias, head))
            r = ps.get_tensor_model_parallel_rank()
            lab = labels_mb[:, r * y.shape[0]:(r + 1) * y.shape[0]]
        h = layer_norm(y, scale.float(), bias.float()).to(y.dtype)
        logits = torch.einsum("sbh,hv->sbv", h.float(),
                              head.float()).transpose(0, 1)
        loss = softmax_cross_entropy_loss(logits, lab).mean()
        return loss / tp if sp else loss

    def init_post(seed: int):
        gen = torch.Generator().manual_seed(seed)
        h, v = cfg.hidden_size, cfg.vocab_size
        return {"norm_scale": torch.ones(h, device=device),
                "norm_bias": torch.zeros(h, device=device),
                "head": (HEAD_STD * torch.randn(h, v, generator=gen)
                         ).to(device)}

    return GPTPipelineParts(embed, chunk, pre_fn, stage_fn, post_loss_fn,
                            init_post)
