"""Mixture-of-experts MLP with expert parallelism (counterpart of
apex_tpu/transformer/moe.py; the reference has no MoE).

Switch (top-1) or GShard (top-2) routing with capacity, as the JAX
module does it:

- the router scores each token against E experts in fp32 and takes the
  top k (ties to the lower index, as ``jax.lax.top_k``), with the
  load-balancing loss ``E * sum_e fraction_e * prob_e`` of the first
  choice;
- each of the k passes packs the tokens into an (E, C, h) buffer by the
  cumsum trick, ``C = max(1, int(capacity_factor * tokens / E))`` a
  pass; a token past its expert's capacity is dropped (it adds zero, and
  the residual carries it), and, as JAX scatters it, sends a zero to slot
  (0, 0);
- with the experts split over a group (``expert_axis``, ep ranks of
  ``E / ep`` experts each) one all-to-all sends every rank's slots to
  the experts' owners and a second brings the results home; the experts
  run as one batched product over (src, local_e, C, h).

JAX's two expert products take bf16 operands with an fp32 result
(``preferred_element_type``) and the tanh GELU runs on that fp32 product
before it is cast to the compute dtype. Here the operands are rounded to
the compute dtype and multiplied in fp32 (as ``ops.mlp.dense_f32``
does): a product of two bf16 values is exact in fp32, so only the order
of the sums differs. On the card these products run at the fp32 rate.

JAX returns the auxiliary loss through flax's ``sow``; here each
``MoEMLP`` keeps the loss of its last call (not of a checkpoint's
recompute) as ``aux_loss``, beside the share of its token assignments
that were dropped (``dropped_share``), and :func:`total_moe_aux_loss` sums a
model's, times ``moe_aux_loss_coeff``.
"""

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.parallel import parallel_state as ps
from apex_tpu_torch.parallel.random import (
    data_parallel_generator,
    is_recomputing,
)
from apex_tpu_torch.transformer.config import TransformerConfig

__all__ = ["MoEMLP", "load_balancing_loss", "router_probs",
           "total_moe_aux_loss"]

ROUTER_STD = 0.02  # JAX's normal(0.02) router


def router_probs(logits, num_experts: int, top_k: int):
    """fp32 softmax probabilities, and the top-k gates and experts, ties
    to the lower expert index (a stable sort, as ``jax.lax.top_k``)."""
    del num_experts
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, order = torch.sort(probs, dim=-1, descending=True,
                                  stable=True)
    return probs, gate_vals[..., :top_k], order[..., :top_k]


def load_balancing_loss(probs, expert_idx, num_experts: int):
    """Switch aux loss: E * sum_e (share of first choices on e) * (mean
    probability of e)."""
    f = F.one_hot(expert_idx[..., 0], num_experts).float().mean(dim=0)
    return num_experts * torch.sum(f * probs.mean(dim=0))


def _dispatch_indices(expert_idx, num_experts: int, capacity: int):
    """Each token's slot in its expert's buffer (cumsum trick); -1 for a
    token past the capacity."""
    onehot = F.one_hot(expert_idx, num_experts).to(torch.int32)
    pos = torch.cumsum(onehot, dim=0) * onehot  # 1-based within an expert
    pos_in_expert = pos.sum(dim=-1) - 1
    return torch.where(pos_in_expert < capacity, pos_in_expert,
                       torch.full_like(pos_in_expert, -1))


class _AllToAll(torch.autograd.Function):
    """``parallel_state.all_to_all`` over dim 0; its backward is the same
    exchange of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return ps.all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return ps.all_to_all(g, ctx.group), None


def _expert_group(expert_axis: Optional[str]):
    return None if expert_axis is None else ps.get_group(expert_axis)


def draw_experts(p: torch.Tensor, generator: torch.Generator) -> None:
    """Draws a ``MoEMLP`` parameter in place: the router normal(0.02);
    an expert kernel (local_e, fan_in, fan_out) normal(1/sqrt(fan_in)),
    JAX's lecun scale over the batch axis, drawn for all E experts and
    sliced to this rank's, so every ep size holds the same experts."""
    with torch.no_grad():
        if not hasattr(p, "expert_parallel"):
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=p.device) * ROUTER_STD)
            return
        rank, ep = p.expert_parallel
        local = p.shape[0]
        full = torch.randn((local * ep,) + tuple(p.shape[1:]),
                           generator=generator, device=p.device)
        p.copy_(full[rank * local:(rank + 1) * local]
                / math.sqrt(p.shape[1]))


class MoEMLP(nn.Module):
    """The expert-parallel MoE FFN (Switch top-1, GShard top-2) over
    (tokens, hidden) input. ``num_experts`` is the global count and must
    divide by the expert group's size; each rank holds ``num_experts /
    ep`` experts: ``router`` (h, E), ``w_in`` (local_e, h, ffn) and
    ``w_out`` (local_e, ffn, h), JAX's names and layouts. Returns
    ``(output, aux_loss)``. The weights are drawn from a generator of
    ``seed`` (:func:`draw_experts`)."""

    def __init__(self, config: TransformerConfig, num_experts: int = 8,
                 top_k: int = 1, capacity_factor: float = 1.25,
                 expert_axis: Optional[str] = "dp", device=None,
                 seed: int = 0):
        super().__init__()
        self.config, self.num_experts = config, num_experts
        self.top_k, self.capacity_factor = top_k, capacity_factor
        self.expert_axis = expert_axis
        group = _expert_group(expert_axis)
        ep = ps.group_size(group)
        if num_experts % ep:
            raise ValueError(f"num_experts ({num_experts}) not divisible "
                             f"by ep ({ep})")
        rank = 0 if group is None else torch.distributed.get_rank(group)
        local_e = num_experts // ep
        h, ffn, dt = (config.hidden_size, config.ffn_hidden_size,
                      config.params_dtype)
        self.router = nn.Parameter(torch.empty(h, num_experts, dtype=dt,
                                               device=device))
        self.w_in = nn.Parameter(torch.empty(local_e, h, ffn, dtype=dt,
                                             device=device))
        self.w_out = nn.Parameter(torch.empty(local_e, ffn, h, dtype=dt,
                                              device=device))
        for p in (self.w_in, self.w_out):
            p.expert_parallel = (rank, ep)
        gen = data_parallel_generator(seed, self.router.device)
        for p in (self.router, self.w_in, self.w_out):
            draw_experts(p, gen)
        self.aux_loss: Optional[torch.Tensor] = None
        # of the last call's token assignments, the share past capacity
        self.dropped_share: Optional[torch.Tensor] = None

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        tokens, h = x.shape
        e = self.num_experts
        group = _expert_group(self.expert_axis)
        ep = ps.group_size(group)
        local_e = e // ep
        # each of the top_k passes dispatches one assignment a token:
        # cf * tokens / e slots a pass (GShard's convention)
        capacity = max(1, int(self.capacity_factor * tokens / e))
        logits = x.float() @ self.router.float()
        probs, gate_vals, expert_idx = router_probs(logits, e, self.top_k)
        aux = load_balancing_loss(probs, expert_idx, e)
        w_in = self.w_in.to(x.dtype).float()
        w_out = self.w_out.to(x.dtype).float()

        out = torch.zeros((tokens, h), dtype=torch.float32, device=x.device)
        dropped = torch.zeros((), dtype=torch.float32, device=x.device)
        for k in range(self.top_k):
            idx_k, gate_k = expert_idx[:, k], gate_vals[:, k]
            pos = _dispatch_indices(idx_k, e, capacity)
            keep = pos >= 0
            dropped = dropped + (~keep).float().mean() / self.top_k
            ei = torch.where(keep, idx_k, torch.zeros_like(idx_k))
            pi = torch.where(keep, pos, torch.zeros_like(pos)).long()
            kept = torch.where(keep[:, None], x, torch.zeros_like(x))
            dispatch = torch.zeros((e, capacity, h), dtype=x.dtype,
                                   device=x.device).index_put(
                (ei, pi), kept, accumulate=True)
            d = dispatch.reshape(ep, local_e, capacity, h)
            if ep > 1:  # (src, local_e, C, h): my experts' slots
                d = _AllToAll.apply(d, group)
            hdn = torch.einsum("slch,lhf->slcf", d.float(), w_in)
            hdn = F.gelu(hdn, approximate="tanh")  # jax.nn.gelu
            y = torch.einsum("slcf,lfh->slch", hdn.to(x.dtype).float(),
                             w_out).to(x.dtype)
            if ep > 1:
                y = _AllToAll.apply(y, group)
            gathered = y.reshape(e, capacity, h)[ei, pi]
            out = out + torch.where(
                keep[:, None], gate_k[:, None] * gathered.float(),
                torch.zeros((), dtype=torch.float32, device=x.device))
        if not is_recomputing():
            self.aux_loss, self.dropped_share = aux, dropped.detach()
        return out.to(x.dtype), aux


def total_moe_aux_loss(model: nn.Module, config: TransformerConfig
                       ) -> torch.Tensor:
    """``moe_aux_loss_coeff`` times the sum of every ``MoEMLP``'s last aux
    loss under ``model`` (JAX sums every sown ``moe_aux_loss``); an fp32
    zero when there is none. Add it to the training loss."""
    losses = [m.aux_loss for m in model.modules()
              if isinstance(m, MoEMLP) and m.aux_loss is not None]
    total = torch.zeros((), dtype=torch.float32,
                        device=next(model.parameters()).device)
    for loss in losses:  # JAX's order
        total = total + loss
    return config.moe_aux_loss_coeff * total
