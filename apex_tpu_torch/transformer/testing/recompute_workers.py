"""Rank functions of spawned worlds for recompute, MoE and FP8 (the
tests' gloo worlds on the CPU, ``chip_smoke.py``'s on the card). Each
takes ``(rank, world_size, ...)`` and returns plain values; numpy arrays
cross the process boundary."""

from typing import Dict, Sequence

import numpy as np
import torch

from apex_tpu_torch.parallel import parallel_state as ps
from apex_tpu_torch.transformer.testing.pipeline_workers import remat_worker

__all__ = ["amax_worker", "checkpoint_distributed_worker", "jobs_worker",
           "moe_ep_worker", "moe_gpt_ep_worker", "remat_toy_worker",
           "remat_worker", "sp_dropout_recompute_worker"]


def _np(t):
    return t.detach().cpu().float().numpy()


def checkpoint_distributed_worker(rank: int, world_size: int,
                                  cases: Sequence):
    """``checkpoint_distributed(fn)`` over a tp group of the whole world,
    ``fn(x, w) = sum(tanh(x @ w)^2)``: for each ``(x, w)`` the value and
    the gradients of x and w; then the leading-dim refusal's message."""
    from apex_tpu_torch.parallel.random import checkpoint_distributed

    ps.initialize_model_parallel(tensor_model_parallel_size=world_size)

    def fn(x, w):
        return torch.sum(torch.tanh(x @ w) ** 2)

    out = []
    for x, w in cases:
        x = torch.tensor(x, requires_grad=True)
        w = torch.tensor(w, requires_grad=True)
        val = checkpoint_distributed(fn)(x, w)
        gx, gw = torch.autograd.grad(val, [x, w])
        out.append(dict(value=float(val.detach()), gx=_np(gx), gw=_np(gw)))
    try:
        checkpoint_distributed(fn)(torch.zeros(world_size + 1, 4),
                                   torch.zeros(4, 4))
        refusal = None
    except ValueError as e:
        refusal = str(e)
    ps.destroy_model_parallel()
    return dict(cases=out, refusal=refusal)


def _toy_stage(params, x):
    return torch.tanh(x @ params["w"] + params["b"])


def _toy_loss(y, t):
    return torch.mean((y - t) ** 2)


def remat_toy_worker(rank: int, world_size: int, cases: Sequence,
                     variants: Sequence):
    """The toy stage ``tanh(x @ w + b)`` through 1F1B, the interleaved
    schedule (``case["chunks"]`` V, each rank's leaves stacked on a
    leading V dim) and zero bubble at pp = ``case["pp"]``, once per
    ``(remat, tick_block_remat)`` of ``variants``: each variant's loss,
    losses and gradients by case name."""
    from apex_tpu_torch.parallel.pipeline import schedules as sched

    out = {}
    for c in cases:
        pp, V = c["pp"], c.get("chunks", 1)
        ps.initialize_model_parallel(pipeline_model_parallel_size=pp)
        r = ps.get_pipeline_model_parallel_rank()
        # a leading V dim on every leaf when interleaved
        params = {k: torch.tensor(v, requires_grad=True)
                  for k, v in c["params"][r].items()}
        mbs, tgt = (torch.tensor(c[k]) for k in ("microbatches", "targets"))
        for remat, block in variants:
            kw = dict(remat=remat, tick_block_remat=block)
            if c["schedule"] == "1f1b":
                res = sched.forward_backward_pipelining_without_interleaving(
                    _toy_stage, _toy_loss, params, mbs, tgt, **kw)
            elif c["schedule"] == "zero_bubble":
                res = sched.forward_backward_zero_bubble(
                    _toy_stage, _toy_loss, params, mbs, tgt, **kw)
            else:
                res = sched.forward_backward_pipelining_with_interleaving(
                    _toy_stage, _toy_loss, params, mbs, tgt,
                    num_model_chunks=V, **kw)
            loss, losses, grads = res
            out[(c["name"], remat, block)] = dict(
                loss=float(loss), losses=_np(losses),
                grads={k: _np(g) for k, g in grads.items()})
        ps.destroy_model_parallel()
    return out


def sp_dropout_recompute_worker(rank: int, world_size: int,
                                granularities: Sequence, steps: int = 2):
    """A tiny GPT at tp = 2 with sequence parallelism and dropout 0.1 (the
    hidden dropout folds the tp rank in at its first draw) trained
    ``steps`` plain SGD steps at each recompute granularity from one
    seed: each granularity's losses, gradients by step and the states of
    every generator the model's dropout drew from after the last step."""
    from apex_tpu_torch.models import GPTModel
    from apex_tpu_torch.models.gpt import gpt_loss_fn
    from apex_tpu_torch.transformer import TransformerConfig
    from apex_tpu_torch.transformer.layer import ShardAwareDropout

    ps.initialize_model_parallel(tensor_model_parallel_size=2)
    gen = torch.Generator().manual_seed(7)
    tokens = torch.randint(0, 64, (2, 16), generator=gen)
    labels = torch.roll(tokens, -1, dims=1)
    out = {}
    for g in granularities:
        cfg = TransformerConfig(
            num_layers=2, hidden_size=32, num_attention_heads=4,
            vocab_size=64, max_position_embeddings=16, hidden_dropout=0.1,
            attention_dropout=0.1, sequence_parallel=True,
            recompute_granularity=g, compute_dtype=torch.float32)
        model = GPTModel(cfg, device="cpu", seed=0).train()
        losses, grads = [], []
        for _ in range(steps):
            for p in model.parameters():
                p.grad = None
            loss = gpt_loss_fn(model(tokens, labels=labels))
            loss.backward()
            losses.append(loss.item())
            grads.append({n: _np(p.grad) for n, p in
                          model.named_parameters()})
            with torch.no_grad():
                for p in model.parameters():
                    p.sub_(0.1 * p.grad)
        states = []
        for m in model.modules():
            if isinstance(m, ShardAwareDropout):
                gens = [m.generator] + ([m._folded[1]] if m._folded else [])
                states.append([g_.get_state().numpy() for g_ in gens])
        out[g] = dict(losses=losses, grads=grads, states=states)
    ps.destroy_model_parallel()
    return out


def moe_ep_worker(rank: int, world_size: int, params: Dict, x: np.ndarray,
                  num_experts: int, top_k: int):
    """``MoEMLP`` with its experts over dp (ep = the world's size), rank r
    holding experts ``[r E / ep, (r + 1) E / ep)`` of ``params`` and
    routing the whole ``x``: the output, the aux loss and the gradients
    of ``sum(out^2) + 0.01 aux`` for x, the router and its experts."""
    from apex_tpu_torch.transformer import TransformerConfig
    from apex_tpu_torch.transformer.moe import MoEMLP

    ps.initialize_model_parallel()
    h, ffn = params["w_in"].shape[1:]
    cfg = TransformerConfig(num_layers=1, hidden_size=h, num_attention_heads=4,
                            ffn_hidden_size=ffn, compute_dtype=torch.float32)
    mod = MoEMLP(cfg, num_experts=num_experts, top_k=top_k,
                 expert_axis="dp", device="cpu")
    local = num_experts // world_size
    with torch.no_grad():
        mod.router.copy_(torch.tensor(params["router"]))
        for n in ("w_in", "w_out"):
            getattr(mod, n).copy_(torch.tensor(
                params[n][rank * local:(rank + 1) * local]))
    xt = torch.tensor(x, requires_grad=True)
    y, aux = mod(xt)
    (torch.sum(y ** 2) + 0.01 * aux).backward()
    ps.destroy_model_parallel()
    return dict(out=_np(y), aux=float(aux), gx=_np(xt.grad),
                grads={n: _np(getattr(mod, n).grad)
                       for n in ("router", "w_in", "w_out")})


def moe_gpt_ep_worker(rank: int, world_size: int, config: Dict, batch: int,
                      seq: int, device: str = "cuda", seed: int = 0):
    """A GPT with MoE layers (``config``: ``TransformerConfig`` fields)
    whose experts split over dp (ep = the world's size) against the same
    model at ep = 1 with all experts, on this rank's tokens (``batch`` x
    ``seq`` from a generator of ``seed + rank``) from one seed (every ep
    draws the same experts): one forward and backward of the mean loss
    plus ``total_moe_aux_loss`` each. Returns the loss and aux of both,
    the largest relative error in norm over the gradients (an expert's
    ep = 1 gradient summed over the ranks, as the all-to-all's backward
    sums it, then cut to this rank's experts) and over the outputs' last
    hidden states, the routing's agreement, the all-to-alls and bytes
    ``STAGED`` counted in the ep run and the peak memory of each run."""
    from apex_tpu_torch import _kernels
    from apex_tpu_torch.models import GPTModel
    from apex_tpu_torch.models.gpt import gpt_loss_fn
    from apex_tpu_torch.parallel.cross_entropy import (
        vocab_parallel_cross_entropy,
    )
    from apex_tpu_torch.transformer import TransformerConfig
    from apex_tpu_torch.transformer.moe import total_moe_aux_loss

    ps.initialize_model_parallel()
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    gen = torch.Generator().manual_seed(seed + rank)
    vocab = config["vocab_size"]
    tokens = torch.randint(0, vocab, (batch, seq), generator=gen).to(dev)
    labels = torch.roll(tokens, -1, dims=1)
    runs = {}
    for ep_axis in ("dp", None):
        cfg = TransformerConfig(moe_expert_axis=ep_axis, **config)
        model = GPTModel(cfg, device=dev, seed=seed)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launch_counts()
        staged0 = dict(ps.STAGED)
        h = model.hidden_states(tokens)
        loss = gpt_loss_fn(vocab_parallel_cross_entropy(model.logits(h),
                                                        labels))
        aux = total_moe_aux_loss(model, cfg)
        (loss + aux).backward()
        if cuda:
            torch.cuda.synchronize()
        runs[ep_axis] = dict(
            loss=loss.item(), aux=aux.item(), hidden=h.detach().float(),
            grads={n: p.grad.detach() for n, p in model.named_parameters()},
            staged={k: n - staged0[k] for k, n in ps.STAGED.items()},
            launches=_kernels.launch_counts(),
            peak_mem_gb=(torch.cuda.max_memory_allocated() / 1e9
                         if cuda else None))
        del model
    ep, one = runs["dp"], runs[None]
    dp_group = ps.get_data_parallel_group()
    local = config["num_moe_experts"] // world_size
    worst = {}
    for n, g in ep["grads"].items():
        want = one["grads"][n]
        if n.rsplit(".", 1)[-1] in ("w_in", "w_out"):
            want = ps.all_reduce(want, dp_group)[rank * local:
                                                 (rank + 1) * local]
        worst[n] = float((g - want).float().norm()
                         / max(float(want.float().norm()), 1e-30))
    hidden_rel = float((ep["hidden"] - one["hidden"]).norm()
                       / one["hidden"].norm())
    ps.destroy_model_parallel()
    return dict(
        loss_ep=ep["loss"], loss_one=one["loss"], aux_ep=ep["aux"],
        aux_one=one["aux"], hidden_rel=hidden_rel,
        grad_rel_worst=max(worst.items(), key=lambda kv: kv[1]),
        staged_ep=ep["staged"], staged_one=one["staged"],
        launches_ep=ep["launches"], peak_mem_gb_ep=ep["peak_mem_gb"],
        peak_mem_gb_one=one["peak_mem_gb"])


def amax_worker(rank: int, world_size: int, shards: Sequence,
                w: np.ndarray, tp: int):
    """``fp8_dense`` at tp = ``tp`` x dp over the world, rank r on
    ``shards[r]``: the amax that entered each returned state's history
    (the x one is the max over the ranks' shards, the w one w's own)."""
    from apex_tpu_torch.amp.fp8 import fp8_dense, init_fp8_state

    ps.initialize_model_parallel(tensor_model_parallel_size=tp)
    sx, sw = init_fp8_state(4, "cpu"), init_fp8_state(4, "cpu")
    _, (sx, sw) = fp8_dense(torch.tensor(shards[rank]), torch.tensor(w),
                            sx, sw)
    ps.destroy_model_parallel()
    return dict(x_amax=float(sx.amax_history[0]),
                w_amax=float(sw.amax_history[0]))


def jobs_worker(rank: int, world_size: int, jobs: Sequence):
    """Runs ``jobs``, pairs (name of a worker of this module, or
    ``remat_worker``, its extra arguments), one after another in one
    world; their results in order."""
    return [globals()[name](rank, world_size, *args) for name, args in jobs]
