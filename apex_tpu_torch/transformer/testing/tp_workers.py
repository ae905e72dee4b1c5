"""Rank functions of the tensor-parallel model checks (BERT, the KV-cache
decode and MoE layers at tp > 1), for
:func:`~apex_tpu_torch.transformer.testing.distributed_test_base.spawn`
(``tests/test_torch_bert_tp.py``, ``tests/test_torch_tp_decode.py``,
``tests/test_torch_moe.py`` and ``chip_smoke.py``).

Each worker builds the port's model at its tp size from this rank's
weights (``params[rank]``, a state_dict of numpy arrays, e.g. from
``models.convert.gpt_tp_params_from_jax``) or from a seed, runs it on
the rank's inputs and returns numpy arrays by name, which the caller
holds against JAX's on its CPU mesh or against another run.
"""

import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from apex_tpu_torch.parallel import parallel_state as ps

__all__ = ["bert_card_vs_plain_worker", "bert_train_worker",
           "bert_tp_worker", "decode_tp_worker", "moe_tp_card_worker",
           "moe_tp_worker", "run_bert_worker", "tp_shard"]


def _np(t):
    return t.detach().float().cpu().numpy()


def _load(module, params: Dict[str, np.ndarray]) -> None:
    module.load_state_dict({k: torch.as_tensor(np.asarray(v))
                            for k, v in params.items()}, strict=True)


def _grads(module):
    return {n: _np(p.grad) for n, p in module.named_parameters()
            if p.grad is not None}


def tp_shard(full: Dict[str, torch.Tensor], model, rank: int
             ) -> Dict[str, torch.Tensor]:
    """``model``'s state_dict at its tp size cut from the tp = 1 state
    ``full``: a tensor whose shape differs is sliced to this rank's
    contiguous part along the one dim that differs (the parallel layers
    keep each rank's columns, rows, vocab rows or heads contiguous)."""
    out = {}
    for name, t in model.state_dict().items():
        f = full[name]
        if f.shape != t.shape:
            d = next(i for i, (a, b) in enumerate(zip(f.shape, t.shape))
                     if a != b)
            f = f.narrow(d, rank * t.shape[d], t.shape[d])
        out[name] = f.to(t.device)
    return out


def bert_tp_worker(rank: int, world_size: int, tp: int, cases: Dict):
    """``BertModel`` at ``tp`` (fp32) for each case ({name: dict(config,
    params, tokens, labels)}, ``params`` by rank): the per-token LM losses,
    the binary logits and every gradient of ``mean(lm) + mean(binary **
    2)``, which reaches both heads through the sequence gather."""
    from apex_tpu_torch.models import BertModel
    from apex_tpu_torch.transformer import TransformerConfig

    ps.initialize_model_parallel(tp)
    out = {}
    for name, c in cases.items():
        model = BertModel(TransformerConfig(**c["config"]), device="cpu")
        _load(model, c["params"][rank])
        lm, binary = model(torch.as_tensor(c["tokens"]).long(),
                           lm_labels=torch.as_tensor(c["labels"]).long())
        (lm.mean() + binary.square().mean()).backward()
        out[name] = dict(lm=_np(lm), binary=_np(binary),
                         grads=_grads(model))
    return out


def run_bert_worker(rank: int, world_size: int, argv: Sequence[str],
                    params: Optional[Sequence[Dict]] = None, tokens=None,
                    labels=None):
    """``standalone_bert.BertPretraining`` from ``argv`` on the CPU, with
    this rank's ``params[rank]`` and the world's ``tokens`` and
    ``labels`` (steps, num_micro, micro_batch x dp, seq) where given:
    each step's dp-mean loss and the first step's gradients."""
    from apex_tpu_torch.transformer.testing import parse_args
    from apex_tpu_torch.transformer.testing.standalone_bert import (
        BertPretraining,
    )

    args = parse_args(args=list(argv))
    run = BertPretraining(args, device="cpu")
    if params is not None:
        _load(run.model, params[rank])
        run.opt_state = run.opt.init(dict(run.model.named_parameters()))
    if tokens is not None:
        run.set_data(tokens, labels)
    losses, first = [], None
    for i in range(run.steps):
        loss, grads = run.step(i)
        losses.append(float(loss))
        if first is None:
            first = {n: _np(g) for n, g in grads.items()}
    return dict(losses=losses, grads=first, tp=run.tp, dp=run.dp)


def decode_tp_worker(rank: int, world_size: int, tp: int, config: Dict,
                     params: Optional[Sequence[Dict]], tokens, prompt: int,
                     slots: int, device: str = "cpu", seed: int = 0,
                     return_logits: bool = True):
    """``GPTModel`` at ``tp`` on ``device`` from this rank's ``params``
    (or drawn from ``seed`` when None): the full forward's logits of
    ``tokens`` (b, s), then a KV-cache prefill of the first ``prompt``
    tokens into ``slots`` slots and one decode step a position after it,
    teacher-forced. Returns the worst difference of the prefill's and
    every step's logits from the full forward's and the largest |logit|,
    the launch counts of the prefill and of the decode steps, apart, the
    decode kernel's split count at the first step's shape, the ms of the
    prefill and of a decode step, and with ``return_logits`` the full,
    prefill and step logits (this rank's vocab shard)."""
    from apex_tpu_torch import _kernels
    from apex_tpu_torch.models import GPTModel
    from apex_tpu_torch.ops.attention import _decode_splits
    from apex_tpu_torch.transformer import TransformerConfig

    ps.initialize_model_parallel(tp)
    cfg = TransformerConfig(**config)
    model = GPTModel(cfg, device=device, seed=seed)
    if params is not None:
        _load(model, params[rank])
    model.eval()
    tok = torch.as_tensor(np.asarray(tokens)).long().to(device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    with torch.no_grad():
        full = model(tok).float()
        cache = model.new_cache(tok.shape[0], slots)
        sync()
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        pre = model(tok[:, :prompt], cache=cache).float()
        sync()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        prefill_launches = _kernels.launch_counts()
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        steps = []
        for pos in range(prompt, tok.shape[1]):
            steps.append(model(tok[:, pos:pos + 1], cache=cache,
                               decode_step=True)[:, 0].float())
        sync()
        step_ms = (time.perf_counter() - t0) * 1e3 / max(1, len(steps))
        steps = torch.stack(steps, dim=1)
        err = max(float((pre - full[:, :prompt]).abs().max()),
                  float((steps - full[:, prompt:]).abs().max()))
        heads = cfg.num_attention_heads // tp
        q = torch.empty(tok.shape[0], heads, 1, cfg.kv_channels,
                        dtype=cfg.compute_dtype)
        splits = _decode_splits(q, cache.k[0])
    out = dict(worst=err, logit_max=float(full.abs().max()),
               launches_prefill=prefill_launches,
               launches_decode=_kernels.launch_counts(), decode_splits=splits,
               prefill_ms=prefill_ms, step_ms=step_ms,
               cache_heads=cache.k.shape[2], vocab_local=full.shape[-1])
    if return_logits:
        out.update(full=_np(full), prefill=_np(pre), steps=_np(steps))
    return out


def moe_tp_worker(rank: int, world_size: int, tp: int, cases: Dict):
    """A ``ParallelTransformerLayer`` with MoE at ``tp`` (fp32) for each
    case ({name: dict(config, params, x, ct)}, ``params``, ``x`` and
    ``ct`` by rank): the output, the aux loss and every gradient of
    ``<out, ct> + 0.01 aux`` to the input and the parameters."""
    from apex_tpu_torch.transformer import (
        ParallelTransformerLayer,
        TransformerConfig,
    )

    ps.initialize_model_parallel(tp)
    out = {}
    for name, c in cases.items():
        layer = ParallelTransformerLayer(TransformerConfig(**c["config"]))
        _load(layer, c["params"][rank])
        x = torch.tensor(np.asarray(c["x"][rank]), requires_grad=True)
        y = layer(x)
        aux = layer.mlp.aux_loss
        ((y * torch.as_tensor(c["ct"][rank])).sum() + 0.01 * aux).backward()
        out[name] = dict(y=_np(y), aux=float(aux), dx=_np(x.grad),
                         grads=_grads(layer))
    return out


def bert_train_worker(rank: int, world_size: int, argv: Sequence[str],
                      device: str = "cuda"):
    """``standalone_bert``'s run from ``argv`` on ``device`` in this world
    (``BertPretraining`` through ``train``, as its ``main`` runs it):
    ``train``'s closing summary (the same on every rank)."""
    from apex_tpu_torch.transformer.testing import parse_args
    from apex_tpu_torch.transformer.testing.standalone_bert import (
        BertPretraining,
        train,
    )

    _, summary = train(BertPretraining(parse_args(args=list(argv)), device),
                       log=lambda *a: None)
    return summary


def bert_card_vs_plain_worker(rank: int, world_size: int,
                              argv: Sequence[str], device: str = "cuda"):
    """``standalone_bert.BertPretraining`` from ``argv`` on ``device`` and
    on the CPU from the same weights (the card's draw) and batches: each
    step's dp-mean loss on both, the largest relative error in norm of
    the first step's gradients, and the card run's launch counts."""
    from apex_tpu_torch import _kernels
    from apex_tpu_torch.transformer.testing import parse_args
    from apex_tpu_torch.transformer.testing.standalone_bert import (
        BertPretraining,
    )

    args = parse_args(args=list(argv))
    out, init, first = {}, None, {}
    for dev in (device, "cpu"):
        run = BertPretraining(args, device=dev)
        if init is None:
            init = {k: v.detach().cpu().clone()
                    for k, v in run.model.state_dict().items()}
        else:
            run.model.load_state_dict(init)
            run.opt_state = run.opt.init(dict(run.model.named_parameters()))
        _kernels.reset_launch_counts()
        losses = []
        for i in range(run.steps):
            loss, grads = run.step(i)
            losses.append(float(loss))
            if i == 0:
                first[dev] = {n: g.detach().float().cpu()
                              for n, g in grads.items()}
            del grads
        out[dev] = dict(losses=losses, launches=_kernels.launch_counts())
        del run
    worst = max(float((first[device][n] - g).norm()
                      / max(float(g.norm()), 1e-30))
                for n, g in first["cpu"].items())
    return dict(card=out[device]["losses"], plain=out["cpu"]["losses"],
                grad_rel_worst=worst, launches=out[device]["launches"])


def moe_tp_card_worker(rank: int, world_size: int, config: Dict,
                       batch: int, seq: int, plain_seq: int,
                       device: str = "cuda", seed: int = 0):
    """A GPT with MoE layers (``config``: ``TransformerConfig`` fields,
    fp32) at tp = 2 on a world of 2 against tp = 1 from the same weights
    (the tp = 1 draw of ``seed``, cut to each rank by :func:`tp_shard`),
    one forward and backward of the mean loss plus
    ``total_moe_aux_loss`` on ``batch`` x ``seq`` tokens of ``seed``:
    without sequence parallelism both tp ranks route the same tokens, so
    the loss, aux and every gradient (cut to the rank) equal tp = 1's;
    under it each rank routes its own shard, so the tp = 2 SP run on the
    card is held to the same run on the CPU at ``plain_seq`` tokens.
    Returns the losses, the worst relative gradient errors in norm, the
    launch counts and staged collectives of the SP run at ``seq`` and
    the peak memory of each card run."""
    from apex_tpu_torch import _kernels
    from apex_tpu_torch.models import GPTModel
    from apex_tpu_torch.models.gpt import gpt_loss_fn
    from apex_tpu_torch.transformer import TransformerConfig
    from apex_tpu_torch.transformer.moe import total_moe_aux_loss

    gen = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, config["vocab_size"], (batch, seq),
                           generator=gen)

    def run(tp, sp, dev, full, toks):
        ps.initialize_model_parallel(tp)
        cfg = TransformerConfig(sequence_parallel=sp, **config)
        model = GPTModel(cfg, device=dev, seed=seed)
        if full is not None:
            model.load_state_dict(tp_shard(full, model, rank))
        cuda = torch.device(dev).type == "cuda"
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launch_counts()
        staged0 = dict(ps.STAGED)
        toks = toks.to(dev)
        loss = gpt_loss_fn(model(toks, labels=torch.roll(toks, -1, 1)))
        aux = total_moe_aux_loss(model, cfg)
        (loss + aux).backward()
        if cuda:
            torch.cuda.synchronize()
        res = dict(loss=loss.item(), aux=aux.item(),
                   grads={n: p.grad.detach().float().cpu()
                          for n, p in model.named_parameters()},
                   launches=_kernels.launch_counts(),
                   staged={k: n - staged0[k] for k, n in ps.STAGED.items()},
                   peak_mem_gb=(torch.cuda.max_memory_allocated() / 1e9
                                if cuda else None))
        state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        ps.destroy_model_parallel()
        return res, state, model

    def worst(a, b):
        return max(float((a[n] - g).norm() / max(float(g.norm()), 1e-30))
                   for n, g in b.items())

    one, full, _ = run(1, False, device, None, tokens)
    tp2, _, model2 = run(2, False, device, full, tokens)
    want = {n: g.cpu() for n, g in tp_shard(one["grads"], model2,
                                             rank).items()}
    del model2
    sp_card, _, _ = run(2, True, device, full, tokens)
    small = tokens[:, :plain_seq]
    sp_small, _, _ = run(2, True, device, full, small)
    sp_plain, _, _ = run(2, True, "cpu", full, small)
    return dict(
        loss_one=one["loss"], loss_tp2=tp2["loss"], aux_one=one["aux"],
        aux_tp2=tp2["aux"], grad_rel_tp2=worst(tp2["grads"], want),
        loss_sp=sp_card["loss"], loss_sp_small_card=sp_small["loss"],
        loss_sp_small_plain=sp_plain["loss"],
        grad_rel_sp_small=worst(sp_small["grads"], sp_plain["grads"]),
        launches_sp=sp_card["launches"], staged_sp=sp_card["staged"],
        launches_tp2=tp2["launches"],
        peak_mem_gb={"tp1": one["peak_mem_gb"], "tp2": tp2["peak_mem_gb"],
                     "tp2_sp": sp_card["peak_mem_gb"]})

