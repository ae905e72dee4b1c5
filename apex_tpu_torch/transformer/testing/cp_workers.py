"""Rank functions of the context-parallel and zero-bubble checks, for
:func:`~apex_tpu_torch.transformer.testing.distributed_test_base.spawn`
(``tests/test_torch_context_parallel.py``,
``tests/test_torch_zero_bubble.py``, ``chip_smoke.py``).

Each ``*_worker(rank, world_size, ...)`` runs the port's side of a group
of checks on its rank and returns numpy arrays (and, on the card, the
numbers a phase logs). Inputs are numpy arrays made from seeds by the
caller: global arrays, of which each rank takes its cp chunk along the
sequence. :func:`jobs_worker` runs several of them in one world.
"""

import dataclasses
import time
from typing import Dict, Sequence

import numpy as np
import torch

from apex_tpu_torch.parallel import parallel_state as ps

__all__ = ["attention_worker", "cp_card_worker", "cp_decode_worker",
           "dropout_worker", "gpt_cp_worker", "jobs_worker",
           "train_ring_cp_worker", "zero_bubble_vs_1f1b_worker",
           "zero_bubble_worker"]


def _np(t):
    return t.detach().float().cpu().numpy()


def _chunk(x, axis: int, rank: int, n: int):
    """Rank ``rank``'s contiguous chunk of ``x`` along ``axis``."""
    size = x.shape[axis] // n
    return x.narrow(axis, rank * size, size)


def attention_worker(rank: int, world_size: int, cases: Sequence):
    """Each case (a dict: ``name``, ``fn`` of ``"ring"``, ``"ulysses"``
    or ``"decode"``, ``cp``, ``kwargs`` of the function, the global
    ``q``, ``k``, ``v``, and for ``ring``/``ulysses`` the output
    cotangent ``ct`` and optionally ``kpm``; for ``decode`` ``padded``)
    on this rank's chunk along the sequence (the cache for ``decode``)
    of a cp group of ``cp`` ranks: ``cp_rank`` and the local output,
    with the local ``dq``, ``dk``, ``dv`` of ``sum(o * ct)``; or the
    message of the ``ValueError`` it raised."""
    from apex_tpu_torch.parallel.ring_attention import (
        cp_decode_attention,
        ring_attention,
        ulysses_attention,
    )

    out = {}
    for c in cases:
        ps.initialize_model_parallel(context_parallel_size=c["cp"])
        cp, r = c["cp"], ps.get_context_parallel_rank()
        res = {"cp_rank": r}
        try:
            if c["fn"] == "decode":
                kv = [_chunk(torch.from_numpy(c[n]), 2, r, cp)
                      for n in ("k", "v")]
                padded = _chunk(torch.from_numpy(c["padded"]), 1, r, cp)
                o = cp_decode_attention(torch.from_numpy(c["q"]), *kv,
                                        padded, "cp", **c["kwargs"])
                res["o"] = _np(o)
            else:
                q, k, v = (_chunk(torch.from_numpy(c[n]), 2, r, cp)
                           .requires_grad_(True) for n in ("q", "k", "v"))
                kw = dict(c["kwargs"])
                if c.get("kpm") is not None:
                    kw["key_padding_mask"] = _chunk(
                        torch.from_numpy(c["kpm"]), 1, r, cp)
                fn = (ring_attention if c["fn"] == "ring"
                      else ulysses_attention)
                o = fn(q, k, v, axis_name="cp", **kw)
                ct = _chunk(torch.from_numpy(c["ct"]), 2, r, cp)
                dq, dk, dv = torch.autograd.grad((o * ct).sum(), (q, k, v))
                res.update(o=_np(o), dq=_np(dq), dk=_np(dk), dv=_np(dv))
        except ValueError as e:
            res["error"] = str(e)
        out[c["name"]] = res
        ps.destroy_model_parallel()
    return out


def _cp_model(config: Dict, params, device="cpu", **overrides):
    from apex_tpu_torch.models.gpt import GPTModel
    from apex_tpu_torch.transformer import TransformerConfig

    cfg = TransformerConfig(**dict(config, **overrides))
    model = GPTModel(cfg, device=device)
    if params is not None:
        model.load_state_dict({k: torch.as_tensor(v)
                               for k, v in params.items()})
    return model


def gpt_cp_worker(rank: int, world_size: int, cases: Sequence):
    """Each case (``name``, ``cp``, ``tp``, ``config`` of an fp32
    ``TransformerConfig``, ``params`` (one state dict, or one a rank as a
    list), global ``tokens``/``labels`` (b, s)) as a GPT whose tokens are
    this rank's cp chunk: ``cp_rank``, ``tp_rank`` and the local per-token
    losses."""
    out = {}
    for c in cases:
        ps.initialize_model_parallel(c.get("tp", 1),
                                     context_parallel_size=c["cp"])
        params = c["params"]
        if isinstance(params, list):
            params = params[rank]
        model = _cp_model(c["config"], params)
        r = ps.get_context_parallel_rank()
        tokens, labels = (_chunk(torch.from_numpy(c[n]).long(), 1, r, c["cp"])
                          for n in ("tokens", "labels"))
        with torch.no_grad():
            losses = model(tokens, labels=labels)
        out[c["name"]] = dict(cp_rank=r,
                              tp_rank=ps.get_tensor_model_parallel_rank(),
                              losses=_np(losses))
        ps.destroy_model_parallel()
    return out


def _decode(model, tokens, prompt: int, cp: int, reference: bool,
            params=None):
    """Prefill of this rank's chunk of ``tokens[:, :prompt]``, then
    teacher-forced decode steps to the end: ``decoded`` (b, len - prompt,
    vocab) logits, ``launches`` (the kernels' counts read after the last
    step, before any reference runs), and with ``reference`` on cp rank 0
    a cp = 1 model's uncached logits of the whole sequence from the same
    weights."""
    from apex_tpu_torch import _kernels

    r = ps.get_context_parallel_rank()
    total = tokens.shape[1]
    out = {}
    with torch.no_grad():
        cache = model.new_cache(tokens.shape[0], total // cp)
        model(_chunk(tokens[:, :prompt], 1, r, cp), cache=cache)
        steps = [model(tokens[:, pos:pos + 1], cache=cache,
                       decode_step=True)[:, 0]
                 for pos in range(prompt, total)]
        out["decoded"] = _np(torch.stack(steps, dim=1))
        out["launches"] = _kernels.launch_counts()
        if reference and r == 0:
            single = _cp_model(dataclasses.asdict(model.config), params,
                               model.device, context_parallel_mode=None)
            single.load_state_dict(model.state_dict())
            single.eval()
            out["reference"] = _np(single(tokens))
    return out


def cp_decode_worker(rank: int, world_size: int, cp: int, config: Dict,
                     params, tokens: np.ndarray, prompt: int):
    """KV-cache decode over cp on the CPU: each rank prefills its chunk of
    the first ``prompt`` tokens into a cache of ``len / cp`` slots, then
    every rank decodes the remaining tokens teacher-forced, one a step.
    Returns the logits of each decoded position (``decoded``, (b, len -
    prompt, vocab)), and the message of the ``ValueError`` a decode step
    raises when the cache's rows sit at different positions
    (``refusal``)."""
    ps.initialize_model_parallel(context_parallel_size=cp)
    model = _cp_model(config, params)
    model.eval()
    tok = torch.as_tensor(tokens).long()
    out = _decode(model, tok, prompt, cp, False)
    cache = model.new_cache(tok.shape[0], tok.shape[1] // cp)
    with torch.no_grad():
        model(_chunk(tok[:, :prompt], 1, ps.get_context_parallel_rank(), cp),
              cache=cache)
        cache.index[0] += 1
        try:
            model(tok[:, prompt:prompt + 1], cache=cache, decode_step=True)
        except ValueError as e:
            out["refusal"] = str(e)
    ps.destroy_model_parallel()
    return out


def dropout_worker(rank: int, world_size: int, cp: int):
    """``ShardAwareDropout(0.5, axis_names=("cp",))`` on ones (4, 64) at a
    cp group of ``cp`` and at cp = 1: the output of its first call and of
    a second (``y2``), whether the generator came back unchanged, the next
    draw of the module's own generator after both calls (the same on
    every rank while the ranks stay in step), that draw after a single
    48-bit draw of a fresh generator of the same seed (``one_fold``: what
    the shared generator gives when the cp rank is folded in once a
    module, not once a call), and the output in eval mode."""
    from apex_tpu_torch.parallel.random import (
        data_parallel_generator,
        shard_aware_generator,
    )
    from apex_tpu_torch.transformer.layer import ShardAwareDropout

    out = {}
    for size in (cp, 1):
        ps.initialize_model_parallel(context_parallel_size=size)
        gen = data_parallel_generator(7)
        mod = ShardAwareDropout(0.5, axis_names=("cp",), generator=gen)
        mod.train()
        y = mod(torch.ones(4, 64))
        y2 = mod(torch.ones(4, 64))
        fresh = data_parallel_generator(7)
        torch.randint(0, 2 ** 48, (1,), generator=fresh)
        out[size] = dict(
            y=_np(y), y2=_np(y2),
            next_draw=float(torch.rand(1, generator=gen)),
            one_fold=float(torch.rand(1, generator=fresh)),
            same=shard_aware_generator(gen, ("cp",)) is gen)
        mod.eval()
        out[size]["eval"] = _np(mod(torch.ones(4, 64)))
        ps.destroy_model_parallel()
    return out


def train_ring_cp_worker(rank: int, world_size: int, argv: Sequence[str],
                         params: Dict[str, np.ndarray]):
    """The ported example's ``train`` from ``argv`` and the weights
    ``params``: its losses and lines logged."""
    from apex_tpu_torch.examples.long_context import train_ring_cp

    lines = []
    losses = train_ring_cp.train(train_ring_cp.parse_args(list(argv)),
                                 log=lines.append, params=params)
    ps.destroy_model_parallel()
    return dict(losses=losses, lines=lines)


def _digest(params) -> str:
    import hashlib

    h = hashlib.sha256()
    for p in params.values():
        h.update(p.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def cp_card_worker(rank: int, world_size: int, jobs: Sequence,
                   device: str = "cuda"):
    """The card phases of context parallelism, one ``jobs`` entry (a dict)
    after another on ``device``, each from a fresh model of
    ``job["config"]`` (a dict of ``TransformerConfig`` fields whose
    ``context_parallel_mode`` picks ring or Ulysses, weights from seed 0)
    at cp = ``job["cp"]``, on the batch ``make_batch(**job["batch"])``:

    - ``kind="train"``: ``RingCPTraining``, 1 + ``job["steps"]`` steps:
      each step's loss, ms, parameter digest and ``STAGED`` counts; with
      ``job["profile"]``, one more step profiled on the last rank, whose
      causal ring work is the most (the ring chunk spans' share of it);
    - ``kind="vs_single"``: one step's loss and gradients at cp against a
      cp = 1 model of the same weights on rank 0 over the whole sequence;
    - ``kind="decode"``: the batch's first ``job["prompt"]`` tokens
      prefilled over cp, then decode steps to ``job["total"]`` tokens,
      against a cp = 1 model's uncached logits on rank 0.

    Every job's result carries the launch counts of its run (set to 0
    just before it; the profiled step comes after the reading, and a
    decode job's are read before its cp = 1 reference runs; a
    ``vs_single`` job's include its reference) and the peak memory.
    Returns the results in order."""
    from apex_tpu_torch import _kernels
    from apex_tpu_torch.examples.long_context.train_ring_cp import (
        RingCPTraining,
        make_batch,
    )

    cuda = torch.device(device).type == "cuda"
    if cuda:
        _kernels.build_all()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    results = []
    for job in jobs:
        ps.initialize_model_parallel(context_parallel_size=job["cp"])
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launch_counts()
        model = _cp_model(job["config"], None, device)
        batch = make_batch(**job["batch"])
        out = {"rank": rank, "kind": job["kind"]}
        if job["kind"] == "decode":
            model.eval()
            tokens = torch.as_tensor(batch["tokens"][:, :job["total"]],
                                     device=model.device).long()
            out.update(_decode(model, tokens, job["prompt"], job["cp"],
                               True))
        else:
            run = RingCPTraining(model, batch, lr=job.get("lr", 1e-3))
            if job["kind"] == "train":
                out["records"] = [_timed_step(run, sync)
                                  for _ in range(1 + job["steps"])]
            else:
                out.update(_vs_single(run, batch, job["config"], device,
                                      rank))
            out["launches"] = _kernels.launch_counts()
        out["peak_mem_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                              if cuda else None)
        if job.get("profile") and cuda:
            if rank == world_size - 1:
                out["profile"] = _profile_step(run)
            else:
                run.step()  # the profiled step's partners
        results.append(out)
        del model
        ps.destroy_model_parallel()
    return results


def _timed_step(run, sync) -> Dict:
    staged0 = dict(ps.STAGED)
    t0 = time.perf_counter()
    loss = run.step()
    sync()
    return dict(loss=loss, ms=(time.perf_counter() - t0) * 1e3,
                digest=_digest(run.params),
                staged={k: n - staged0[k] for k, n in ps.STAGED.items()})


def _profile_step(run) -> Dict:
    """One step under ``torch.profiler``: ``profile_device``'s
    report with the ring chunk updates' span (host and device time) and
    its host time's share of the step."""
    from apex_tpu_torch.parallel.ring_attention import CHUNK_SPAN
    from apex_tpu_torch.utils.profiling import profile_device

    report = profile_device(lambda: (run.step(), torch.cuda.synchronize()),
                            spans=(CHUNK_SPAN,))
    span = report["spans"][CHUNK_SPAN]
    return {"chunk_update_host_share": span["host_ms"] / report["wall_ms"],
            "chunk_update_device_share_of_device_time":
                span["device_ms"] / max(report["device_ms"], 1e-9),
            **report}


def _vs_single(run, batch, cfg, device, rank) -> Dict:
    """The CP step's losses and gradients against a cp = 1 model."""
    cp = ps.get_context_parallel_world_size()
    r = ps.get_context_parallel_rank()
    losses = run.model(run.tokens, key_padding_mask=run.kpm,
                       labels=run.labels, loss_mask=run.loss_mask)
    local = losses.sum() / run.n
    names = list(run.params)
    grads = dict(zip(names, torch.autograd.grad(
        local, [run.params[n] for n in names])))
    from apex_tpu_torch.parallel.ddp import all_reduce_gradients

    grads = all_reduce_gradients(grads, run.group, gradient_average=False)
    mean = float(ps.all_reduce(local.detach(), run.group))
    gathered = ps.all_gather(losses.detach(), run.group, dim=1)
    out = {"cp_mean_loss": mean}
    if rank != 0:
        return out
    single = _cp_model(cfg, None, device, context_parallel_mode=None)
    single.load_state_dict(run.model.state_dict())
    dev = run.model.device
    full = {k: torch.as_tensor(batch[k], device=dev)
            for k in ("tokens", "labels", "kpm", "loss_mask")}
    ref = single(full["tokens"].long(), key_padding_mask=full["kpm"],
                 labels=full["labels"].long(), loss_mask=full["loss_mask"])
    n = full["loss_mask"].sum().clamp_min(1.0)
    ref_mean = ref.sum() / n
    sp = dict(single.named_parameters())
    ref_grads = dict(zip(names, torch.autograd.grad(
        ref_mean, [sp[k] for k in names])))
    err = (gathered - ref.detach()).abs()
    rel = {k: float((grads[k] - ref_grads[k]).norm()
                    / ref_grads[k].norm().clamp_min(1e-30)) for k in names}
    worst = max(rel, key=rel.get)
    out.update(
        single_mean_loss=float(ref_mean.detach()),
        loss_max_abs_err=float(err.max()),
        loss_max_rel_err=float((err / ref.detach().abs().clamp_min(1e-30))
                               .max()),
        loss_ok=bool(torch.allclose(gathered, ref.detach(), rtol=2e-4,
                                    atol=2e-5)),
        grad_rel=rel, worst_grad=worst, worst_grad_rel=rel[worst],
        cp=cp, cp_rank=r)
    return out


def zero_bubble_worker(rank: int, world_size: int, cases: Sequence):
    """Each case (``name``, ``kind``: ``"toy"`` or ``"pre_post"``, ``pp``,
    and either the toy stage's ``params`` by pp rank, ``microbatches``
    and ``targets``, or ``tp``, ``config``, ``params`` by rank as
    ``gpt_pipeline_params_from_jax`` gives them, ``tokens`` and
    ``labels``) through the port's zero-bubble function and, beside it,
    its 1F1B: each one's loss, losses and gradients."""
    from apex_tpu_torch.parallel import pipeline as pl
    from apex_tpu_torch.transformer.testing.pipeline_workers import (
        _params,
        _tree_np,
        toy_loss,
        toy_stage,
    )

    out = {}
    for c in cases:
        ps.initialize_model_parallel(c.get("tp", 1), c["pp"])
        res = {}
        if c["kind"] == "toy":
            p = _params(c["params"][ps.get_pipeline_model_parallel_rank()])
            x, t = (torch.from_numpy(c[n])
                    for n in ("microbatches", "targets"))
            for name, fn in (
                    ("zb", pl.get_forward_backward_func(None, c["pp"],
                                                        zero_bubble=True)),
                    ("1f1b", pl.get_forward_backward_func(None, c["pp"]))):
                loss, losses, grads = fn(toy_stage, toy_loss, p, x, t)
                res[name] = dict(loss=float(loss), losses=_np(losses),
                                 grads=_tree_np(grads),
                                 fields_untouched=[q.grad is None
                                                   for q in p.values()])
        else:
            from apex_tpu_torch.models.gpt_pipeline import build_gpt_pipeline
            from apex_tpu_torch.transformer import TransformerConfig
            from apex_tpu_torch.transformer.layer import sequence_parallel

            cfg = TransformerConfig(compute_dtype=torch.float32,
                                    **c["config"])
            parts = build_gpt_pipeline(cfg, c["pp"], device="cpu")
            params = _params(c["params"][rank])
            _, mb, seq = c["tokens"].shape
            if sequence_parallel(cfg):
                seq //= c["tp"]
            args = (parts.pre_fn, parts.stage_fn, parts.post_loss_fn,
                    params, torch.from_numpy(c["tokens"]).long(),
                    torch.from_numpy(c["labels"]).long())
            kw = dict(tensor_shape=(seq, mb, cfg.hidden_size),
                      dtype=torch.float32)
            for name, fn in (
                    ("zb", pl.forward_backward_zero_bubble_with_pre_post),
                    ("1f1b", pl.forward_backward_with_pre_post)):
                loss, losses, grads = fn(*args, **kw)
                res[name] = dict(loss=float(loss), losses=_np(losses),
                                 grads=_tree_np(grads))
        out[c["name"]] = res
        ps.destroy_model_parallel()
    return out


def zero_bubble_vs_1f1b_worker(rank: int, world_size: int,
                               argv: Sequence[str], device: str = "cuda"):
    """``GPTPipelineTraining`` from ``argv`` (fp32) through 1F1B and
    through the zero-bubble schedule from the same weights (the 1F1B
    run's, drawn from the seed) and tokens, ``--train-iters`` steps each
    on ``device``: both runs' losses, each step's worst gradient relative
    error in norm (zero bubble against 1F1B) with its name, and this
    rank's launch counts."""
    from apex_tpu_torch import _kernels
    from apex_tpu_torch.transformer.testing.pipeline_workers import _args
    from apex_tpu_torch.transformer.testing.standalone_gpt import (
        GPTPipelineTraining,
    )

    _kernels.reset_launch_counts()
    args = _args(argv, world_size)
    out, init, ref = {}, None, []
    for schedule in ("1f1b", "zero_bubble"):
        run = GPTPipelineTraining(args, device,
                                  zero_bubble=schedule == "zero_bubble")
        if init is None:
            init = {part: {n: t.detach().clone() for n, t in named.items()}
                    for part, named in run.params.items()}
        else:
            run.load(init)
        losses, worst = [], []
        for i in range(run.steps):
            loss, grads = run.step(i, return_grads=True)
            losses.append(loss)
            if schedule == "1f1b":
                ref.append({n: g.detach().clone() for n, g in grads.items()})
                continue
            rel = {n: float((g - ref[i][n]).norm()
                            / ref[i][n].norm().clamp_min(1e-30))
                   for n, g in grads.items()}
            name = max(rel, key=rel.get)
            worst.append((name, rel[name]))
        out[schedule] = losses
        if worst:
            out["grad_rel_worst"] = worst
    ps.destroy_model_parallel()
    out["launches"] = _kernels.launch_counts()
    return out


def jobs_worker(rank: int, world_size: int, jobs: Sequence):
    """Runs ``jobs``, pairs (name of a worker of this module, its extra
    arguments), one after another in one world; their results in
    order."""
    return [globals()[name](rank, world_size, *args) for name, args in jobs]
