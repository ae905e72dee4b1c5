"""Rank functions of the pipeline checks, for
:func:`~apex_tpu_torch.transformer.testing.distributed_test_base.spawn`
(``tests/test_torch_pipeline*.py``, ``chip_smoke.py``).

Each ``*_worker(rank, world_size, ...)`` runs the port's side of a group
of checks on its rank and returns numpy arrays, which the caller holds
against the JAX package's functions on its device mesh. Inputs are
numpy arrays made from seeds by the caller, stacked by rank where ranks
differ. :func:`jobs_worker` runs several of them in one world.
"""

from typing import Dict, Sequence

import numpy as np
import torch
import torch.distributed as dist

from apex_tpu_torch.parallel import parallel_state as ps

__all__ = ["P2P_FUNCTIONS", "card_vs_plain_worker", "gpt_pre_post_worker",
           "groups_worker", "interleaved_worker", "jobs_worker",
           "p2p_worker", "run_gpt_worker", "staged_p2p_worker", "toy_loss",
           "toy_schedules_worker", "toy_stage", "untagged_schedules_worker"]

# the JAX functions of p2p.py, by name
P2P_FUNCTIONS = ("send_forward_recv_forward", "send_backward_recv_backward",
                 "ring_forward", "ring_send_last_to_first", "send_forward",
                 "recv_forward", "send_backward", "recv_backward")


def _np(t):
    return t.detach().float().cpu().numpy()


def toy_stage(params, x):
    """The toy stage of the schedule checks: ``tanh(x @ w + b)``."""
    return torch.tanh(x @ params["w"] + params["b"])


def toy_loss(y, t):
    return ((y - t) ** 2).mean()


def groups_worker(rank: int, world_size: int, layouts: Sequence):
    """For each (dp, pp, tp) of ``layouts``: this rank's tp, dp and pp
    groups as lists of ranks, its ranks on the three axes, the first and
    last stage flags, and ``get_group("pp")``'s ranks. A layout (dp, pp,
    cp, tp) adds the cp group, and its ranks and sizes are given in that
    order."""
    out = {}
    for layout in layouts:
        with_cp = len(layout) == 4
        dp, pp, cp, tp = layout if with_cp else (layout[0], layout[1], 1,
                                                 layout[2])
        ps.initialize_model_parallel(tp, pp, context_parallel_size=cp)
        axes = ("tp", "dp", "pp") + (("cp",) if with_cp else ())
        groups = {a: dist.get_process_group_ranks(ps.get_group(a))
                  if ps.get_group(a) is not None else [rank]
                  for a in axes}
        ranks = (ps.get_data_parallel_rank(),
                 ps.get_pipeline_model_parallel_rank(),
                 ps.get_tensor_model_parallel_rank())
        sizes = (ps.get_data_parallel_world_size(),
                 ps.get_pipeline_model_parallel_world_size(),
                 ps.get_tensor_model_parallel_world_size())
        if with_cp:
            ranks = ranks[:2] + (ps.get_context_parallel_rank(),) + ranks[2:]
            sizes = sizes[:2] + (ps.get_context_parallel_world_size(),) \
                + sizes[2:]
        out[layout] = dict(
            groups=groups, ranks=ranks, sizes=sizes,
            first=ps.is_pipeline_first_stage(),
            last=ps.is_pipeline_last_stage(),
            pp_group_is_group=ps.get_group("pp")
            is ps.get_pipeline_model_parallel_group())
        ps.destroy_model_parallel()
    return out


def p2p_worker(rank: int, world_size: int, cases: Dict):
    """For each pp size of ``cases`` ({pp: x stacked by rank}): every
    JAX function of p2p.py on this rank's ``x``, and the paired
    operations (even pp ranks send forward and receive backward, odd ones
    send backward and receive forward; the last and first stage's own
    calls of the other kind return None)."""
    from apex_tpu_torch.parallel.pipeline import p2p

    out = {}
    for pp, x in cases.items():
        ps.initialize_model_parallel(1, pp)
        t = torch.from_numpy(x[rank])
        res = {name: _np(getattr(p2p, name)(t)) for name in P2P_FUNCTIONS}
        r = ps.get_pipeline_model_parallel_rank()
        if r % 2 == 0:
            res["paired"] = _np(p2p.send_forward_recv_backward(t))
        else:
            res["paired"] = _np(p2p.send_backward_recv_forward(t))
        if r == pp - 1:
            res["last_sfrb"] = p2p.send_forward_recv_backward(t)
        if r == 0:
            res["first_sbrf"] = p2p.send_backward_recv_forward(t)
        out[pp] = res
        ps.destroy_model_parallel()
    return out


def _params(tree, requires_grad=True):
    if isinstance(tree, dict):
        return {k: _params(v, requires_grad) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree), requires_grad=requires_grad)


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    return _np(tree)


def toy_schedules_worker(rank: int, world_size: int, cases: Sequence):
    """Each case ``(name, kind, pp, V, params_by_pp_rank, microbatches,
    targets)`` through the port's schedule ``kind`` (``forward``, ``1f1b``,
    ``interleaved``, ``interleaved_forward``) with the toy stage: the
    outputs (forward; None off the last stage) or the loss, the losses
    and the gradients; an error's message where the schedule raised."""
    from apex_tpu_torch.parallel import pipeline as pl

    out, current = {}, None
    for name, kind, pp, V, params, mbs, targets in cases:
        if current != pp:
            ps.initialize_model_parallel(1, pp)
            current = pp
        p = _params(params[ps.get_pipeline_model_parallel_rank()])
        x, t = torch.from_numpy(mbs), torch.from_numpy(targets)
        try:
            if kind == "forward":
                y = pl.pipeline_forward(toy_stage, p, x)
                out[name] = None if y is None else _np(y)
            elif kind == "interleaved_forward":
                y = pl.pipeline_forward_interleaved(toy_stage, p, x,
                                                    num_model_chunks=V)
                out[name] = None if y is None else _np(y)
            else:
                fn = pl.get_forward_backward_func(
                    V if kind == "interleaved" else None, pp)
                loss, losses, grads = fn(toy_stage, toy_loss, p, x, t)
                out[name] = dict(loss=float(loss), losses=_np(losses),
                                 grads=_tree_np(grads),
                                 grad_fields=[q.grad is None
                                              for q in p.values()])
        except ValueError as e:
            out[name] = {"error": str(e)}
    ps.destroy_model_parallel()
    return out


def untagged_schedules_worker(rank: int, world_size: int, cases: Sequence):
    """:func:`toy_schedules_worker` with every message of ``p2p`` sent and
    received under tag 0, so gloo matches a pair's messages in posting
    order, as NCCL does."""
    isend, irecv = dist.isend, dist.irecv
    dist.isend = lambda *a, **kw: isend(*a, **{**kw, "tag": 0})
    dist.irecv = lambda *a, **kw: irecv(*a, **{**kw, "tag": 0})
    try:
        return toy_schedules_worker(rank, world_size, cases)
    finally:
        dist.isend, dist.irecv = isend, irecv


def gpt_pre_post_worker(rank: int, world_size: int, cases: Sequence):
    """Each case (a dict: ``name``, ``tp``, ``pp``, ``V``, ``config``, the
    fields of an fp32 ``TransformerConfig``, ``params`` by rank as
    ``gpt_pipeline_params_from_jax`` gives them, and ``tokens`` and
    ``labels`` (M, micro_batch, seq)) through ``forward_backward_with_
    pre_post`` with ``build_gpt_pipeline(cfg, pp * V)``'s functions on
    the CPU: the loss, the losses and every gradient."""
    from apex_tpu_torch.models.gpt_pipeline import build_gpt_pipeline
    from apex_tpu_torch.parallel.pipeline import (
        forward_backward_with_pre_post,
    )
    from apex_tpu_torch.transformer import TransformerConfig
    from apex_tpu_torch.transformer.layer import sequence_parallel

    out = {}
    for c in cases:
        ps.initialize_model_parallel(c["tp"], c["pp"])
        cfg = TransformerConfig(compute_dtype=torch.float32, **c["config"])
        parts = build_gpt_pipeline(cfg, c["pp"] * c["V"], device="cpu")
        params = _params(c["params"][rank])
        _, mb, seq = c["tokens"].shape
        if sequence_parallel(cfg):
            seq //= c["tp"]
        loss, losses, grads = forward_backward_with_pre_post(
            parts.pre_fn, parts.stage_fn, parts.post_loss_fn, params,
            torch.from_numpy(c["tokens"]).long(),
            torch.from_numpy(c["labels"]).long(), num_model_chunks=c["V"],
            tensor_shape=(seq, mb, cfg.hidden_size), dtype=torch.float32)
        out[c["name"]] = dict(loss=float(loss), losses=_np(losses),
                              grads=_tree_np(grads))
        ps.destroy_model_parallel()
    return out


def run_gpt_worker(rank: int, world_size: int, argv: Sequence[str],
                   params: Sequence, tokens: np.ndarray):
    """``standalone_gpt``'s ``GPTPipelineTraining`` from the arguments
    ``argv`` on the CPU, from this rank's weights ``params[rank]`` and
    the world's tokens (steps, M, micro_batch x dp, seq): the losses of
    ``--train-iters`` steps and the final parameters. Then ``run_gpt``
    itself from its own seeded weights: its losses and logged lines."""
    from apex_tpu_torch.transformer.testing.standalone_gpt import (
        GPTPipelineTraining,
        run_gpt,
    )

    args = _args(argv, world_size)
    run = GPTPipelineTraining(args, device="cpu")
    run.load(params[rank])
    d, mb = ps.get_data_parallel_rank(), args.micro_batch_size
    run.set_data(tokens[:, :, d * mb:(d + 1) * mb])
    losses = [run.step(i) for i in range(run.steps)]
    final = {part: {n: _np(t) for n, t in named.items()}
             for part, named in run.params.items()}
    lines = []
    own = run_gpt(args, log=lines.append, device="cpu")
    return dict(losses=losses, params=final, run_gpt=own, lines=lines)


def _args(argv: Sequence[str], world_size: int):
    import os

    from apex_tpu_torch.transformer.testing.arguments import parse_args

    os.environ["WORLD_SIZE"] = str(world_size)
    return parse_args(args=list(argv))


def interleaved_worker(rank: int, world_size: int, argv: Sequence[str],
                       device: str = "cuda", zero_bubble: bool = False):
    """``GPTPipelineTraining`` with as many model chunks as ``argv``'s
    virtual pipeline size (``forward_backward_with_pre_post(
    num_model_chunks=V)``), or with ``zero_bubble`` through the B/W split,
    trained on ``device`` by ``standalone_gpt.train``: its closing fields
    (the same on every rank)."""
    from apex_tpu_torch.transformer.testing.standalone_gpt import (
        GPTPipelineTraining,
        train,
    )

    args = _args(argv, world_size)
    run = GPTPipelineTraining(
        args, device, zero_bubble=zero_bubble,
        num_model_chunks=args.virtual_pipeline_model_parallel_size or 1)
    _, summary = train(run, log=lambda *a: None)
    ps.destroy_model_parallel()
    return summary


def card_vs_plain_worker(rank: int, world_size: int, argv: Sequence[str],
                         fp32_steps: int, device: str = "cuda"):
    """``GPTPipelineTraining`` from ``argv`` on ``device``'s kernels and on
    the CPU's plain versions from the same weights (the card run's, drawn
    from the seed) and tokens: ``--train-iters`` steps with ``--bf16``,
    and ``fp32_steps`` in fp32. Returns each run's losses and final
    parameters (flat names), each step's gradients' relative error in
    norm (``grad_rel``, plain against card, by flat name), the names of
    the parameters that start at zero, and this rank's launch counts on
    ``device``. (``device`` is the card, the CPU only to rehearse.)"""
    from apex_tpu_torch import _kernels
    from apex_tpu_torch.transformer.testing.standalone_gpt import (
        GPTPipelineTraining,
    )

    _kernels.reset_launch_counts()
    out = {}
    for precision, extra in (("bf16", ["--bf16"]),
                             ("fp32", ["--train-iters", str(fp32_steps)])):
        args = _args(list(argv) + extra, world_size)
        init, grads = None, []
        for side, dev in (("card", device), ("plain", "cpu")):
            run = GPTPipelineTraining(args, dev)
            if init is None:
                init = {part: {n: _np(t).copy() for n, t in named.items()}
                        for part, named in run.params.items()}
            else:
                run.load(init)
            losses = []
            for i in range(run.steps):
                loss, step = run.step(i, return_grads=True)
                losses.append(loss)
                step = {n: _np(g) for n, g in step.items()}
                if side == "card":
                    grads.append(step)
                else:
                    grads[i] = {n: float(np.linalg.norm(grads[i][n] - g)
                                         / max(np.linalg.norm(g), 1e-30))
                                for n, g in step.items()}
            out.setdefault(precision, {})[side] = dict(
                losses=losses,
                params={f"{part}.{n}": _np(t)
                        for part, named in run.params.items()
                        for n, t in named.items()})
        out[precision]["grad_rel"] = grads
    ps.destroy_model_parallel()
    out["zero_init"] = [f"{part}.{n}" for part, named in init.items()
                        for n, a in named.items() if not a.any()]
    out["launches"] = _kernels.launch_counts()
    return out


def remat_worker(rank: int, world_size: int, argv: Sequence[str],
                 device: str = "cuda", zero_bubble: bool = False):
    """``GPTPipelineTraining`` from ``argv`` at ``remat=True`` and then at
    ``remat=False`` from the same weights and tokens, ``--train-iters``
    steps each on ``device``. Returns, for this rank, whether every
    loss and every step's gradients are bit-equal between the two (and
    the largest difference), each run's losses, peak memory (the card's,
    reset before the run), launch counts (and a step) and ``STAGED``
    counts a step."""
    from apex_tpu_torch import _kernels
    from apex_tpu_torch.transformer.testing.standalone_gpt import (
        GPTPipelineTraining,
    )

    args = _args(argv, world_size)
    cuda = torch.device(device).type == "cuda"
    init, ref, out = None, None, {}
    for remat in (True, False):
        run = GPTPipelineTraining(
            args, device, zero_bubble=zero_bubble, remat=remat,
            num_model_chunks=args.virtual_pipeline_model_parallel_size or 1)
        if init is None:  # on the host: both runs hold the same on the card
            init = {part: {n: t.detach().cpu().clone()
                           for n, t in named.items()}
                    for part, named in run.params.items()}
        else:
            run.load(init)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launch_counts()
        staged0 = dict(ps.STAGED)
        steps = []
        for i in range(run.steps):
            loss, grads = run.step(i, return_grads=True)
            steps.append((loss, {n: g.detach().cpu().clone()
                                 for n, g in grads.items()}))
        launches = _kernels.launch_counts()
        out[f"remat_{remat}"] = dict(
            losses=[loss for loss, _ in steps], launches=launches,
            peak_mem_gb=(torch.cuda.max_memory_allocated() / 1e9
                         if cuda else None),
            launches_per_step={k: n / run.steps for k, n in
                               launches.items()},
            staged_per_step={k: (n - staged0[k]) / run.steps
                             for k, n in ps.STAGED.items()})
        if ref is None:
            ref = steps
        del run
    worst, equal = 0.0, True
    for (la, ga), (lb, gb) in zip(ref, steps):
        equal &= la == lb
        for n, a in ga.items():
            equal &= bool(torch.equal(a, gb[n]))
            worst = max(worst, float((a - gb[n]).abs().max()))
    ps.destroy_model_parallel()
    return dict(out, bit_equal=equal, max_abs_diff=worst)


def staged_p2p_worker(rank: int, world_size: int, device: str = "cuda"):
    """``parallel_state.p2p`` of CUDA tensors over gloo (two ranks, each
    sending to the other) against the same exchange of host tensors: the
    results by device, and what ``STAGED`` counted meanwhile."""
    group = dist.group.WORLD
    x = torch.randn(3, 5, generator=torch.Generator().manual_seed(rank))
    y = torch.arange(4, dtype=torch.bfloat16) + rank
    before = dict(ps.STAGED)
    out = {}
    for dev in (device, "cpu"):
        a, b = x.to(dev), y.to(dev)
        got = ps.p2p(group, [(a, 1 - rank, 0), (b, 1 - rank, 1)],
                     [(a, 1 - rank, 0), (b, 1 - rank, 1)])
        ps.wait_sends()
        out[dev] = [_np(g) for g in got] + [str(g.device.type) for g in got]
    return out, {k: ps.STAGED[k] - n for k, n in before.items()}


def jobs_worker(rank: int, world_size: int, jobs: Sequence):
    """Runs ``jobs``, pairs (name of a worker of this module, its extra
    arguments), one after another in one world; their results in
    order."""
    return [globals()[name](rank, world_size, *args) for name, args in jobs]
