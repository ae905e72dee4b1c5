"""Rank functions of the parallel checks, for
:func:`~apex_tpu_torch.transformer.testing.distributed_test_base.spawn`.

Each ``*_worker(rank, world_size, ...)`` runs the port's side of one
group of checks on its rank of a spawned world and returns numpy arrays
by name, which the caller holds against the JAX package's functions on
its device mesh (``tests/test_torch_parallel*.py``) or against another
run (``chip_smoke.py``). Inputs come in as numpy arrays made from seeds
by the caller, per rank where ranks differ (``x[rank]``). They live in a
module of the package, not in the tests, so that spawned processes can
import them.
"""

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

from apex_tpu_torch.parallel import mappings
from apex_tpu_torch.parallel import parallel_state as ps

__all__ = ["REGIONS", "card_vs_plain_worker", "data_parallel_worker",
           "gpt_worker", "layers_worker", "mappings_worker",
           "sequence_worker", "staged_collectives_worker",
           "training_worker"]

# the seven regions, by the JAX package's function names
REGIONS = (
    "copy_to_tensor_model_parallel_region",
    "reduce_from_tensor_model_parallel_region",
    "scatter_to_tensor_model_parallel_region",
    "gather_from_tensor_model_parallel_region",
    "scatter_to_sequence_parallel_region",
    "gather_from_sequence_parallel_region",
    "reduce_scatter_to_sequence_parallel_region",
)


def _t(a, requires_grad=False, device="cpu"):
    return torch.tensor(np.asarray(a), device=device,
                        requires_grad=requires_grad)


def _np(t):
    return t.detach().float().cpu().numpy()


def _vjp(fn, inputs: Dict[str, np.ndarray], ct: np.ndarray):
    """(fn's output, the gradients of <output, ct> by input name)."""
    ts = {k: _t(v, requires_grad=True) for k, v in inputs.items()}
    out = fn(**ts)
    out.backward(_t(ct))
    return _np(out), {k: _np(t.grad) for k, t in ts.items()}


def mappings_worker(rank: int, world_size: int,
                    cases: Dict[int, Dict[str, tuple]]):
    """For each tp size of ``cases`` ({tp: {region: (x, ct)}}, x and ct
    stacked by rank), each region's output and input gradient."""
    from apex_tpu_torch.parallel.utils import broadcast_data

    out = {}
    for tp, regions in cases.items():
        ps.initialize_model_parallel(tp)
        out[tp] = {}
        for name, (x, ct) in regions.items():
            fn = getattr(mappings, name)
            y, g = _vjp(lambda x: fn(x), {"x": x[rank]}, ct[rank])
            out[tp][name] = (y, g["x"])
            # tp rank 0's input, sent to its tp group
            out[tp][name + " broadcast_data"] = _np(broadcast_data(
                ["x"], {"x": _t(x[rank])})["x"])
        ps.destroy_model_parallel()
    return out


def _load(module, params: Dict[str, np.ndarray]) -> None:
    module.load_state_dict({k: torch.from_numpy(np.asarray(v))
                            for k, v in params.items()}, strict=True)


def _param_grads(module):
    return {n: _np(p.grad) for n, p in module.named_parameters()}


def layers_worker(rank: int, world_size: int, tp: int, cases: Dict):
    """Column, Row and the vocab-parallel embedding and cross entropy at
    ``tp``: each case's output, input gradient and parameter gradients.
    ``cases``: {name: dict(kind, kw, params, x, ct[, labels, ls])}, all
    stacked by rank."""
    from apex_tpu_torch.parallel.cross_entropy import (
        vocab_parallel_cross_entropy,
    )
    from apex_tpu_torch.parallel.layers import (
        ColumnParallelLinear,
        RowParallelLinear,
        VocabParallelEmbedding,
    )

    ps.initialize_model_parallel(tp)
    out = {}
    for name, c in cases.items():
        kind, ct = c["kind"], _t(c["ct"][rank])
        if kind == "cross_entropy":
            x = _t(c["x"][rank], requires_grad=True)
            y = vocab_parallel_cross_entropy(x, _t(c["labels"][rank]),
                                             c["ls"])
            y.backward(ct)
            out[name] = dict(y=_np(y), dx=_np(x.grad))
            continue
        cls = {"column": ColumnParallelLinear, "row": RowParallelLinear,
               "embedding": VocabParallelEmbedding}[kind]
        layer = cls(**c["kw"])
        _load(layer, {k: v[rank] for k, v in c["params"].items()})
        if kind == "embedding":
            y = layer(_t(c["x"][rank]))
            y.backward(ct)
            out[name] = dict(y=_np(y), grads=_param_grads(layer))
            continue
        x = _t(c["x"][rank], requires_grad=True)
        y = layer(x)
        y.backward(ct)
        out[name] = dict(y=_np(y), dx=_np(x.grad),
                         grads=_param_grads(layer))
    return out


def gpt_worker(rank: int, world_size: int, tp: int, config: Dict,
               layer_cases: Dict, model_case: Dict):
    """``ParallelTransformerLayer``s and one ``GPTModel`` at ``tp`` (fp32,
    the ``config`` fields of a ``TransformerConfig``; each layer case
    adds its own ``config``) from this rank's JAX shards: each layer's
    output and gradients of <output, ct>; the model's logits, loss and
    every parameter gradient."""
    from apex_tpu_torch.models import GPTModel, gpt_loss_fn
    from apex_tpu_torch.transformer import (
        ParallelTransformerLayer,
        TransformerConfig,
    )

    ps.initialize_model_parallel(tp)
    out = {}
    for name, case in layer_cases.items():
        layer = ParallelTransformerLayer(
            TransformerConfig(**config, **case["config"]))
        _load(layer, case["params"][rank])
        y, g = _vjp(layer, {"hidden_states": case["x"][rank]},
                    case["ct"][rank])
        out[name] = dict(y=y, dx=g["hidden_states"],
                         grads=_param_grads(layer))

    cfg = TransformerConfig(**config)
    model = GPTModel(cfg, device="cpu")
    _load(model, model_case["params"][rank])
    tokens = _t(model_case["tokens"][rank]).long()
    labels = _t(model_case["labels"][rank]).long()
    with torch.no_grad():
        logits = model(tokens)
    loss = gpt_loss_fn(model(tokens, labels=labels))
    loss.backward()
    out["model"] = dict(logits=_np(logits), loss=float(loss),
                        grads=_param_grads(model))
    return out


def _run_steps(training, state, batches: Sequence) -> List[Dict]:
    steps = []
    for x, y, nan in batches:
        state, loss, verdict, metrics = training.train_step(
            state, x, y, inject_nan=nan)
        steps.append(dict(metrics, verdict=verdict))
    return steps


def training_worker(rank: int, world_size: int, target: Dict,
                    params: List[Dict[str, np.ndarray]], batches: Sequence):
    """``build_gpt_training(GPTTargetConfig(**target))`` on the CPU from
    this rank's weights ``params[rank]``, through ``batches`` ((tokens,
    labels, inject_nan) of the whole world): each step's loss, verdict and
    metrics, the final parameters and the optimizer's step."""
    from apex_tpu_torch.resilience.replay import (
        GPTTargetConfig,
        build_gpt_training,
    )

    training = build_gpt_training(GPTTargetConfig(**target), device="cpu")
    state = training.init_state()
    _load(training.model, params[rank])
    if training.cfg.zero:  # the master shard of the loaded weights
        state.opt = training.opt.init(state.params)
    steps = _run_steps(training, state, batches)
    return dict(steps=steps, opt_step=int(state.opt.step),
                params={n: _np(p) for n, p in state.params.items()})


def data_parallel_worker(rank: int, world_size: int, cases: Dict):
    """The data-parallel pieces over groups of this world:
    ``all_reduce_gradients`` (with and without the predivide factor and
    fp32 reduction), ``broadcast_params``, ``Reducer``,
    ``DistributedDataParallel.value_and_grad``, ``distributed_fused_adam``
    (``cases["zero"]``: each case's group of ranks, per-rank params and
    per-step grads) and ``SyncBatchNorm`` (``cases["syncbn"]``)."""
    from apex_tpu_torch.optimizers import distributed_fused_adam
    from apex_tpu_torch.optimizers.distributed_fused_adam import (
        zero_state_specs,
    )
    from apex_tpu_torch.parallel import (
        DistributedDataParallel,
        Reducer,
        SyncBatchNorm,
        all_reduce_gradients,
        broadcast_params,
    )

    out = {}
    world = torch.distributed.group.WORLD
    grads = {k: _t(v[rank]) for k, v in cases["ddp_grads"].items()}
    w = {"w": _t(cases["vg_w"], requires_grad=True)}
    loss, vg = DistributedDataParallel(
        lambda p, x: (x @ p["w"]).square().mean(), world
    ).value_and_grad()(w, _t(cases["vg_x"][rank]))
    out["ddp"] = {
        "mean": {k: _np(v) for k, v in all_reduce_gradients(
            grads, world).items()},
        "predivide": {k: _np(v) for k, v in all_reduce_gradients(
            grads, world, gradient_predivide_factor=2.0,
            allreduce_always_fp32=True).items()},
        "sum": {k: _np(v) for k, v in all_reduce_gradients(
            grads, world, gradient_average=False).items()},
        "reducer": {k: _np(v) for k, v in
                    Reducer(world).reduce(grads).items()},
        "broadcast": {k: _np(v) for k, v in broadcast_params(
            {k: v.clone() for k, v in grads.items()}, world).items()},
        "value_and_grad": {"loss": _np(loss), "w": _np(vg["w"])},
    }

    out["zero"] = {}
    for name, c in cases["zero"].items():
        ranks = c["ranks"]
        group = torch.distributed.new_group(ranks)  # every rank calls it
        if rank not in ranks:
            continue
        i = ranks.index(rank)
        params = {k: _t(v) for k, v in c["params"].items()}
        opt = distributed_fused_adam(group=group, **c["hyper"])
        state = opt.init(params)
        for g in c["grads"]:
            updates, state = opt.update(
                {k: _t(v[i]) for k, v in g.items()}, state, params)
            params = {k: params[k] + updates[k] for k in params}
        specs = zero_state_specs(params, len(ranks))
        out["zero"][name] = dict(
            params={k: _np(v) for k, v in params.items()},
            master_shard=_np(state.master_shard),
            exp_avg=_np(state.exp_avg), step=int(state.step),
            shard_range=specs.shard_range(i),
            padded_total=specs.spec.padded_total)

    out["syncbn"] = {}
    for name, c in cases["syncbn"].items():
        ranks = c["ranks"]
        group = torch.distributed.new_group(ranks)
        if rank not in ranks:
            continue
        i = ranks.index(rank)
        bn = SyncBatchNorm(c["features"], use_running_average=False,
                           momentum=0.1, process_group=group)
        _load(bn, c["params"])
        x = _t(c["x"][i], requires_grad=True)
        y = bn(x)
        y.backward(_t(c["ct"][i]))
        out["syncbn"][name] = dict(y=_np(y), dx=_np(x.grad),
                                   grads=_param_grads(bn),
                                   mean=_np(bn.mean), var=_np(bn.var))
    return out


def card_vs_plain_worker(rank: int, world_size: int, target: Dict,
                         batches: Sequence, fp32_steps: int,
                         device: str = "cuda"):
    """The same 4-rank training on the card's kernels and on the CPU's
    plain versions, from the same weights (the card's, drawn from the
    seed): ``build_gpt_training(GPTTargetConfig(**target))`` in bf16
    through ``batches``, and an fp32 loop of the same model and pieces
    (the model's losses, the data-parallel all-reduce, ``fused_adam``)
    over the first ``fp32_steps`` batches. Returns each run's losses,
    final parameters and this rank's launch counts on the card. (The
    first run's ``device`` is the card, the CPU only to rehearse.)"""
    from apex_tpu_torch import _kernels
    from apex_tpu_torch.models import GPTModel, gpt_loss_fn
    from apex_tpu_torch.optimizers import fused_adam
    from apex_tpu_torch.parallel import all_reduce_gradients
    from apex_tpu_torch.resilience.replay import (
        GPTTargetConfig,
        build_gpt_training,
    )

    cfg = GPTTargetConfig(**target)
    device = torch.device(device)
    out = {"bf16": {}, "fp32": {}}
    _kernels.reset_launch_counts()
    init = None
    for dev in (device, torch.device("cpu")):
        training = build_gpt_training(cfg, device=dev)
        state = training.init_state()
        if init is None:
            init = {k: v.detach().cpu().clone() for k, v in
                    training.model.state_dict().items()}
        else:
            training.model.load_state_dict(init)
            state.opt = training.opt.init(state.params)
        steps = _run_steps(training, state, batches)
        out["bf16"]["card" if dev is device else "plain"] = dict(
            steps=steps, params={n: _np(p) for n, p in
                                 state.params.items()})

    fp32 = dataclasses.replace(training.transformer_config,
                               compute_dtype=torch.float32)
    cols = slice(ps.get_data_parallel_rank() * cfg.micro_batch,
                 (ps.get_data_parallel_rank() + 1) * cfg.micro_batch)
    for dev in (device, torch.device("cpu")):
        model = GPTModel(fp32, device=dev)
        model.load_state_dict(init)
        params = dict(model.named_parameters())
        opt = fused_adam(lr=cfg.lr, weight_decay=cfg.weight_decay)
        opt_state = opt.init(params)
        losses = []
        for x, y, _ in batches[:fp32_steps]:
            x = torch.as_tensor(x)[:, cols].to(dev).long()
            y = torch.as_tensor(y)[:, cols].to(dev).long()
            for p in params.values():
                p.grad = None
            micro = []
            for i in range(x.shape[0]):
                li = gpt_loss_fn(model(x[i], labels=y[i]))
                (li / x.shape[0]).backward()
                micro.append(li.detach())
            loss = ps.all_reduce(torch.stack(micro).mean(),
                                 ps.get_data_parallel_group())
            losses.append(float(loss) / training.dp)
            with torch.no_grad():
                grads = all_reduce_gradients(
                    {n: p.grad for n, p in params.items()})
                updates, opt_state = opt.update(grads, opt_state, params)
                for n, p in params.items():
                    p.add_(updates[n])
        out["fp32"]["card" if dev is device else "plain"] = dict(
            losses=losses, params={n: _np(p) for n, p in params.items()})
    out["launches"] = _kernels.launch_counts()
    return out


def staged_collectives_worker(rank: int, world_size: int,
                              device: str = "cuda"):
    """Each collective of ``parallel_state`` over the world, on a tensor
    on ``device`` (under gloo, staged through host memory) and on the
    same tensor on the CPU: the results by device, and what
    ``parallel_state.STAGED`` counted meanwhile."""
    group = torch.distributed.group.WORLD
    x = torch.randn(4, 6, generator=torch.Generator().manual_seed(rank))
    before = dict(ps.STAGED)
    out = {}
    for dev in (device, "cpu"):
        t = x.to(dev)
        out[dev] = [_np(y) for y in (
            ps.all_reduce(t, group), ps.all_reduce(t, group, op="max"),
            ps.all_gather(t, group, dim=1), ps.reduce_scatter(t, group),
            ps.broadcast(t.clone(), group))]
    return out, {k: ps.STAGED[k] - n for k, n in before.items()}


def sequence_worker(rank: int, world_size: int, jobs: Sequence):
    """Runs ``jobs``, pairs (name of a worker of this module, its extra
    arguments), one after another in one world; returns their results in
    order."""
    return [globals()[name](rank, world_size, *args) for name, args in jobs]


def sp_dropout_worker(rank: int, world_size: int, seed: int = 7):
    """A transformer layer's two dropout modules at tp = ``world_size``
    with sequence parallelism, rate 0.5, on ones (8, 2, 16), handed their
    generators by ``seed_dropout`` from ``seed``, twice from the same
    seed: the hidden dropout's outputs (``hidden``, ``hidden_again``),
    the attention dropout's (``attention``, ``attention_again``), and the
    attention mask the model-parallel generator draws directly
    (``attention_direct``: its present behaviour, no fold)."""
    from apex_tpu_torch.parallel.random import model_parallel_generator
    from apex_tpu_torch.transformer import TransformerConfig
    from apex_tpu_torch.transformer.layer import (
        CoreAttention,
        ShardAwareDropout,
        _hidden_dropout_axes,
        keep_mask,
        seed_dropout,
    )

    ps.initialize_model_parallel(tensor_model_parallel_size=world_size)
    cfg = TransformerConfig(num_layers=1, hidden_size=16,
                            num_attention_heads=2 * world_size,
                            sequence_parallel=True, hidden_dropout=0.5,
                            attention_dropout=0.5)
    x = torch.ones(8, 2, 16)
    out = {}
    for suffix in ("", "_again"):
        mods = torch.nn.ModuleDict({
            "hidden": ShardAwareDropout(
                cfg.hidden_dropout, axis_names=_hidden_dropout_axes(cfg)),
            "attention": CoreAttention(cfg).attention_dropout})
        seed_dropout(mods, seed, "cpu")
        mods.train()
        for name, mod in mods.items():
            out[name + suffix] = _np(mod(x))
    direct = keep_mask(model_parallel_generator(seed, rank), 0.5, x.shape,
                       "cpu")
    out["attention_direct"] = _np(direct.float() * 2.0)
    out["tp_rank"] = ps.get_tensor_model_parallel_rank()
    return out
