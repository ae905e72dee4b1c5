"""The steps the CLI audits: tiny GPT and BERT training steps
(counterpart of apex_tpu/analysis/targets.py).

The port's own step shapes at JAX's ``_tiny_cfg`` (2 layers, hidden 16,
2 heads, vocabulary 32, sequence 8, bf16, no dropout), each one step of
real work on this rank's device:

- ``gpt_step_target``: ``resilience.replay.targets.build_gpt_training``
  at dp 2 x tp 2 with sequence parallelism — ``GradScaler``, fused
  Adam, the dp gradient all-reduce and the anomaly-sentinel gate (the
  step the GPT example trains);
- ``gpt_compressed_step_target``: the same with the int8 quantized dp
  all-reduce (``parallel/compress.py``);
- ``bert_step_target``: the BERT masked-LM step at dp 2 x tp 2 — fused
  Adam behind the dp gradient all-reduce;
- ``gpt_pp_step_target``: GPT at dp 2 x pp 2 through the zero-bubble
  schedule (``forward_backward_zero_bubble_with_pre_post``) with ZeRO's
  ``distributed_fused_adam``, whose reduce-scatter is the dp gradient
  sync.

Each target function initializes ``parallel_state`` over the initialized
``torch.distributed`` world of 4 ranks (``python -m
apex_tpu_torch.analysis`` spawns it, gloo on the CPU or on the card) and
returns a :class:`~apex_tpu_torch.analysis.passes.StepTarget` whose
``fn`` runs one step. The GPT target carries the analytic HBM prediction
the ``hlo-memory`` pass holds it to.

``gpt_zero_naive_step_target`` is autofix's proof target, not one of the
gate's (:data:`FIXABLE_TARGETS`, ``python -m apex_tpu_torch.analysis
--fix``): the tiny GPT at dp 2 x tp 2 whose flat fp32 Adam moments are
whole on every dp rank and updated there, as JAX's.
"""

from typing import Dict, List

import torch

from apex_tpu_torch.analysis.passes import StepTarget

__all__ = [
    "FIXABLE_TARGETS",
    "all_targets",
    "bert_step_target",
    "gpt_compressed_step_target",
    "gpt_pp_step_target",
    "gpt_step_target",
    "gpt_zero_naive_step_target",
    "layout_axes",
    "tiny_config",
]

#: JAX's _tiny_cfg
_TINY = dict(num_layers=2, hidden_size=16, num_attention_heads=2,
             vocab_size=32, max_position_embeddings=8, hidden_dropout=0.0,
             attention_dropout=0.0)


def tiny_config(**overrides):
    """JAX's ``_tiny_cfg`` as the port's ``TransformerConfig`` (bf16)."""
    from apex_tpu_torch.transformer import TransformerConfig

    return TransformerConfig(**{**_TINY, "compute_dtype": torch.bfloat16,
                                **overrides})


def layout_axes() -> Dict[str, int]:
    """The layout's axis sizes (JAX's ``mesh.shape``)."""
    from apex_tpu_torch.parallel import parallel_state as ps

    return {"dp": ps.get_data_parallel_world_size(),
            "pp": ps.get_pipeline_model_parallel_world_size(),
            "cp": ps.get_context_parallel_world_size(),
            "tp": ps.get_tensor_model_parallel_world_size()}


def gpt_step_target(device="cuda", compression: str = "none") -> StepTarget:
    """The GPT dp 2 x tp 2 training step: bf16 + SP over tp, GradScaler,
    fused Adam, the dp gradient all-reduce (int8-quantized with
    ``compression="int8"``) and the sentinel gate; one micro-batch of
    one sequence a dp rank, zero tokens (JAX's ``jnp.zeros``)."""
    from apex_tpu_torch.resilience.replay.targets import (
        GPTTargetConfig,
        build_gpt_training,
    )

    cfg = GPTTargetConfig(vocab=_TINY["vocab_size"],
                          seq_len=_TINY["max_position_embeddings"],
                          layers=_TINY["num_layers"],
                          hidden=_TINY["hidden_size"],
                          heads=_TINY["num_attention_heads"], tp=2,
                          micro_batch=1, global_batch=2,
                          compression=compression)
    training = build_gpt_training(cfg, device=device)
    state = training.init_state()
    tokens = torch.zeros((training.num_micro, cfg.micro_batch * training.dp,
                          cfg.seq_len), dtype=torch.long)
    return StepTarget(
        name="gpt-dp2tp2" if compression == "none"
        else f"gpt-dp2tp2-{compression}",
        fn=training.train_step, args=(state, tokens, tokens),
        axes=layout_axes(), device=training.device,
        hbm=(_gpt_hbm_prediction(training, rows=tokens.shape[0]
                                 * tokens.shape[1], seq=cfg.seq_len)
             if compression == "none" else None))


def _gpt_hbm_prediction(training, rows: int, seq: int):
    """The analytic HBM ledger of the GPT step, from the config the
    builder used: fp32 weights and fused-Adam state at tp 2, the
    GradScaler's four scalars, the sentinel's five (fp32 ema and var,
    three int32 counters), the step's int64 tokens and labels (every dp
    rank's rows: the step takes its own from them), and the port's DDP
    buffers: its gradient all-reduce runs over one flat fp32 buffer
    padded to ``flatten_pytree``'s chunk (``parallel/ddp.py``), alive
    three times at its peak (the flat gradients, their all-reduced copy,
    the averaged one), where JAX's psums each leaf."""
    from apex_tpu_torch.monitor.xray.hbm import model as hbm_model
    from apex_tpu_torch.ops.multi_tensor import CHUNK_SIZE

    dims = hbm_model.TransformerDims.from_config(training.transformer_config)
    flat = -(-hbm_model.gpt_param_elements(dims, tp=2) // CHUNK_SIZE)
    flat = max(1, flat) * CHUNK_SIZE
    return hbm_model.predict_train_memory(
        dims, tp=2, params_dtype="float32", compute_dtype="bfloat16",
        microbatch_size=rows, seq_len=seq, token_dtype="int64",
        optimizer="fused_adam", grad_scaler=True, remat="none",
        label="gpt-dp2tp2",
    ).with_components(
        hbm_model.Component(
            "sentinel_state", 2 * 4 + 3 * 4,
            detail="AnomalySentinel: fp32 ema, var; int32 count, "
                   "consecutive, anomalies"),
        hbm_model.Component(
            "ddp_flat_buffers", 3 * flat * 4, transient=True,
            detail=f"3 x {flat} fp32: the DDP all-reduce's flat gradients"))


def gpt_compressed_step_target(device="cuda") -> StepTarget:
    """The GPT step with the int8 quantized dp gradient all-reduce."""
    return gpt_step_target(device, compression="int8")


def bert_step_target(device="cuda") -> StepTarget:
    """The BERT masked-LM step at dp 2 x tp 2: bf16, tp vocabulary and
    heads, the mean LM loss over an all-ones mask, the dp gradient
    all-reduce, fused Adam."""
    from apex_tpu_torch._kernels import resolve_device
    from apex_tpu_torch.models.bert import BertModel
    from apex_tpu_torch.optimizers import fused_adam
    from apex_tpu_torch.parallel import parallel_state as ps
    from apex_tpu_torch.parallel.ddp import all_reduce_gradients

    dev = resolve_device(device)
    ps.initialize_model_parallel(tensor_model_parallel_size=2)
    model = BertModel(tiny_config(), add_binary_head=False, device=dev,
                      seed=0)
    params = dict(model.named_parameters())
    opt = fused_adam(lr=1e-3)
    box = [opt.init(params)]
    tokens = torch.zeros((1, _TINY["max_position_embeddings"]),
                         dtype=torch.long, device=dev)

    def bert_train_step(tokens, labels):
        for p in params.values():
            p.grad = None
        losses, _ = model(tokens, torch.ones_like(tokens), lm_labels=labels)
        loss = losses.float().mean()
        loss.backward()
        grads = all_reduce_gradients(
            {n: p.grad for n, p in params.items()})
        with torch.no_grad():
            updates, box[0] = opt.update(grads, box[0], params)
            for n, p in params.items():
                p.add_(updates[n])
            return ps.all_reduce(loss.detach(),
                                 ps.get_data_parallel_group()) / 2

    return StepTarget(name="bert-dp2tp2", fn=bert_train_step,
                      args=(tokens, tokens), axes=layout_axes(), device=dev)


def gpt_pp_step_target(device="cuda") -> StepTarget:
    """GPT at dp 2 x pp 2: the zero-bubble schedule (its backward edges
    are the port's own p2p sends), two micro-batches of two sequences a
    dp rank, and ZeRO's ``distributed_fused_adam`` over dp, whose
    reduce-scatter is the gradient sync; the loss averaged over dp."""
    from apex_tpu_torch._kernels import resolve_device
    from apex_tpu_torch.models.gpt import init_params
    from apex_tpu_torch.models.gpt_pipeline import build_gpt_pipeline
    from apex_tpu_torch.optimizers import distributed_fused_adam
    from apex_tpu_torch.parallel import parallel_state as ps
    from apex_tpu_torch.parallel.pipeline import (
        forward_backward_zero_bubble_with_pre_post,
    )

    dev = resolve_device(device)
    pp = 2
    ps.initialize_model_parallel(pipeline_model_parallel_size=pp)
    cfg = tiny_config()
    parts = build_gpt_pipeline(cfg, pp, dev)
    init_params(parts.chunk, 7 + ps.get_pipeline_model_parallel_rank())
    post = parts.init_post(9)
    for t in post.values():
        t.requires_grad_(True)
    params = {"pre": dict(parts.embed.named_parameters()),
              "stages": dict(parts.chunk.named_parameters()), "post": post}
    flat = {f"{part}.{n}": t for part, named in params.items()
            for n, t in named.items()}
    opt = distributed_fused_adam(lr=1e-3, axis_name="dp", average_grads=True,
                                 param_gather_buckets=2)
    box = [opt.init(flat)]
    num_micro, mb, seq = 2, 2, _TINY["max_position_embeddings"]
    tokens = torch.zeros((num_micro, mb, seq), dtype=torch.long, device=dev)
    shape = (seq, mb, cfg.hidden_size)

    def gpt_pp_train_step(tokens, labels):
        loss, losses, grads = forward_backward_zero_bubble_with_pre_post(
            parts.pre_fn, parts.stage_fn, parts.post_loss_fn, params,
            tokens, labels, axis_name="pp", tensor_shape=shape,
            dtype=cfg.compute_dtype)
        flat_grads = {f"{part}.{n}": g for part, named in grads.items()
                      for n, g in named.items()}
        with torch.no_grad():
            updates, box[0] = opt.update(flat_grads, box[0], flat)
            for n, p in flat.items():
                p.add_(updates[n])
        dp = ps.get_data_parallel_group()
        return (ps.all_reduce(loss, dp) / 2, ps.all_reduce(losses, dp) / 2)

    return StepTarget(name="gpt-dp2pp2", fn=gpt_pp_train_step,
                      args=(tokens, tokens), axes=layout_axes(), device=dev)


def _flat_adam(p, m, v, g, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8):
    """One Adam step over flat fp32 buffers through ``adam_flat`` (kernel
    #8 on a CUDA tensor): ``(p + update, m, v)``, no bias correction (the
    audits run a single step), as JAX's ``_flat_adam``."""
    from apex_tpu_torch.optimizers._fused_kernels import adam_flat

    one = torch.ones((), dtype=torch.float32, device=p.device)
    upd, m, v = adam_flat(g, p, m, v, one, one, lr=lr, beta1=b1, beta2=b2,
                          eps=eps, weight_decay=0.0, adam_w_mode=True)
    return p + upd, m, v


def gpt_zero_naive_step_target(device="cuda", *, state_spec=None,
                               donate_argnums=()) -> StepTarget:
    """The deliberately naive GPT step at dp 2 x tp 2: autofix's proof
    target (arXiv:2004.13336's baseline), as JAX's.

    The optimizer state follows the ZeRO flat-buffer convention (one
    padded fp32 buffer each for Adam's m and v, laid out by
    ``flatten_pytree``). At the default spec (``state_spec=None``) the
    buffers are whole on every dp rank and the update runs there: a full
    gradient all-reduce, a full Adam (``adam_flat``), a parameter resync
    all-reduce, and the new m and v are fresh tensors (nothing is
    declared in place). The auditors flag it: ``sharding.replicated-*``
    on m and v, ``donation.missed`` on m and v.

    With ``state_spec=("dp",)``, what the derivation prescribes, the same
    builder composes ZeRO-2: m and v are this dp rank's shards, the
    gradient is reduce-scattered, Adam runs on the local shard and the
    updated shard is all-gathered (the gather is the resync). With
    ``donate_argnums=(1, 2)`` m and v are updated in place. The predicted
    dp-axis weight-update wire bytes drop by the dp factor (JAX's
    524,292 -> 262,148 B at this config).
    """
    from apex_tpu_torch._kernels import resolve_device
    from apex_tpu_torch.models.gpt import GPTModel, gpt_loss_fn
    from apex_tpu_torch.ops.multi_tensor import (
        flatten_pytree,
        unflatten_pytree,
    )
    from apex_tpu_torch.parallel import parallel_state as ps

    dev = resolve_device(device)
    ps.initialize_model_parallel(tensor_model_parallel_size=2)
    spec = tuple(state_spec or ())
    sharded = bool(spec)
    dp = ps.get_data_parallel_world_size()
    donate = tuple(donate_argnums or ())
    model = GPTModel(tiny_config(), device=dev, seed=0)
    params = dict(model.named_parameters())
    flat, _ = flatten_pytree(params, dtype=torch.float32)
    if flat.numel() % dp:
        raise ValueError(f"flat buffer length {flat.numel()} is not "
                         f"divisible by dp={dp}")
    n = flat.numel() // dp if sharded else flat.numel()
    m = torch.zeros(n, dtype=torch.float32, device=dev)
    v = torch.zeros(n, dtype=torch.float32, device=dev)
    b, s = 2, _TINY["max_position_embeddings"]
    tokens = torch.zeros((b, s), dtype=torch.long, device=dev)

    def gpt_zero_naive_train_step(params, m, v, tokens, labels):
        group = ps.get_data_parallel_group()
        rank = ps.get_data_parallel_rank()
        rows = slice(rank * (b // dp), (rank + 1) * (b // dp))
        for p in params.values():
            p.grad = None
        loss = gpt_loss_fn(model(tokens[rows], labels=labels[rows]))
        loss.backward()
        with torch.no_grad():
            gflat, _ = flatten_pytree({k: p.grad for k, p in params.items()},
                                      dtype=torch.float32)
            pflat, pspec = flatten_pytree(params, dtype=torch.float32)
            if sharded:
                # ZeRO-2: the reduce-scatter is the gradient sync, the
                # update touches 1/dp of the state, the all-gather is
                # the resync
                gshard = ps.reduce_scatter(gflat, group) / dp
                pshard = pflat[rank * n:(rank + 1) * n]
                new_p, new_m, new_v = _flat_adam(pshard, m, v, gshard)
                new_pflat = ps.all_gather(new_p, group)
            else:
                # the seeded anti-pattern: a full-payload all-reduce, a
                # replicated full-buffer update and a full resync
                gmean = ps.all_reduce(gflat, group) / dp
                new_pflat, new_m, new_v = _flat_adam(pflat, m, v, gmean)
                new_pflat = ps.all_reduce(new_pflat, group) / dp
            for k, t in unflatten_pytree(new_pflat, pspec).items():
                params[k].copy_(t)
            if 1 in donate:
                new_m = m.copy_(new_m)
            if 2 in donate:
                new_v = v.copy_(new_v)
            loss = ps.all_reduce(loss.detach().float(), group) / dp
        return params, new_m, new_v, loss

    return StepTarget(
        name="gpt-zero-naive", fn=gpt_zero_naive_train_step,
        args=(params, m, v, tokens, tokens), axes=layout_axes(), device=dev,
        donate_argnums=donate,
        # the tiny config's flat buffers are 256 KiB, under the auditors'
        # 1 MiB floors: the target's floors keep the seeded defects
        # visible without a big model (JAX's)
        sharding_min_bytes=1 << 16, donation_min_bytes=1 << 16,
        builder=gpt_zero_naive_step_target,
        build_overrides={"state_spec": spec or None,
                         "donate_argnums": donate},
        spec_slots={1: "state_spec", 2: "state_spec"},
        donate_slot="donate_argnums")


#: step builders the autofix applier may rebuild with injected specs
#: (``python -m apex_tpu_torch.analysis --fix`` iterates exactly these)
FIXABLE_TARGETS = {
    "gpt-zero-naive": gpt_zero_naive_step_target,
}


#: the CLI's targets by its ``--target`` names, in audit order
TARGETS = {
    "gpt": gpt_step_target,
    "gpt-compressed": gpt_compressed_step_target,
    "bert": bert_step_target,
    "gpt-pp": gpt_pp_step_target,
}


def all_targets(device="cuda") -> List[StepTarget]:
    return [build(device) for build in TARGETS.values()]
