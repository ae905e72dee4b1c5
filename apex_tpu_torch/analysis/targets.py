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
``fn`` runs one step. JAX's ``gpt_zero_naive_step_target`` is autofix's
and waits with it (ROADMAP item 9c).
"""

from typing import Dict, List

import torch

from apex_tpu_torch.analysis.passes import StepTarget

__all__ = [
    "all_targets",
    "bert_step_target",
    "gpt_compressed_step_target",
    "gpt_pp_step_target",
    "gpt_step_target",
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
        axes=layout_axes(), device=training.device)


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


#: the CLI's targets by its ``--target`` names, in audit order
TARGETS = {
    "gpt": gpt_step_target,
    "gpt-compressed": gpt_compressed_step_target,
    "bert": bert_step_target,
    "gpt-pp": gpt_pp_step_target,
}


def all_targets(device="cuda") -> List[StepTarget]:
    return [build(device) for build in TARGETS.values()]
