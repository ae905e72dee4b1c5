"""Standalone pipelined GPT pre-training driven by the Megatron argument
system (counterpart of apex_tpu/transformer/testing/standalone_gpt.py).

``run_gpt`` builds the process groups with
``initialize_model_parallel(tp, pp, virtual)``, splits GPT with
``build_gpt_pipeline`` (the embedding on the first stage, ``num_layers /
pp`` layers a stage, the final norm, an untied head and the token-mean
loss on the last) and trains it with ``forward_backward_with_pre_post``
(1F1B; as in JAX, the schedule is called without ``num_model_chunks``,
so a virtual pipeline size reaches the process state only), the
data-parallel gradient all-reduce and ``fused_adam``. As in JAX, the
number of micro-batches ``global / (micro x dp)`` is rounded up to a
multiple of pp, the vocabulary is ``--make-vocab-size-divisible-by``
unless ``args.padded_vocab_size`` is set, the tokens are random from
``--seed`` (here a ``torch.Generator``'s, not ``jax.random``'s) with
the labels the tokens shifted by one, the head is drawn at JAX's std
0.05 (``models.gpt_pipeline.HEAD_STD``), and under sequence parallelism
the reported loss is summed over tp (each tp rank's is its shard's mean
over tp), then averaged over dp. Each step logs ``iteration N | lm loss
X``; then one JSON line gives the layout, the step times, tokens/s,
every rank's peak memory, the kernel launch counts of the first and the
last stage, and what ``parallel_state.STAGED`` counted on rank 0.

Run under ``torch.distributed.run`` (gloo where NCCL cannot run, such as
several ranks on one card; rank 0 prints):

    python -m torch.distributed.run --standalone --nproc_per_node 4 \\
        -m apex_tpu_torch.transformer.testing.standalone_gpt \\
        --num-layers 12 --hidden-size 768 --num-attention-heads 12 \\
        --seq-length 1024 --max-position-embeddings 1024 \\
        --make-vocab-size-divisible-by 50304 --bf16 \\
        --pipeline-model-parallel-size 2 --tensor-model-parallel-size 2 \\
        --sequence-parallel --micro-batch-size 4 --global-batch-size 16 \\
        --train-iters 4 --distributed-backend gloo

``--profile-steps N`` profiles N more steps under ``torch.profiler`` on
the card and prints rank 0's device time by kernel as one more JSON line.
"""

import dataclasses
import json
import os
import sys
import time

import torch
import torch.distributed as dist

from apex_tpu_torch import _kernels
from apex_tpu_torch._kernels import resolve_device
from apex_tpu_torch.models.gpt import init_params
from apex_tpu_torch.models.gpt_pipeline import build_gpt_pipeline
from apex_tpu_torch.optimizers import fused_adam
from apex_tpu_torch.parallel import parallel_state as ps
from apex_tpu_torch.parallel.ddp import all_reduce_gradients
from apex_tpu_torch.parallel.pipeline import (
    forward_backward_with_pre_post,
    forward_backward_zero_bubble_with_pre_post,
)
from apex_tpu_torch.resilience.elastic.layout import mark_pipeline_stage
from apex_tpu_torch.transformer.config import TransformerConfig
from apex_tpu_torch.transformer.layer import sequence_parallel
from apex_tpu_torch.transformer.testing import global_vars
from apex_tpu_torch.transformer.testing.arguments import (
    parse_args,
    transformer_config_from_args,
)

__all__ = ["GPTPipelineTraining", "gpt_config_from_args", "main", "run_gpt",
           "train"]


def gpt_config_from_args(args) -> TransformerConfig:
    """``transformer_config_from_args`` with dropout off, as the reference
    tests run (and the standalone BERT with them)."""
    return dataclasses.replace(transformer_config_from_args(args),
                               hidden_dropout=0.0, attention_dropout=0.0)


def _flat(tree, prefix=""):
    """``{"pre": {name: t}, ...}`` as ``{"pre.name": t, ...}``."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}.{k}" if prefix else k))
    return out


class GPTPipelineTraining:
    """``run_gpt``'s process groups, model, optimizer and data, built from
    ``args`` on ``device``: ``params`` is ``{"pre", "stages", "post"}``
    (this rank's), ``tokens`` and ``labels`` are this dp rank's
    ``(steps, M, micro_batch, seq)``; :meth:`load` takes weights from
    elsewhere (the JAX run's), :meth:`step` trains on batch ``i``.

    ``num_model_chunks`` V > 1 runs the interleaved schedule over V
    chunks of ``num_layers / (pp V)`` layers a rank, their parameters
    stacked on a leading V dim (JAX's ``run_gpt`` passes no chunks; this
    is the ``forward_backward_with_pre_post(num_model_chunks=V)`` route).
    ``zero_bubble`` trains through ``forward_backward_zero_bubble_with_
    pre_post`` (the B/W split) instead of 1F1B. ``remat`` is the
    schedules' (JAX's default, True: each stage forward recomputed in its
    backward).
    The weights are drawn from ``--seed`` as ``GPTModel``'s are, chunk v
    of pp rank p (global stage ``v pp + p``) from its own seed, and the
    head at JAX's std (``build_gpt_pipeline``'s ``init_post``)."""

    def __init__(self, args, device="cuda", num_model_chunks: int = 1,
                 zero_bubble: bool = False, remat: bool = True):
        if zero_bubble and num_model_chunks > 1:
            raise ValueError("zero_bubble has no interleaved variant")
        self.zero_bubble, self.remat = zero_bubble, remat
        self.device = device = resolve_device(device)
        self.tp = tp = args.tensor_model_parallel_size
        self.pp = pp = args.pipeline_model_parallel_size
        self.virtual = args.virtual_pipeline_model_parallel_size
        self.num_model_chunks = V = num_model_chunks
        ps.initialize_model_parallel(tp, pp, self.virtual)
        self.dp = dp = ps.get_data_parallel_world_size()
        self.config = cfg = gpt_config_from_args(args)
        seq, mb = args.seq_length, args.micro_batch_size
        num_micro = args.global_batch_size // (mb * dp)
        if num_micro < 1:
            raise ValueError("global batch too small for micro batch x dp")
        if pp > 1 and num_micro % pp != 0:
            num_micro = -(-num_micro // pp) * pp  # JAX rounds up
        self.num_micro, self.micro_batch, self.seq = num_micro, mb, seq
        self.steps = args.train_iters or 3

        self.parts = parts = build_gpt_pipeline(cfg, pp * V, device)
        init_params(parts.embed, args.seed)  # the same on every stage
        p = ps.get_pipeline_model_parallel_rank()
        chunks = []
        for v in range(V):  # chunk v is global stage v * pp + p
            init_params(parts.chunk, args.seed + 7919 * (v * pp + p + 1))
            chunks.append({n: t.detach().clone()
                           for n, t in parts.chunk.named_parameters()})
        stages = dict(parts.chunk.named_parameters()) if V == 1 else {
            n: torch.stack([c[n] for c in chunks]).requires_grad_()
            for n in chunks[0]}
        # a checkpoint stacks the pp ranks' stages on a leading axis
        mark_pipeline_stage(stages.values())
        post = parts.init_post(args.seed + 9)
        for t in post.values():
            t.requires_grad_(True)
        self.params = {"pre": dict(parts.embed.named_parameters()),
                       "stages": stages, "post": post}
        gen = torch.Generator().manual_seed(args.seed)
        tokens = torch.randint(0, cfg.vocab_size,
                               (self.steps, num_micro, mb * dp, seq),
                               generator=gen)
        d = ps.get_data_parallel_rank()
        self.set_data(tokens[:, :, d * mb:(d + 1) * mb])
        self.opt = fused_adam(lr=args.lr or 1e-3,
                              betas=(args.adam_beta1, args.adam_beta2),
                              eps=args.adam_eps,
                              weight_decay=args.weight_decay)
        self.opt_state = self.opt.init(_flat(self.params))
        s_local = seq // tp if sequence_parallel(cfg) else seq
        self.tensor_shape = (s_local, mb, cfg.hidden_size)

    def state(self):
        """``(params, opt_state)``: the state a checkpoint, a snapshot or a
        fingerprint takes, the live tensors (``params`` by flat name, so a
        leaf's path reads ``[0]['stages']['layer_0']...``, the JAX
        package's global tree with its ``pp``-stacked ``stages``;
        ``elastic.layout``). Take it anew after each step: the optimizer
        returns new moments."""
        return (_flat(self.params), self.opt_state)

    def set_data(self, tokens) -> None:
        """Trains on ``tokens`` (steps, M, micro_batch, seq), labels the
        tokens shifted by one (JAX's ``roll``)."""
        tokens = torch.as_tensor(tokens).long()
        self.tokens = tokens.to(self.device)
        self.labels = torch.roll(tokens, -1, dims=3).to(self.device)

    @torch.no_grad()
    def load(self, params) -> None:
        """Copies ``{"pre", "stages", "post"}`` of name: array (e.g.
        ``gpt_pipeline_params_from_jax``'s) into the parameters and
        restarts the optimizer."""
        for part, named in self.params.items():
            for name, t in named.items():
                t.copy_(torch.as_tensor(params[part][name]))
        self.opt_state = self.opt.init(_flat(self.params))

    def _sync(self, grads):
        """The dp mean of the gradients, one all-reduce per dtype."""
        flat = all_reduce_gradients(_flat(grads))
        return {part: {n: flat[f"{part}.{n}"] for n in named}
                for part, named in grads.items()}

    def step(self, i: int, return_grads: bool = False):
        """Trains on batch ``i``; returns the reported loss (tp sum under
        sequence parallelism, dp mean), and with ``return_grads`` the
        step's synced gradients by flat name too."""
        parts, cfg = self.parts, self.config
        kw = dict(axis_name="pp", remat=self.remat,
                  grad_sync_fn=self._sync if self.dp > 1 else None,
                  tensor_shape=self.tensor_shape, dtype=cfg.compute_dtype)
        if self.zero_bubble:
            schedule = forward_backward_zero_bubble_with_pre_post
        else:
            schedule = forward_backward_with_pre_post
            kw["num_model_chunks"] = self.num_model_chunks
        loss, _, grads = schedule(
            parts.pre_fn, parts.stage_fn, parts.post_loss_fn, self.params,
            self.tokens[i], self.labels[i], **kw)
        flat = _flat(self.params)
        updates, self.opt_state = self.opt.update(_flat(grads),
                                                  self.opt_state, flat)
        with torch.no_grad():
            for name, p in flat.items():
                p.add_(updates[name])
        if sequence_parallel(cfg):
            loss = ps.all_reduce(loss, ps.get_tensor_model_parallel_group())
        loss = float(ps.all_reduce(loss, ps.get_data_parallel_group())
                     / self.dp)
        return (loss, _flat(grads)) if return_grads else loss


def _gather(obj):
    """Every rank's ``obj``, by rank (a list of one without a world)."""
    if not dist.is_initialized():
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def train(run: GPTPipelineTraining, log=print, profile_steps: int = 0):
    """Trains ``run`` for its steps, logging each step's loss, then the
    closing JSON line (every rank of the world takes part in it), and,
    with ``profile_steps`` on the card, that many more steps' profile.
    Returns ``(losses, the closing line's fields)``."""
    cuda = run.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        _kernels.build_all()
        torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    staged0 = dict(ps.STAGED)
    losses, step_ms = [], []
    for i in range(run.steps):
        t0 = time.perf_counter()
        loss = run.step(i)
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        log(f"iteration {i:4d} | lm loss {loss:.4f}")
        losses.append(loss)
    pp_rank = ps.get_pipeline_model_parallel_rank()
    mine = dict(
        pp_rank=pp_rank, launches=_kernels.launch_counts(),
        peak_mem_gb=(torch.cuda.max_memory_allocated(run.device) / 1e9
                     if cuda else None),
        staged={k: n - staged0[k] for k, n in ps.STAGED.items()})
    ranks = _gather(mine)
    tokens_per_step = run.num_micro * run.micro_batch * run.dp * run.seq
    measured = step_ms[1:] or step_ms
    mean_ms = sum(measured) / len(measured)
    summary = {
        "world": len(ranks), "tp": run.tp, "pp": run.pp, "dp": run.dp,
        "virtual": run.virtual, "num_model_chunks": run.num_model_chunks,
        "schedule": ("zero_bubble" if run.zero_bubble else "interleaved"
                     if run.num_model_chunks > 1 else "1f1b"),
        "num_micro": run.num_micro,
        "sequence_parallel": sequence_parallel(run.config),
        "backend": dist.get_backend() if dist.is_initialized() else None,
        "steps": run.steps, "losses": losses, "step_ms": step_ms,
        "step_ms_mean_after_first": mean_ms,
        "tokens_per_step": tokens_per_step,
        "tokens_per_s": tokens_per_step / mean_ms * 1e3,
        "peak_mem_gb_by_rank": [r["peak_mem_gb"] for r in ranks],
        "launch_counts_first_stage": ranks[0]["launches"],
        "launch_counts_last_stage": next(
            r["launches"] for r in ranks if r["pp_rank"] == run.pp - 1),
        "staged_rank0": ranks[0]["staged"]}
    log(json.dumps(summary))
    if profile_steps > 0:
        from apex_tpu_torch.utils.profiling import profile_device

        def steps():
            for j in range(profile_steps):
                run.step(j % run.steps)
        report = profile_device(steps) if cuda else None
        if report is not None:
            log(json.dumps({"profile_steps": profile_steps,
                            "tokens_per_step": tokens_per_step, **report}))
    return losses, summary


def run_gpt(args=None, log=print, device="cuda", profile_steps: int = 0):
    """Builds the groups and model from ``args`` (the global args when
    None), trains ``--train-iters`` steps (3 when unset) with
    :func:`train` and returns the losses. The groups are destroyed at the
    end, as in JAX."""
    if args is None:
        args = global_vars.get_args()
    losses, _ = train(GPTPipelineTraining(args, device), log, profile_steps)
    ps.destroy_model_parallel()
    return losses


def _extra_args(parser):
    """The launcher's own flags: the backend (Megatron's name; NCCL by
    default, gloo where NCCL cannot run) and the profile."""
    parser.add_argument("--distributed-backend", default="nccl",
                        choices=["nccl", "gloo"])
    parser.add_argument("--profile-steps", type=int, default=0,
                        help="after the run, profile this many more steps "
                             "on the card")
    return parser


def main(argv=None):
    """Under ``torch.distributed.run`` (``WORLD_SIZE`` set) every process
    is one rank of a ``--distributed-backend`` world; only rank 0 logs."""
    args = parse_args(extra_args_provider=_extra_args, args=argv)
    distributed = "WORLD_SIZE" in os.environ
    if distributed:
        backend = args.distributed_backend
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0))
                                  % torch.cuda.device_count())
        dist.init_process_group(backend)
    try:
        rank0 = not distributed or dist.get_rank() == 0
        return run_gpt(args, log=print if rank0 else (lambda *a: None),
                       profile_steps=args.profile_steps)
    finally:
        if distributed:
            dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
