"""Standalone BERT pre-training driven by the Megatron argument system
(counterpart of apex_tpu/transformer/testing/standalone_bert.py).

``BertModel`` (LM head and, unless ``--bert-no-binary-head``, the binary
head) trained on the mean LM loss of seeded random tokens and labels,
through ``forward_backward_no_pipelining`` over the micro-batches, the
data-parallel gradient all-reduce (``all_reduce_gradients``) and the
port's ``fused_adam`` (the Adam kernel once per parameter tensor), over
dp x tp: ``--tensor-model-parallel-size`` over the initialized
``torch.distributed`` world, dp the rest of it (a world of one without
it). The batches are (steps, num_micro, micro_batch x dp, seq), ``num_micro
= global_batch // (micro_batch x dp)``, the same on every rank, each rank
taking its dp columns; the logged loss is the dp mean. A pipeline size
above 1 raises JAX's ``NotImplementedError``. Dropout is off, as in the
reference's tests (``gpt_config_from_args``). The vocabulary is
``args.padded_vocab_size`` when set (a caller with a real tokenizer sets
it, as Megatron's tokenizer step does), else
``--make-vocab-size-divisible-by``.

Run on the card, and at tp 2 x dp 2 over gloo:

    python -m apex_tpu_torch.transformer.testing.standalone_bert \\
        --num-layers 2 --hidden-size 64 --num-attention-heads 4 \\
        --seq-length 32 --max-position-embeddings 32 \\
        --micro-batch-size 2 --global-batch-size 4 --train-iters 3 --bf16
    python -m torch.distributed.run --standalone --nproc_per_node 4 \\
        -m apex_tpu_torch.transformer.testing.standalone_bert \\
        --tensor-model-parallel-size 2 --sequence-parallel \\
        --distributed-backend gloo ...
"""

import json
import os
import sys
import time

import torch
import torch.distributed as dist

from apex_tpu_torch import _kernels
from apex_tpu_torch._kernels import resolve_device
from apex_tpu_torch.models.bert import BertModel
from apex_tpu_torch.optimizers import fused_adam
from apex_tpu_torch.parallel import parallel_state as ps
from apex_tpu_torch.parallel.ddp import all_reduce_gradients
from apex_tpu_torch.parallel.pipeline import forward_backward_no_pipelining
from apex_tpu_torch.transformer.layer import sequence_parallel
from apex_tpu_torch.transformer.testing import global_vars
from apex_tpu_torch.transformer.testing.arguments import parse_args
from apex_tpu_torch.transformer.testing.standalone_gpt import (
    _extra_args,
    _gather,
    gpt_config_from_args,
)

__all__ = ["BertPretraining", "bert_train_step", "main", "run_bert",
           "train"]


def bert_train_step(model, opt, opt_state, tokens, labels):
    """One step on (num_micro, micro_batch, seq) tokens and labels: the
    mean LM loss of each micro-batch, gradients averaged over them by
    ``forward_backward_no_pipelining`` and over the data-parallel group,
    then ``opt``'s update added to the parameters in place. Returns
    ``(mean_loss, opt_state, grads)``, the loss this rank's."""
    params = dict(model.named_parameters())

    def fwd(_, batch):
        toks, labs = batch
        lm_loss, _ = model(toks, lm_labels=labs)
        return lm_loss.mean()

    sync = (all_reduce_gradients
            if ps.get_data_parallel_world_size() > 1 else None)
    loss, _, grads = forward_backward_no_pipelining(
        fwd, params, (tokens, labels), grad_sync_fn=sync)
    updates, opt_state = opt.update(grads, opt_state, params)
    with torch.no_grad():
        for name, p in params.items():
            p.add_(updates[name])
    return loss, opt_state, grads


class BertPretraining:
    """The standalone BERT's groups, model, optimizer and data, built from
    ``args`` on ``device``: ``steps`` batches of tokens and labels, each
    (num_micro, micro_batch x dp, seq), drawn from a ``torch.Generator``
    seeded by ``args.seed``, of which this rank keeps its dp columns;
    :meth:`step` trains on batch ``i``."""

    def __init__(self, args, device="cuda"):
        if args.pipeline_model_parallel_size > 1:
            raise NotImplementedError(
                "standalone_bert covers the dp x tp configuration; "
                "pipelined runs follow standalone_gpt's layout")
        self.device = device = resolve_device(device)
        self.tp = args.tensor_model_parallel_size
        ps.initialize_model_parallel(self.tp)
        self.dp = dp = ps.get_data_parallel_world_size()
        self.config = cfg = gpt_config_from_args(args)
        self.model = BertModel(cfg, add_binary_head=args.bert_binary_head,
                               device=device, seed=args.seed)
        seq, mb = args.seq_length, args.micro_batch_size
        self.num_micro = max(1, args.global_batch_size // (mb * dp))
        self.micro_batch, self.seq = mb, seq
        self.steps = args.train_iters or 3
        gen = torch.Generator().manual_seed(args.seed)
        shape = (self.steps, self.num_micro, mb * dp, seq)
        tokens = torch.randint(0, cfg.vocab_size, shape, generator=gen)
        labels = torch.randint(0, cfg.vocab_size, shape, generator=gen)
        self.set_data(tokens, labels)
        self.opt = fused_adam(lr=args.lr or 1e-3,
                              betas=(args.adam_beta1, args.adam_beta2),
                              eps=args.adam_eps,
                              weight_decay=args.weight_decay)
        self.opt_state = self.opt.init(dict(self.model.named_parameters()))

    def set_data(self, tokens, labels) -> None:
        """Trains on (steps, num_micro, micro_batch x dp, seq) ``tokens``
        and ``labels``, the whole world's; this rank keeps its columns."""
        d, mb = ps.get_data_parallel_rank(), self.micro_batch
        cols = slice(d * mb, (d + 1) * mb)
        self.tokens = torch.as_tensor(tokens)[:, :, cols].long().to(
            self.device)
        self.labels = torch.as_tensor(labels)[:, :, cols].long().to(
            self.device)

    def step(self, i: int):
        """Trains on batch ``i``; returns ``(dp mean loss, grads)``, the
        loss a 0-d tensor on the device, the gradients the dp mean."""
        loss, self.opt_state, grads = bert_train_step(
            self.model, self.opt, self.opt_state, self.tokens[i],
            self.labels[i])
        loss = ps.all_reduce(loss, ps.get_data_parallel_group()) / self.dp
        return loss, grads


def train(run: BertPretraining, log=print):
    """Trains ``run`` for its steps, logging each step's loss, then one
    closing JSON line (every rank of the world takes part in it): the
    layout, losses, step ms, peak memory by rank, rank 0's launch counts
    and staged collectives, and whether every parameter of every rank got
    a finite gradient in the first step, with the parameters' elements
    summed over the tp ranks. Returns ``(losses, the closing line)``."""
    cuda = run.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    staged0 = dict(ps.STAGED)
    losses, step_ms, finite = [], [], True
    for i in range(run.steps):
        t0 = time.perf_counter()
        loss, grads = run.step(i)
        loss = float(loss)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            finite = all(bool(torch.isfinite(g).all())
                         for g in grads.values())
        del grads
        log(f"iteration {i:4d} | lm loss {loss:.4f}")
        losses.append(loss)
    params = list(run.model.parameters())
    mine = dict(
        launches=_kernels.launch_counts(), finite=finite,
        sharded=sum(p.numel() for p in params
                    if getattr(p, "tensor_model_parallel", False)),
        replicated=sum(p.numel() for p in params
                       if not getattr(p, "tensor_model_parallel", False)),
        tensors=len(params),
        tp_rank=ps.get_tensor_model_parallel_rank(),
        dp_rank=ps.get_data_parallel_rank(),
        peak_mem_gb=(torch.cuda.max_memory_allocated(run.device) / 1e9
                     if cuda else None),
        staged={k: n - staged0[k] for k, n in ps.STAGED.items()})
    ranks = _gather(mine)
    tokens_per_step = run.num_micro * run.micro_batch * run.dp * run.seq
    measured = step_ms[1:] or step_ms
    mean_ms = sum(measured) / len(measured)
    summary = {
        "world": len(ranks), "tp": run.tp, "dp": run.dp,
        "sequence_parallel": sequence_parallel(run.config),
        "num_micro": run.num_micro, "steps": run.steps, "losses": losses,
        "step_ms": step_ms, "step_ms_mean_after_first": mean_ms,
        "tokens_per_step": tokens_per_step,
        "tokens_per_s": tokens_per_step / mean_ms * 1e3,
        "finite_grads_every_rank": all(r["finite"] for r in ranks),
        # the model's elements: the tp shards of dp rank 0's tp group
        # summed, and the replicated parameters once
        "elements_over_tp": ranks[0]["replicated"] + sum(
            r["sharded"] for r in ranks if r["dp_rank"] == 0),
        "tensors_a_rank": ranks[0]["tensors"],
        "peak_mem_gb_by_rank": [r["peak_mem_gb"] for r in ranks],
        "launch_counts_rank0": ranks[0]["launches"],
        "staged_rank0": ranks[0]["staged"]}
    log(json.dumps(summary))
    return losses, summary


def run_bert(args=None, log=print, device="cuda"):
    """Builds the groups and the model from ``args`` (the global args when
    None), trains ``--train-iters`` steps (3 when unset) and returns the
    dp-mean losses. The groups are destroyed at the end, as in JAX."""
    if args is None:
        args = global_vars.get_args()
    run = BertPretraining(args, device)
    try:
        losses = []
        for i in range(run.steps):
            loss = float(run.step(i)[0])
            log(f"iteration {i:4d} | lm loss {loss:.4f}")
            losses.append(loss)
    finally:
        ps.destroy_model_parallel()
    return losses


def main(argv=None):
    """Under ``torch.distributed.run`` (``WORLD_SIZE`` set) every process
    is one rank of a ``--distributed-backend`` world, trained by
    :func:`train`; only rank 0 logs."""
    args = parse_args(extra_args_provider=_extra_args, args=argv)
    distributed = "WORLD_SIZE" in os.environ
    if distributed:
        if args.distributed_backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0))
                                  % torch.cuda.device_count())
        dist.init_process_group(args.distributed_backend)
    try:
        rank0 = not distributed or dist.get_rank() == 0
        run = BertPretraining(args)
        if run.device.type == "cuda":
            _kernels.build_all()
        losses, _ = train(run, log=print if rank0 else (lambda *a: None))
        ps.destroy_model_parallel()
        return losses
    finally:
        if distributed:
            dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
