"""Standalone BERT pre-training driven by the Megatron argument system
(counterpart of apex_tpu/transformer/testing/standalone_bert.py).

``BertModel`` (LM head and, unless ``--bert-no-binary-head``, the binary
head) trained on the mean LM loss of seeded random tokens and labels,
through ``forward_backward_no_pipelining`` over the micro-batches and
the port's ``fused_adam`` (the Adam kernel once per parameter tensor).
The port runs at dp = tp = 1: a tensor, pipeline or data-parallel size
above 1 raises ``NotImplementedError``. Dropout is off, as in the
reference's tests (``gpt_config_from_args``). The vocabulary is
``args.padded_vocab_size`` when set (a caller with a real tokenizer sets
it, as Megatron's tokenizer step does), else
``--make-vocab-size-divisible-by``.

Run on the card:

    python -m apex_tpu_torch.transformer.testing.standalone_bert \
        --num-layers 2 --hidden-size 64 --num-attention-heads 4 \
        --seq-length 32 --max-position-embeddings 32 \
        --micro-batch-size 2 --global-batch-size 4 --train-iters 3 --bf16
"""

import sys

import torch

from apex_tpu_torch._kernels import resolve_device
from apex_tpu_torch.models.bert import BertModel
from apex_tpu_torch.optimizers import fused_adam
from apex_tpu_torch.parallel.pipeline import forward_backward_no_pipelining
from apex_tpu_torch.transformer.testing import global_vars
from apex_tpu_torch.transformer.testing.arguments import parse_args
from apex_tpu_torch.transformer.testing.standalone_gpt import (
    gpt_config_from_args,
)

__all__ = ["BertPretraining", "bert_train_step", "main", "run_bert"]


def bert_train_step(model, opt, opt_state, tokens, labels):
    """One step on (num_micro, micro_batch, seq) tokens and labels: the
    mean LM loss of each micro-batch, gradients averaged over them by
    ``forward_backward_no_pipelining``, then ``opt``'s update added to
    the parameters in place. Returns ``(mean_loss, opt_state, grads)``."""
    params = dict(model.named_parameters())

    def fwd(_, batch):
        toks, labs = batch
        lm_loss, _ = model(toks, lm_labels=labs)
        return lm_loss.mean()

    loss, _, grads = forward_backward_no_pipelining(fwd, params,
                                                    (tokens, labels))
    updates, opt_state = opt.update(grads, opt_state, params)
    with torch.no_grad():
        for name, p in params.items():
            p.add_(updates[name])
    return loss, opt_state, grads


class BertPretraining:
    """The standalone BERT's model, optimizer and data, built from
    ``args`` on ``device``: ``steps`` batches of tokens and labels, each
    (num_micro, micro_batch, seq), drawn from a ``torch.Generator`` seeded
    by ``args.seed``; :meth:`step` trains on batch ``i``."""

    def __init__(self, args, device="cuda"):
        for flag, size in (
                ("--pipeline-model-parallel-size",
                 args.pipeline_model_parallel_size),
                ("--tensor-model-parallel-size",
                 args.tensor_model_parallel_size),
                ("data-parallel size", args.data_parallel_size)):
            if size > 1:
                raise NotImplementedError(
                    f"{flag} {size}: the port's standalone BERT runs at "
                    f"dp = tp = pp = 1")
        device = resolve_device(device)
        self.config = cfg = gpt_config_from_args(args)
        self.model = BertModel(cfg, add_binary_head=args.bert_binary_head,
                               device=device, seed=args.seed)
        seq, mb = args.seq_length, args.micro_batch_size
        num_micro = max(1, args.global_batch_size // mb)
        self.steps = args.train_iters or 3
        gen = torch.Generator().manual_seed(args.seed)
        shape = (self.steps, num_micro, mb, seq)
        self.tokens = torch.randint(0, cfg.vocab_size, shape,
                                    generator=gen).to(device)
        self.labels = torch.randint(0, cfg.vocab_size, shape,
                                    generator=gen).to(device)
        self.opt = fused_adam(lr=args.lr or 1e-3,
                              betas=(args.adam_beta1, args.adam_beta2),
                              eps=args.adam_eps,
                              weight_decay=args.weight_decay)
        self.opt_state = self.opt.init(dict(self.model.named_parameters()))

    def step(self, i: int):
        """Trains on batch ``i``; returns ``(mean_loss, grads)``, the loss
        a 0-d tensor on the device."""
        loss, self.opt_state, grads = bert_train_step(
            self.model, self.opt, self.opt_state, self.tokens[i],
            self.labels[i])
        return loss, grads


def run_bert(args=None, log=print, device="cuda"):
    """Builds the model from ``args`` (the global args when None), trains
    ``--train-iters`` steps (3 when unset) and returns the losses."""
    if args is None:
        args = global_vars.get_args()
    run = BertPretraining(args, device)
    losses = []
    for i in range(run.steps):
        loss = float(run.step(i)[0])
        log(f"iteration {i:4d} | lm loss {loss:.4f}")
        losses.append(loss)
    return losses


def main(argv=None):
    args = parse_args(args=argv)
    return run_bert(args)


if __name__ == "__main__":
    main(sys.argv[1:])
