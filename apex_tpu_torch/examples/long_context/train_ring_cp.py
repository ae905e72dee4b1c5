"""Long-context training with ring context parallelism, GQA and padding
(the port of the JAX package's examples/long_context/train_ring_cp.py).

A GPT whose sequence is split over the cp group: each rank holds seq/cp
tokens of every sequence, attention is ``ring_attention`` with the
grouped K/V travelling the ring, and ragged documents are padded out by
a key-padding mask whose chunks travel with their keys. The data are
the JAX example's, from ``--seed`` with numpy: a markov-ish token
stream, document lengths in ``[--doc-len-min, --seq-len]``, labels the
tokens shifted by one, the loss mask the unpadded tokens. The step is
the JAX example's: ``n``, the real tokens summed over cp, is taken
outside autograd; each rank's loss is its chunk's token-loss sum / n;
the gradients are summed over cp (``all_reduce_gradients(...,
gradient_average=False)``), so every rank's parameters stay the same;
``fused_adam`` updates them. Each step prints the loss summed over cp
and the step time.

A world of ``--cp`` gloo ranks, spawned by the script:

    python -m apex_tpu_torch.examples.long_context.train_ring_cp --steps 10
    python -m apex_tpu_torch.examples.long_context.train_ring_cp \\
        --device cpu --steps 10

or under ``torch.distributed.run`` (``--nproc_per_node`` = ``--cp``):

    python -m torch.distributed.run --standalone --nproc_per_node 4 \\
        -m apex_tpu_torch.examples.long_context.train_ring_cp --steps 10

The ranks run on the card (all on the one card over gloo, every ring
message staged through host memory) unless ``--device cpu``.
:class:`RingCPTraining` is the step, so other programs (``chip_smoke.py``)
run it on a config of their own, Ulysses attention included.
"""

import argparse
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from apex_tpu_torch import _kernels
from apex_tpu_torch.models.gpt import GPTModel
from apex_tpu_torch.optimizers import fused_adam
from apex_tpu_torch.parallel import parallel_state as ps
from apex_tpu_torch.parallel.ddp import all_reduce_gradients
from apex_tpu_torch.transformer import TransformerConfig

__all__ = ["RingCPTraining", "example_config", "make_batch", "main",
           "parse_args", "train"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ring-CP long-context training")
    p.add_argument("--cp", type=int, default=4)
    p.add_argument("--vocab", type=int, default=256)
    p.add_argument("--seq-len", type=int, default=256,
                   help="GLOBAL sequence length (sharded seq/cp per rank)")
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--kv-heads", type=int, default=2,
                   help="GQA: the ring rotates only these")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--doc-len-min", type=int, default=128,
                   help="ragged docs: tokens beyond each doc's length are "
                        "padded out via the key-padding mask")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def example_config(args, **overrides) -> TransformerConfig:
    """The JAX example's config: learned positions, LayerNorm, GELU, no
    dropout, fp32 compute, ring attention."""
    kw = dict(num_layers=args.layers, hidden_size=args.hidden,
              num_attention_heads=args.heads, num_query_groups=args.kv_heads,
              vocab_size=args.vocab, max_position_embeddings=args.seq_len,
              hidden_dropout=0.0, attention_dropout=0.0,
              compute_dtype=torch.float32, context_parallel_mode="ring")
    kw.update(overrides)
    return TransformerConfig(**kw)


def make_batch(batch: int, seq_len: int, vocab: int, doc_len_min: int,
               seed: int) -> Dict[str, np.ndarray]:
    """The JAX example's global batch, drawn with numpy from ``seed``:
    ``tokens``, ``labels``, ``kpm`` (True = padded out), ``loss_mask``
    and ``doc_len``."""
    rng = np.random.RandomState(seed)
    base = np.cumsum(rng.randint(1, 5, size=(batch, seq_len)),
                     axis=1) % vocab
    doc_len = rng.randint(doc_len_min, seq_len + 1, size=(batch,))
    kpm = np.arange(seq_len)[None, :] >= doc_len[:, None]
    return {"tokens": base, "labels": np.roll(base, -1, axis=1),
            "kpm": kpm, "loss_mask": (~kpm).astype(np.float32),
            "doc_len": doc_len}


class RingCPTraining:
    """The example's model, optimizer and this cp rank's chunk of a global
    batch (:func:`make_batch`'s arrays), on ``model``'s device.
    :meth:`step` trains once; :meth:`loss_and_grads` is the step before
    the update."""

    def __init__(self, model: GPTModel, batch: Dict[str, np.ndarray],
                 lr: float = 1e-3):
        self.model = model
        self.params = dict(model.named_parameters())
        self.opt = fused_adam(lr=lr)
        self.state = self.opt.init(
            {n: p.detach() for n, p in self.params.items()})
        self.group = ps.get_context_parallel_group()
        cp, r = ps.group_size(self.group), ps.get_context_parallel_rank()
        seq = batch["tokens"].shape[1]
        if seq % cp:
            raise ValueError(f"seq_len ({seq}) does not divide by cp ({cp})")
        lo, hi = r * seq // cp, (r + 1) * seq // cp
        dev = model.device

        def local(name, dtype):
            return torch.as_tensor(batch[name][:, lo:hi], dtype=dtype,
                                   device=dev)

        self.tokens = local("tokens", torch.long)
        self.labels = local("labels", torch.long)
        self.kpm = local("kpm", torch.bool)
        self.loss_mask = local("loss_mask", torch.float32)
        # the real tokens over cp, outside the gradient's path
        self.n = ps.all_reduce(self.loss_mask.sum(), self.group).clamp_min(1.0)

    def loss_and_grads(self):
        """(the loss summed over cp, a 0-dim tensor; the gradients summed
        over cp, by name)."""
        losses = self.model(self.tokens, key_padding_mask=self.kpm,
                            labels=self.labels, loss_mask=self.loss_mask)
        local = losses.sum() / self.n
        names = list(self.params)
        grads = dict(zip(names, torch.autograd.grad(
            local, [self.params[n] for n in names])))
        if self.group is not None:
            grads = all_reduce_gradients(grads, self.group,
                                         gradient_average=False)
        return ps.all_reduce(local.detach(), self.group), grads

    def step(self) -> float:
        loss, grads = self.loss_and_grads()
        updates, self.state = self.opt.update(
            grads, self.state, {n: p.detach() for n, p in self.params.items()})
        with torch.no_grad():
            for n, p in self.params.items():
                p.add_(updates[n])
        return float(loss)


def train(args, log=print, params: Optional[Dict[str, np.ndarray]] = None,
          config: Optional[TransformerConfig] = None) -> List[float]:
    """The example's run on this rank of an initialized world: the cp
    groups, the model from ``--seed`` (or ``params``, a state dict of
    arrays), ``--steps`` steps; returns the losses."""
    ps.initialize_model_parallel(context_parallel_size=args.cp)
    model = GPTModel(config or example_config(args), device=args.device,
                     seed=args.seed)
    if params is not None:
        model.load_state_dict({k: torch.as_tensor(v)
                               for k, v in params.items()})
    cuda = model.device.type == "cuda"
    if cuda:
        _kernels.build_all()
    batch = make_batch(args.batch, args.seq_len, args.vocab,
                       args.doc_len_min, args.seed)
    run = RingCPTraining(model, batch, lr=args.lr)
    cfg = model.config
    log(f"ring-CP GPT: cp={args.cp}  seq {args.seq_len} "
        f"({args.seq_len // args.cp}/rank)  heads {cfg.num_attention_heads} "
        f"kv_heads {cfg.num_query_groups}  docs {batch['doc_len'].tolist()}")
    losses = []
    for step in range(args.steps):
        t0 = time.perf_counter()
        loss = run.step()
        if cuda:
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        losses.append(loss)
        log(f"step {step:4d} loss {loss:9.4f} step_ms {ms:.2f}")
    if not np.isfinite(losses[-1]):
        raise FloatingPointError(f"diverged: loss {losses[-1]}")
    log("done")
    return losses


def _spawned_rank(rank: int, world_size: int, argv):
    args = parse_args(argv)
    return train(args, log=print if rank == 0 else (lambda *a: None))


def main(argv=None):
    """Under ``torch.distributed.run`` (``WORLD_SIZE`` set) this process is
    one gloo rank; otherwise the script spawns ``--cp`` gloo ranks.
    Returns the losses."""
    args = parse_args(argv)
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group("gloo")
        try:
            return train(args, log=(print if dist.get_rank() == 0
                                    else (lambda *a: None)))
        finally:
            ps.destroy_model_parallel()
            dist.destroy_process_group()
    from apex_tpu_torch.transformer.testing.distributed_test_base import (
        spawn,
    )

    argv = sys.argv[1:] if argv is None else list(argv)
    return spawn(_spawned_rank, args.cp, args=(argv,), timeout=3600.0)[0]


if __name__ == "__main__":
    main()
