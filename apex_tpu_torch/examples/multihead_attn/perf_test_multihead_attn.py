"""Multi-head attention throughput sweep (the port of the JAX package's
examples/multihead_attn/perf_test_multihead_attn.py; ref:
apex/contrib/examples/multihead_attn/perf_test_multihead_attn.py).

A stack of ``--layers`` chained ``contrib.SelfMultiheadAttn`` (or, with
``--encdec-attn``, ``EncdecMultiheadAttn`` with the keys from the same
input) at seq ``--seq-length``, swept over the number of sequences from
``--num-seqs-start`` to ``--num-seqs-stop`` by ``--num-seqs-inc``; the
JAX example's flags and prints. ``--ref`` takes the unfused composition
(``impl="xla"``, the reference's 'default'), else the flash path, whose
kernels (#5 forward, #6 and #7 backward, and with ``--norm-add`` the
LayerNorm's #1 and #2) run on the card. ``--fwd`` times the forward
alone, else forward and backward: each iteration's input gradient of
``sum(out ** 2)``, rescaled to unit RMS, is the next iteration's input
(JAX feeds the raw gradient; the rescale keeps a long fp32 chain finite).
Timing is the slope of chained iterations (``utils.benchmarking``), as
in JAX, which cancels the per-call constants. fp32 as in JAX, or bf16
with ``--bf16`` (the port's addition); parameters fp32 from seed 111.

    python -m apex_tpu_torch.examples.multihead_attn.perf_test_multihead_attn \\
        [--seq-length 64] [--num-seqs-start 10 --num-seqs-stop 120 \\
        --num-seqs-inc 5] [--layers 18] [--hidden-dim 1024] [--heads 16] \\
        [--encdec-attn] [--norm-add] [--biases] [--fwd] [--ref] [--bf16] \\
        [--device cpu]

On the card unless ``--device cpu``.
"""

import argparse
from typing import Callable, Dict, List

import torch

from apex_tpu_torch._kernels import resolve_device
from apex_tpu_torch.contrib.multihead_attn import (
    EncdecMultiheadAttn,
    SelfMultiheadAttn,
)
from apex_tpu_torch.utils.benchmarking import (
    chained_seconds_per_iter,
    full_reduce,
)

__all__ = ["build_layer", "chain", "main", "parse_args", "run"]

SEED = 111


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Multihead Attention Standalone Test")
    p.add_argument("--seq-length", default=64, type=int)
    p.add_argument("--num-seqs-start", default=10, type=int)
    p.add_argument("--num-seqs-stop", default=120, type=int)
    p.add_argument("--num-seqs-inc", default=5, type=int)
    p.add_argument("--layers", default=18, type=int,
                   help="attention layers chained per step")
    p.add_argument("--hidden-dim", default=1024, type=int)
    p.add_argument("--heads", default=16, type=int)
    p.add_argument("--encdec-attn", action="store_true")
    p.add_argument("--norm-add", action="store_true")
    p.add_argument("--biases", action="store_true")
    p.add_argument("--fwd", action="store_true", help="forward pass only")
    p.add_argument("--ref", action="store_true",
                   help="unfused composition instead of the flash path")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 activations (fp32 parameters)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def build_layer(args, device):
    """The module every layer of the stack applies (dropout 0, as the
    reference's timing runs)."""
    cls = EncdecMultiheadAttn if args.encdec_attn else SelfMultiheadAttn
    return cls(embed_dim=args.hidden_dim, num_heads=args.heads, dropout=0.0,
               bias=args.biases, include_norm_add=args.norm_add,
               impl="xla" if args.ref else "auto", device=device, seed=SEED)


def chain(layer, args) -> Callable[[int], Callable]:
    """``build(k)`` for the slope timing: k chained iterations of the
    stack (forward, or forward and backward) from ``x``."""
    def apply(x):
        return layer(x, x) if args.encdec_attn else layer(x)

    def stack(x):
        for _ in range(args.layers):
            x = apply(x)
        return x

    def build(k):
        def run(x):
            c = x
            for _ in range(k):
                if args.fwd:
                    with torch.no_grad():
                        c = stack(c)
                else:
                    xi = c.detach().requires_grad_(True)
                    (g,) = torch.autograd.grad(
                        stack(xi).float().square().sum(), xi)
                    c = (g.float() * torch.rsqrt(
                        g.float().square().mean() + 1e-30)).to(x.dtype)
            return full_reduce(c)
        return run
    return build


def run(args, log: Callable = print, reps: int = 2,
        target_signal: float = 0.4, max_span: int = 1024) -> List[Dict]:
    """The sweep; returns one row a point: ``seqs``, ``ms`` (a step of
    the stack), ``us_per_layer``, ``mtok_s``."""
    dev = resolve_device(args.device)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    layer = build_layer(args, dev)
    kind = "fwd" if args.fwd else "fwd+bwd"
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    log(f"backend: {dev.type} / {name}   "
        f"{'encdec' if args.encdec_attn else 'self'}-attn  hidden "
        f"{args.hidden_dim}  heads {args.heads}  seq {args.seq_length}  "
        f"layers {args.layers}  {kind}  impl="
        f"{'xla' if args.ref else 'auto'}  {str(dtype)[6:]}")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for seqs in range(args.num_seqs_start, args.num_seqs_stop + 1,
                      args.num_seqs_inc):
        x = torch.randn((args.seq_length, seqs, args.hidden_dim),
                        generator=gen, device=dev).to(dtype)
        sec = chained_seconds_per_iter(chain(layer, args), (x,), reps=reps,
                                       target_signal=target_signal,
                                       max_span=max_span)
        row = {"seqs": seqs, "ms": sec * 1e3,
               "us_per_layer": sec / args.layers * 1e6,
               "mtok_s": args.seq_length * seqs / sec / 1e6}
        log(f"seqs {seqs:4d}   {row['ms']:9.3f} ms/iter   "
            f"{row['us_per_layer']:9.1f} us/layer   "
            f"{row['mtok_s']:8.2f} Mtok/s ({kind})")
        rows.append(row)
    return rows


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
