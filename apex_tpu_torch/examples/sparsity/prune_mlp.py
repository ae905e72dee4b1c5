"""ASP 2:4 structured sparsity end to end (the port of the JAX package's
examples/sparsity/prune_mlp.py; ref: apex/contrib/sparsity's recipe and
asp.py's prune_trained_model).

A tanh MLP [64, 128, 128, 1] (flax-layout ``kernel`` parameters, (in,
out)) regresses y = x @ w_true on one batch of 512 seeded inputs: dense
training through ``ASP.init_optimizer_for_pruning(fused_adam(lr=3e-3))``
(the Adam kernel, #8, on the card), a one-shot prune whose 2:4 masks
enter the live optimizer state, the channel-permutation search on the
hidden layer (how much more magnitude a permuted 2:4 mask keeps), then a
sparse fine-tune with the same optimizer, after which every pruned
weight is still exactly zero and each group of 4 along the pruned axis
holds at most 2 non-zeros. The JAX example's flags and prints:

    python -m apex_tpu_torch.examples.sparsity.prune_mlp [--steps 150]
    python -m apex_tpu_torch.examples.sparsity.prune_mlp --device cpu

On the card unless ``--device cpu``.
"""

import argparse
from typing import Callable, Dict

import torch

from apex_tpu_torch._kernels import resolve_device
from apex_tpu_torch.contrib.sparsity import ASP, permute_and_mask, prune
from apex_tpu_torch.optimizers import fused_adam

__all__ = ["main", "parse_args", "train"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def _is_2_4(weight, mask) -> bool:
    """Every group of 4 along the pruned axis (-2 of an (in, out)
    kernel) keeps at most 2 non-zeros, and the mask exactly 2."""
    def groups(t):
        return t.movedim(-2, -1).reshape(-1, 4)
    return bool(((groups(weight) != 0).sum(dim=1) <= 2).all()
                and (groups(mask).sum(dim=1) == 2).all())


def train(args, log: Callable = print) -> Dict:
    """Dense training, the prune, the permutation search and the sparse
    fine-tune; returns the losses and the checks."""
    dev = resolve_device(args.device)
    gen = torch.Generator().manual_seed(args.seed)
    params = {"in.kernel": torch.randn(64, 128, generator=gen) * 0.1,
              "hid.kernel": torch.randn(128, 128, generator=gen) * 0.1,
              "out.kernel": torch.randn(128, 1, generator=gen) * 0.1}
    params = {n: p.to(dev) for n, p in params.items()}
    x = torch.randn(512, 64, generator=gen).to(dev)
    y = (x @ torch.randn(64, generator=gen).to(dev))[:, None]

    def loss_fn(p):
        h = torch.tanh(x @ p["in.kernel"])
        h = torch.tanh(h @ p["hid.kernel"])
        return torch.mean((h @ p["out.kernel"] - y) ** 2)

    asp = ASP()
    asp.init_model_for_pruning(params)
    opt = asp.init_optimizer_for_pruning(fused_adam(lr=3e-3))
    state = opt.init(params)

    def step(p, state):
        p = {n: t.detach().requires_grad_(True) for n, t in p.items()}
        loss = loss_fn(p)
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        upd, state = opt.update(grads, state, p)
        with torch.no_grad():
            return ({n: t + upd[n] for n, t in p.items()}, state,
                    loss.detach())

    for i in range(args.steps):
        params, state, loss = step(params, state)
        if i % 50 == 0:
            log(f"dense   step {i:4d} loss {float(loss):.5f}")
    with torch.no_grad():
        dense_loss = float(loss_fn(params))

    # one-shot prune; the masks enter the live optimizer state
    pruned, state = asp.prune_trained_model(params, state)
    with torch.no_grad():
        pruned_loss = float(loss_fn(pruned))

    # the permutation search recovers magnitude the plain mask drops:
    # the hidden kernel's input dim is pruned, so search its transpose
    k = params["hid.kernel"]
    _, mask = permute_and_mask(k.t())
    naive = prune({"k": k}, {"k": asp.masks["hid.kernel"]})["k"]
    permuted_kept = float((k.t() * mask).abs().sum())
    naive_kept = float(naive.abs().sum())
    log(f"hid layer retained |w|: naive 2:4 {naive_kept:.2f}, permuted "
        f"{permuted_kept:.2f} ({permuted_kept / max(naive_kept, 1e-9):.3f}x)")

    params = pruned
    for i in range(args.steps):
        params, state, loss = step(params, state)
        if i % 50 == 0:
            log(f"sparse  step {i:4d} loss {float(loss):.5f}")
    with torch.no_grad():
        final_loss = float(loss_fn(params))
    for name, p in params.items():
        m = asp.masks[name]
        if not bool((p[m == 0] == 0).all()):
            raise AssertionError(f"{name}: pruned weights drifted off zero")
        if not _is_2_4(p, m):
            raise AssertionError(f"{name}: not 2:4 along the pruned axis")
    log(f"dense loss {dense_loss:.5f} -> post-prune {pruned_loss:.5f} -> "
        f"fine-tuned {final_loss:.5f}; 2:4 zeros preserved through training")
    return {"dense_loss": dense_loss, "pruned_loss": pruned_loss,
            "final_loss": final_loss, "naive_kept": naive_kept,
            "permuted_kept": permuted_kept}


def main(argv=None) -> int:
    train(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
