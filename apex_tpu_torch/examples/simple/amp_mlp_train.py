"""Minimal end-to-end training through amp O2, fused Adam and the fused
ops (the port of the JAX package's examples/simple/amp_mlp_train.py).

A regression MLP [256, 512, 512, 1] on one fixed batch of 512 seeded
random inputs, y = x @ w_true: the inputs go through LayerNorm (kernel
#1 on the card), ``ops.mlp.mlp_apply`` in the policy's compute dtype,
the mean squared error in fp32; the scaled loss's gradients through
``clip_grad_norm`` (kernel #9 per tensor on the card) and
``AmpOptimizer`` over ``fused_adam`` (kernel #8 per tensor on the card).
``--inject-overflow-at N`` poisons step N's gradients with inf to show
the skip: the step leaves the parameters, masters and Adam state alone
and halves a dynamic scale. The JAX example's flags and prints:

    python -m apex_tpu_torch.examples.simple.amp_mlp_train --steps 60 \\
        --opt-level O2 --half float16 --inject-overflow-at 10
    python -m apex_tpu_torch.examples.simple.amp_mlp_train --device cpu

On the card unless ``--device cpu``.
"""

import argparse
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from apex_tpu_torch import amp
from apex_tpu_torch._kernels import resolve_device
from apex_tpu_torch.ops.layer_norm import layer_norm
from apex_tpu_torch.ops.mlp import mlp_apply, mlp_init
from apex_tpu_torch.optimizers import clip_grad_norm, fused_adam

__all__ = ["BATCH", "SIZES", "make_data", "parse_args", "train"]

SIZES = [256, 512, 512, 1]
BATCH = 512
HALF = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--opt-level", default="O2")
    ap.add_argument("--half", default="bfloat16", choices=sorted(HALF))
    ap.add_argument("--inject-overflow-at", type=int, default=-1,
                    help="poison grads at this step to exercise skip-step")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def make_data(seed: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (512, 256) standard normal and y = x @ w_true, from a generator
    of ``seed + 1`` (the weights take ``seed``)."""
    gen = torch.Generator().manual_seed(seed + 1)
    x = torch.randn(BATCH, SIZES[0], generator=gen)
    w_true = torch.randn(SIZES[0], generator=gen)
    return x.to(device), (x @ w_true)[:, None].to(device)


def train(args, params: Optional[Dict[str, np.ndarray]] = None,
          data: Optional[Tuple[np.ndarray, np.ndarray]] = None,
          log: Callable[[str], None] = print,
          hook: Optional[Callable] = None,
          state: Optional[amp.AmpOptimizerState] = None) -> List[Dict]:
    """The example's loop; returns each step's ``loss`` (the unscaled
    loss before the update), ``scale`` (after it) and ``skipped``.
    ``params`` (``weights.<i>``/``biases.<i>``) and ``data`` (x, y) come
    from the caller when given, else from ``--seed``; ``state`` (an
    ``AmpOptimizerState``, e.g. ``models.convert.amp_state_from_jax``)
    resumes a run, its masters replaced by the parameters where the level
    keeps none. ``hook(step, params, state, info)`` runs after every
    step."""
    dev = resolve_device(args.device)
    half = HALF[args.half]
    if params is None:
        params = mlp_init(args.seed, SIZES, device=dev)
    else:
        params = {n: torch.as_tensor(np.array(v), device=dev)
                  for n, v in params.items()}
    if data is None:
        x, y = make_data(args.seed, dev)
    else:
        x, y = (torch.as_tensor(np.array(a), device=dev) for a in data)

    tx = fused_adam(lr=1e-3, weight_decay=1e-4)
    params, amp_opt, policy = amp.initialize(
        params, tx, opt_level=args.opt_level, half_dtype=half)
    params = {n: p.detach().requires_grad_() for n, p in params.items()}
    if state is None:
        state = amp_opt.init(params)
    elif not policy.master_weights:
        state = state.replace(master=params)
    ln_w = torch.ones(SIZES[0], device=dev)
    ln_b = torch.zeros(SIZES[0], device=dev)
    names, plist = list(params), list(params.values())

    def loss_fn(p):
        h = layer_norm(x, ln_w, ln_b)  # kernel #1 on the features
        h = mlp_apply(p, policy.cast_inputs(h))
        return ((h.float() - y) ** 2).mean()

    records = []
    t0 = time.time()
    for i in range(args.steps):
        scaled = amp_opt.scale_loss(loss_fn(params), state)
        grads = dict(zip(names, torch.autograd.grad(scaled, plist)))
        if i == args.inject_overflow_at:
            grads = {n: torch.full_like(g, float("inf"))
                     for n, g in grads.items()}
        grads, _ = clip_grad_norm(grads, 1e9)
        loss = scaled.detach() / state.scaler.scale  # the pre-update scale
        params, state, info = amp_opt.step(grads, state, params)
        skipped = bool(info["found_inf"])
        rec = {"loss": float(loss), "scale": float(info["loss_scale"]),
               "skipped": skipped}
        records.append(rec)
        if hook is not None:
            hook(i, params, state, info)
        if i % 10 == 0 or i == args.steps - 1 or skipped:
            log(f"step {i:4d} loss {rec['loss']:10.4f} "
                f"scale {rec['scale']:10.1f} skipped {skipped}")
    dt = time.time() - t0
    log(f"done: {args.steps} steps in {dt:.2f}s ({args.steps / dt:.1f} "
        f"steps/s) on {dev.type}")
    return records


def main(argv=None) -> int:
    train(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
