"""FP8 delayed-scaling training (the port of the JAX package's
examples/fp8/train_fp8_mlp.py).

A regression MLP [32, 128, 128, 1] on one fixed batch of 256 seeded
random inputs, y = sum(sin(x)), whose linears run through
``amp.fp8.fp8_dense`` (quantize-dequantize with delayed scales: this
step quantizes with the earlier steps' statistics). The two facts the
JAX example shows:

1. the saturation demo: at scale 1 a tensor far above e4m3's 448
   saturates and the product is garbage; one state update later the
   scale has locked onto the observed amax and the same product tracks
   fp32;
2. the loop: the fp8 states thread through the step as optimizer state
   does, the loss falls, and ``qerr`` (the fp8 forward against an fp32
   forward on the same updated weights, relative to the fp32 output's
   max) stays small.

The update is ``torch.optim.Adam`` at lr 3e-3 (optax.adam's defaults:
betas 0.9, 0.999, eps 1e-8, eps outside the root as optax has it).

    python -m apex_tpu_torch.examples.fp8.train_fp8_mlp --steps 60
    python -m apex_tpu_torch.examples.fp8.train_fp8_mlp --device cpu

On the card unless ``--device cpu``.
"""

import argparse
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from apex_tpu_torch._kernels import resolve_device
from apex_tpu_torch.amp.fp8 import fp8_dense, init_fp8_state

__all__ = ["forward", "make_data", "make_params", "parse_args",
           "saturation_demo", "train"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--history", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def saturation_demo(gen: torch.Generator, device, log=print
                    ) -> Tuple[float, float]:
    """Step t quantizes with step t-1's statistics: the first call at
    scale 1 saturates, the second recovers. Returns both relative
    errors."""
    x = torch.randn(8, 16, generator=gen).to(device) * 1000.0  # amax >> 448
    w = torch.randn(16, 4, generator=gen).to(device)
    ref = x @ w
    states = (init_fp8_state(4, device), init_fp8_state(4, device))
    y1, states = fp8_dense(x, w, *states)
    y2, _ = fp8_dense(x, w, *states)

    def rel(y):
        return float((y - ref).abs().max() / ref.abs().max())

    e1, e2 = rel(y1), rel(y2)
    log(f"[demo] rel err at scale 1 (saturated): {e1:.3f}; "
        f"after one amax update: {e2:.4f}")
    return e1, e2


def make_params(gen: torch.Generator, dims: Sequence[int], device
                ) -> List[Dict[str, torch.Tensor]]:
    """Each layer's w (fan_in, fan_out) normal / sqrt(fan_in), b zeros."""
    return [{"w": (torch.randn(i, o, generator=gen) / math.sqrt(i)).to(device),
             "b": torch.zeros(o, device=device)}
            for i, o in zip(dims[:-1], dims[1:])]


def make_data(gen: torch.Generator, batch: int, dim: int, device):
    x = torch.randn(batch, dim, generator=gen)
    return x.to(device), torch.sin(x).sum(dim=-1, keepdim=True).to(device)


def forward(params, fp8_states, x, use_fp8: bool = True):
    """The MLP forward, linears through ``fp8_dense`` (or plain fp32);
    returns (out, the new fp8 states)."""
    new_states, h = [], x
    for i, layer in enumerate(params):
        if use_fp8:
            sx, sw = fp8_states[i]
            h, (sx, sw) = fp8_dense(h, layer["w"], sx, sw, bias=layer["b"])
            new_states.append((sx, sw))
        else:
            h = h @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            h = torch.relu(h)
    return h, new_states


def train(args, params: Optional[Sequence[Dict[str, np.ndarray]]] = None,
          data: Optional[Tuple[np.ndarray, np.ndarray]] = None,
          log: Callable[[str], None] = print,
          hook: Optional[Callable] = None) -> List[Dict[str, float]]:
    """The example: the demo, then ``args.steps`` steps. ``params`` (a
    list of {w, b}) and ``data`` (x, y) come from the caller when given,
    else from ``--seed``. Returns each step's ``loss`` (before the
    update), ``qerr`` and ``scale_x0`` (the first layer's input scale
    after the step); raises if the loss did not fall. ``hook(step,
    params, states)`` runs after every step."""
    dev = resolve_device(args.device)
    gen = torch.Generator().manual_seed(args.seed)
    saturation_demo(torch.Generator().manual_seed(args.seed + 7), dev, log)
    dims = [32, args.hidden, args.hidden, 1]
    if params is None:
        params = make_params(gen, dims, dev)
    else:
        params = [{k: torch.as_tensor(np.array(v), device=dev)
                   for k, v in layer.items()} for layer in params]
    if data is None:
        x, y = make_data(gen, args.batch, dims[0], dev)
    else:
        x, y = (torch.as_tensor(np.array(a), device=dev) for a in data)
    for layer in params:
        for t in layer.values():
            t.requires_grad_(True)
    # one (x, w) state pair a layer, threaded as optimizer state
    states = [(init_fp8_state(args.history, dev),
               init_fp8_state(args.history, dev)) for _ in params]
    opt = torch.optim.Adam([t for layer in params for t in layer.values()],
                           lr=args.lr, betas=(0.9, 0.999), eps=1e-8)
    records = []
    for i in range(args.steps):
        opt.zero_grad(set_to_none=True)
        out, new_states = forward(params, states, x)
        loss = ((out - y) ** 2).mean()
        loss.backward()
        opt.step()
        states = new_states
        with torch.no_grad():  # the recipe's accuracy once scales lock on
            q_out, _ = forward(params, states, x)
            f_out, _ = forward(params, None, x, use_fp8=False)
            qerr = (q_out - f_out).abs().max() / (f_out.abs().max() + 1e-9)
        rec = {"loss": loss.item(), "qerr": float(qerr),
               "scale_x0": float(states[0][0].scale)}
        records.append(rec)
        if hook is not None:
            hook(i, params, states)
        if i % 10 == 0 or i == args.steps - 1:
            log(f"step {i:4d} loss {rec['loss']:10.4f} "
                f"qerr {rec['qerr']:.4f} scale_x0 {rec['scale_x0']:.4g}")
    first, last = records[0]["loss"], records[-1]["loss"]
    if not last < first:
        raise AssertionError(f"loss did not decrease: {first} -> {last}")
    log(f"done: {args.steps} steps (loss {first:.3f} -> {last:.3f})")
    return records


def main(argv=None) -> int:
    train(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
