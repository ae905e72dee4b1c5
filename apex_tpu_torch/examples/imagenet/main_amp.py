"""ResNet-50 ImageNet training with amp (the port of the JAX package's
examples/imagenet/main_amp.py; ref examples/imagenet/main_amp.py).

``models.resnet`` through ``amp.initialize(model, fused_sgd(...),
opt_level, half_dtype)`` and ``AmpOptimizer``, on one fixed batch of
seeded random images (the benchmarking mode; the JAX example's). Each
step: the forward in train mode under the policy's cast context, the
mean cross-entropy, the backward of the scaled loss, the amp step. The
levels:

- O0: fp32 everywhere (TF32 is whatever the caller set);
- O1: fp32 parameters and a model that computes in fp32, run under the
  cast engine, which takes every convolution and the head to the half
  dtype (the JAX example gives flax its compute dtype and runs no cast
  lists at O1; the port's O1 is the reference Apex's);
- O2: half parameters but the BatchNorms', fp32 masters, a half model;
- O3: all half.

``--sync-bn`` and ``--data-parallel`` are taken, as the JAX example
takes them, and refused: at a world of one they would change nothing,
and this example runs a world of one.

    python -m apex_tpu_torch.examples.imagenet.main_amp --steps 20
    python -m apex_tpu_torch.examples.imagenet.main_amp --device cpu \\
        --batch-size 4 --image-size 32 --steps 3

On the card unless ``--device cpu``. Prints a line every 10 steps and a
closing line with the images/s of the steps after ``--warmup``.
"""

import argparse
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from apex_tpu_torch import amp
from apex_tpu_torch._kernels import resolve_device
from apex_tpu_torch.models import resnet
from apex_tpu_torch.optimizers import fused_sgd
from apex_tpu_torch.utils.profiling import profile_device

__all__ = ["build", "parse_args", "train"]

HALF = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--opt-level", default="O2",
                   choices=["O0", "O1", "O2", "O3"])
    p.add_argument("--half", default="bfloat16", choices=sorted(HALF))
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--warmup", type=int, default=0,
                   help="steps before the timed ones")
    p.add_argument("--profile-steps", type=int, default=0,
                   help="steps more, after the timed ones, under "
                        "torch.profiler (on the card)")
    p.add_argument("--loss-scale", default=None,
                   help="None = the opt level decides (bf16 O2 -> 1.0, "
                        "fp16 -> dynamic)")
    p.add_argument("--sync-bn", action="store_true")
    p.add_argument("--data-parallel", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def _refuse_multi_rank(args):
    for flag, on in (("--sync-bn", args.sync_bn),
                     ("--data-parallel", args.data_parallel)):
        if on:
            raise SystemExit(
                f"{flag}: this example runs a world of one, where "
                f"SyncBatchNorm and data parallelism change nothing; "
                f"refused rather than ignored")


def build(args, model=None, data=None):
    """(model, amp optimizer, policy, images, labels): ``model`` (built
    with the level's compute dtype: fp32 at O0 and O1, else the half
    dtype) and ``data`` (NHWC images and labels, numpy) from the caller
    when given, else made from ``--seed``."""
    _refuse_multi_rank(args)
    dev = resolve_device(args.device)
    half = HALF[args.half]
    policy = amp.opt_levels[args.opt_level](half)
    # O1 computes in fp32 and lets the cast engine take ops to half
    dtype = torch.float32 if policy.patch_functions else \
        (policy.compute_dtype or torch.float32)
    if model is None:
        model = resnet.ResNet50(num_classes=1000, dtype=dtype, device=dev,
                                seed=args.seed)
    if data is None:
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        images = torch.randn(args.batch_size, args.image_size,
                             args.image_size, 3, generator=gen, device=dev)
        labels = torch.randint(0, 1000, (args.batch_size,), generator=gen,
                               device=dev)
    else:
        images, labels = (torch.as_tensor(np.array(a), device=dev)
                          for a in data)
        labels = labels.long()
    overrides = {}
    if args.loss_scale is not None:
        overrides["loss_scale"] = (args.loss_scale
                                   if args.loss_scale == "dynamic"
                                   else float(args.loss_scale))
    tx = fused_sgd(lr=args.lr, momentum=args.momentum,
                   weight_decay=args.weight_decay)
    model, amp_opt, policy = amp.initialize(
        model, tx, opt_level=args.opt_level, half_dtype=half, **overrides)
    return model, amp_opt, policy, images, labels


def train(args, model=None, data=None, log: Callable[[str], None] = print,
          casts: Optional[List[int]] = None) -> Dict:
    """The example's loop: each step's loss (before the update), scale
    and skip flag, the images/s and ms of the steps after ``--warmup``
    (CUDA events on the card, the host clock on the CPU), the peak
    memory, and with ``--profile-steps`` the device time by kernel of
    that many more steps. ``casts`` (a list) receives the number of
    tensors the cast engine cast in each forward (O1)."""
    model, amp_opt, policy, images, labels = build(args, model, data)
    params = dict(model.named_parameters())
    names, plist = list(params), list(params.values())
    state = amp_opt.init(params)
    cuda = images.is_cuda
    if cuda:
        torch.cuda.reset_peak_memory_stats(images.device)

    def step():
        nonlocal params, state
        with policy.cast_context() as mode:
            logits = model(policy.cast_inputs(images), train=True)
        if casts is not None and mode is not None:
            casts.append(mode.casts)
        loss = resnet.cross_entropy_loss(logits, labels)
        grads = torch.autograd.grad(amp_opt.scale_loss(loss, state), plist)
        params, state, info = amp_opt.step(dict(zip(names, grads)), state,
                                           params)
        return loss.detach(), info

    records = []
    t0 = e0 = None
    for i in range(args.steps):
        if i == args.warmup:
            if cuda:
                torch.cuda.synchronize(images.device)
                e0 = torch.cuda.Event(enable_timing=True)
                e0.record()
            t0 = time.perf_counter()
        loss, info = step()
        records.append({"loss": loss, "scale": info["loss_scale"],
                        "skipped": info["found_inf"]})
        if i % 10 == 0 or i == args.steps - 1:
            log(f"step {i:5d} loss {float(loss):9.4f} "
                f"scale {float(info['loss_scale']):9.1f} "
                f"skipped {bool(info['found_inf'])}")
    timed = args.steps - args.warmup
    ms = None
    if timed > 0:
        if cuda:
            e1 = torch.cuda.Event(enable_timing=True)
            e1.record()
            torch.cuda.synchronize(images.device)
            ms = e0.elapsed_time(e1) / timed
        else:
            ms = (time.perf_counter() - t0) * 1e3 / timed
    rec = {"opt_level": args.opt_level, "half": args.half,
           "losses": [float(r["loss"]) for r in records],
           "scales": [float(r["scale"]) for r in records],
           "skipped": [bool(r["skipped"]) for r in records],
           "step_ms": ms,
           "imgs_per_s": None if ms is None else args.batch_size / ms * 1e3,
           "peak_mem_gb": (torch.cuda.max_memory_allocated(images.device)
                           / 1e9 if cuda else None),
           "timer": "cuda events" if cuda else "host clock",
           "model": model, "params": params, "state": state}
    if ms is not None:
        log(f"done: {args.steps} steps, {rec['imgs_per_s']:.1f} imgs/sec "
            f"over the last {timed} on {images.device.type}")
    if args.profile_steps:
        if not cuda:
            raise ValueError("--profile-steps profiles the card")
        rec["profile"] = profile_device(
            lambda: [step() for _ in range(args.profile_steps)], top=10)
    return rec


def main(argv=None) -> int:
    train(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
