"""The ResNet-50 amp-O2 training step's images per second on one card (the
H100 twin of the repository's ``bench.py``).

    python -m apex_tpu_torch.bench                  # ResNet-50, 224^2, batch 256
    python -m apex_tpu_torch.bench --model resnet18 --image-size 32 \\
        --batch 8 --device cpu                      # the CPU smoke size

One step is the JAX benchmark's ``mode="step"``: the forward in train
mode (BatchNorm on the batch's statistics, updating the running ones),
the mean softmax cross-entropy, the backward, and ``fused_sgd(lr=0.1,
momentum=0.9, weight_decay=1e-4)`` applied to the fp32 parameters, on one
fixed batch of seeded random images and labels. O2 computes in bf16 over
fp32 parameters; O0 is the same step in fp32, with TF32 off in cuDNN and
cuBLAS for its run (restored after). cuDNN's autotuner
(``cudnn.benchmark``, as the ImageNet example sets it) is on for O2 and
off for O0: on an H100 80GB HBM3 (700 W) its search over the fp32
convolutions took 69.3 s and found nothing faster than cuDNN's own
choice (0.43 s a step either way), while O2's took 20.0 s and saves
about 4% a step.

After ``--warmup`` steps, a step is timed by its slope, as the JAX
bench times it (``utils.benchmarking.chained_seconds_per_iter``): chains
of 1 and of 1 + ``--steps`` steps in a row, each best of 2 runs that end
in a ``torch.cuda.synchronize`` and the fetch of the chain's losses, and
the difference of the two over ``--steps`` (no host sync inside a
chain; on the CPU, which only the tests ask for, the same on the host's
clock). Prints one JSON line: each mode's images/s, step ms, peak memory
and losses (the warm-up steps' and the longest chain's last
``--steps``), O2's ratio to O0, the batch, and the device with its power
limit. Raises if a loss or the parameter
sum is not finite. ``--profile-steps N`` (on the card) runs N more steps
of each mode under ``torch.profiler`` and adds the device time by kernel
(the top 10) and the device's idle share to the mode's record.
"""

import argparse
import json
import math
import subprocess
from typing import Dict, List

import torch

from apex_tpu_torch._kernels import resolve_device
from apex_tpu_torch.models import resnet
from apex_tpu_torch.optimizers import fused_sgd
from apex_tpu_torch.utils.benchmarking import chained_seconds_per_iter
from apex_tpu_torch.utils.profiling import profile_device

__all__ = ["MODELS", "main", "measure", "train_step"]

MODELS = {"resnet18": resnet.ResNet18, "resnet50": resnet.ResNet50}
SGD = dict(lr=0.1, momentum=0.9, weight_decay=1e-4)  # bench.py:85
MODES = {"O2": torch.bfloat16, "O0": torch.float32}


def train_step(model, opt, images, labels):
    """A step closure: loss, gradients and the SGD update of ``model``'s
    parameters in place; returns the loss (a 0-d tensor, not synced)."""
    params = dict(model.named_parameters())
    names, plist = list(params), list(params.values())
    state = [opt.init(params)]

    def step():
        loss = resnet.cross_entropy_loss(model(images, train=True), labels)
        grads = torch.autograd.grad(loss, plist)
        updates, state[0] = opt.update(dict(zip(names, grads)), state[0],
                                       params)
        with torch.no_grad():
            torch._foreach_add_(plist, [updates[n] for n in names])
        return loss.detach()

    return step


def measure(dtype: torch.dtype, model_name: str = "resnet50",
            image_size: int = 224, batch: int = 256, warmup: int = 3,
            steps: int = 10, device="cuda", seed: int = 0,
            profile_steps: int = 0) -> Dict:
    """Images/s of ``steps`` training steps after ``warmup`` ones; with
    ``profile_steps``, then that many steps under the profiler."""
    dev = resolve_device(device)
    model = MODELS[model_name](num_classes=1000, dtype=dtype, device=dev,
                               seed=seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    images = torch.randn(batch, image_size, image_size, 3, generator=gen,
                         device=dev)
    labels = torch.randint(0, 1000, (batch,), generator=gen, device=dev)
    step = train_step(model, fused_sgd(**SGD), images, labels)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    losses: List[torch.Tensor] = [step() for _ in range(warmup)]

    def build(k):
        # k steps in a row, each on the parameters the last one updated;
        # their losses are the chain's output (one small fetch)
        return lambda: torch.stack([step() for _ in range(k)])

    # the slope between chains of 1 and 1 + steps steps, best of 2 each
    # (as the JAX bench times its scan): the host's dispatch, the
    # synchronisation and the fetch cancel
    sec, (chain,) = chained_seconds_per_iter(
        build, reps=2, target_signal=0.4, max_span=steps,
        return_output=True)
    ms = sec * 1e3
    losses = [float(v) for v in losses] + [float(v)
                                           for v in chain[-steps:]]
    psum = float(sum(p.detach().double().sum() for p in model.parameters()))
    if not all(map(math.isfinite, losses + [psum])):
        raise FloatingPointError(f"diverged: losses {losses}, parameter sum "
                                 f"{psum}")
    rec = {"imgs_per_s": batch / (ms / 1e3), "step_ms": ms,
           "peak_mem_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                           if cuda else None),
           "losses": losses, "param_sum": psum}
    if profile_steps:
        if not cuda:
            raise ValueError("--profile-steps profiles the card")
        rec["profile"] = profile_device(
            lambda: [step() for _ in range(profile_steps)], top=10)
    return rec


def run(model_name="resnet50", image_size=224, batch=256, warmup=3,
        steps=10, device="cuda", seed=0, profile_steps=0) -> Dict:
    """Both modes, O2 then O0, and their ratio."""
    dev = resolve_device(device)
    rec = {"metric": f"{model_name}_train_imgs_per_s_ampO2",
           "model": model_name, "image_size": image_size, "batch": batch,
           "warmup": warmup, "steps": steps, "sgd": SGD}
    if dev.type == "cuda":
        rec["device"] = torch.cuda.get_device_name(dev)
        rec["gpu"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True).stdout.strip()
        rec["timer"] = "slope of chained steps, cuda synchronize"
    else:
        rec["device"], rec["timer"] = "cpu", "slope of chained steps"
    flags = (torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        for mode, dtype in MODES.items():
            tf32 = mode != "O0"
            torch.backends.cudnn.benchmark = mode != "O0"
            torch.backends.cudnn.allow_tf32 = tf32 and flags[1]
            torch.backends.cuda.matmul.allow_tf32 = tf32 and flags[2]
            rec[mode] = measure(dtype, model_name, image_size, batch, warmup,
                                steps, dev, seed, profile_steps)
            rec[mode]["tf32"] = torch.backends.cudnn.allow_tf32
            rec[mode]["cudnn_benchmark"] = torch.backends.cudnn.benchmark
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        (torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    rec["value"] = rec["O2"]["imgs_per_s"]
    rec["o2_over_o0"] = rec["O2"]["imgs_per_s"] / rec["O0"]["imgs_per_s"]
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="resnet50", choices=sorted(MODELS))
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile-steps", type=int, default=0)
    a = ap.parse_args(argv)
    print(json.dumps(run(a.model, a.image_size, a.batch, a.warmup, a.steps,
                         a.device, a.seed, a.profile_steps)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
