"""DCGAN training with amp: two models, two optimizers, three scaled
losses (the port of the JAX package's examples/dcgan/main_amp.py; ref
examples/dcgan/main_amp.py, ``amp.initialize([netD, netG], [optD, optG],
num_losses=3)``).

As in the JAX example, the three loss ids become D's ``AmpOptimizer``
with ``num_losses=2`` (0: the real batch, 1: the fake one) and G's with
a scaler of its own. D takes one backward per loss, unscales each with
its own scaler, sums them and hands the total to ``step_unscaled`` with
both flags: the step is skipped if either overflowed, and each scaler
advances on its own flag. The models are the JAX example's, with its
flax names and layouts carried over by ``models.convert``:

- G: ``Dense_0`` (nz -> (s/8)^2 x 256, reshaped as NHWC), then three
  times GroupNorm(8 groups, eps 1e-6), ReLU and a 4x4 stride-2
  ``ConvTranspose`` with flax's SAME padding (256 -> 128 -> 64 -> 3),
  then tanh: NHWC images in [-1, 1];
- D: three 4x4 stride-2 SAME ``Conv``s (3 -> 64 -> 128 -> 256), each
  followed by leaky ReLU 0.2, the NHWC flattening and ``Dense_0`` to one
  logit.

The port computes in NCHW and permutes at the two NHWC points (G's
reshape, D's flattening). Each layer computes in the promotion of its
input's and its parameters' dtypes, as flax's layers do (so a GroupNorm
kept fp32 under O2 hands fp32 to the next layer). The loss is the binary
cross-entropy on logits. Data are synthetic, as in JAX: each step draws
real images uniform in [-1, 1] and the latents from ``--seed``.

    python -m apex_tpu_torch.examples.dcgan.main_amp --steps 200
    python -m apex_tpu_torch.examples.dcgan.main_amp --device cpu \\
        --steps 40 --half float16 --batch-size 8

On the card unless ``--device cpu``.
"""

import argparse
import functools
import math
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch import amp
from apex_tpu_torch._kernels import resolve_device
from apex_tpu_torch.models.resnet import lecun_normal, same_padding
from apex_tpu_torch.optimizers import fused_adam

__all__ = ["Discriminator", "Generator", "bce_with_logits", "build_models",
           "parse_args", "train"]

HALF = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--opt-level", default="O2",
                   choices=["O0", "O1", "O2", "O3"])
    p.add_argument("--half", default="bfloat16", choices=sorted(HALF))
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--image-size", type=int, default=32)
    p.add_argument("--nz", type=int, default=100, help="latent dim")
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def _promote(*tensors):
    """The tensors (None allowed) cast to the promotion of their dtypes:
    flax's ``promote_dtype`` of a layer's input and parameters."""
    dt = functools.reduce(torch.promote_types,
                          [t.dtype for t in tensors if t is not None])
    return [None if t is None else t.to(dt) for t in tensors]


class Dense(nn.Module):
    """flax ``nn.Dense``: ``weight`` (out, in), ``bias``."""

    def __init__(self, cin, cout, gen):
        super().__init__()
        self.weight = nn.Parameter(lecun_normal((cin, cout), cin, gen).t()
                                   .contiguous())
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        x, w, b = _promote(x, self.weight, self.bias)
        return F.linear(x, w, b)


class Conv(nn.Module):
    """flax ``nn.Conv`` with ``'SAME'`` padding over NCHW: ``weight``
    (out, in, kh, kw), ``bias``."""

    def __init__(self, cin, cout, kernel, stride, gen):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(lecun_normal(
            (kernel, kernel, cin, cout), kernel * kernel * cin, gen)
            .permute(3, 2, 0, 1).contiguous())
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        x, w, b = _promote(x, self.weight, self.bias)
        k = w.shape[-1]
        (top, bottom), (left, right) = (same_padding(n, k, self.stride)
                                        for n in x.shape[2:])
        return F.conv2d(F.pad(x, (left, right, top, bottom)), w, b,
                        stride=self.stride)


def conv_transpose_padding(k: int, s: int) -> Tuple[int, int]:
    """``jax.lax.conv_transpose``'s ``'SAME'`` padding of the dilated
    input: ``(pad_a, pad_b)``."""
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else int(math.ceil(pad_len / 2))
    return pad_a, pad_len - pad_a


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose`` (``transpose_kernel=False``, ``'SAME'``)
    over NCHW. flax correlates the stride-dilated input with its HWIO
    kernel as it is; ``conv_transpose2d`` correlates it with its weight
    flipped and in/out swapped, so ``weight`` (in, out, kh, kw) is the
    flax kernel flipped in both spatial dims
    (``models.convert.dcgan_params_from_jax``). flax pads the dilated
    input by ``conv_transpose_padding`` (a, b); the full transposed
    convolution is padded by k - 1 on both sides, so its output is cut
    by k - 1 - a at the start and k - 1 - b at the end."""

    def __init__(self, cin, cout, kernel, stride, gen):
        super().__init__()
        self.stride = stride
        k = lecun_normal((kernel, kernel, cin, cout), kernel * kernel * cin,
                          gen)
        self.weight = nn.Parameter(k.flip(0, 1).permute(2, 3, 0, 1)
                                   .contiguous())
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        x, w, b = _promote(x, self.weight, self.bias)
        k = w.shape[-1]
        a, b_pad = conv_transpose_padding(k, self.stride)
        lo, hi = k - 1 - a, k - 1 - b_pad
        if lo == hi:
            return F.conv_transpose2d(x, w, b, stride=self.stride,
                                      padding=lo)
        y = F.conv_transpose2d(x, w, b, stride=self.stride)
        return y[..., lo:y.shape[-2] - hi, lo:y.shape[-1] - hi]


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups=8)`` (epsilon 1e-6) over NCHW: the
    statistics and the affine in fp32, the output in the promotion of
    the input's and the parameters' dtypes (``F.group_norm``, its plain
    counterpart; the JAX package has no kernel for it)."""

    def __init__(self, channels, groups=8, eps=1e-6):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        out = torch.promote_types(x.dtype, self.scale.dtype)
        y = F.group_norm(x.float(), self.groups, self.scale.float(),
                         self.bias.float(), eps=self.eps)
        return y.to(out)


class Generator(nn.Module):
    """z (b, nz) -> NHWC images (b, s, s, 3) in [-1, 1]."""

    def __init__(self, image_size, nz, gen):
        super().__init__()
        self.feat, ch = image_size // 8, 256
        self.Dense_0 = Dense(nz, self.feat * self.feat * ch, gen)
        for i, (cin, cout) in enumerate(((256, 128), (128, 64), (64, 3))):
            self.add_module(f"GroupNorm_{i}", GroupNorm(cin))
            self.add_module(f"ConvTranspose_{i}",
                            ConvTranspose(cin, cout, 4, 2, gen))

    def forward(self, z):
        x = self.Dense_0(z)
        x = x.reshape(z.shape[0], self.feat, self.feat, -1)
        x = x.permute(0, 3, 1, 2)  # flax's NHWC reshape, as NCHW
        for i in range(3):
            x = F.relu(getattr(self, f"GroupNorm_{i}")(x))
            x = getattr(self, f"ConvTranspose_{i}")(x)
        return torch.tanh(x).permute(0, 2, 3, 1)


class Discriminator(nn.Module):
    """NHWC images (b, s, s, 3) -> one logit each."""

    def __init__(self, image_size, gen):
        super().__init__()
        feat = image_size // 8
        for i, (cin, cout) in enumerate(((3, 64), (64, 128), (128, 256))):
            self.add_module(f"Conv_{i}", Conv(cin, cout, 4, 2, gen))
        self.Dense_0 = Dense(feat * feat * 256, 1, gen)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        for i in range(3):
            x = F.leaky_relu(getattr(self, f"Conv_{i}")(x), 0.2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten
        return self.Dense_0(x)[:, 0]


def build_models(image_size: int, nz: int, device="cuda", seed: int = 0):
    """(G, D) with flax's initialisation from a generator of ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    return (Generator(image_size, nz, gen).to(dev),
            Discriminator(image_size, gen).to(dev))


def bce_with_logits(logits, labels):
    """optax's ``sigmoid_binary_cross_entropy``, element-wise, in the
    logits' dtype."""
    return (-labels * F.logsigmoid(logits)
            - (1.0 - labels) * F.logsigmoid(-logits))


def train(args, models=None,
          data: Optional[Sequence[Tuple[np.ndarray, np.ndarray]]] = None,
          log: Callable[[str], None] = print,
          inject_overflow: Optional[Tuple[int, int]] = None,
          hook: Optional[Callable] = None) -> List[Dict]:
    """The example's loop; returns each step's ``errD``, ``errG``, the
    three scales after it and whether D's and G's steps were skipped.
    ``models`` (G, D) and ``data`` (one (real, z) numpy pair a step) come
    from the caller when given, else from ``--seed``. ``inject_overflow``
    (step, loss_id) poisons that D loss's gradients with inf at that
    step. ``hook(step, info)`` gets each step's tensors."""
    dev = resolve_device(args.device)
    half = HALF[args.half]
    netG, netD = models if models is not None else build_models(
        args.image_size, args.nz, dev, args.seed)
    # DCGAN betas (radford et al.): beta1 = 0.5
    netD, d_amp, policy = amp.initialize(
        netD, fused_adam(lr=args.lr, betas=(0.5, 0.999)),
        opt_level=args.opt_level, half_dtype=half, num_losses=2)
    netG, g_amp, _ = amp.initialize(
        netG, fused_adam(lr=args.lr, betas=(0.5, 0.999)),
        opt_level=args.opt_level, half_dtype=half)
    d_params = dict(netD.named_parameters())
    g_params = dict(netG.named_parameters())
    d_state, g_state = d_amp.init(d_params), g_amp.init(g_params)
    d_apply, g_apply = policy.wrap_apply(netD), policy.wrap_apply(netG)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    shape = (args.batch_size, args.image_size, args.image_size, 3)

    def d_grads(images, loss_id, label, step):
        logits = d_apply(images)
        loss = bce_with_logits(logits, torch.full_like(logits, label)).mean()
        scaled = d_amp.scale_loss(loss, d_state, loss_id=loss_id)
        grads = torch.autograd.grad(scaled, list(d_params.values()))
        if inject_overflow == (step, loss_id):
            grads = [torch.full_like(g, float("inf")) for g in grads]
        unscaled, inf = d_amp.unscale_grads(dict(zip(d_params, grads)),
                                            d_state, loss_id=loss_id)
        return loss.detach(), unscaled, inf

    records = []
    t0 = time.time()
    for step in range(args.steps):
        if data is None:
            real = torch.rand(shape, generator=gen, device=dev) * 2.0 - 1.0
            z = torch.randn(args.batch_size, args.nz, generator=gen,
                            device=dev)
        else:
            real, z = (torch.as_tensor(np.array(a), device=dev)
                       for a in data[step])
        with torch.no_grad():
            fake = g_apply(z)
        # D: one backward per loss, each with its own scaler
        err_real, g_real, inf0 = d_grads(real, 0, 1.0, step)
        err_fake, g_fake, inf1 = d_grads(fake, 1, 0.0, step)
        total = {n: g_real[n] + g_fake[n] for n in d_params}
        d_params, d_state, d_info = d_amp.step_unscaled(
            total, d_state, d_params, {0: inf0, 1: inf1})
        # G: its own optimizer and scaler, through the updated D
        logits = d_apply(g_apply(z))
        err_g = bce_with_logits(logits, torch.ones_like(logits)).mean()
        g_grads = torch.autograd.grad(g_amp.scale_loss(err_g, g_state),
                                      list(g_params.values()))
        g_params, g_state, g_info = g_amp.step(dict(zip(g_params, g_grads)),
                                               g_state, g_params)
        info = {"errD": err_real + err_fake, "errG": err_g.detach(),
                "scale_d0": d_state.scaler[0].scale,
                "scale_d1": d_state.scaler[1].scale,
                "scale_g": g_state.scaler.scale,
                "d_skipped": d_info["found_inf"],
                "g_skipped": g_info["found_inf"]}
        if hook is not None:
            hook(step, info)
        rec = {k: (bool(v) if k.endswith("skipped") else float(v))
               for k, v in info.items()}
        records.append(rec)
        if step % 10 == 0 or step == args.steps - 1:
            log(f"step {step:4d} errD {rec['errD']:8.4f} "
                f"errG {rec['errG']:8.4f} scales D0 {rec['scale_d0']:8.1f} "
                f"D1 {rec['scale_d1']:8.1f} G {rec['scale_g']:8.1f} "
                f"skipped D={rec['d_skipped']} G={rec['g_skipped']}")
    dt = time.time() - t0
    log(f"done: {args.steps} steps in {dt:.2f}s ({args.steps / dt:.1f} "
        f"steps/s) on {dev.type}")
    return records


def main(argv=None) -> int:
    train(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
