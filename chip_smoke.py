"""Drive the PyTorch/H100 port on one CUDA card, end to end.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero and no phase's exception is
swallowed:

1. device: a CUDA card must be present; prints ``nvidia-smi``'s name and
   power limit;
2. build: compiles every kernel of ``apex_tpu_torch/csrc`` with ``nvcc``
   (one process per source, all at once) and prints the seconds;
3. kernel parity: each kernel against its plain PyTorch version on the
   card, in fp32 and bf16 where it takes bf16, at the main paths' shapes
   and the edge cases (ragged lengths, a fully padded row, GQA, a sliding
   window, causal with sq != sk; Adam over GPT-2 small's 124,439,808
   parameters and a ragged length, both decay modes, steps 1 and 10);
   prints each case's error and tolerance, and checks that a second call
   on the same inputs is bit-equal; then times each kernel, its plain
   version and the one PyTorch call that computes the same function;
4. serving: GPT-2 small at full width (12 x 768, vocab 50257, 1024
   positions, seeded random weights, params fp32, compute bf16) behind
   the continuous-batching engine answers 24 requests; the launch counts
   of both forward kernels must grow during this run. Then the logits of a
   short input on the card agree with the plain path on the CPU, and in
   fp32 the engine's greedy tokens equal ``generate``'s on the same
   prompts;
5. training: ``build_gpt_training`` at GPT-2 small's full width (micro
   batch 8, global batch 16, seq 1024, lr 3e-4) on the synthetic stream,
   one warm-up step (after which every one of the 148 parameters must
   hold a finite gradient) and 8 measured steps: finite losses, every
   verdict OK, the last loss below the first, and all six kernels'
   launch counts grow. Then on a small model: loss and every gradient on
   the card agree with the CPU, 3 bf16 training steps give the CPU's
   verdicts, loss scales and losses, and an ``inject_nan`` step is
   skipped with params and Adam state bit-unchanged and the scale halved;
6. prints the ``kernels`` line, then as the last line
   ``{"ok": true, "device": {...}}``.
"""

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12         # dense tensor-core bf16
FP32_FLOPS = 67e12          # fp32 outside the tensor cores

# tolerances of kernel vs plain version, as (atol, rtol)
TOL = {
    # fp32: the same arithmetic summed in another order
    ("layer_norm_fwd", torch.float32): (1e-5, 1e-5),
    # bf16: both round an fp32 result to bf16, so they may differ by one
    # bf16 ulp (2^-8 relative)
    ("layer_norm_fwd", torch.bfloat16): (1e-2, 1e-2),
    # fp32: scalar-FMA dot products vs cuBLAS fp32 (TF32 off)
    ("flash_fwd", torch.float32): (2e-5, 1e-4),
    # bf16: the kernel rounds the unnormalised P of its running max to
    # bf16, the plain version the normalised softmax (attention.py:155)
    ("flash_fwd", torch.bfloat16): (2e-2, 2e-2),
    # dx: the same fp32 arithmetic in another order / one bf16 rounding
    ("layer_norm_bwd", torch.float32): (1e-4, 1e-4),
    ("layer_norm_bwd", torch.bfloat16): (2e-2, 2e-2),
    # dgamma, dbeta: fp32 sums over up to 8192 rows in another order
    ("layer_norm_bwd dgamma/dbeta", torch.float32): (2e-3, 1e-4),
    ("layer_norm_bwd dgamma/dbeta", torch.bfloat16): (2e-3, 1e-4),
    # fp32: scalar-FMA sums over up to 1024 keys or queries in another
    # order; bf16: one rounding of the output, and p and ds rounded to
    # bf16 from fp32 values that may differ in their last bits
    ("flash_bwd_dq", torch.float32): (1e-4, 1e-4),
    ("flash_bwd_dq", torch.bfloat16): (2e-2, 2e-2),
    ("flash_bwd_dkv", torch.float32): (1e-4, 1e-4),
    ("flash_bwd_dkv", torch.bfloat16): (2e-2, 2e-2),
    # every operation explicitly rounded as the plain version rounds it
    ("adam_update", torch.float32): (0.0, 0.0),
}
N_GPT2_SMALL = 124_439_808  # parameters of GPT-2 small (tied head)
# the kernels of each path, in the order of the kernels line
FORWARD_KERNELS = ("layer_norm_fwd", "flash_fwd")
KERNEL_META = {  # name: (source, TPU kernel it replaces)
    "layer_norm_fwd": ("apex_tpu_torch/csrc/layer_norm.cu",
                       "apex_tpu/ops/layer_norm.py:81"),
    "layer_norm_bwd": ("apex_tpu_torch/csrc/layer_norm.cu",
                       "apex_tpu/ops/layer_norm.py:90"),
    "flash_fwd": ("apex_tpu_torch/csrc/flash_attention.cu",
                  "apex_tpu/ops/attention.py:122"),
    "flash_bwd_dq": ("apex_tpu_torch/csrc/flash_attention_bwd.cu",
                     "apex_tpu/ops/attention.py:247"),
    "flash_bwd_dkv": ("apex_tpu_torch/csrc/flash_attention_bwd.cu",
                      "apex_tpu/ops/attention.py:289"),
    "adam_update": ("apex_tpu_torch/csrc/adam.cu",
                    "apex_tpu/optimizers/_fused_kernels.py:33"),
}


def log(*a):
    print(*a, flush=True)


def device_phase() -> str:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is "
                 "false); this script runs only on the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def time_ms(fn, iters: int = 50) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def check(name, dtype, case, out, ref, errors, tol_key=None):
    atol, rtol = TOL[(tol_key or name, dtype)]
    out, ref = out.float(), ref.float()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name} {case}: non-finite output")
    err = (out - ref).abs()
    bad = err > atol + rtol * ref.abs()
    mx = float(err.max()) if err.numel() else 0.0
    log(f"parity {name} {case} {str(dtype)[6:]}: max_abs_err={mx:.3e} "
        f"(atol {atol}, rtol {rtol})")
    if bool(bad.any()):
        raise AssertionError(f"{name} {case}: {int(bad.sum())} elements "
                             f"outside tolerance, max_abs_err {mx}")
    errors.setdefault(name, {})[dtype] = max(
        errors.get(name, {}).get(dtype, 0.0), mx)


# -- kernel parity ---------------------------------------------------------

def ln_inputs(rows, hidden, dtype, gen):
    x = (torch.randn(rows, hidden, generator=gen, device="cuda") * 3 + 1)
    w = torch.randn(hidden, generator=gen, device="cuda")
    b = torch.randn(hidden, generator=gen, device="cuda")
    return x.to(dtype), w, b


def ln_parity(errors):
    from apex_tpu_torch.ops import layer_norm as ln

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for dtype in (torch.float32, torch.bfloat16):
        for rows in (1, 1000, 8192):
            for hidden in (768, 1000):
                x, w, b = ln_inputs(rows, hidden, dtype, gen)
                out = ln.layer_norm(x, w, b, 1e-5)
                torch.cuda.synchronize()
                if out.dtype != dtype or out.shape != x.shape:
                    raise AssertionError("layer_norm_fwd: wrong dtype/shape")
                check("layer_norm_fwd", dtype, f"rows={rows} hidden={hidden}",
                      out, ln._ln_ref(x, w, b, 1e-5), errors)


def attn_inputs(b, h, h_kv, sq, sk, d, dtype, gen):
    q = torch.randn(b, h, sq, d, generator=gen, device="cuda").to(dtype)
    k = torch.randn(b, h_kv, sk, d, generator=gen, device="cuda").to(dtype)
    v = torch.randn(b, h_kv, sk, d, generator=gen, device="cuda").to(dtype)
    return q, k, v


def decode_kpm(lanes, sk, gen):
    """Per-lane cache lengths; lane 0 is fully padded (a dead row)."""
    lens = torch.randint(1, sk + 1, (lanes,), generator=gen, device="cuda")
    lens[0] = 0
    lens[1] = sk
    return torch.arange(sk, device="cuda")[None, :] >= lens[:, None]


def flash_cases(gen):
    """(label, q, k, v, causal, kpm, window) at the path's shapes and the
    edge cases, for one dtype at a time."""
    def cases(dtype):
        for sq in (16, 100, 1024):
            q, k, v = attn_inputs(1, 12, 12, sq, sq, 64, dtype, gen)
            yield f"prefill causal (1,12,{sq},64)", q, k, v, True, None, None
        q, k, v = attn_inputs(8, 12, 12, 1, 1024, 64, dtype, gen)
        yield ("decode (8,12,1,64) sk=1024 key-padding", q, k, v, False,
               decode_kpm(8, 1024, gen), None)
        q, k, v = attn_inputs(2, 12, 4, 300, 300, 64, dtype, gen)
        yield "GQA 12q/4kv causal (2,12,300,64)", q, k, v, True, None, None
        q, k, v = attn_inputs(1, 12, 12, 1024, 1024, 64, dtype, gen)
        yield "window=256 causal (1,12,1024,64)", q, k, v, True, None, 256
        q, k, v = attn_inputs(1, 12, 12, 77, 200, 64, dtype, gen)
        yield "causal sq!=sk (1,12,77,64) sk=200", q, k, v, True, None, None
    return cases


def flash_parity(errors):
    from apex_tpu_torch.ops import attention as at

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    cases = flash_cases(gen)
    for dtype in (torch.float32, torch.bfloat16):
        for label, q, k, v, causal, kpm, window in cases(dtype):
            scale = 1.0 / math.sqrt(q.shape[-1])
            out, lse = at._flash_kernel(q, k, v, scale, causal, kpm, window)
            torch.cuda.synchronize()
            if out.dtype != dtype or out.shape != q.shape:
                raise AssertionError("flash_fwd: wrong dtype/shape")
            ref = at._flash_ref(q, k, v, scale, causal, None, kpm, window)
            check("flash_fwd", dtype, label, out, ref, errors)
            if dtype == torch.float32:
                rl = at._flash_fwd_ref(q, k, v, scale, causal, kpm, window)[1]
                check("flash_fwd", dtype, label + " lse", lse, rl, errors)


def same_twice(name, case, first, second):
    """Asserts that a repeat call on the same inputs is bit-equal."""
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError(f"{name} {case}: a repeat call differs")


def ln_bwd_parity(errors):
    from apex_tpu_torch.ops import layer_norm as ln

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    for dtype in (torch.float32, torch.bfloat16):
        for rows in (1, 1000, 8192):
            for hidden in (768, 1000):
                x, w, _ = ln_inputs(rows, hidden, dtype, gen)
                dy = torch.randn(rows, hidden, generator=gen,
                                 device="cuda").to(dtype)
                got = ln._ln_bwd_kernel(x, w, dy, 1e-5)
                torch.cuda.synchronize()
                ref = ln._ln_bwd_ref(x, w, dy, 1e-5)
                case = f"rows={rows} hidden={hidden}"
                if got[0].dtype != dtype or got[0].shape != x.shape:
                    raise AssertionError("layer_norm_bwd: wrong dtype/shape")
                check("layer_norm_bwd", dtype, case + " dx", got[0], ref[0],
                      errors)
                for part, g, r in (("dgamma", got[1], ref[1]),
                                   ("dbeta", got[2], ref[2])):
                    check("layer_norm_bwd", dtype, f"{case} {part}", g, r,
                          errors, tol_key="layer_norm_bwd dgamma/dbeta")
                same_twice("layer_norm_bwd", case, got,
                           ln._ln_bwd_kernel(x, w, dy, 1e-5))


def flash_bwd_cases(gen):
    """(label, q, k, v, causal, kpm, window) of the training shape and the
    edge cases, for one dtype at a time."""
    def cases(dtype):
        q, k, v = attn_inputs(8, 12, 12, 1024, 1024, 64, dtype, gen)
        yield "causal (8,12,1024,64)", q, k, v, True, None, None
        q, k, v = attn_inputs(2, 12, 12, 512, 512, 64, dtype, gen)
        yield "non-causal (2,12,512,64)", q, k, v, False, None, None
        q, k, v = attn_inputs(2, 12, 4, 300, 300, 64, dtype, gen)
        yield "GQA 12q/4kv causal (2,12,300,64)", q, k, v, True, None, None
        q, k, v = attn_inputs(1, 12, 12, 1024, 1024, 64, dtype, gen)
        yield "window=256 causal (1,12,1024,64)", q, k, v, True, None, 256
        q, k, v = attn_inputs(4, 12, 12, 256, 256, 64, dtype, gen)
        yield ("key padding, dead row (4,12,256,64)", q, k, v, True,
               decode_kpm(4, 256, gen), None)
        q, k, v = attn_inputs(2, 12, 12, 100, 100, 64, dtype, gen)
        yield "ragged s=100 causal (2,12,100,64)", q, k, v, True, None, None
        q, k, v = attn_inputs(1, 12, 12, 77, 200, 64, dtype, gen)
        yield "causal sq!=sk (1,12,77,64) sk=200", q, k, v, True, None, None
    return cases


def flash_bwd_parity(errors):
    from apex_tpu_torch.ops import attention as at

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    cases = flash_bwd_cases(gen)
    for dtype in (torch.float32, torch.bfloat16):
        for label, q, k, v, causal, kpm, window in cases(dtype):
            scale = 1.0 / math.sqrt(q.shape[-1])
            args = (scale, causal, kpm, window)
            o, lse = at._flash_kernel(q, k, v, *args)
            do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
            delta = (do.float() * o.float()).sum(-1)
            got = at._flash_bwd_kernel(q, k, v, do, lse, delta, *args)
            torch.cuda.synchronize()
            ref = at._flash_bwd_ref(q, k, v, do, lse, delta, *args)
            for g, r, t in zip(got, ref, (q, k, v)):
                if g.dtype != dtype or g.shape != t.shape:
                    raise AssertionError("flash backward: wrong dtype/shape")
            check("flash_bwd_dq", dtype, label + " dq", got[0], ref[0],
                  errors)
            check("flash_bwd_dkv", dtype, label + " dk", got[1], ref[1],
                  errors)
            check("flash_bwd_dkv", dtype, label + " dv", got[2], ref[2],
                  errors)
            if kpm is not None and torch.count_nonzero(got[0][0]) != 0:
                raise AssertionError("flash backward: the dead row has a "
                                     "nonzero dq")
            same_twice("flash backward", label, got, at._flash_bwd_kernel(
                q, k, v, do, lse, delta, *args))


def adam_inputs(n, gen):
    g, p, m = (torch.randn(n, generator=gen, device="cuda") for _ in range(3))
    v = torch.rand(n, generator=gen, device="cuda") * 1e-2
    return g, p, m * 1e-1, v


ADAM_HYPER = dict(lr=3e-4, beta1=0.9, beta2=0.999, eps=1e-8,
                  weight_decay=0.01)


def adam_parity(errors):
    from apex_tpu_torch.optimizers import _fused_kernels as fk

    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    for n in (N_GPT2_SMALL, 1_000_003):
        g, p, m, v = adam_inputs(n, gen)
        for adam_w_mode in (True, False):
            for step in (1, 10):
                stepf = torch.tensor(float(step), device="cuda")
                bc1, bc2 = 1.0 - 0.9 ** stepf, 1.0 - 0.999 ** stepf
                kw = dict(ADAM_HYPER, adam_w_mode=adam_w_mode)
                got = fk._adam_kernel(g, p, m, v, bc1, bc2, **kw)
                torch.cuda.synchronize()
                ref = fk._adam_flat_ref(g, p, m, v, bc1, bc2, **kw)
                case = (f"n={n} {'adamw' if adam_w_mode else 'l2'} "
                        f"step={step}")
                for part, a, b in zip(("update", "m", "v"), got, ref):
                    check("adam_update", torch.float32, f"{case} {part}", a, b,
                          errors)
                same_twice("adam_update", case, got,
                           fk._adam_kernel(g, p, m, v, bc1, bc2, **kw))
                del got, ref


# -- kernel timing ---------------------------------------------------------

def bound(bytes_moved, flops, peak_flops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def time_layer_norm(rows, hidden):
    import torch.nn.functional as F

    from apex_tpu_torch.ops import layer_norm as ln

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    x, w, b = ln_inputs(rows, hidden, torch.bfloat16, gen)
    wl, bl = w.to(x.dtype), b.to(x.dtype)
    esize = x.element_size()
    b_ms, by = bound(2 * rows * hidden * esize + 2 * hidden * 4,
                     8 * rows * hidden, FP32_FLOPS)
    err = float((ln.layer_norm(x, w, b) .float()
                 - ln._ln_ref(x, w, b, 1e-5).float()).abs().max())
    return {
        "shape": f"x ({rows},{hidden}) bf16",
        "max_abs_err": err,
        "ms": time_ms(lambda: ln.layer_norm(x, w, b)),
        "plain_ms": time_ms(lambda: ln._ln_ref(x, w, b, 1e-5)),
        "bound_ms": b_ms, "bound_by": by,
        "library_ms": time_ms(lambda: F.layer_norm(x, (hidden,), wl, bl)),
    }


def time_flash(label, q, k, v, causal, kpm):
    import torch.nn.functional as F

    from apex_tpu_torch.ops import attention as at

    b, h, sq, d = q.shape
    sk = k.shape[2]
    scale = 1.0 / math.sqrt(d)
    # the (query, key) pairs this run's masks keep, and the keys it needs
    keep = torch.ones(b, sq, sk, dtype=torch.bool, device="cuda")
    if causal:
        keep &= ~at.causal_mask(sq, sk, "cuda")
    if kpm is not None:
        keep &= ~kpm[:, None, :]
    pairs = int(keep.sum()) * h
    keys = int(keep.any(dim=1).sum()) * k.shape[1]
    esize = q.element_size()
    b_ms, by = bound((2 * q.numel() + 2 * keys * d) * esize
                     + b * h * sq * 4 + (kpm.numel() if kpm is not None else 0),
                     4 * pairs * d, BF16_FLOPS)
    out = at.flash_attention(q, k, v, causal=causal, key_padding_mask=kpm)
    ref = at._flash_ref(q, k, v, scale, causal, None, kpm)
    attn_mask = None if kpm is None else ~kpm[:, None, None, :]
    return {
        "shape": label,
        "max_abs_err": float((out.float() - ref.float()).abs().max()),
        "ms": time_ms(lambda: at.flash_attention(
            q, k, v, causal=causal, key_padding_mask=kpm)),
        "plain_ms": time_ms(lambda: at._flash_ref(
            q, k, v, scale, causal, None, kpm)),
        "bound_ms": b_ms, "bound_by": by,
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, is_causal=causal, scale=scale)),
    }


def time_layer_norm_bwd(rows, hidden):
    import torch.nn.functional as F

    from apex_tpu_torch.ops import layer_norm as ln

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    x, w, b = ln_inputs(rows, hidden, torch.bfloat16, gen)
    dy = torch.randn(rows, hidden, generator=gen, device="cuda").bfloat16()
    # reads x and dy, writes dx (bf16); reads w, writes dgamma and dbeta
    b_ms, by = bound(3 * rows * hidden * 2 + 3 * hidden * 4,
                     12 * rows * hidden, FP32_FLOPS)
    got = ln._ln_bwd_kernel(x, w, dy, 1e-5)
    ref = ln._ln_bwd_ref(x, w, dy, 1e-5)
    xl = x.detach().requires_grad_(True)
    wl = w.bfloat16().requires_grad_(True)
    bl = b.bfloat16().requires_grad_(True)
    yl = F.layer_norm(xl, (hidden,), wl, bl)
    return {
        "shape": f"x, dy ({rows},{hidden}) bf16",
        "max_abs_err": float((got[0].float() - ref[0].float()).abs().max()),
        "ms": time_ms(lambda: ln._ln_bwd_kernel(x, w, dy, 1e-5)),
        "plain_ms": time_ms(lambda: ln._ln_bwd_ref(x, w, dy, 1e-5)),
        "bound_ms": b_ms, "bound_by": by,
        "library_ms": time_ms(lambda: torch.autograd.grad(
            yl, (xl, wl, bl), dy, retain_graph=True)),
    }


def time_flash_bwd(gen):
    """dq and dk/dv at the training shape, (8, 12, 1024, 64) bf16 causal.
    The plain version and the library call compute the whole backward
    (dq, dk and dv) and stand in both rows."""
    import torch.nn.functional as F

    from apex_tpu_torch.ops import attention as at

    b, h, s, d = 8, 12, 1024, 64
    q, k, v = attn_inputs(b, h, h, s, s, d, torch.bfloat16, gen)
    do = torch.randn(q.shape, generator=gen, device="cuda").bfloat16()
    scale = 1.0 / math.sqrt(d)
    o, lse = at._flash_kernel(q, k, v, scale, True)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, scale, True)
    pairs = b * h * s * (s + 1) // 2  # (query, key) pairs the mask keeps
    got = at._flash_bwd_kernel(*args)
    ref = at._flash_bwd_ref(*args)
    plain_ms = time_ms(lambda: at._flash_bwd_ref(*args), iters=10)
    qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                              scale=scale)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(), (qs, ks, vs), do)

    with torch.no_grad():
        fwd_ms = time_ms(sdpa)
    library_ms = time_ms(sdpa_fwd_bwd) - fwd_ms
    tensor = b * h * s * d * 2  # bytes of one bf16 (b, h, s, d) tensor
    rows = b * h * s * 4  # bytes of one fp32 (b, h, s) row vector
    dq_bound = bound(5 * tensor + 2 * rows, 3 * 2 * pairs * d, BF16_FLOPS)
    dkv_bound = bound(6 * tensor + 2 * rows, 4 * 2 * pairs * d, BF16_FLOPS)
    label = f"q,k,v,dO ({b},{h},{s},{d}) bf16 causal"
    out = []
    for idx, bnd in (([0], dq_bound), ([1, 2], dkv_bound)):
        err = max(float((got[i].float() - ref[i].float()).abs().max())
                  for i in idx)
        out.append({"shape": label, "max_abs_err": err,
                    "bound_ms": bnd[0], "bound_by": bnd[1],
                    "plain_ms": plain_ms, "library_ms": library_ms})
    out[0]["ms"], out[1]["ms"] = time_flash_bwd_kernels(*args)
    return [out[0]], [out[1]]


def time_flash_bwd_kernels(q, k, v, do, lse, delta, scale, causal):
    """Device ms of the dq and of the dk/dv kernel alone at these inputs
    (the wrapper's reshapes done once, outside the timed launches)."""
    from apex_tpu_torch import _kernels

    b, h, sq, d = q.shape
    h_kv, sk = k.shape[1], k.shape[2]
    q3, do3 = (t.reshape(b * h, sq, d).contiguous() for t in (q, do))
    k3, v3 = (t.reshape(b * h_kv, sk, d).contiguous() for t in (k, v))
    dq, dk, dv = (torch.empty_like(t) for t in (q3, k3, v3))
    lse, delta = lse.contiguous(), delta.contiguous()
    ins = (q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), do3.data_ptr(),
           lse.data_ptr(), delta.data_ptr(), None)
    common = (b * h, sq, sk, d, h, h // h_kv, float(scale), int(causal), 0,
              _kernels.dtype_code(q))
    return (time_ms(lambda: _kernels.FLASH_BWD_DQ(*ins, dq.data_ptr(),
                                                  *common)),
            time_ms(lambda: _kernels.FLASH_BWD_DKV(
                *ins, dk.data_ptr(), dv.data_ptr(), *common)))


def time_adam(n):
    from apex_tpu_torch.optimizers import _fused_kernels as fk

    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    g, p, m, v = adam_inputs(n, gen)
    stepf = torch.tensor(10.0, device="cuda")
    bc1, bc2 = 1.0 - 0.9 ** stepf, 1.0 - 0.999 ** stepf
    kw = dict(ADAM_HYPER, adam_w_mode=True)
    got = fk._adam_kernel(g, p, m, v, bc1, bc2, **kw)
    ref = fk._adam_flat_ref(g, p, m, v, bc1, bc2, **kw)
    err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    del got, ref
    # reads g, p, m, v and writes the update, m and v, all fp32
    b_ms, by = bound(7 * 4 * n, 12 * n, FP32_FLOPS)
    pl = torch.nn.Parameter(p.clone())
    pl.grad = g.clone()
    opt = torch.optim.AdamW([pl], lr=ADAM_HYPER["lr"], eps=ADAM_HYPER["eps"],
                            weight_decay=ADAM_HYPER["weight_decay"],
                            fused=True)
    return {
        "shape": f"g, p, m, v ({n},) fp32, AdamW",
        "max_abs_err": err,
        "ms": time_ms(lambda: fk._adam_kernel(g, p, m, v, bc1, bc2, **kw),
                      iters=20),
        "plain_ms": time_ms(lambda: fk._adam_flat_ref(
            g, p, m, v, bc1, bc2, **kw), iters=10),
        "bound_ms": b_ms, "bound_by": by,
        "library_ms": time_ms(opt.step, iters=20),
    }


def kernel_timings():
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    out = {"layer_norm_fwd": [time_layer_norm(768, 768),
                              time_layer_norm(8, 768)]}
    q, k, v = attn_inputs(1, 12, 12, 768, 768, 64, torch.bfloat16, gen)
    prefill = time_flash("prefill causal q,k,v (1,12,768,64) bf16",
                         q, k, v, True, None)
    q, k, v = attn_inputs(8, 12, 12, 1, 1024, 64, torch.bfloat16, gen)
    lens = torch.tensor([32, 100, 300, 500, 700, 800, 900, 1024],
                        device="cuda")
    kpm = torch.arange(1024, device="cuda")[None, :] >= lens[:, None]
    decode = time_flash("decode q (8,12,1,64) k,v (8,12,1024,64) bf16 "
                        "key-padding", q, k, v, False, kpm)
    out["flash_fwd"] = [prefill, decode]
    out["layer_norm_bwd"] = [time_layer_norm_bwd(8192, 768)]
    out["flash_bwd_dq"], out["flash_bwd_dkv"] = time_flash_bwd(gen)
    out["adam_update"] = [time_adam(N_GPT2_SMALL)]
    for name, rows in out.items():
        for r in rows:
            log(f"time {name} {r['shape']}: kernel {r['ms']:.4f} ms, plain "
                f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
                f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return out


# -- serving ---------------------------------------------------------------

def serving_phase(smi):
    from apex_tpu_torch import _kernels
    from apex_tpu_torch.models import GPTModel, generate, gpt2_small_config
    from apex_tpu_torch.serving.profile import (
        make_requests,
        serve,
        serving_config,
    )

    cfg = serving_config(SEED)
    mcfg = gpt2_small_config()
    model = GPTModel(mcfg, device="cuda", seed=SEED)
    rs = np.random.RandomState(SEED)
    serve(model, make_requests(1, mcfg.vocab_size, rs), cfg)  # warm-up

    requests = make_requests(24, mcfg.vocab_size, rs)
    _kernels.reset_launch_counts()
    eng, reqs, wall = serve(model, requests, cfg)
    launches = _kernels.launch_counts()
    stats = eng.stats()
    done = stats["terminal"].get("completed", 0)
    if done != len(reqs):
        raise AssertionError(f"only {done} of {len(reqs)} requests "
                             f"completed: {stats['terminal']}")
    for r in reqs:
        if len(r.tokens_out) != r.max_new_tokens or not all(
                0 <= t < mcfg.vocab_size for t in r.tokens_out):
            raise AssertionError(f"request {r.rid}: bad tokens")
    for name in FORWARD_KERNELS:
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 f"serving run")
    serving = {
        "model": "gpt2-small 12x768 vocab 50257 (random weights, bf16)",
        "requests": len(reqs), "completed": done,
        "tokens_out": stats["tokens_out"],
        "wall_s": wall, "tokens_per_s": stats["tokens_out"] / wall,
        "ttft_p50_ms": stats["ttft_p50_s"] * 1e3,
        "per_token_p50_ms": stats["per_token_p50_s"] * 1e3,
        "ticks": stats["ticks"], "launches": launches, "gpu": smi,
    }
    log("serving " + json.dumps(serving))

    # logits of a short input: kernels on the card vs plain path on CPU
    tokens = torch.as_tensor(rs.randint(0, mcfg.vocab_size, (1, 64)))
    f32 = gpt2_small_config(compute_dtype=torch.float32)
    gpu32 = GPTModel(f32, device="cuda", seed=SEED)
    cpu32 = GPTModel(f32, device="cpu", seed=SEED)
    cpu32.load_state_dict({k: v.cpu() for k, v in gpu32.state_dict().items()})
    with torch.no_grad():
        lg = gpu32(tokens.cuda()).cpu()
        lc = cpu32(tokens)
    if lg.shape != (1, 64, mcfg.vocab_size) or not torch.isfinite(lg).all():
        raise AssertionError("logits: wrong shape or non-finite")
    lerr = float((lg - lc).abs().max())
    log(f"logits card vs cpu plain (fp32, 1x64 tokens): max_abs_err="
        f"{lerr:.3e} (atol 2e-3)")
    if lerr > 2e-3:
        raise AssertionError(f"logits disagree with the plain path: {lerr}")

    # exact tokens: the engine's greedy decode equals generate's, in fp32
    reqs32 = make_requests(4, mcfg.vocab_size, rs)
    eng32, out32, _ = serve(gpu32, [(p[:200], 16) for p, _ in reqs32], cfg)
    for r in out32:
        want = generate(gpu32, r.prompt[None], r.max_new_tokens)
        want = want[0, r.prompt_len:].tolist()
        if r.tokens_out != want:
            raise AssertionError(f"request {r.rid}: engine {r.tokens_out} "
                                 f"!= generate {want}")
    log(f"engine == generate on {len(out32)} fp32 greedy requests")
    return launches, serving


# -- training --------------------------------------------------------------

TRAIN_STEPS = 8


def training_phase(smi):
    """GPT-2 small at full width through ``build_gpt_training``: one
    warm-up step, then TRAIN_STEPS measured steps."""
    from apex_tpu_torch import _kernels
    from apex_tpu_torch.data import LMDataset
    from apex_tpu_torch.models import gpt2_small_config
    from apex_tpu_torch.resilience import VERDICT_OK, verdict_name
    from apex_tpu_torch.resilience.replay import (
        GPTTargetConfig,
        build_gpt_training,
        synthetic_corpus,
    )

    cfg = GPTTargetConfig(vocab=50257, seq_len=1024, layers=12, hidden=768,
                          heads=12, micro_batch=8, global_batch=16, lr=3e-4,
                          weight_decay=0.01, seed=SEED)
    tr = build_gpt_training(cfg, device="cuda")
    if tr.transformer_config != gpt2_small_config():
        raise AssertionError("the training target is not GPT-2 small")
    state = tr.init_state()
    n_params = sum(p.numel() for p in state.params.values())
    if len(state.params) != 148 or n_params != N_GPT2_SMALL:
        raise AssertionError(f"{len(state.params)} parameters of "
                             f"{n_params} elements")
    lm = LMDataset(synthetic_corpus(cfg.vocab), cfg.seq_len)

    def batch(i):
        first = (i * cfg.global_batch) % (len(lm) - cfg.global_batch + 1)
        return tr.reshape_batch(*lm.batch(range(first,
                                                first + cfg.global_batch)))

    state, loss0, verdict0, _ = tr.train_step(state, *batch(0))  # warm-up
    torch.cuda.synchronize()
    bad = [n for n, p in state.params.items()
           if p.grad is None or not bool(torch.isfinite(p.grad).all())]
    if bad or verdict0 != VERDICT_OK:
        raise AssertionError(f"warm-up step: verdict {verdict0}, no finite "
                             f"gradient for {bad}")
    log(f"training warm-up: loss {loss0:.4f}; all 148 parameters got a "
        f"finite gradient")

    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    steps, t_all = [], 0.0
    for i in range(1, TRAIN_STEPS + 1):
        x, y = batch(i)
        t0 = time.perf_counter()
        state, loss, verdict, metrics = tr.train_step(state, x, y)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        t_all += ms
        steps.append(dict(step=i, loss=loss, grad_norm=metrics["grad_norm"],
                          loss_scale=metrics["loss_scale"],
                          verdict=verdict_name(verdict), step_ms=ms))
        log(f"train step {i} loss {loss:.4f} grad_norm "
            f"{metrics['grad_norm']:.4f} loss_scale "
            f"{metrics['loss_scale']:.1f} verdict {verdict_name(verdict)} "
            f"step_ms {ms:.2f}")
    launches = _kernels.launch_counts()
    tokens = TRAIN_STEPS * cfg.global_batch * cfg.seq_len
    losses = [r["loss"] for r in steps]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if any(r["verdict"] != "ok" for r in steps):
        raise AssertionError(f"verdicts: {[r['verdict'] for r in steps]}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    for name in KERNEL_META:
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 f"training run")
    training = {
        "model": "gpt2-small 12x768 vocab 50257 (random weights, bf16 "
                 "compute, fp32 params)",
        "micro_batch": cfg.micro_batch, "global_batch": cfg.global_batch,
        "seq_len": cfg.seq_len, "steps": TRAIN_STEPS,
        "tokens_per_s": tokens / (t_all / 1e3),
        "step_ms_mean": t_all / TRAIN_STEPS,
        "step_ms_min": min(r["step_ms"] for r in steps),
        "first_loss": losses[0], "last_loss": losses[-1],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches,
        "launches_per_step": {k: n / TRAIN_STEPS for k, n in launches.items()},
        "gpu": smi,
    }
    log(f"training: {training['tokens_per_s']:.1f} tokens/s over "
        f"{TRAIN_STEPS} steps of {cfg.global_batch} x {cfg.seq_len} tokens")
    log("training " + json.dumps(training))
    del tr, state
    torch.cuda.empty_cache()
    return launches, training


SMALL_TARGET = dict(vocab=512, seq_len=64, layers=2, hidden=128, heads=2,
                    micro_batch=2, global_batch=4)


def training_card_vs_plain():
    """The repair check and the step's control flow, card against CPU."""
    from apex_tpu_torch.data import LMDataset
    from apex_tpu_torch.models import GPTModel, gpt_loss_fn
    from apex_tpu_torch.resilience import VERDICT_SKIP
    from apex_tpu_torch.resilience.replay import (
        GPTTargetConfig,
        build_gpt_training,
        synthetic_corpus,
    )
    from apex_tpu_torch.transformer import TransformerConfig

    # loss and every gradient of a small fp32 GPT: the kernels' backward
    # against the plain backward on the CPU; 1e-5 + 1e-3 relative (fp32
    # sums in another order through two layers)
    tcfg = TransformerConfig(num_layers=2, hidden_size=128,
                             num_attention_heads=2, vocab_size=512,
                             max_position_embeddings=64, hidden_dropout=0.0,
                             attention_dropout=0.0,
                             compute_dtype=torch.float32)
    gpu = GPTModel(tcfg, device="cuda", seed=SEED)
    cpu = GPTModel(tcfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    rs = np.random.RandomState(SEED + 9)
    tokens = torch.as_tensor(rs.randint(0, 512, (2, 64)))
    labels = torch.as_tensor(rs.randint(0, 512, (2, 64)))
    lg = gpt_loss_fn(gpu(tokens.cuda(), labels=labels.cuda()))
    lg.backward()
    lc = gpt_loss_fn(cpu(tokens, labels=labels))
    lc.backward()
    named = dict(cpu.named_parameters())
    gerr = 0.0
    for name, p in gpu.named_parameters():
        ref = named[name].grad
        if p.grad is None or not bool(torch.isfinite(p.grad).all()):
            raise AssertionError(f"{name}: no finite gradient on the card")
        err = (p.grad.cpu() - ref).abs()
        if bool((err > 1e-5 + 1e-3 * ref.abs()).any()):
            raise AssertionError(f"{name}: card gradient differs by "
                                 f"{float(err.max())}")
        gerr = max(gerr, float(err.max()))
    lerr = abs(lg.item() - lc.item())
    log(f"small GPT fp32 card vs cpu: loss err {lerr:.3e}, max grad err "
        f"{gerr:.3e} over {len(named)} parameters (atol 1e-5, rtol 1e-3)")
    if lerr > 1e-4:
        raise AssertionError(f"loss differs by {lerr}")

    # 3 bf16 steps of the small target from the same init: the same
    # verdicts and loss scales, losses within 1e-2 relative (bf16
    # activations rounded at the same points, summed in another order)
    cfg = GPTTargetConfig(**SMALL_TARGET)
    tg, tc = (build_gpt_training(cfg, device=d) for d in ("cuda", "cpu"))
    sg, sc = tg.init_state(), tc.init_state()
    tc.model.load_state_dict({k: v.cpu()
                              for k, v in tg.model.state_dict().items()})
    lm = LMDataset(synthetic_corpus(cfg.vocab, 20_000), cfg.seq_len)
    for i in range(3):
        x, y = tg.reshape_batch(*lm.batch(range(4 * i, 4 * i + 4)))
        sg, loss_g, v_g, m_g = tg.train_step(sg, x, y)
        sc, loss_c, v_c, m_c = tc.train_step(sc, x, y)
        log(f"small target step {i}: card loss {loss_g:.5f} cpu loss "
            f"{loss_c:.5f}, verdicts {v_g}/{v_c}, loss scales "
            f"{m_g['loss_scale']}/{m_c['loss_scale']}")
        if (v_g, m_g["loss_scale"]) != (v_c, m_c["loss_scale"]):
            raise AssertionError("card and cpu steps disagree")
        if abs(loss_g - loss_c) > 1e-2 * abs(loss_c):
            raise AssertionError(f"losses differ: {loss_g} vs {loss_c}")

    # an inject_nan step: SKIP, params and Adam state bit-unchanged, the
    # loss scale halved
    params = {n: p.detach().clone() for n, p in sg.params.items()}
    moments = {n: (sg.opt.exp_avg[n].clone(), sg.opt.exp_avg_sq[n].clone())
               for n in sg.params}
    step, scale = int(sg.opt.step), float(sg.scaler.scale)
    x, y = tg.reshape_batch(*lm.batch(range(12, 16)))
    sg, loss, verdict, metrics = tg.train_step(sg, x, y, inject_nan=1.0)
    same = all(torch.equal(p, params[n]) and
               torch.equal(sg.opt.exp_avg[n], moments[n][0]) and
               torch.equal(sg.opt.exp_avg_sq[n], moments[n][1])
               for n, p in sg.params.items())
    if not (verdict == VERDICT_SKIP and same and int(sg.opt.step) == step
            and metrics["loss_scale"] == scale / 2):
        raise AssertionError(f"inject_nan step: verdict {verdict}, state "
                             f"unchanged {same}, scale "
                             f"{metrics['loss_scale']} (was {scale})")
    log(f"inject_nan step: verdict skip, params and Adam state bit-unchanged,"
        f" loss scale {scale} -> {metrics['loss_scale']}")


def main():
    smi = device_phase()

    from apex_tpu_torch import _kernels

    log(f"build: {_kernels.build_all():.1f} s")

    errors = {}
    ln_parity(errors)
    flash_parity(errors)
    ln_bwd_parity(errors)
    flash_bwd_parity(errors)
    adam_parity(errors)
    timings = kernel_timings()

    serve_launches, _ = serving_phase(smi)
    train_launches, _ = training_phase(smi)
    training_card_vs_plain()

    kernels = []
    for name, (source, replaces) in KERNEL_META.items():
        main_shape, *others = timings[name]
        path = serve_launches if name in FORWARD_KERNELS else train_launches
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": path[name],
            "launches_by_path": {"serving": serve_launches[name],
                                 "training": train_launches[name]},
            **main_shape,
            "max_abs_err_parity": {str(d)[6:]: e
                                   for d, e in errors[name].items()},
            "other_shapes": others,
        })
    log(json.dumps({"kernels": kernels, "gpu": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
