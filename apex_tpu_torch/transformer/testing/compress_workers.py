"""Rank functions of the compressed-collective and ZeRO checks, for
:func:`~apex_tpu_torch.transformer.testing.distributed_test_base.spawn`
(``tests/test_torch_compress.py``, ``tests/test_torch_zero_compress.py``
and ``chip_smoke.py``).

Each worker runs the port's side of its cases on its rank and returns
numpy arrays by name; the caller holds them against the JAX package's
functions on its CPU mesh, or against another run. A case names the
ranks ``[0, n)`` of its group; every rank builds every group, as
``torch.distributed.new_group`` requires, and the ranks outside a case
skip it. Inputs are numpy arrays made from seeds by the caller, stacked
by rank; bf16 values travel as fp32, which holds them exactly.
"""

from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from apex_tpu_torch.parallel import compress
from apex_tpu_torch.parallel import parallel_state as ps

__all__ = ["collectives_worker", "ddp_compressed_worker",
           "zero_bytes_worker", "zero_worker"]


def _np(t):
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).cpu().numpy()
    return t.detach().float().cpu().numpy() if t.is_floating_point() \
        else t.detach().cpu().numpy()


def _groups(cases: Dict):
    return {n: dist.new_group(list(range(n)))
            for n in sorted({c["n"] for c in cases.values()})}


def collectives_worker(rank: int, world_size: int, cases: Dict,
                       device: str = "cpu"):
    """``cases``: {name: dict(kind, n, config, x)} with ``kind`` one of
    "psum" (``quantized_psum`` with the transmitted value), "scatter"
    (``quantized_psum_scatter``, ditto), "gather"
    (``quantized_all_gather``) and "telescope" (``x`` a (steps, n, ...)
    series of gradients: each step's ``quantized_psum`` of ``g + e`` and
    ``ef_update``; returns the sum of what this rank sent, the last
    residual and the sum of its gradients). Returns each case's outputs
    and what ``parallel_state.STAGED`` counted during it."""
    groups = _groups(cases)
    out = {}
    for name, c in cases.items():
        if rank >= c["n"]:
            continue
        group, cfg = groups[c["n"]], compress.CompressionConfig(**c["config"])
        before = dict(ps.STAGED)
        kind = c["kind"]
        if kind == "telescope":
            series = torch.tensor(np.asarray(c["x"])[:, rank], device=device)
            ef = torch.zeros_like(series[0])
            sent_sum = torch.zeros_like(series[0])
            for g in series:
                acc = g + ef
                _, sent = compress.quantized_psum(acc, group, cfg,
                                                  return_transmitted=True)
                ef = compress.ef_update(acc, sent)
                sent_sum = sent_sum + sent
            res = dict(sent_sum=_np(sent_sum), residual=_np(ef),
                       grad_sum=_np(series.sum(0)))
        else:
            x = torch.tensor(np.asarray(c["x"])[rank], device=device)
            if kind == "psum":
                y, sent = compress.quantized_psum(x, group, cfg,
                                                  return_transmitted=True)
                res = dict(y=_np(y), sent=_np(sent))
            elif kind == "scatter":
                y, sent = compress.quantized_psum_scatter(
                    x, group, cfg, return_transmitted=True)
                res = dict(y=_np(y), sent=_np(sent))
            else:
                res = dict(y=_np(compress.quantized_all_gather(x, group,
                                                               cfg)))
        res["staged"] = {k: ps.STAGED[k] - v for k, v in before.items()}
        out[name] = res
    return out


def ddp_compressed_worker(rank: int, world_size: int, cases: Dict):
    """``all_reduce_gradients`` with compression over the world, each
    case's ``grads`` a list of steps of {name: (world, ...)} arrays and
    its ``kw`` the call's options: each step's reduced gradients and the
    residuals after it (error feedback on), or the reduced gradients
    alone (``kw["ef"]`` False)."""
    from apex_tpu_torch.parallel.ddp import all_reduce_gradients

    world = dist.group.WORLD
    out = {}
    for name, c in cases.items():
        kw = dict(c["kw"])
        cfg = compress.CompressionConfig(**kw.pop("config"))
        use_ef = kw.pop("ef")
        ef, steps = None, []
        for g in c["grads"]:
            grads = {k: torch.tensor(v[rank]) for k, v in g.items()}
            if use_ef:
                if ef is None:
                    ef = compress.ef_init(grads)
                red, ef = all_reduce_gradients(grads, world, compression=cfg,
                                               ef_state=ef, **kw)
                steps.append(dict(grads={k: _np(v) for k, v in red.items()},
                                  ef={k: _np(v) for k, v in ef.items()}))
            else:
                red = all_reduce_gradients(grads, world, compression=cfg,
                                           **kw)
                steps.append(dict(grads={k: _np(v) for k, v in red.items()}))
        out[name] = steps
    return out


def zero_worker(rank: int, world_size: int, cases: Dict,
                device: str = "cpu"):
    """ZeRO optimizers over a group of ranks ``[0, n)``: each case's
    ``opt`` ("adam" or "lamb") with ``hyper`` (a ``compression`` dict
    becomes a ``CompressionConfig``), from ``params`` (``bf16`` casts
    them), through ``grads`` (steps of {name: (n, ...)}): the final
    params, the state's fields and the state's master bytes."""
    from apex_tpu_torch.optimizers import (
        distributed_fused_adam,
        distributed_fused_lamb,
    )

    groups = _groups(cases)
    out = {}
    for name, c in cases.items():
        if rank >= c["n"]:
            continue
        hyper = dict(c["hyper"])
        if hyper.get("compression") is not None:
            hyper["compression"] = compress.CompressionConfig(
                **hyper["compression"])
        make = {"adam": distributed_fused_adam,
                "lamb": distributed_fused_lamb}[c["opt"]]
        opt = make(group=groups[c["n"]], **hyper)
        dtype = torch.bfloat16 if c.get("bf16") else torch.float32
        params = {k: torch.tensor(v, device=device).to(dtype)
                  for k, v in c["params"].items()}
        state = opt.init(params)
        for g in c["grads"]:
            grads = {k: torch.tensor(v[rank], device=device).to(dtype)
                     for k, v in g.items()}
            updates, state = opt.update(grads, state, params)
            params = {k: (params[k] + updates[k]).to(dtype) for k in params}
        out[name] = dict(
            params={k: _np(v) for k, v in params.items()},
            master_shard=_np(state.master_shard),
            master_bytes=state.master_shard.nbytes,
            exp_avg=_np(state.exp_avg), ef_residual=_np(state.ef_residual),
            step=int(state.step))
    return out


def zero_bytes_worker(rank: int, world_size: int, shapes: Dict, steps: int,
                      device: str = "cuda", seed: int = 0):
    """The ZeRO optimizers over a model's parameter ``shapes`` (name:
    shape, so the flat layout is the model's) at dp =
    ``world_size`` on ``device``, gradients drawn from ``seed`` on the
    device: ``distributed_fused_lamb`` exact and int8-compressed, and
    ``distributed_fused_adam`` over the shapes in bf16 with
    ``store_param_remainders`` and over the same bf16 values in fp32.
    Returns the launch counts of each run, the staged collectives and
    bytes a step, each run's ms a step, the master state's bytes, the
    rebuilt master's bits against the fp32 run's (bit for bit) and the
    compressed LAMB's parameters against the exact one's."""
    import time

    from apex_tpu_torch import _kernels
    from apex_tpu_torch.optimizers import (
        distributed_fused_adam,
        distributed_fused_lamb,
    )
    from apex_tpu_torch.optimizers.distributed_fused_adam import (
        master_from_remainder,
        split_master,
    )

    group = dist.group.WORLD
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(scale):
        return {n: torch.randn(s, generator=gen, device=device) * scale
                for n, s in shapes.items()}

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    base = draw(0.02)
    # bf16 values, so the bf16 and fp32 runs take the same gradients
    grads = [{k: v.to(torch.bfloat16).float() for k, v in draw(1e-3).items()}
             for _ in range(steps)]
    out = {}

    def run(opt, params, dtype):
        params = {k: v.to(dtype) for k, v in params.items()}
        state = opt.init(params)
        _kernels.reset_launch_counts()
        before = dict(ps.STAGED)
        sync()
        t0 = time.perf_counter()
        for g in grads:
            upd, state = opt.update({k: v.to(dtype) for k, v in g.items()},
                                    state, params)
            params = {k: (params[k] + upd[k]).to(dtype) for k in params}
        sync()
        ms = (time.perf_counter() - t0) * 1e3 / steps
        staged = {k: (ps.STAGED[k] - v) / steps for k, v in before.items()}
        return params, state, dict(ms=ms, staged=staged,
                                   launches=_kernels.launch_counts())

    lamb = {}
    for label, comp in (("exact", None), ("int8", compress.CompressionConfig(
            "int8"))):
        p, state, rec = run(distributed_fused_lamb(group=group,
                                                   compression=comp),
                            base, torch.float32)
        lamb[label] = p
        out[f"lamb_{label}"] = rec
    diff = max(float((lamb["int8"][k] - lamb["exact"][k]).abs().max())
               for k in base)
    out["lamb_int8_vs_exact_max_abs"] = diff

    bf16 = {k: v.to(torch.bfloat16) for k, v in base.items()}
    p_rem, s_rem, rec = run(distributed_fused_adam(
        group=group, store_param_remainders=True), bf16, torch.bfloat16)
    out["adam_remainders"] = rec
    p32, s32, rec = run(distributed_fused_adam(group=group),
                        {k: v.float() for k, v in bf16.items()},
                        torch.float32)
    out["adam_fp32"] = rec
    # the master rebuilt from this rank's (bf16 params, remainder) shard
    from apex_tpu_torch.ops.multi_tensor import flatten_pytree

    flat, _ = flatten_pytree(p_rem, dtype=torch.bfloat16)
    n = ps.group_size(group)
    pad = -flat.shape[0] % n
    flat = torch.cat([flat, flat.new_zeros(pad)]) if pad else flat
    shard = flat.shape[0] // n
    rebuilt = master_from_remainder(flat[rank * shard:(rank + 1) * shard],
                                    s_rem.master_shard)
    out["master_bits_equal"] = bool(torch.equal(
        rebuilt.view(torch.int32), s32.master_shard.view(torch.int32)))
    hi, _ = split_master(s32.master_shard)
    out["params_are_high_halves"] = bool(torch.equal(
        hi.view(torch.int16),
        flat[rank * shard:(rank + 1) * shard].view(torch.int16)))
    out["master_bytes"] = {"remainders": s_rem.master_shard.nbytes,
                           "fp32": s32.master_shard.nbytes}
    out["n_params"] = sum(torch.Size(s).numel() for s in shapes.values())
    out["shard_len"] = shard
    return out

