"""Rank functions of the contrib slice's multi-rank checks, run in a
spawned world by the tests and by ``chip_smoke.py``'s shared world
(``distributed_test_base.spawn`` / ``jobs_worker``).

:func:`spatial_bottleneck_worker` splits H over a context-parallel group
of the whole world and runs ``contrib.SpatialBottleneck`` on each rank's
rows, forward and backward, from one state_dict; every rank's rows are
gathered and held against the unsharded ``contrib.Bottleneck`` on the
whole input, outputs, the input gradient, the parameter gradients
(summed over the ranks) and, in training mode, the running statistics.
"""

from typing import Dict, Sequence

import numpy as np
import torch

from apex_tpu_torch.parallel import parallel_state as ps

__all__ = ["spatial_bottleneck_worker"]


def _np(t):
    return t.detach().float().cpu().numpy()


def _gather_h(t, group):
    """The ranks' (N, C, H_local, W) along H."""
    return ps.all_gather(t.contiguous(), group, dim=2)


def spatial_bottleneck_worker(rank: int, world_size: int,
                              cases: Sequence[Dict], device: str = "cpu"
                              ) -> list:
    """One result a case. A case: ``channels`` (in, bottleneck, out),
    ``stride``, ``train``, ``x`` (the whole NHWC input, an array) or
    ``shape`` (N, H, W, C, drawn from ``seed``), and ``state`` (a
    state_dict of arrays) or None (the blocks' own initialisation from
    ``seed``). Each rank returns its rows' output and input gradient
    under ``loss = sum(out ** 2)`` of its rows, its halos, its parameter
    gradients, the running statistics after the call, the p2p messages
    it staged, and the largest differences from the unsharded block
    (``err_*``, the same on every rank)."""
    from apex_tpu_torch.contrib import (
        Bottleneck,
        SpatialBottleneck,
        halo_exchange_1d,
    )

    if device != "cpu":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ps.initialize_model_parallel(context_parallel_size=world_size)
    group = ps.get_context_parallel_group()
    out = []
    for case in cases:
        cin, mid, cout = case["channels"]
        seed = case.get("seed", 0)
        if case.get("x") is not None:
            x_full = np.asarray(case["x"], np.float32)
        else:
            x_full = np.random.RandomState(seed).randn(
                *case["shape"]).astype(np.float32)
        x = torch.from_numpy(x_full).permute(0, 3, 1, 2).to(device)
        x = x.contiguous(memory_format=torch.channels_last)
        h_local = x.shape[2] // world_size
        kw = dict(stride=case["stride"], device=device, seed=seed)
        sp = SpatialBottleneck(cin, mid, cout, **kw)
        ref = Bottleneck(cin, mid, cout, **kw)
        state = case.get("state")
        if state is not None:
            state = {k: torch.as_tensor(np.asarray(v)) for k, v in
                     state.items()}
            sp.load_state_dict(state)
        ref.load_state_dict(sp.state_dict())
        xl = x[:, :, rank * h_local:(rank + 1) * h_local].detach() \
            .requires_grad_(True)
        staged = dict(ps.STAGED)
        y = sp(xl, train=case["train"])
        (y.float().square().sum()).backward()
        staged = {k: ps.STAGED[k] - staged[k] for k in ("p2p", "p2p_bytes")}
        with torch.no_grad():
            halo = halo_exchange_1d(xl.detach(), "cp", halo=1, dim=2)
        grads = {n: p.grad for n, p in sp.named_parameters()}
        summed = {n: ps.all_reduce(g, group) for n, g in grads.items()}
        y_all = _gather_h(y.detach(), group)
        dx_all = _gather_h(xl.grad, group)
        xr = x.detach().requires_grad_(True)
        yr = ref(xr, train=case["train"])
        (yr.float().square().sum()).backward()
        res = {
            "out": _np(y), "dx": _np(xl.grad),
            "halo": (_np(halo[:, :, :1]), _np(halo[:, :, -1:])),
            "param_grads": {n: _np(g) for n, g in grads.items()},
            "stats": {k: _np(v) for k, v in sp.state_dict().items()
                      if k.endswith((".mean", ".var"))},
            "staged": staged,
            "err_out": float((y_all - yr.detach()).abs().max()),
            "err_dx": float((dx_all - xr.grad).abs().max()),
            "err_params": max(float((summed[n] - p.grad).abs().max()
                                    / max(float(p.grad.abs().max()), 1e-30))
                              for n, p in ref.named_parameters()),
            "err_stats": max(float((v - ref.state_dict()[k]).abs().max())
                             for k, v in sp.state_dict().items()
                             if k.endswith((".mean", ".var"))),
            "scale_out": float(yr.detach().abs().max()),
            "scale_dx": float(xr.grad.abs().max()),
        }
        out.append(res)
    return out
