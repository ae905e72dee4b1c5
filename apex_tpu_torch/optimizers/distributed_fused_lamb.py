"""ZeRO fused LAMB (counterpart of
apex_tpu/optimizers/distributed_fused_lamb.py; ref: apex.contrib
DistributedFusedLAMB).

The skeleton of ``distributed_fused_adam``: the flat gradient is
reduce-scattered over the data-parallel group (exact, or through
``compress.quantized_psum_scatter`` with error feedback in
``ef_residual``), the LAMB math runs on this rank's fp32 shard of the
master and the moments, and the new master shards are all-gathered. The
global gradient norm is the sum-of-squares kernel (``sumsq_flat``) on
the shard, all-reduced; the clip is apex's multi_tensor_lamb rule
(divide by ``norm / max_grad_norm`` above the threshold).

Trust ratios are per tensor while the state lives in one flat shard. The
tensors are contiguous ranges of the flat buffer, so each tensor's sums
of ``p**2`` and ``update**2`` over the part of it this rank holds are sums
of slices (:func:`local_segments`), in a fixed order, never an atomic
scatter; the per-tensor vectors, with one more entry for the padding,
are all-reduced over the group. The ratio multiplies each element by
``repeat_interleave`` of the ratios over the slices' lengths.

``param_gather_buckets``: as ``distributed_fused_adam``'s (None takes
``choose_overlap_buckets``' depth). The moments, norms and trust ratios
need the whole shard, so only the last step, the ratio-scaled master
write, runs bucket by bucket through ``zero_prefetch_gather``, each
bucket's gather started before the next bucket's write; bit for bit the
whole-shard gather's at every depth, as in JAX.
"""

from typing import List, NamedTuple, Optional, Tuple

import torch

from apex_tpu_torch.ops.multi_tensor import FlatSpec
from apex_tpu_torch.optimizers._fused_kernels import sumsq_flat
from apex_tpu_torch.optimizers.distributed_fused_adam import (
    _rank,
    bucket_grid,
    choose_overlap_buckets,
    zero_gather_updates,
    zero_init_ef,
    zero_init_master_shard,
    zero_prefetch_gather,
    zero_scatter_with_ef,
    zero_updates_from_flat,
)
from apex_tpu_torch.optimizers.fused_adam import AdamTransform, Tensors
from apex_tpu_torch.parallel import parallel_state as ps

__all__ = ["DistributedFusedLAMB", "DistributedFusedLAMBState",
           "distributed_fused_lamb", "local_segments"]


class DistributedFusedLAMBState(NamedTuple):
    step: torch.Tensor  # 0-d int32
    master_shard: torch.Tensor  # fp32 (padded_total / N,)
    exp_avg: torch.Tensor
    exp_avg_sq: torch.Tensor
    # as DistributedFusedAdamState.ef_residual (a 0-d zero when off)
    ef_residual: torch.Tensor


def local_segments(spec: FlatSpec, rank: int, shard: int
                   ) -> List[Tuple[int, int, int]]:
    """The parts of the flat buffer's tensors (and, last, of its padding)
    that rank ``rank``'s shard ``[rank * shard, (rank + 1) * shard)``
    holds: ``(segment, start, end)`` in shard coordinates, in order,
    covering the shard. Segment ``i`` is tensor ``i`` (JAX's
    ``_segment_ids``), segment ``len(spec.names)`` the padding."""
    lo, hi = rank * shard, (rank + 1) * shard
    bounds = [(off, off + torch.Size(shape).numel())
              for off, shape in zip(spec.offsets, spec.shapes)]
    bounds.append((spec.total, spec.padded_total))
    out = []
    for seg, (a, b) in enumerate(bounds):
        a, b = max(a, lo), min(b, hi)
        if a < b:
            out.append((seg, a - lo, b - lo))
    return out


def _segment_sumsq(x: torch.Tensor, segments, nseg: int) -> torch.Tensor:
    """(nseg,) fp32: each segment's sum of squares over its slices of
    ``x``, slice by slice."""
    sums = [torch.zeros((), dtype=torch.float32, device=x.device)] * nseg
    for seg, a, b in segments:
        part = x[a:b]
        sums[seg] = sums[seg] + (part * part).sum()
    return torch.stack(sums)


def distributed_fused_lamb(
    lr: float = 1e-3,
    bias_correction: bool = True,
    betas: Tuple[float, float] = (0.9, 0.999),
    eps: float = 1e-6,
    weight_decay: float = 0.01,
    max_grad_norm: float = 1.0,
    use_nvlamb: bool = False,
    axis_name: str = "dp",
    axis_size: Optional[int] = None,
    average_grads: bool = True,
    compression=None,
    param_gather_buckets: Optional[int] = None,
    group=None,
) -> AdamTransform:
    """ZeRO LAMB over the data-parallel group ``group``
    (``parallel_state``'s group of ``axis_name`` when None), the JAX
    arguments and defaults. ``compression``: as ``distributed_fused_adam``
    (the gradient reduce-scatter quantized, the LAMB math fp32).
    ``param_gather_buckets``: see the module docstring."""
    beta1, beta2 = betas
    grp = group if group is not None else ps.get_group(axis_name)
    if axis_size is not None and axis_size != ps.group_size(grp):
        raise ValueError(f"axis_size {axis_size} is not the size of the "
                         f"group ({ps.group_size(grp)})")

    @torch.no_grad()
    def init_fn(params: Tensors) -> DistributedFusedLAMBState:
        master, shard = zero_init_master_shard(params, grp)
        dev = master.device
        return DistributedFusedLAMBState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            master_shard=master,
            exp_avg=torch.zeros(shard, dtype=torch.float32, device=dev),
            exp_avg_sq=torch.zeros(shard, dtype=torch.float32, device=dev),
            ef_residual=zero_init_ef(shard, grp, compression, dev))

    @torch.no_grad()
    def update_fn(grads: Tensors, state: DistributedFusedLAMBState,
                  params: Optional[Tensors] = None):
        if params is None:
            raise ValueError("distributed_fused_lamb requires params")
        gshard, spec, new_ef = zero_scatter_with_ef(
            grads, grp, average_grads, compression, state.ef_residual)
        shard = gshard.shape[0]
        segments = local_segments(spec, _rank(grp), shard)
        nseg = len(spec.names) + 1
        dev = gshard.device

        # the global gradient norm: the shard's sum of squares, all-reduced
        global_norm = torch.sqrt(ps.all_reduce(sumsq_flat(gshard), grp))
        one = torch.ones((), dtype=torch.float32, device=dev)
        clip = one
        if max_grad_norm > 0:
            clip = torch.where(global_norm > max_grad_norm,
                               global_norm / max_grad_norm, one)
        g = gshard / clip
        del gshard

        step = state.step + 1
        stepf = step.to(torch.float32)
        if bias_correction:
            bc1, bc2 = 1.0 - beta1 ** stepf, 1.0 - beta2 ** stepf
        else:
            bc1 = bc2 = one
        p = state.master_shard
        m = beta1 * state.exp_avg + (1.0 - beta1) * g
        v = beta2 * state.exp_avg_sq + (1.0 - beta2) * g * g
        del g
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if weight_decay != 0.0:
            u = u + weight_decay * p

        # per-tensor trust ratios: slice sums over this rank's part of
        # each tensor, all-reduced over the group
        w_norm = torch.sqrt(ps.all_reduce(_segment_sumsq(p, segments, nseg),
                                          grp))
        u_norm = torch.sqrt(ps.all_reduce(_segment_sumsq(u, segments, nseg),
                                          grp))
        live = u_norm > 0
        if not use_nvlamb:
            live = live & (w_norm > 0)
        ratios = torch.where(live, w_norm / torch.clamp(u_norm, min=1e-30),
                             one)
        per_elem = torch.repeat_interleave(
            ratios[[seg for seg, _, _ in segments]],
            torch.tensor([b - a for _, a, b in segments], device=dev))
        nb = param_gather_buckets if param_gather_buckets is not None \
            else choose_overlap_buckets(shard * 4, ps.group_size(grp),
                                        group=grp)
        if nb > 1:
            # padded to the bucket grid: a pad element writes 0 - lr 0 0
            # and is cut before anything is kept
            _, pad = bucket_grid(shard, nb)

            def padto(a):
                return torch.cat([a, a.new_zeros(pad)]) if pad else a

            pw, rw, uw = padto(p), padto(per_elem), padto(u)
            del u, per_elem

            def bucket(b, bsz):
                sl = slice(b * bsz, (b + 1) * bsz)
                return pw[sl] - lr * rw[sl] * uw[sl]

            buckets, new_flat = zero_prefetch_gather(bucket, nb, shard, grp)
            del pw, rw, uw
            new_master = torch.cat(buckets)[:shard]
            updates = zero_updates_from_flat(new_flat, params, spec)
        else:
            new_master = p - lr * per_elem * u
            del u, per_elem
            updates = zero_gather_updates(new_master, params, spec, grp)
        return updates, DistributedFusedLAMBState(
            step=step, master_shard=new_master, exp_avg=m, exp_avg_sq=v,
            ef_residual=new_ef)

    return AdamTransform(init_fn, update_fn)


class DistributedFusedLAMB:
    """Class-style constructor with the reference's signature; returns
    :func:`distributed_fused_lamb`'s transform (the NCCL tuning knobs are
    accepted and ignored, as in JAX)."""

    def __new__(cls, lr: float = 1e-3, bias_correction: bool = True,
                betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-6,
                weight_decay: float = 0.01, max_grad_norm: float = 1.0,
                use_nvlamb: bool = False, axis_name: str = "dp",
                axis_size: Optional[int] = None, average_grads: bool = True,
                compression=None, param_gather_buckets: Optional[int] = None,
                group=None, **_unused):
        return distributed_fused_lamb(
            lr=lr, bias_correction=bias_correction, betas=betas, eps=eps,
            weight_decay=weight_decay, max_grad_norm=max_grad_norm,
            use_nvlamb=use_nvlamb, axis_name=axis_name, axis_size=axis_size,
            average_grads=average_grads, compression=compression,
            param_gather_buckets=param_gather_buckets, group=group)
