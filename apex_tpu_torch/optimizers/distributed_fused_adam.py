"""ZeRO-2 fused Adam (counterpart of
apex_tpu/optimizers/distributed_fused_adam.py).

The optimizer state is sharded over the data-parallel group (``group``,
by default ``parallel_state``'s, whose size is the JAX ``axis_size``):
the flat fp32 gradient, zero-padded to a multiple of the group's size
(:func:`_padded_flatten`), is reduce-scattered in one collective and
divided by N (:func:`zero_scatter_grads`, which takes each rank's own,
un-averaged gradients, the JAX function's per-rank regime), clipped by
the global norm (the hand-written sum-of-squares kernel, ``sumsq_flat``,
on the rank's shard, then an all-reduce of the scalar), and Adam runs on
this rank's shard of the fp32 master and the moments in plain torch ops,
as the JAX ``adam_math`` does; the new master shards are all-gathered
(:func:`zero_gather_updates`). :func:`zero_state_specs` says which rank
holds which slice. With no group (a world of one) the shard is the whole
buffer and no collective runs.

The transform has the optax shape of :func:`~apex_tpu_torch.optimizers.
fused_adam`: ``init(params)`` and ``update(grads, state, params) ->
(updates, state)`` over dicts from parameter names to tensors, in the
JAX leaf order (``ops.multi_tensor``), so the flat master and moments
are element for element the JAX package's. The updates are ``new -
old`` differenced in fp32 and cast to each parameter's dtype; the
caller applies ``p += update``.

Memory: the Adam math runs out of place over the shard, as JAX writes
it, but each intermediate is freed as soon as the next one is made, and
the gradient shard is dropped before the updates are built.

``compression`` (a ``parallel.compress.CompressionConfig``): the flat
padded gradient goes through ``compress.quantized_psum_scatter``
instead of the exact reduce-scatter, so the gradients travel in the
wire dtype with fp32 block scales and the master update stays fp32.
With its ``error_feedback`` the state's ``ef_residual`` is this rank's
fp32 residual over the whole padded buffer (``padded_total``
elements: its error over its contribution to every chunk); otherwise a
0-d zero.

``store_param_remainders`` (bf16 parameters only): the state keeps the
low 16 bits of each fp32 master element (an int16 tensor of the bits),
and the bf16 parameter is the high 16 bits, its truncation, not its
rounding; the master is rebuilt from the two exactly, as int16 halves of
one fp32 word (little-endian: low half first), so no integer arithmetic
on unsigned types is needed. The master shard's state takes half the
bytes. The updates are fp32, so ``p += update`` lands each bf16
parameter exactly on the new master's high half.

``param_gather_buckets`` splits the gather of the new master shards into
that many equal buckets (:func:`bucket_grid`): each bucket's Adam math
runs, then its ``all_gather`` is started (``async_op=True``) before the
next bucket's math, and the gathers are waited on in order
(:func:`zero_prefetch_gather`, the one home of that pipeline). None
takes :func:`choose_overlap_buckets`' depth, the JAX rule over the
ledger's link roofline (``monitor.xray.ledger.ici_bandwidth_per_device``
of the group): 2 where no link is known (gloo, which stages through the
host, or a card missing from the table); over gloo two staged buckets
take less time than one (``scripts/zero_gather_depth.py`` times both).
The result is bit for bit the whole-shard gather's, and the ledger's bytes are the same
(``nb`` gathers of ``bs`` elements, the shard when ``nb`` divides it).
"""

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from apex_tpu_torch.ops.multi_tensor import (
    FlatSpec,
    flatten_pytree,
    unflatten_pytree,
)
from apex_tpu_torch.optimizers._fused_kernels import sumsq_flat
from apex_tpu_torch.optimizers.fused_adam import AdamTransform, Tensors
from apex_tpu_torch.parallel import compress
from apex_tpu_torch.parallel import parallel_state as ps

__all__ = ["DistributedFusedAdam", "DistributedFusedAdamState",
           "ZeroStateSpecs", "bucket_grid", "choose_overlap_buckets",
           "distributed_fused_adam", "master_from_remainder",
           "split_master", "zero_prefetch_gather", "zero_regroup_flat",
           "zero_scatter_with_ef", "zero_state_specs"]


class DistributedFusedAdamState(NamedTuple):
    step: torch.Tensor  # 0-d int32, the same on every rank
    # fp32 (padded_total / N,): this rank's; with store_param_remainders
    # the int16 bits of each element's low half
    master_shard: torch.Tensor
    exp_avg: torch.Tensor
    exp_avg_sq: torch.Tensor
    # error-feedback residual of the compressed reduce-scatter: fp32
    # (padded_total,) a rank; a 0-d zero, as in JAX, with compression or
    # its error feedback off
    ef_residual: torch.Tensor


class ZeroStateSpecs(NamedTuple):
    """Where the ZeRO state lives (the counterpart of the JAX
    ``zero_state_specs``' PartitionSpecs): ``step`` is replicated,
    ``ef_residual`` is each rank's own (its whole padded buffer) under
    compression with error feedback and a replicated zero otherwise, and
    each of ``master_shard``, ``exp_avg`` and
    ``exp_avg_sq`` is data-parallel rank d's slice ``[d * shard_len, (d +
    1) * shard_len)`` of one global flat buffer of ``spec.padded_total``
    elements in the JAX leaf order, zero past ``spec.total``."""

    axis_size: int
    shard_len: int
    spec: FlatSpec

    def shard_range(self, rank: int) -> Tuple[int, int]:
        return rank * self.shard_len, (rank + 1) * self.shard_len


def _padded_flatten(tree: Tensors, axis_size: int):
    """The fp32 flat buffer of ``tree`` (``flatten_pytree``), zero-padded
    to a multiple of ``axis_size``, and its spec."""
    flat, spec = flatten_pytree(tree, dtype=torch.float32)
    pad = -flat.shape[0] % axis_size
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
        spec = dataclasses.replace(spec, padded_total=flat.shape[0])
    return flat, spec


def zero_state_specs(params: Tensors, axis_size: int) -> ZeroStateSpecs:
    """The layout of the ZeRO state of ``params`` over ``axis_size``
    data-parallel ranks (worked out on meta tensors: nothing is
    allocated)."""
    _, spec = _padded_flatten({n: p.detach().to("meta")
                               for n, p in params.items()}, axis_size)
    return ZeroStateSpecs(axis_size, spec.padded_total // axis_size, spec)


def _rank(group) -> int:
    return 0 if group is None else torch.distributed.get_rank(group)


def zero_init_master_shard(params: Tensors, group):
    """This rank's fp32 shard of the flattened, padded params, and the
    shard's length."""
    n = ps.group_size(group)
    flat, _ = _padded_flatten(params, n)
    shard = flat.shape[0] // n
    r = _rank(group)
    return flat[r * shard:(r + 1) * shard].clone(), shard


def zero_scatter_grads(grads: Tensors, group, average: bool = True,
                       compression=None, ef=None):
    """This rank's shard of the group's sum of the ranks' own gradients
    (one fused reduce-scatter of the flat buffer), divided by N with
    ``average``; and the flat spec. A gradient that is already the dp
    mean would be divided twice: pass each rank's own.

    With ``compression`` the reduce-scatter is
    ``compress.quantized_psum_scatter`` of the flat buffer plus ``ef``
    (the fp32 residual at the padded length, where given), and a third
    value is returned: the new residual (``ef`` itself without one)."""
    n = ps.group_size(group)
    gflat, spec = _padded_flatten(grads, n)
    new_ef = ef
    if compression is not None:
        acc = gflat if ef is None else gflat + ef
        del gflat
        gshard, sent = compress.quantized_psum_scatter(
            acc, group, compression, return_transmitted=True)
        if ef is not None:
            new_ef = compress.ef_update(acc, sent)
        del acc, sent
    else:
        gshard = ps.reduce_scatter(gflat, group)
    if average and n > 1:
        gshard = gshard / n
    if compression is not None:
        return gshard, spec, new_ef
    return gshard, spec


def zero_scatter_with_ef(grads: Tensors, group, average: bool, compression,
                         ef_residual):
    """The ZeRO optimizers' shared scatter: always ``(gshard, spec,
    new_ef)``, ``new_ef`` the state's residual where compression or its
    error feedback leaves it untouched, so Adam and LAMB agree on it."""
    if compression is None:
        gshard, spec = zero_scatter_grads(grads, group, average)
        return gshard, spec, ef_residual
    use_ef = getattr(compression, "error_feedback", False)
    gshard, spec, new_ef = zero_scatter_grads(
        grads, group, average, compression=compression,
        ef=ef_residual if use_ef else None)
    return gshard, spec, ef_residual if new_ef is None else new_ef


def zero_init_ef(shard: int, group, compression, device) -> torch.Tensor:
    """The initial ``ef_residual``: fp32 zeros at the padded length under
    compression with error feedback, else a 0-d zero."""
    if compression is not None and getattr(compression, "error_feedback",
                                           False):
        return torch.zeros(shard * ps.group_size(group), dtype=torch.float32,
                           device=device)
    return torch.zeros((), dtype=torch.float32, device=device)


def master_from_remainder(param_bf16: torch.Tensor,
                          remainder: torch.Tensor) -> torch.Tensor:
    """The exact fp32 master: the bf16 parameter's bits as the high half
    and ``remainder``'s (int16) as the low half of each fp32 word."""
    return torch.stack([remainder, param_bf16.view(torch.int16)],
                       dim=-1).view(torch.float32).reshape(param_bf16.shape)


def split_master(master: torch.Tensor):
    """fp32 master -> (its high half as bf16, the truncation that is the
    parameter; its low half's int16 bits, the remainder)."""
    halves = master.contiguous().view(torch.int16).reshape(
        master.shape + (2,))
    return (halves[..., 1].contiguous().view(torch.bfloat16),
            halves[..., 0].contiguous())


def zero_regroup_flat(flat: torch.Tensor, target_len: int) -> torch.Tensor:
    """A saved padded ZeRO flat buffer regrouped to a new dp size (the
    JAX function's rule): the global buffer is the true vector of length
    T zero-padded to a multiple of the dp size (:func:`_padded_flatten`),
    so a change of dp changes only the padding: truncate (dropping
    zeros) or zero-extend to ``target_len``, on the buffer's device and
    in its dtype.

    Refuses (``ValueError``) a truncation that would drop a nonzero
    value: that is optimizer state, not padding. The
    ``store_param_remainders`` state (int16 low halves of the master)
    regroups by the same rule: a padding element's master is 0.0, whose
    low half is the int16 0, so its zeros are padding as the fp32
    buffers' are. The elastic restore (``resilience.elastic.reshard``)
    wraps the refusal in its ``ElasticRestoreError``."""
    if flat.dim() != 1:
        raise ValueError(f"ZeRO flat buffer must be 1-D, got "
                         f"{tuple(flat.shape)}")
    n, target_len = flat.shape[0], int(target_len)
    if target_len == n:
        return flat
    if target_len < n:
        tail = flat[target_len:]
        nonzero = int(torch.count_nonzero(tail))
        if nonzero:
            raise ValueError(
                f"regroup {n} -> {target_len} would truncate {nonzero} "
                f"nonzero value(s) — the dropped region is state, not dp "
                f"padding; the target layout is too small for the saved "
                f"flat buffer")
        return flat[:target_len]
    return torch.cat([flat, flat.new_zeros(target_len - n)])


def zero_gather_updates(new_master: torch.Tensor, params: Tensors,
                        spec: FlatSpec, group) -> Tensors:
    """All-gathers the new master shards and returns the updates (new -
    old) in the params' dtypes."""
    return zero_updates_from_flat(ps.all_gather(new_master, group), params,
                                  spec)


def zero_updates_from_flat(new_flat, params: Tensors, spec) -> Tensors:
    """The ZeRO update-dtype rule: unflatten the gathered buffer with the
    params' dtypes and return ``new - old`` differenced in fp32, cast to
    each parameter's dtype."""
    spec = dataclasses.replace(
        spec, dtypes=tuple(params[n].dtype for n in spec.names))
    new = unflatten_pytree(new_flat, spec)
    return {n: (new[n].float() - params[n].float()).to(params[n].dtype)
            for n in spec.names}


# -- the bucketed param all-gather ------------------------------------------


def choose_overlap_buckets(shard_bytes: int, axis_size: int,
                           bandwidth: Optional[float] = None,
                           target_bucket_s: float = 5e-4,
                           max_buckets: int = 8, group=None) -> int:
    """The gather's overlap depth, the JAX function's rule: the
    whole-shard gather's ring wire time ``(n - 1) * shard_bytes /
    bandwidth`` in buckets of about ``target_bucket_s`` each, clamped to
    ``[1, max_buckets]``; 1 at one rank, and 2 (plain double-buffering)
    where the bandwidth is unknown. ``bandwidth`` defaults to the link
    roofline of ``group`` (``ledger.ici_bandwidth_per_device``, None for
    a group staged through the host)."""
    if axis_size <= 1:
        return 1
    if bandwidth is None:
        from apex_tpu_torch.monitor.xray.ledger import (
            ici_bandwidth_per_device,
        )

        bandwidth = ici_bandwidth_per_device(group=group)
    if not bandwidth:
        return 2
    gather_s = (axis_size - 1) * shard_bytes / bandwidth
    return max(1, min(max_buckets, math.ceil(gather_s / target_bucket_s)))


def bucket_grid(shard_len: int, num_buckets: int) -> Tuple[int, int]:
    """``(bucket_size, pad)`` of a shard split into ``num_buckets`` equal
    buckets: the one rule the callers pad by and
    :func:`zero_prefetch_gather` slices by."""
    bs = -(-shard_len // num_buckets)
    return bs, bs * num_buckets - shard_len


def _interleave_gathered(gathered, shard_len: int, axis_size: int):
    """The rank-major flat buffer from bucket-major gathers:
    ``gathered[b]`` is the ranks' bucket b in rank order; each rank's
    bucket padding is cut from its tail."""
    nb = len(gathered)
    bs = gathered[0].shape[0] // axis_size
    stacked = torch.stack(gathered)  # (nb, n * bs)
    return (stacked.reshape(nb, axis_size, bs).transpose(0, 1)
            .reshape(axis_size, nb * bs)[:, :shard_len].reshape(-1))


def zero_prefetch_gather(bucket_fn: Callable, num_buckets: int,
                         shard_len: int, group):
    """The bucketed ZeRO param gather. ``bucket_fn(b, bs)`` computes
    bucket ``b``'s values (a ``(bs,)`` slice of this rank's padded
    shard); its ``all_gather`` starts at once (``async_op=True``), before
    bucket ``b + 1``'s math, and the gathers are waited on in order.
    Returns ``(buckets, new_flat)``: the buckets this rank computed and
    the full rank-major flat buffer (the whole-shard gather's, bit for
    bit)."""
    bs, _ = bucket_grid(shard_len, num_buckets)
    buckets, pending = [], []
    for b in range(num_buckets):
        v = bucket_fn(b, bs)
        pending.append(ps.all_gather_async(v, group))
        buckets.append(v)
    gathered = [p.wait() for p in pending]
    return buckets, _interleave_gathered(gathered, shard_len,
                                         ps.group_size(group))


def distributed_fused_adam(
    lr: float = 1e-3,
    bias_correction: bool = True,
    betas: Tuple[float, float] = (0.9, 0.999),
    eps: float = 1e-8,
    adam_w_mode: bool = True,
    weight_decay: float = 0.0,
    axis_name: str = "dp",
    axis_size: Optional[int] = None,
    average_grads: bool = True,
    max_grad_norm: Optional[float] = None,
    store_param_remainders: bool = False,
    compression=None,
    param_gather_buckets: Optional[int] = None,
    group=None,
) -> AdamTransform:
    """ZeRO-2 Adam (ref: apex.contrib DistributedFusedAdam) over the
    data-parallel group ``group`` (``parallel_state``'s group of the axis
    ``axis_name`` when None).

    ``axis_size``, where given, must be the group's size; the group is
    read when the transform is made.
    ``average_grads`` divides the reduce-scattered sum by N.
    ``max_grad_norm``: clip the global gradient norm before the Adam
    math, ``min(1, max_grad_norm / (norm + 1e-6))`` (the torch
    convention), the norm from ``sumsq_flat`` on this rank's shard and an
    all-reduce of the sum. ``compression`` and ``store_param_remainders``:
    ``param_gather_buckets``: see the module docstring.
    """
    beta1, beta2 = betas
    grp = group if group is not None else ps.get_group(axis_name)
    if axis_size is not None and axis_size != ps.group_size(grp):
        raise ValueError(f"axis_size {axis_size} is not the size of the "
                         f"group ({ps.group_size(grp)})")

    @torch.no_grad()
    def init_fn(params: Tensors) -> DistributedFusedAdamState:
        if store_param_remainders:
            bad = [p.dtype for p in params.values()
                   if p.dtype != torch.bfloat16]
            if bad:
                raise ValueError(
                    "store_param_remainders requires bfloat16 params (the "
                    f"bf16 param is the master's high half); got {bad[0]}")
        master, shard = zero_init_master_shard(params, grp)
        dev = master.device
        if store_param_remainders:
            # the master is the bf16 params exactly: every low half is 0
            master = torch.zeros(shard, dtype=torch.int16, device=dev)
        return DistributedFusedAdamState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            master_shard=master,
            exp_avg=torch.zeros(shard, dtype=torch.float32, device=dev),
            exp_avg_sq=torch.zeros(shard, dtype=torch.float32, device=dev),
            ef_residual=zero_init_ef(shard, grp, compression, dev),
        )

    @torch.no_grad()
    def update_fn(grads: Tensors, state: DistributedFusedAdamState,
                  params: Optional[Tensors] = None):
        if params is None:
            raise ValueError("distributed_fused_adam requires params")
        g, spec, new_ef = zero_scatter_with_ef(
            grads, grp, average_grads, compression, state.ef_residual)
        if g.shape != state.master_shard.shape:
            raise ValueError(f"the gradient shard ({g.shape[0]}) does not "
                             f"match the master "
                             f"({state.master_shard.shape[0]})")
        if max_grad_norm is not None:
            total = ps.all_reduce(sumsq_flat(g), grp)
            clip = torch.clamp(max_grad_norm / (torch.sqrt(total) + 1e-6),
                               max=1.0)
            g = g * clip

        step = state.step + 1
        stepf = step.to(torch.float32)
        if bias_correction:
            bc1, bc2 = 1.0 - beta1 ** stepf, 1.0 - beta2 ** stepf
        else:
            bc1 = bc2 = torch.ones((), dtype=torch.float32, device=g.device)
        if store_param_remainders:
            pflat, _ = flatten_pytree(params, dtype=torch.bfloat16)
            n = ps.group_size(grp)
            pad = -pflat.shape[0] % n
            if pad:
                pflat = torch.cat([pflat, pflat.new_zeros(pad)])
            shard = pflat.shape[0] // n
            r = _rank(grp)
            p = master_from_remainder(pflat[r * shard:(r + 1) * shard],
                                      state.master_shard)
            del pflat
        else:
            p = state.master_shard

        def adam_math(p, m0, v0, box):
            # adam_math of the JAX module, one rounded operation at a time
            # in its order, with each intermediate freed when it is
            # consumed (the gradient comes in a one-item list, so the
            # caller holds no reference to it)
            g = box.pop()
            if not adam_w_mode and weight_decay != 0.0:
                g = g + weight_decay * p
            m = m0 * beta1
            m += g * (1.0 - beta1)
            v = v0 * beta2
            t = g * (1.0 - beta2)
            t *= g
            v += t
            del g, t
            upd = m / bc1
            den = v / bc2
            den.sqrt_()
            den += eps
            upd /= den
            del den
            if adam_w_mode and weight_decay != 0.0:
                upd += weight_decay * p
            upd *= lr
            new = p - upd
            return new, m, v

        box = [g]  # the gradient, freed inside the math
        del g
        shard = p.shape[0]
        n = ps.group_size(grp)
        nb = param_gather_buckets if param_gather_buckets is not None \
            else choose_overlap_buckets(
                shard * (2 if store_param_remainders else 4), n, group=grp)
        if nb > 1:
            # every working buffer padded to the bucket grid (zeros are
            # inert for Adam: eps keeps the pad finite, and the tails are
            # cut before anything is kept)
            _, pad = bucket_grid(shard, nb)

            def padto(a):
                return torch.cat([a, a.new_zeros(pad)]) if pad else a

            pw, mw, vw = (padto(a) for a in
                          (p, state.exp_avg, state.exp_avg_sq))
            gw = padto(box.pop())
            kept = []

            def bucket(b, bsz):
                sl = slice(b * bsz, (b + 1) * bsz)
                nm_b, m_b, v_b = adam_math(pw[sl], mw[sl], vw[sl], [gw[sl]])
                if store_param_remainders:
                    hi_b, lo_b = split_master(nm_b)
                    kept.append((m_b, v_b, lo_b))
                    return hi_b
                kept.append((m_b, v_b, nm_b))
                return nm_b

            _, new_flat = zero_prefetch_gather(bucket, nb, shard, grp)
            del pw, mw, vw, gw
            m, v, new_master = (torch.cat([k[i] for k in kept])[:shard]
                                for i in range(3))
            del kept
        else:
            new_master, m, v = adam_math(p, state.exp_avg, state.exp_avg_sq,
                                         box)
            if store_param_remainders:
                hi, new_master = split_master(new_master)
                new_flat = ps.all_gather(hi, grp)
            else:
                new_flat = ps.all_gather(new_master, grp)

        if store_param_remainders:
            new = unflatten_pytree(new_flat, dataclasses.replace(
                spec, dtypes=tuple(params[n].dtype for n in spec.names)))
            # fp32 updates: p + u in fp32 is exactly the new high half
            updates = {n: new[n].float() - params[n].float()
                       for n in spec.names}
        else:
            updates = zero_updates_from_flat(new_flat, params, spec)
        return updates, DistributedFusedAdamState(
            step=step, master_shard=new_master, exp_avg=m, exp_avg_sq=v,
            ef_residual=new_ef)

    return AdamTransform(init_fn, update_fn)


class DistributedFusedAdam:
    """Class-style constructor with the reference's signature; returns
    :func:`distributed_fused_adam`'s transform (the pipeline tuning
    knobs are accepted and ignored, as in JAX)."""

    def __new__(cls, lr: float = 1e-3, bias_correction: bool = True,
                betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                adam_w_mode: bool = True, weight_decay: float = 0.0,
                axis_name: str = "dp", axis_size: Optional[int] = None,
                average_grads: bool = True,
                max_grad_norm: Optional[float] = None,
                store_param_remainders: bool = False, compression=None,
                param_gather_buckets: Optional[int] = None, group=None,
                **_unused):
        return distributed_fused_adam(
            lr=lr, bias_correction=bias_correction, betas=betas, eps=eps,
            adam_w_mode=adam_w_mode, weight_decay=weight_decay,
            axis_name=axis_name, axis_size=axis_size,
            average_grads=average_grads, max_grad_norm=max_grad_norm,
            store_param_remainders=store_param_remainders,
            compression=compression,
            param_gather_buckets=param_gather_buckets, group=group)
