"""Prescription derivation: findings -> concrete Patches (counterpart of
apex_tpu/analysis/autofix/derive.py).

Input is what the pass suite already made for a target: the recorded
step's module (``hlo.parser.HloModule``: each state tensor's argument,
label and shape), the layout, the ledger and the unsuppressed findings.
Output is a list of typed :class:`~.patches.Patch` records:

- ``sharding.replicated-param``  -> a shard spec over the weight-update
  axis (the layout axis carrying the most gradient-reduction bytes in
  the ledger: arXiv:2004.13336's dp axis), splitting the first dimension
  the axis size divides. The ZeRO flat-buffer convention guarantees
  divisibility for flat optimizer state (``flatten_pytree`` pads to a
  chunk multiple); a tensor with no divisible dimension gets a
  constraint prescription instead (refuse, don't guess);
- ``sharding.replicated-output`` -> the same spec, resolved to the
  argument whose shape and dtype the output mirrors (a step returns its
  new state);
- ``donation.missed``            -> an in-place declaration.

JAX's fourth source, ``comms.reshard``, is never raised in the port
(``hlo/comms_diff.py``). Whether a patch is applicable is the target's
call: a ``StepTarget`` whose builder exposes the argument through
``spec_slots``/``donate_slot`` gets the builder keyword in
``Patch.slot``; everything else stays a printed prescription.
"""

import math
from typing import List, Optional, Sequence, Tuple

from apex_tpu_torch.analysis.autofix.patches import (
    KIND_CONSTRAINT,
    KIND_DONATE,
    KIND_SPEC,
    Patch,
)
from apex_tpu_torch.analysis.findings import Finding

__all__ = ["derive_patches", "update_axis"]


def update_axis(mesh, ledger=None) -> Optional[str]:
    """The weight-update (gradient-sync) axis: among the layout's
    >1-sized axes, the one moving the most all-reduce-class bytes in the
    ledger; the largest axis (first in layout order on ties) when no
    ledger traffic tells them apart."""
    if mesh is None:
        return None
    shape = dict(mesh.shape)
    live = [n for n in mesh.axis_names if shape[n] > 1]
    if not live:
        return None
    reduce_bytes = {n: 0 for n in live}
    if ledger is not None:
        for e in ledger.entries:
            if e.axis in reduce_bytes and e.op in ("psum", "pmean",
                                                   "psum_scatter"):
                reduce_bytes[e.axis] += e.bytes * e.count
    return max(live, key=lambda n: (reduce_bytes[n], shape[n]))


def _shard_spec_for(shape: Tuple[int, ...], axis: str,
                    axis_size: int) -> Optional[Tuple]:
    """``(None, ..., axis)`` over the first dimension ``axis_size``
    divides, or None when none does (the refusal case)."""
    for dim, extent in enumerate(shape):
        if extent and extent % axis_size == 0:
            return tuple([None] * dim + [axis])
    return None


def _ici_delta(nbytes: int, n: int) -> int:
    """Wire bytes saved a step by sharding a replicated weight update
    over an ``n``-rank axis, the ledger's ring convention: the
    full-payload all-reduce (``2(n-1)B/n``) becomes a reduce-scatter
    (``(n-1)B/n``)."""
    if n <= 1:
        return 0
    return (math.ceil(2 * (n - 1) * nbytes / n)
            - math.ceil((n - 1) * nbytes / n))


def derive_patches(target, findings: Sequence[Finding], *, module=None,
                   mesh=None, ledger=None) -> List[Patch]:
    """One target's unsuppressed findings as Patches; see the module
    docstring. ``module`` is the recorded step (needed to resolve a
    finding's tensor to its argument), ``mesh`` the layout (default the
    target's), ``ledger`` the step's."""
    mesh = mesh if mesh is not None else getattr(target, "mesh", None)
    axis = update_axis(mesh, ledger)
    if axis is None or module is None:
        return []
    axis_size = int(dict(mesh.shape)[axis])
    params = module.entry_params
    spec_slots = dict(getattr(target, "spec_slots", None) or {})
    donate_slot = getattr(target, "donate_slot", None)

    patches: List[Patch] = []
    seen = set()

    def emit(p: Patch):
        key = (p.kind, p.slot, p.argnum, p.spec, p.site)
        if key not in seen:
            seen.add(key)
            patches.append(p)

    for f in findings:
        if f.rule == "sharding.replicated-param":
            idx = f.data.get("index")
            if idx is None or idx >= len(params):
                continue
            p = params[idx]
            shape = p.shape.dims
            nbytes = int(f.data.get("bytes", 0))
            spec = _shard_spec_for(shape, axis, axis_size)
            if spec is None:
                emit(Patch(
                    kind=KIND_CONSTRAINT, target=target.name,
                    argnum=p.argnum, leaf=p.label, spec=None, site=f.site,
                    axis=axis, reason=(
                        f"refused: no dimension of {shape} divisible by "
                        f"{axis!r}={axis_size} — repad or reshape before "
                        f"sharding")))
                continue
            slot = spec_slots.get(p.argnum)
            emit(Patch(
                kind=KIND_SPEC if slot else KIND_CONSTRAINT,
                target=target.name, argnum=p.argnum, leaf=p.label,
                spec=spec, site=(f"<builder:{slot}>" if slot else f.site),
                axis=axis, wire_delta=_ici_delta(nbytes, axis_size),
                hbm_delta=nbytes - nbytes // axis_size, slot=slot,
                reason=(f"{nbytes} B replicated {axis_size}x over {axis!r} "
                        f"— ZeRO weight-update sharding (arXiv:2004.13336)")))
        elif f.rule == "sharding.replicated-output":
            oi = f.data.get("output")
            if oi is None or oi >= len(module.entry_outputs):
                continue
            out = module.entry_outputs[oi]
            for p in params:
                if (p.argnum in spec_slots and p.shape == out.shape):
                    spec = _shard_spec_for(out.shape.dims, axis, axis_size)
                    if spec is None:
                        break
                    nbytes = int(f.data.get("bytes", 0))
                    emit(Patch(
                        kind=KIND_SPEC, target=target.name, argnum=p.argnum,
                        leaf=p.label, spec=spec,
                        site=f"<builder:{spec_slots[p.argnum]}>",
                        axis=axis, slot=spec_slots[p.argnum],
                        wire_delta=_ici_delta(nbytes, axis_size),
                        hbm_delta=nbytes - nbytes // axis_size,
                        reason=(f"output #{oi} mirrors arg {p.argnum} "
                                f"({p.label}) — shard the state spec, in "
                                f"and out move together")))
                    break
        elif f.rule == "donation.missed":
            label = f.data.get("leaf", "")
            argnum = next((p.argnum for p in params if p.label == label),
                          None)
            if argnum is None:
                continue
            emit(Patch(
                kind=KIND_DONATE, target=target.name, argnum=argnum,
                leaf=label,
                site=(f"<builder:{donate_slot}>" if donate_slot else f.site),
                slot=donate_slot, hbm_delta=int(f.data.get("bytes", 0)),
                reason="an output of its shape and dtype takes a fresh "
                       "storage"))
    return patches
