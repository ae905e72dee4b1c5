"""Replicated-state auditor: big state whole on every rank of a parallel
axis (counterpart of apex_tpu/analysis/hlo/sharding_audit.py).

"Automatic Cross-Replica Sharding of Weight Update in Data-Parallel
Training" (arXiv:2004.13336) is about this failure shape: state that
could be sharded over a >1-sized axis sits whole on every rank and is
updated on every rank, multiplying memory and (for the resync it then
needs) wire traffic. The JAX package reads the verdict off the compiled
entry computation's ``sharding={...}`` annotations. An eager tensor
carries no sharding: each rank holds a tensor of its own. So the port
finds it from the recorded state (``hlo/parser.py``) and the layout:
after the step, the ranks of every live axis exchange each big state
tensor's shape and value fingerprint (``parser.tensor_digest``), and a
tensor that the step updated (its storage or its values changed) and
that is equal on every rank of an axis is whole there. Flags:

- ``sharding.replicated-param``  (warning) — a state tensor (an
  argument leaf) of >= ``min_bytes`` (default 1 MiB) the step updates (in
  place, or by returning its new value: :func:`functional_updates`),
  whole on every rank of a >1-sized axis;
- ``sharding.replicated-output`` (warning) — the same for a tensor the
  step returns (new, or an argument's storage that the step updated).

``sharding.unverifiable`` (the JAX package's ROOT without annotations)
is never raised: every output the step returns is recorded, so none goes
unaudited. Small tensors are exempt (a replicated LayerNorm bias is
right), and a layout with no >1-sized axis has nothing to shard over.
Intentionally replicated state is what the allowlist's reasons are for.
"""

from typing import Dict, List

from apex_tpu_torch.analysis.findings import SEV_WARNING, Finding
from apex_tpu_torch.analysis.passes import trace_pass

__all__ = ["DEFAULT_MIN_BYTES", "audit_entry_shardings", "functional_updates",
           "hlo_sharding_pass", "replicated_axes"]

#: tensors below this are not worth sharding (shared with the donation
#: auditor's floor)
DEFAULT_MIN_BYTES = 1 << 20


def functional_updates(module) -> Dict[int, int]:
    """``{param index: output index}``: the state tensors a step updates
    functionally, each paired (in order) with an output of its shape and
    dtype that lives in a fresh storage (the new value it returns). A
    tensor the step rebinds, returns in its own storage, or changes in
    place is updated otherwise and pairs with nothing."""
    before = {p.ptr_before for p in module.entry_params}
    returned = {o.ptr_after for o in module.entry_outputs}
    fresh: Dict[tuple, List[int]] = {}
    for o in module.entry_outputs:
        if o.ptr_after not in before:
            fresh.setdefault((o.shape.dims, o.shape.dtype), []).append(
                o.index)
    pairs = {}
    for p in module.entry_params:
        if p.rebound or p.ptr_before in returned or (
                p.digest_before is not None
                and p.digest_after != p.digest_before):
            continue
        outs = fresh.get((p.shape.dims, p.shape.dtype))
        if outs:
            pairs[p.index] = outs.pop(0)
    return pairs


def replicated_axes(module, mesh, min_bytes: int) -> Dict[str, List[str]]:
    """``{label: [axes]}``: each state tensor (``param:<index>``) and
    output (``output:<index>``) of >= ``min_bytes`` that the step
    updated, with the live axes on every rank of which it is equal. A
    collective over each live axis's group: every rank of the layout
    calls it, in the same order."""
    from apex_tpu_torch.parallel import parallel_state as ps

    mine = {}
    functional = functional_updates(module)
    for p in module.entry_params:
        if p.nbytes >= min_bytes and (p.updated or p.index in functional):
            mine[f"param:{p.index}"] = (p.shape.dims, p.shape.dtype,
                                        p.digest_after)
    # an output in an argument's storage that the step left unchanged
    # carries no update (its values may be equal everywhere by accident:
    # a shard of zero padding)
    same = {p.ptr_before: p for p in module.entry_params}
    for o in module.entry_outputs:
        kept = same.get(o.ptr_after)
        if o.nbytes >= min_bytes and (kept is None or kept.updated):
            mine[f"output:{o.index}"] = (o.shape.dims, o.shape.dtype,
                                         o.digest_after)
    shape = dict(mesh.shape)
    out: Dict[str, List[str]] = {}
    for axis in mesh.axis_names:
        if shape[axis] <= 1:
            continue
        views = ps.all_gather_object(mine, group=ps.get_group(axis))
        for key, val in mine.items():
            if all(v.get(key) == val for v in views):
                out.setdefault(key, []).append(axis)
    return out


def audit_entry_shardings(module, mesh, min_bytes: int = DEFAULT_MIN_BYTES,
                          target: str = "") -> List[Finding]:
    """Flag >= ``min_bytes`` state tensors and outputs whole on every
    rank of a live axis (:func:`replicated_axes`: a collective)."""
    if mesh is None or module is None:
        return []
    shape = dict(mesh.shape)
    live = [n for n in mesh.axis_names if shape[n] > 1]
    if not live:
        return []  # nothing to shard over
    replicated = replicated_axes(module, mesh, min_bytes)
    site = f"<step:{target or module.name}>"
    findings: List[Finding] = []
    for p in module.entry_params:
        axes = replicated.get(f"param:{p.index}")
        if axes:
            findings.append(Finding(
                rule="sharding.replicated-param",
                message=(f"state {p.label} ({p.shape}, {p.nbytes} B) is "
                         f"updated whole on every rank of "
                         f"{','.join(axes)} — shard it or allowlist the "
                         f"replication with its reason"),
                site=site, severity=SEV_WARNING, target=target,
                data={"param": p.label, "bytes": p.nbytes,
                      "index": p.index, "axes": axes}))
    for o in module.entry_outputs:
        axes = replicated.get(f"output:{o.index}")
        if axes:
            findings.append(Finding(
                rule="sharding.replicated-output",
                message=(f"step output #{o.index} ({o.shape}, {o.nbytes} B) "
                         f"is whole on every rank of {','.join(axes)} — "
                         f"shard it or allowlist the replication with its "
                         f"reason"),
                site=site, severity=SEV_WARNING, target=target,
                data={"output": o.index, "bytes": o.nbytes, "axes": axes}))
    return findings


@trace_pass("hlo-sharding")
def hlo_sharding_pass(ctx) -> List[Finding]:
    """The registered pass over the recorded step."""
    if ctx.mesh is None:
        return []
    return audit_entry_shardings(
        ctx.recording.module, ctx.mesh,
        min_bytes=ctx.target.sharding_min_bytes or DEFAULT_MIN_BYTES,
        target=ctx.name)
