"""Ghost-collective differ: the step's dispatched collectives against the
ledger (counterpart of apex_tpu/analysis/hlo/comms_diff.py).

The xray ledger (``monitor/xray/ledger.py``) records what the program
ASKED for: every collective ``parallel_state``'s helpers issue. The
recorder (``analysis/passes.py``) keeps every c10d op that reached the
transport (``hlo/parser.py``), whichever code issued it. This pass
attributes each op's process group to a layout axis
(``hlo/attribution.py``) and diffs the two sides in the JAX package's
currency, (op class, axis, operand elements):

- ``comms.unpredicted`` (error) — a collective the ledger never saw: one
  issued outside ``parallel_state``'s helpers (a bare ``dist.*`` call in
  a step, a library's own collective), reported at its site;
- ``comms.vanished``    (warning) — a predicted bucket with no
  dispatched counterpart at all: the program records traffic that never
  reaches the transport;
- ``comms.folded``      (info) — a bucket with fewer dispatched ops than
  predicted, but not none;
- ``comms.unverifiable``(info) — no layout to attribute groups against,
  or no recording: comms NOT verified (callers promising verification,
  the examples' ``--audit-comms``, treat this as not ok);
- ``comms.quantized``   (info) — positive confirmation that the 8-bit
  payloads of ``parallel/compress.py``'s int8/fp8 paths (fp8 crosses
  gloo as its uint8 view) were dispatched as the ledger predicted.

Two rules of the JAX package's table are never raised here, and stay in
:data:`RULES` with the reason: ``comms.reshard`` comes from XLA's SPMD
partitioner, which inserts collectives at sharding boundaries; eager
torch has no partitioner, so a collective the program did not issue
cannot appear. ``comms.async`` confirms an op XLA split into a
``-start``/``-done`` pair for its latency-hiding scheduler; over gloo
every collective is one blocking call (a ``send`` posted early is still
one op), so no such pair exists.

Because both sides come from the same eager run, a clean step matches
exactly: the one way to a mismatch is a collective the ledger cannot
see, or a ledger record that no transport call follows.
"""

import dataclasses
from typing import Dict, List, Tuple

from apex_tpu_torch.analysis.findings import (
    SEV_ERROR,
    SEV_INFO,
    SEV_WARNING,
    Finding,
)
from apex_tpu_torch.analysis.hlo import attribution
from apex_tpu_torch.analysis.passes import trace_pass

__all__ = ["OP_CLASS", "RULES", "audit_comms", "diff_buckets",
           "hlo_comms_pass"]

#: ledger op -> the dispatched op's class (the JAX package's opcodes)
OP_CLASS = {
    "psum": "all-reduce",
    "pmean": "all-reduce",
    "pmax": "all-reduce",
    "pmin": "all-reduce",
    "all_gather": "all-gather",
    "psum_scatter": "reduce-scatter",
    "ppermute": "collective-permute",
    "all_to_all": "all-to-all",
    "broadcast": "broadcast",
}

#: the rule table: rule -> what raises it in the port
RULES = {
    "comms.unpredicted": "a dispatched collective the ledger never saw",
    "comms.vanished": "a predicted bucket with no dispatched op",
    "comms.folded": "fewer dispatched ops than predicted in a bucket",
    "comms.unverifiable": "no layout or no recording to diff",
    "comms.quantized": "8-bit payloads matched to the ledger",
    "comms.reshard": "never: eager torch has no SPMD partitioner to insert "
                     "a collective the program did not issue",
    "comms.async": "never: gloo runs each collective as one blocking call, "
                   "with no -start/-done pair to overlap",
}

BucketKey = Tuple[str, str, int]  # (op class, axis label, operand elements)


@dataclasses.dataclass
class _Unit:
    """One matchable dispatched payload: one operand of one op."""

    kind: str
    axis: str
    elements: int
    nbytes: int
    dtype: str
    instr: object

    @property
    def key(self) -> BucketKey:
        return (self.kind, self.axis, self.elements)


def _predicted_buckets(ledger, mesh) -> Dict[BucketKey, int]:
    pred: Dict[BucketKey, int] = {}
    for e in ledger.entries:
        axis = attribution.canon_axis_key(mesh, e.axis)
        if axis == attribution.AXIS_NONE:
            continue
        elements = 1
        for d in e.shape:
            elements *= d
        key = (OP_CLASS.get(e.op, e.op), axis, elements)
        pred[key] = pred.get(key, 0) + e.count
    return pred


def _emitted_units(module, mesh) -> List[_Unit]:
    partitions = attribution.mesh_axis_partitions(mesh)
    units: List[_Unit] = []
    for c in module.collectives_in_entry():
        if c.kind == "recv_":
            continue  # the receiving half of a send: no payload of its own
        axis = attribution.axis_of_collective(mesh, c, partitions)
        if axis == attribution.AXIS_NONE:
            continue  # one-rank groups: zero bytes, the ledger's dead list
        for op in c.operands:
            units.append(_Unit(kind=c.op_class, axis=axis,
                               elements=op.elements, nbytes=op.nbytes,
                               dtype=op.shape.dtype, instr=c))
    return units


def audit_comms(module, ledger, mesh, target: str = "") -> List[Finding]:
    """Diff the recorded ``module``'s collectives against ``ledger``, the
    same step's; see the module docstring for the rules."""
    site0 = f"<step:{target or 'step'}>"
    if mesh is None:
        return [Finding(
            rule="comms.unverifiable",
            message="no layout available: process groups cannot be "
                    "attributed to axes, comms NOT verified",
            site=site0, severity=SEV_INFO, target=target)]
    if module is None or ledger is None:
        return [Finding(
            rule="comms.unverifiable",
            message="the step was not recorded (no dispatched ops or no "
                    "ledger): comms NOT verified",
            site=site0, severity=SEV_INFO, target=target)]

    return diff_buckets(_emitted_units(module, mesh),
                        _predicted_buckets(ledger, mesh), target)


def diff_buckets(units: List[_Unit], pred: Dict[BucketKey, int],
                 target: str = "") -> List[Finding]:
    """The matcher itself: dispatched ``units`` against predicted bucket
    counts ``pred``, in the JAX package's stages (exact matches, ops of
    the helpers first; then the unpredicted, the vanished and folded,
    and the quantized confirmation)."""
    site0 = f"<step:{target or 'step'}>"
    emitted_keys = {u.key for u in units}
    findings: List[Finding] = []
    remaining = dict(pred)
    consumed_any: Dict[BucketKey, bool] = {k: False for k in pred}

    # exact bucket matches; ops the helpers issued (the ledger-recorded
    # ones) consume predictions first, so any excess is reported at the
    # site that is not the wrapper
    matched: List[_Unit] = []
    unmatched: List[_Unit] = []
    for u in sorted(units, key=lambda u: (not u.instr.via_helper,
                                          u.instr.line)):
        if remaining.get(u.key, 0) > 0:
            remaining[u.key] -= 1
            consumed_any[u.key] = True
            matched.append(u)
        else:
            unmatched.append(u)

    # dispatched but never predicted: the gate's reason to be
    for u in unmatched:
        c = u.instr
        data = {"op": u.kind, "axis": u.axis, "elements": u.elements,
                "bytes": u.nbytes, "dtype": u.dtype, "c10d": c.kind,
                "group_size": c.group_size or 2, "backend": c.backend}
        findings.append(Finding(
            rule="comms.unpredicted",
            message=(f"the step dispatched {c.kind} ({u.kind}) over "
                     f"{u.axis!r} ({u.elements} el, {u.nbytes} B "
                     f"{u.dtype}) that matches no ledger record: a "
                     f"collective issued outside parallel_state's "
                     f"helpers"),
            site=c.site, severity=SEV_ERROR, target=target, data=data))

    # predicted but not dispatched
    for key, n in sorted(remaining.items(), key=str):
        if n <= 0:
            continue
        cls, axis, elements = key
        if consumed_any.get(key) or key in emitted_keys:
            findings.append(Finding(
                rule="comms.folded",
                message=(f"{n} predicted {cls} over {axis!r} ({elements} "
                         f"el) beyond what the step dispatched"),
                site=site0, severity=SEV_INFO, target=target, count=n,
                data={"op": cls, "axis": axis, "elements": elements}))
        else:
            findings.append(Finding(
                rule="comms.vanished",
                message=(f"{n} predicted {cls} over {axis!r} ({elements} "
                         f"el) never reached the transport: traffic the "
                         f"ledger records that no collective follows"),
                site=site0, severity=SEV_WARNING, target=target, count=n,
                data={"op": cls, "axis": axis, "elements": elements}))

    # positive confirmation of the 8-bit payloads (parallel/compress.py)
    quantized: Dict[str, Dict[str, int]] = {}
    for u in matched:
        if not u.dtype.startswith(("int8", "uint8", "float8")):
            continue
        d = quantized.setdefault(u.axis, {"ops": 0, "bytes": 0})
        d["ops"] += 1
        d["bytes"] += u.nbytes
    for axis, d in sorted(quantized.items()):
        findings.append(Finding(
            rule="comms.quantized",
            message=(f"quantized collective pattern verified over {axis!r}: "
                     f"{d['ops']} 8-bit-payload op(s), {d['bytes']} payload "
                     f"bytes, all matched to ledger records"),
            site=site0, severity=SEV_INFO, target=target,
            data={"axis": axis, "ops": d["ops"], "bytes": d["bytes"]}))
    return findings


@trace_pass("hlo-comms")
def hlo_comms_pass(ctx) -> List[Finding]:
    """The registered pass: the recorded step's module and ledger."""
    if ctx.mesh is None:
        return []
    rec = ctx.recording
    return audit_comms(rec.module, rec.ledger, ctx.mesh, target=ctx.name)
