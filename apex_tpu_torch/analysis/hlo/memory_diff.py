"""Measured-memory differ: the recorded step against the HBM ledger
(counterpart of apex_tpu/analysis/hlo/memory_diff.py).

The analytic ledger (``monitor/xray/hbm/model.py``) predicts a step's
per-device memory in closed form. The JAX package holds it to the
compiled program's ``memory_analysis()``; the port holds it to what the
recorded step (``hlo/parser.py``) really held:

- the resident components (weights, optimizer state, scaler state, the
  sentinel's state, batch data) are measured from the step's state
  tensors, booked by their root (:data:`COMPONENT_ROOTS`): they match
  exactly on either device, their layout being deterministic;
- the peak and the temporaries come from the caching allocator on the
  card (``monitor/xray/hbm/live.py``, the one home ``lint.memory-api``
  allows), over the recorder's second, warm run of the step (the first
  run in a process also allocates one-time workspaces, such as
  cuBLAS's): temporaries are the peak of the bytes the step's tensors
  asked for above what was in use when it began (before the allocator's
  block rounding), held to ``temp_band`` times the predicted transient
  bytes; the headroom reads the allocated peak. On the CPU no allocator
  reports them: ``memory.unverifiable``, as JAX's is with no capacity.

The five rules, as in the JAX package:

- ``memory.unpredicted``  (error) — a resident component whose bytes
  differ from the prediction, state bytes booked to no predicted
  component, or temporaries beyond the band;
- ``memory.headroom``     (warning) — the peak within
  ``headroom_fraction`` of the card's capacity;
- ``memory.overpredicted``(info) — the measured peak below the
  prediction;
- ``memory.reconciled``   (info) — every resident component matched
  exactly and the temporaries sat inside the band, with the table;
- ``memory.unverifiable`` (info) — no allocator report, or no
  prediction on the target (``StepTarget.hbm``).

The band is the JAX package's and reports what it finds.
"""

from typing import Dict, List, Optional, Tuple

from apex_tpu_torch.analysis.findings import (
    SEV_ERROR,
    SEV_INFO,
    SEV_WARNING,
    Finding,
)
from apex_tpu_torch.analysis.passes import trace_pass

__all__ = [
    "COMPONENT_ROOTS",
    "audit_memory",
    "largest_buffers",
    "hlo_memory_pass",
]

#: ledger component -> the state roots it books (a state object's field,
#: or an argument's name); roots claimed by no component book to
#: ``batch_data``
COMPONENT_ROOTS: Dict[str, Tuple[str, ...]] = {
    "weights": ("params",),
    "optimizer_state": ("opt", "opt_state", "m", "v"),
    "scaler_state": ("scaler", "scaler_state"),
    "sentinel_state": ("sentinel",),
}

#: measured temporaries may exceed the predicted transient bytes by this
#: factor before they are unpredicted (the JAX package's band)
DEFAULT_TEMP_BAND = 4.0

#: warn when the peak lands within this fraction of capacity
DEFAULT_HEADROOM_FRACTION = 0.1


def largest_buffers(module, n: int = 5) -> List[dict]:
    """The ``n`` largest state tensors, largest first."""
    rows = [{"name": p.label[:120], "bytes": int(p.nbytes)}
            for p in module.entry_params]
    rows.sort(key=lambda r: r["bytes"], reverse=True)
    return rows[:n]


def _measured_components(module, predicted) -> Tuple[Dict[str, int], int]:
    """(component -> measured bytes, unattributed bytes)."""
    root_of = {}
    for comp, roots in COMPONENT_ROOTS.items():
        if predicted.component(comp) is not None:
            for r in roots:
                root_of[r] = comp
    has_data = predicted.component("batch_data") is not None
    measured: Dict[str, int] = {}
    unattributed = 0
    for p in module.entry_params:
        comp = root_of.get(p.root)
        if comp is None and has_data:
            comp = "batch_data"
        if comp is None:
            unattributed += p.nbytes
            continue
        measured[comp] = measured.get(comp, 0) + p.nbytes
    return measured, unattributed


def audit_memory(module, predicted=None, target: str = "",
                 capacity_bytes: Optional[int] = None,
                 headroom_fraction: float = DEFAULT_HEADROOM_FRACTION,
                 temp_band: float = DEFAULT_TEMP_BAND) -> List[Finding]:
    """Reconcile the analytic ``predicted`` (an ``hbm.model.HbmBreakdown``)
    against the recorded ``module``; see the module docstring."""
    site0 = f"<step:{target or 'step'}>"
    findings: List[Finding] = []
    mem = module.memory if module is not None else None
    if predicted is None:
        return [Finding(
            rule="memory.unverifiable",
            message="target carries no analytic HBM ledger (StepTarget.hbm) "
                    "— prediction NOT verified",
            site=site0, severity=SEV_INFO, target=target,
            data={"measured": mem})]
    if module is None or not module.entry_params:
        return [Finding(
            rule="memory.unverifiable",
            message="the step's state was not recorded — component "
                    "attribution NOT verified",
            site=site0, severity=SEV_INFO, target=target)]

    measured, unattributed = _measured_components(module, predicted)
    table = {}
    ok = True
    for comp in sorted(set(measured) | {c.name for c in predicted.components
                                        if not c.transient}):
        pred_c = predicted.component(comp)
        if pred_c is None or pred_c.transient:
            continue
        got, want = measured.get(comp, 0), pred_c.bytes
        table[comp] = {"predicted": want, "measured": got}
        if got != want:
            ok = False
            findings.append(Finding(
                rule="memory.unpredicted",
                message=(f"component {comp!r}: predicted {want} bytes but "
                         f"the step's state holds {got} (delta "
                         f"{got - want:+d}) — the ledger's layout "
                         f"arithmetic disagrees with the port's"),
                site=site0, severity=SEV_ERROR, target=target,
                data={"component": comp, "predicted": want, "measured": got,
                      "largest_buffers": largest_buffers(module)}))
    if unattributed:
        ok = False
        findings.append(Finding(
            rule="memory.unpredicted",
            message=(f"{unattributed} state bytes book to no predicted "
                     f"component — the model cannot account for them"),
            site=site0, severity=SEV_ERROR, target=target,
            data={"unattributed_bytes": unattributed,
                  "largest_buffers": largest_buffers(module)}))
    resident = sum(p.nbytes for p in module.entry_params)
    if mem is None:
        findings.append(Finding(
            rule="memory.unverifiable",
            message=("no allocator report on this device: the resident "
                     "components were reconciled "
                     + ("exactly" if ok else "with the errors above")
                     + ", the peak and the temporaries NOT verified"),
            site=site0, severity=SEV_INFO, target=target,
            data={"components": table}))
        return findings

    before, after = mem["before"], mem["after"]
    peak = int(after["peak_bytes_in_use"])
    # temporaries in the bytes the tensors asked for: the allocator's
    # block rounding is no live range the ledger could model
    temp = max(0, int(after["peak_requested_bytes"])
               - int(before["requested_bytes_in_use"]))
    transient = max(1, predicted.transient_bytes)
    temp_ratio = temp / transient
    if temp_ratio > temp_band:
        ok = False
        findings.append(Finding(
            rule="memory.unpredicted",
            message=(f"{temp} temporary bytes exceed the declared band "
                     f"({temp_band:.1f}x the {predicted.transient_bytes} "
                     f"predicted transient bytes, ratio {temp_ratio:.2f}) "
                     f"— an unmodeled live range dominates the step"),
            site=site0, severity=SEV_ERROR, target=target,
            data={"temp_bytes": temp,
                  "predicted_transient_bytes": predicted.transient_bytes,
                  "temp_band": temp_band, "peak_bytes": peak,
                  "largest_buffers": largest_buffers(module)}))
    if ok:
        findings.append(Finding(
            rule="memory.reconciled",
            message=(f"resident components reconciled exactly "
                     f"({len(table)} components, {resident} state bytes) "
                     f"and temporaries within the band (ratio "
                     f"{temp_ratio:.2f} <= {temp_band:.1f})"),
            site=site0, severity=SEV_INFO, target=target,
            data={"components": table, "temp_bytes": temp,
                  "temp_ratio": round(temp_ratio, 4),
                  "predicted_peak_bytes": predicted.peak_bytes,
                  "measured_peak_bytes": peak}))
    if predicted.peak_bytes > peak:
        findings.append(Finding(
            rule="memory.overpredicted",
            message=(f"predicted peak {predicted.peak_bytes} exceeds the "
                     f"measured peak {peak} by {predicted.peak_bytes - peak}"
                     f" bytes — model pessimism"),
            site=site0, severity=SEV_INFO, target=target,
            data={"predicted_peak_bytes": predicted.peak_bytes,
                  "measured_peak_bytes": peak}))
    capacity = (capacity_bytes or after.get("bytes_limit")
                or predicted.capacity_bytes)
    if capacity:
        top = max(peak, predicted.peak_bytes)
        if top > (1.0 - headroom_fraction) * capacity:
            findings.append(Finding(
                rule="memory.headroom",
                message=(f"peak {top} bytes lands within "
                         f"{headroom_fraction:.0%} of the {capacity}-byte "
                         f"capacity — the config fits today and runs out on "
                         f"the first regression"),
                site=site0, severity=SEV_WARNING, target=target,
                data={"peak_bytes": top, "capacity_bytes": capacity,
                      "headroom_fraction": headroom_fraction}))
    return findings


@trace_pass("hlo-memory")
def hlo_memory_pass(ctx) -> List[Finding]:
    """The registered pass: the recorded step against ``StepTarget.hbm``
    (None -> ``memory.unverifiable``)."""
    return audit_memory(ctx.recording.module,
                        predicted=getattr(ctx.target, "hbm", None),
                        target=ctx.name)
