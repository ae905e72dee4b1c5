"""Donation auditor: declared in-place state against the storage the step
really reused (counterpart of apex_tpu/analysis/donation.py).

In the JAX package donation is how a functional step stops
double-buffering the model: ``jit(step, donate_argnums=...)`` lets XLA
write the new state into the old state's buffers, and the auditor holds
the declaration to the compiled module's realized aliases. In eager
torch donation is storage reuse: a step that updates its state in place
(``p.add_``, ``m.copy_``) keeps it in one storage, one that builds new
tensors holds two copies while the old ones live. A
:class:`~apex_tpu_torch.analysis.passes.StepTarget` declares which
arguments it updates in place (``donate_argnums``, JAX's name), and the
recorder (``hlo/parser.py``) keeps each argument leaf's storage before
and after the step and each output's:

- ``donation.rejected`` — a declared state tensor whose storage changed
  across the step (the path now points at a new tensor: ``rebound``), or
  whose new value the step returns in a fresh storage
  (``fresh-output``): either way the old storage is not reused. Error at
  or above ``min_donatable_bytes``, info below (a rebound scalar wastes
  nothing worth chasing), as in JAX;
- ``donation.missed`` (warning) — a state tensor of ``min_donatable_bytes``
  or more, not declared, whose output of the same shape and dtype took a
  fresh storage while the old one lived: a second copy of the state at
  the step's peak.

A target that declares nothing (``donate_argnums=None``) is not audited,
as in JAX. ``donation.unverifiable`` (JAX: the HLO parameters could not
be mapped to the input leaves) cannot arise: the leaves are the
recorded tensors themselves.
"""

from typing import Iterable, List

from apex_tpu_torch.analysis.findings import (
    SEV_ERROR,
    SEV_INFO,
    SEV_WARNING,
    Finding,
)
from apex_tpu_torch.analysis.passes import trace_pass

__all__ = ["DEFAULT_MIN_DONATABLE_BYTES", "audit_donation", "donation_pass"]

#: tensors below this are not worth donating; "could be donated" findings
#: fire only above it
DEFAULT_MIN_DONATABLE_BYTES = 1 << 20


def audit_donation(module, donate_argnums, target: str = "",
                   min_donatable_bytes: int = DEFAULT_MIN_DONATABLE_BYTES
                   ) -> List[Finding]:
    """Audit one recorded step's storage reuse; see the module docstring."""
    if donate_argnums is None or module is None:
        return []
    from apex_tpu_torch.analysis.hlo.sharding_audit import functional_updates

    declared = set(donate_argnums)
    site = f"<step:{target or module.name}>"
    findings: List[Finding] = []
    functional = functional_updates(module)
    for p in module.entry_params:
        if p.argnum not in declared:
            continue
        if p.ptr_after is None:
            stage, how = "dropped", "dropped it"
        elif p.rebound:
            stage, how = "rebound", "moved it to a new storage"
        elif p.index in functional:
            stage = "fresh-output"
            how = "returns its new value in a fresh storage"
        else:
            continue
        sev = SEV_ERROR if p.nbytes >= min_donatable_bytes else SEV_INFO
        findings.append(Finding(
            rule="donation.rejected",
            message=(f"{p.label} ({p.nbytes} B) is declared updated in place "
                     f"but the step {how}: its storage is not reused"),
            site=site, severity=sev, target=target,
            data={"leaf": p.label, "bytes": p.nbytes, "stage": stage}))

    # state whose new value comes back in a fresh storage (paired by
    # shape and dtype with a returned tensor), not declared
    for p in module.entry_params:
        if (p.argnum in declared or p.nbytes < min_donatable_bytes
                or p.index not in functional):
            continue
        findings.append(Finding(
            rule="donation.missed",
            message=(f"{p.label} ({p.nbytes} B) is not declared updated in "
                     f"place and the step returns its new value in a fresh "
                     f"storage: updating it in place would reuse the "
                     f"storage instead of double-buffering"),
            site=site, severity=SEV_WARNING, target=target,
            data={"leaf": p.label, "bytes": p.nbytes}))
    return findings


@trace_pass("donation")
def donation_pass(ctx) -> Iterable[Finding]:
    t = ctx.target
    if t.donate_argnums is None:
        return []
    return audit_donation(
        ctx.recording.module, t.donate_argnums, target=ctx.name,
        min_donatable_bytes=(t.donation_min_bytes
                             or DEFAULT_MIN_DONATABLE_BYTES))
