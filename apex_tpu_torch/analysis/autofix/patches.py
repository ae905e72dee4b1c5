"""Typed prescription records: what the autofix derivation emits
(counterpart of apex_tpu/analysis/autofix/patches.py).

A :class:`Patch` is one concrete, checkable fix for one flagged state
tensor: a shard spec (the layout axes to split it over, the port's
``PartitionSpec``), a user-code insertion site, or an in-place
declaration (JAX's ``donate_argnums`` addition). Patches are data about
code, never code edits: the applier (``apply.py``) injects them into
step builders whose specs are data (``targets.py``), and renders a
unified diff for user code instead of changing it.

Every prescription carries the predicted wire-byte delta on its axis
under the xray ledger's ring convention (``monitor/xray/ledger.py``):
sharding a replicated weight update turns the full-payload gradient
all-reduce into a reduce-scatter, saving ``ici(psum, B) -
ici(psum_scatter, B)`` wire bytes a step for a tensor of ``B`` bytes
(arXiv:2004.13336's accounting, as the sharding auditor cites it).

Patches export as ``kind="analysis"`` findings with the ``fix=`` payload
(:meth:`Patch.to_finding`), so prescriptions ride the same jsonl stream
as the defects they fix.
"""

import dataclasses
from typing import Optional, Tuple

from apex_tpu_torch.analysis.findings import SEV_INFO, Finding

__all__ = ["Patch", "KIND_SPEC", "KIND_DONATE", "KIND_CONSTRAINT"]

KIND_SPEC = "shard-spec"
KIND_DONATE = "donate"
KIND_CONSTRAINT = "constraint"
_KINDS = (KIND_SPEC, KIND_DONATE, KIND_CONSTRAINT)


@dataclasses.dataclass(frozen=True)
class Patch:
    """One prescription.

    - ``kind``: ``shard-spec`` (inject a shard spec for an argument),
      ``donate`` (declare an argument updated in place), or
      ``constraint`` (shard at ``site`` in user code: rendered as a
      diff, never applied).
    - ``target``: the StepTarget the prescription belongs to.
    - ``argnum``/``leaf``: the flagged argument and its label.
    - ``spec``: the prescribed shard spec, a tuple of axis names per
      dimension (None for ``donate``).
    - ``site``: where to apply: a builder slot (``<builder:kwarg>``) or
      a ``file.py:line`` insertion site for user code.
    - ``slot``: the builder keyword the applier injects into; None means
      not applicable by the applier (user code, or no builder hook).
    - ``wire_delta``: predicted wire-byte saving a step on ``axis`` under
      the ledger's convention (0 for donation, whose saving is memory:
      ``hbm_delta``).
    """

    kind: str
    target: str
    argnum: Optional[int]
    leaf: str
    spec: Optional[Tuple] = None
    site: str = ""
    reason: str = ""
    axis: str = ""
    wire_delta: int = 0
    hbm_delta: int = 0
    slot: Optional[str] = None

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"patch kind must be one of {_KINDS}, "
                             f"got {self.kind!r}")

    @property
    def auto(self) -> bool:
        """Applicable: the target's builder exposes a slot for it."""
        return self.slot is not None

    def payload(self) -> dict:
        """The ``fix=`` payload: JSON-safe, the spec rendered as source."""
        return {
            "kind": self.kind,
            "argnum": self.argnum,
            "leaf": self.leaf,
            "spec": _spec_src(self.spec) if self.spec is not None else None,
            "site": self.site,
            "reason": self.reason,
            "axis": self.axis,
            "wire_delta_bytes": self.wire_delta,
            "hbm_delta_bytes": self.hbm_delta,
            "auto": self.auto,
        }

    def to_finding(self) -> Finding:
        """The prescription as a ``kind="analysis"`` finding (info: the
        fix, not a defect; the defect is already on the stream)."""
        return Finding(
            rule="autofix.prescription",
            message=self.describe(),
            site=self.site or f"<fix:{self.target}>",
            severity=SEV_INFO,
            target=self.target,
            data={"kind": self.kind, "leaf": self.leaf},
            fix=self.payload(),
        )

    def describe(self) -> str:
        if self.kind == KIND_DONATE:
            return (f"declare argnum {self.argnum} ({self.leaf}) updated in "
                    f"place — frees {self.hbm_delta} B of double-buffered "
                    f"memory ({self.reason})")
        how = (f"inject via builder kwarg {self.slot!r}" if self.auto
               else f"shard it at {self.site}")
        return (f"shard {self.leaf} (arg {self.argnum}) as "
                f"{_spec_src(self.spec)} — {how}; predicted {self.axis!r}-"
                f"axis wire delta {self.wire_delta} B/step ({self.reason})")


def _spec_src(spec) -> str:
    """A shard spec as source text: the tuple of axis names."""
    return repr(tuple(spec)) if spec is not None else "()"
