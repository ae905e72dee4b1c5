"""Autofix: turn analysis findings into applied fixes (counterpart of
apex_tpu/analysis/autofix/).

The prescriptive half of ``apex_tpu_torch.analysis``: the passes find
replicated weight updates and state the step double-buffers; this
package derives concrete prescriptions for them (``derive.py`` -> typed
``Patch`` records, ``patches.py``), applies the applicable ones to step
builders whose specs are data, and re-audits to a bounded fixpoint
(``apply.py``). User code is never changed: those prescriptions render
as unified diffs.

Entry point: ``python -m apex_tpu_torch.analysis --fix``.
"""

from apex_tpu_torch.analysis.autofix.apply import (
    MAX_ROUNDS,
    FixReport,
    apply_fixes,
    render_user_diff,
)
from apex_tpu_torch.analysis.autofix.derive import derive_patches, update_axis
from apex_tpu_torch.analysis.autofix.patches import (
    KIND_CONSTRAINT,
    KIND_DONATE,
    KIND_SPEC,
    Patch,
)

__all__ = [
    "MAX_ROUNDS",
    "FixReport",
    "Patch",
    "KIND_SPEC",
    "KIND_DONATE",
    "KIND_CONSTRAINT",
    "apply_fixes",
    "derive_patches",
    "render_user_diff",
    "update_axis",
]
