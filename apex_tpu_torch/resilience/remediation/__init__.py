"""Self-healing runs: detector findings -> bounded recovery actions
(counterpart of apex_tpu/resilience/remediation/).

- ``policy``     — the closed action state machine (verify ->
  quarantine -> probation -> readmit | cleared | recovered | halted) and
  the :class:`RemediationPolicy` bounds table.
- ``state``      — the persisted cross-incarnation plan
  (``<save>/remediation-state.json``) and the reversible
  checkpoint-quarantine move.
- ``controller`` — :class:`RemediationController`: detector records in,
  decisions out (restart/halt + exit code), every transition one
  ``kind="remediation"`` record with its evidence; canary verification
  before any restart.
- ``canary``     — the replayer-backed verifier (:class:`GPTCanary`).
- ``supervisor`` — the relauncher: exit codes in, bounded incarnations
  out (``torch.distributed.run`` worlds of the persisted device count,
  through ``launch``, which exits with the failed rank's own code).
- ``campaign``   — seeded randomized fault sequences against the GPT
  target, the invariant checker and failing-sequence minimization.

CLI: ``python -m apex_tpu_torch.resilience.remediation`` (``--selftest``,
``--supervise``, ``--campaign N``). The host-only pieces (policy, state,
controller, supervisor) import eagerly; the canary and the campaign,
which build the model, load on first use (PEP 562).
"""

from apex_tpu_torch.resilience.remediation.controller import (
    DETECTOR_KINDS,
    ControllerSink,
    RemediationController,
    RemediationDecision,
)
from apex_tpu_torch.resilience.remediation.policy import (
    CASE_KINDS,
    STATES,
    TERMINAL_STATES,
    TERMINAL_VERDICTS,
    TRANSITIONS,
    RemediationPolicy,
    advance,
)
from apex_tpu_torch.resilience.remediation.state import (
    RemediationState,
    quarantine_checkpoints,
    state_path,
)
from apex_tpu_torch.resilience.remediation.supervisor import (
    SupervisorReport,
    supervise,
    torchrun_command,
)

__all__ = [
    "CASE_KINDS", "ControllerSink", "DETECTOR_KINDS", "RemediationController",
    "RemediationDecision", "RemediationPolicy", "RemediationState",
    "STATES", "SupervisorReport", "TERMINAL_STATES", "TERMINAL_VERDICTS",
    "TRANSITIONS", "advance", "quarantine_checkpoints", "state_path",
    "supervise", "torchrun_command",
    # the model-building pieces, loaded on first use (PEP 562)
    "FaultEvent", "GPTCanary", "TrainingCache", "check_invariants",
    "minimize_failing", "random_sequence", "run_campaign", "run_sequence",
]

_LAZY = {
    "GPTCanary": "apex_tpu_torch.resilience.remediation.canary",
    "FaultEvent": "apex_tpu_torch.resilience.remediation.campaign",
    "TrainingCache": "apex_tpu_torch.resilience.remediation.campaign",
    "random_sequence": "apex_tpu_torch.resilience.remediation.campaign",
    "run_sequence": "apex_tpu_torch.resilience.remediation.campaign",
    "check_invariants": "apex_tpu_torch.resilience.remediation.campaign",
    "minimize_failing": "apex_tpu_torch.resilience.remediation.campaign",
    "run_campaign": "apex_tpu_torch.resilience.remediation.campaign",
}


def __getattr__(name):
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(name)
    import importlib

    return getattr(importlib.import_module(target), name)
