"""Auto-remediation (counterpart of apex_tpu/resilience/remediation/):
only the policy so far, the response table and closed case machine that
the serving fleet's replica health runs on. The controller, campaign,
canary, supervisor and command line are not ported yet.
"""

from apex_tpu_torch.resilience.remediation.policy import (
    STATES,
    TERMINAL_STATES,
    TERMINAL_VERDICTS,
    TRANSITIONS,
    RemediationPolicy,
    advance,
)

__all__ = [
    "RemediationPolicy", "STATES", "TERMINAL_STATES", "TERMINAL_VERDICTS",
    "TRANSITIONS", "advance",
]
