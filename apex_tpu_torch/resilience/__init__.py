"""Training and serving health: the anomaly sentinel, fault injection,
the exit-code taxonomy, the remediation policy and the incident
responder (``health``)."""

from apex_tpu_torch.resilience.chaos import (
    FaultPlan,
    bitflip_leaf,
    parse_steps,
    poison_loss,
    simulate_sigterm,
    wedge,
)
from apex_tpu_torch.resilience.health import (
    INCIDENT_EXIT_CODE,
    IncidentResponder,
    capture_incident,
    thread_stacks,
)
from apex_tpu_torch.resilience.exit_codes import (
    RESTARTABLE_EXIT_CODES,
    ExitCode,
)
from apex_tpu_torch.resilience.sentinel import (
    VERDICT_HALT,
    VERDICT_OK,
    VERDICT_ROLLBACK,
    VERDICT_SKIP,
    AnomalySentinel,
    SentinelState,
    verdict_name,
)

__all__ = [
    "AnomalySentinel", "ExitCode", "FaultPlan", "INCIDENT_EXIT_CODE",
    "IncidentResponder", "RESTARTABLE_EXIT_CODES",
    "SentinelState", "VERDICT_HALT", "VERDICT_OK", "VERDICT_ROLLBACK",
    "VERDICT_SKIP", "bitflip_leaf", "parse_steps", "poison_loss",
    "capture_incident", "simulate_sigterm", "thread_stacks",
    "verdict_name", "wedge",
]
