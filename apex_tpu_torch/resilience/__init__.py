"""Training and serving health: the anomaly sentinel, fault injection,
the exit-code taxonomy, the incident responder (``health``), the
rollback ladder (``rollback``), checkpoint integrity (``integrity``),
the shared retry policy (``retry``), the elastic restore across a change
of layout (``elastic``), deterministic replay (``replay``) and the
self-healing loop (``remediation``)."""

from apex_tpu_torch.resilience.chaos import (
    FaultPlan,
    bitflip_leaf,
    corrupt_checkpoint,
    corrupt_latest_checkpoint,
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
from apex_tpu_torch.resilience.integrity import (
    apply_retention,
    load_checkpoint_verified,
    manifest_path,
    read_manifest,
    save_checkpoint_verified,
    save_with_retry,
    tree_fingerprint,
    verified_latest_step,
    verified_steps,
    verify_checkpoint,
    write_abandoned_marker,
    write_manifest,
)
from apex_tpu_torch.resilience.retry import retry_with_backoff
from apex_tpu_torch.resilience.rollback import (
    EscalationPolicy,
    ResilienceManager,
    RollbackBuffer,
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
    "AnomalySentinel", "EscalationPolicy", "ExitCode", "FaultPlan",
    "INCIDENT_EXIT_CODE", "IncidentResponder", "RESTARTABLE_EXIT_CODES",
    "ResilienceManager", "RollbackBuffer", "SentinelState", "VERDICT_HALT",
    "VERDICT_OK", "VERDICT_ROLLBACK", "VERDICT_SKIP", "apply_retention",
    "bitflip_leaf", "capture_incident", "corrupt_checkpoint",
    "corrupt_latest_checkpoint", "load_checkpoint_verified",
    "manifest_path", "parse_steps", "poison_loss", "read_manifest",
    "retry_with_backoff", "save_checkpoint_verified", "save_with_retry",
    "simulate_sigterm", "thread_stacks", "tree_fingerprint",
    "verdict_name", "verified_latest_step", "verified_steps",
    "verify_checkpoint", "wedge", "write_abandoned_marker",
    "write_manifest",
]
