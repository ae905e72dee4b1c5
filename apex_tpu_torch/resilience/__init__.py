"""Training health: the anomaly sentinel and fault injection."""

from apex_tpu_torch.resilience.chaos import poison_loss
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
    "AnomalySentinel", "SentinelState", "VERDICT_HALT", "VERDICT_OK",
    "VERDICT_ROLLBACK", "VERDICT_SKIP", "poison_loss", "verdict_name",
]
