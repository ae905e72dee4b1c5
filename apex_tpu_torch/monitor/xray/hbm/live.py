"""Live device-memory watermarks: the measure leg of the HBM x-ray
(counterpart of apex_tpu/monitor/xray/hbm/live.py).

``model.py`` predicts; this module samples what PyTorch's caching
allocator ACTUALLY holds at runtime (``torch.cuda.memory_stats``: bytes
allocated now and their peak, and ``torch.cuda.mem_get_info``'s total as
the limit), emitted as ``kind="memory"`` records through the
MetricRouter with the peak joined against the analytic prediction.

Off CUDA the functions return None, as the JAX package's do off the
accelerator: achieved-against-predicted is then None, never a fake
number, and the records still flow so the join's absence shows.

:class:`HbmWatermarkMonitor` follows the ``goodput/live.LiveFleetMonitor``
cadence (anchor on the first call, then every ``interval_steps``); a
headroom breach emits a ``headroom_breach=True`` record and a warning.
:func:`kv_pool_fields` is the serving engine's KV-pool record, plain
Python.
"""

import logging
from typing import Optional

import torch

__all__ = [
    "device_watermarks",
    "device_memory_limit",
    "HbmWatermarkMonitor",
    "kv_pool_fields",
]

logger = logging.getLogger(__name__)


def _cuda(device) -> Optional[torch.device]:
    if device is None or not torch.cuda.is_available():
        return None
    device = torch.device(device)
    return device if device.type == "cuda" else None


def device_watermarks(device) -> Optional[dict]:
    """Allocator watermarks for one card: ``{"bytes_in_use",
    "peak_bytes_in_use", "bytes_limit", "requested_bytes_in_use",
    "peak_requested_bytes"}`` (the caching allocator's allocated bytes,
    their peak since the last ``torch.cuda.reset_peak_memory_stats``, the
    card's total memory, and the bytes the tensors asked for before the
    allocator's block rounding, now and at their peak), or None for a
    device that is not a CUDA card."""
    device = _cuda(device)
    if device is None:
        return None
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current"),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
        "bytes_limit": torch.cuda.mem_get_info(device)[1],
        "requested_bytes_in_use": stats.get("requested_bytes.all.current"),
        "peak_requested_bytes": stats.get("requested_bytes.all.peak"),
    }


def device_memory_limit(device=None) -> Optional[int]:
    """The card's total memory in bytes, or None off CUDA. ``device``
    defaults to the current card."""
    if device is None:
        device = "cuda"
    wm = device_watermarks(device)
    return None if wm is None else wm.get("bytes_limit")


class HbmWatermarkMonitor:
    """Per-interval watermark sampling joined against the prediction.

    ``predicted`` is an ``hbm.model.HbmBreakdown`` (or None — the
    monitor still samples, utilization just stays None);
    ``capacity_bytes`` overrides the allocator's ``bytes_limit`` when
    given (virtual-topology rehearsals). A sample whose bytes-in-use
    exceed ``(1 - headroom_fraction) * capacity`` is a breach: the
    record carries ``headroom_breach=True`` and the monitor logs a
    warning. ``metrics_fields()`` exposes the newest sample as metric
    gauges (``peak_hbm_bytes``, ``hbm_utilization``) for merging into
    ``router.metrics`` calls — the keys ``CsvSink`` tolerates.
    """

    def __init__(self, router, *, interval_steps: int = 50, predicted=None,
                 capacity_bytes: Optional[int] = None,
                 headroom_fraction: float = 0.1, device=None):
        if interval_steps < 1:
            raise ValueError(
                f"interval_steps must be >= 1, got {interval_steps}"
            )
        if not (0.0 <= headroom_fraction < 1.0):
            raise ValueError(
                f"headroom_fraction must be in [0, 1), got "
                f"{headroom_fraction}"
            )
        self.router = router
        self.interval_steps = interval_steps
        self.predicted = predicted
        self.capacity_bytes = capacity_bytes
        self.headroom_fraction = headroom_fraction
        self._device = device
        self._last_check: Optional[int] = None
        self.last_sample: Optional[dict] = None
        self.breaches = 0

    def _resolve_device(self):
        if self._device is None:
            self._device = torch.device(
                "cuda" if torch.cuda.is_available() else "cpu")
        return self._device

    def sample(self, step: int) -> dict:
        """Sample now, emit one ``kind="memory"`` record, return its
        fields. None fields mean the device reports no stats (CPU)."""
        wm = device_watermarks(self._resolve_device())
        bytes_in_use = peak = limit = None
        if wm is not None:
            bytes_in_use = wm.get("bytes_in_use")
            peak = wm.get("peak_bytes_in_use")
            limit = wm.get("bytes_limit")
        capacity = self.capacity_bytes if self.capacity_bytes else limit
        predicted_peak = (
            None if self.predicted is None else self.predicted.peak_bytes
        )
        utilization = None
        if peak is not None and predicted_peak:
            utilization = peak / predicted_peak
        breach = False
        watermark = peak if peak is not None else bytes_in_use
        if watermark is not None and capacity:
            breach = watermark > (1.0 - self.headroom_fraction) * capacity
        fields = {
            "scope": "device",
            "bytes_in_use": bytes_in_use,
            "peak_bytes_in_use": peak,
            "capacity_bytes": capacity,
            "predicted_peak_bytes": predicted_peak,
            "utilization": utilization,
            "headroom_breach": breach,
        }
        self.router.event("memory", step, **fields)
        self.last_sample = fields
        if breach:
            self.breaches += 1
            logger.warning(
                "HBM headroom breach at step %d: %d bytes in use vs "
                "%d capacity (required free fraction %.2f)",
                step, watermark, capacity, self.headroom_fraction,
            )
        return fields

    def maybe_sample(self, step: int) -> Optional[dict]:
        """Sample on the monitor's cadence (anchor on first call, like
        ``LiveFleetMonitor.maybe_check``)."""
        if self._last_check is None:
            self._last_check = step
            return None
        if step - self._last_check < self.interval_steps:
            return None
        self._last_check = step
        return self.sample(step)

    def metrics_fields(self) -> dict:
        """Newest sample as metric gauges; empty on CPU (None is never
        forged into a number)."""
        out = {}
        if self.last_sample:
            peak = self.last_sample.get("peak_bytes_in_use")
            if peak is not None:
                out["peak_hbm_bytes"] = peak
            util = self.last_sample.get("utilization")
            if util is not None:
                out["hbm_utilization"] = util
        return out

    def summary(self) -> dict:
        """End-of-run achieved-vs-predicted join for the examples'
        closing banner."""
        peak = util = None
        if self.last_sample:
            peak = self.last_sample.get("peak_bytes_in_use")
            util = self.last_sample.get("utilization")
        return {
            "predicted_peak_bytes": (
                None if self.predicted is None else self.predicted.peak_bytes
            ),
            "achieved_peak_bytes": peak,
            "utilization": util,
            "breaches": self.breaches,
        }


def kv_pool_fields(*, num_blocks: int, free_blocks: int, block_size: int,
                   live_tokens: int,
                   peak_used_blocks: Optional[int] = None) -> dict:
    """KV block-pool occupancy + internal fragmentation as
    ``kind="memory"`` record fields (the serving engine calls this from
    ``tick()``).

    ``live_tokens`` is the sum of in-flight sequence positions;
    fragmentation is the fraction of RESERVED pool capacity holding no
    live token (tail waste of partially-filled blocks) — the number the
    prefix-aware placer needs to distinguish "full" from "fragmented".
    """
    used = num_blocks - free_blocks
    if used < 0:
        raise ValueError(
            f"free_blocks {free_blocks} exceeds num_blocks {num_blocks}"
        )
    reserved_tokens = used * block_size
    fragmentation = 0.0
    if reserved_tokens:
        fragmentation = max(0.0, 1.0 - live_tokens / reserved_tokens)
    fields = {
        "scope": "kv_pool",
        "num_blocks": num_blocks,
        "used_blocks": used,
        "free_blocks": free_blocks,
        "occupancy": used / num_blocks if num_blocks else 0.0,
        "live_tokens": live_tokens,
        "fragmentation": fragmentation,
    }
    if peak_used_blocks is not None:
        fields["kv_pool_peak_blocks"] = peak_used_blocks
    return fields
