"""OOM forensics: turn a device-memory exhaustion into one explainable
record (counterpart of apex_tpu/monitor/xray/hbm/oom.py).

:func:`oom_guard` wraps an execute boundary (the GPT example's step under
``--xray-hbm``) and, on ``torch.cuda.OutOfMemoryError`` (or XLA's
``RESOURCE_EXHAUSTED`` text, so the JAX package's records read here too),
emits exactly ONE ``kind="oom"`` record and re-raises. The record
carries the analytic component breakdown (``model.HbmBreakdown``) that
predicted the step's footprint, a largest-buffers table where the caller
has one, and knob suggestions ranked by the component that dominates the
prediction. The record builder allocates nothing on the device (it runs
while the device is full) and keeps the JAX package's schema, so
:func:`read_oom_records` reads either package's stream.
"""

import contextlib
import dataclasses
import json
import logging
from typing import Iterable, List, Optional

import torch

from apex_tpu_torch.monitor.router import make_record

__all__ = [
    "OOM_MARKERS",
    "is_oom_error",
    "suggest_knobs",
    "oom_record",
    "OomIncident",
    "read_oom_records",
    "oom_guard",
]

logger = logging.getLogger(__name__)

#: substrings that identify an allocator exhaustion in the error text:
#: PyTorch's "CUDA out of memory" and XLA's "RESOURCE_EXHAUSTED", so that
#: a stream written by the JAX package reads here too
OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory")


def is_oom_error(exc: BaseException) -> bool:
    """True when ``exc`` is a ``torch.cuda.OutOfMemoryError`` or reads as
    a device-memory exhaustion."""
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    text = f"{type(exc).__name__}: {exc}"
    return any(marker in text for marker in OOM_MARKERS)


def suggest_knobs(breakdown=None) -> List[dict]:
    """Concrete remediation knobs, dominant component first.

    The list is the JAX package's, so the two packages' records agree:
    the examples' ``--micro-batch`` flag, the remat policy of the
    analytic stash model, ``distributed_fused_adam(param_gather_buckets=
    ...)`` (the bucketed gather of the port's ZeRO Adam and LAMB),
    ``ServingConfig.num_blocks``, and tensor parallelism. With a
    breakdown the list is ranked by the component actually dominating
    the predicted peak; without one it falls back to the generic
    ordering (microbatch first — the cheapest knob).
    """
    generic = [
        {
            "knob": "--micro-batch",
            "action": "halve the per-device microbatch size",
            "component": "activation_stash",
        },
        {
            "knob": "remat",
            "action": "deepen rematerialization "
                      "(remat='selective' -> 'full')",
            "component": "activation_stash",
        },
        {
            "knob": "param_gather_buckets",
            "action": "raise distributed_fused_adam param_gather_buckets "
                      "so gathers stream in smaller buckets",
            "component": "optimizer_state",
        },
        {
            "knob": "num_blocks",
            "action": "shrink the serving KV pool (ServingConfig.num_blocks)",
            "component": "kv_pool",
        },
        {
            "knob": "tensor_model_parallel_size",
            "action": "shard weights wider (raise tp)",
            "component": "weights",
        },
    ]
    if breakdown is None:
        return generic
    ranked = sorted(
        breakdown.components, key=lambda c: c.bytes, reverse=True
    )
    order = {c.name: i for i, c in enumerate(ranked)}
    return sorted(
        generic, key=lambda s: order.get(s["component"], len(order))
    )


def oom_record(step: int, error, *, phase: str = "execute",
               breakdown=None, largest_buffers=None,
               capacity_bytes: Optional[int] = None) -> dict:
    """The ONE ``kind="oom"`` incident bundle for a memory exhaustion.

    ``breakdown`` is the analytic ``HbmBreakdown`` (optional — an OOM
    with no prediction still gets generic knob suggestions);
    ``largest_buffers`` is the differ's attribution table
    (``[{"name", "bytes"}, ...]``, largest first).
    """
    fields = {
        "phase": phase,
        "error": str(error)[:500],
        "suggestions": suggest_knobs(breakdown),
        "capacity_bytes": capacity_bytes,
        "predicted_peak_bytes": (
            None if breakdown is None else breakdown.peak_bytes
        ),
        "components": (
            {} if breakdown is None
            else {c.name: int(c.bytes) for c in breakdown.components}
        ),
        "largest_buffers": list(largest_buffers or ()),
    }
    return make_record("oom", step, **fields)


@dataclasses.dataclass(frozen=True)
class OomIncident:
    """A parsed ``kind="oom"`` record (the reader's view)."""

    step: int
    phase: str
    error: str
    predicted_peak_bytes: Optional[int]
    capacity_bytes: Optional[int]
    components: dict
    largest_buffers: tuple
    suggestions: tuple

    @property
    def dominant_component(self) -> Optional[str]:
        if not self.components:
            return None
        return max(self.components, key=self.components.get)

    def suggested_knobs(self) -> List[str]:
        return [s.get("knob", "") for s in self.suggestions]


def read_oom_records(records: Iterable) -> List[OomIncident]:
    """Parse ``kind="oom"`` records out of a record/jsonl-line stream.

    Accepts dicts or json strings mixed with other kinds (hand it a
    whole jsonl file's lines); anything that is not an oom record is
    skipped; it reads the JAX package's records as well.
    """
    out: List[OomIncident] = []
    for rec in records:
        if isinstance(rec, (str, bytes)):
            line = rec.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
        if not isinstance(rec, dict) or rec.get("kind") != "oom":
            continue
        out.append(
            OomIncident(
                step=int(rec.get("step", -1)),
                phase=rec.get("phase", ""),
                error=rec.get("error", ""),
                predicted_peak_bytes=rec.get("predicted_peak_bytes"),
                capacity_bytes=rec.get("capacity_bytes"),
                components=dict(rec.get("components") or {}),
                largest_buffers=tuple(rec.get("largest_buffers") or ()),
                suggestions=tuple(rec.get("suggestions") or ()),
            )
        )
    return out


@contextlib.contextmanager
def oom_guard(router, step: int, *, phase: str = "execute",
              breakdown=None, largest_buffers=None,
              capacity_bytes: Optional[int] = None):
    """Wrap an execute boundary: on a device-memory
    exhaustion, emit exactly one ``kind="oom"`` record through
    ``router`` and re-raise (the guard explains the failure; it never
    swallows it). Non-OOM exceptions pass through untouched."""
    try:
        yield
    except Exception as exc:
        if is_oom_error(exc):
            rec = oom_record(
                step, exc, phase=phase, breakdown=breakdown,
                largest_buffers=largest_buffers,
                capacity_bytes=capacity_bytes,
            )
            router.emit(rec)
            logger.error(
                "OOM at step %d (%s): %s — suggestions: %s",
                step, phase, str(exc)[:120],
                ", ".join(s["knob"] for s in rec["suggestions"][:3]),
            )
        raise
