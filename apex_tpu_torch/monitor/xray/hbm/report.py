"""Device-memory reports of one call (counterpart of
apex_tpu/monitor/xray/hbm/report.py).

The JAX package reads XLA's ``compiled.memory_analysis()``. Eager
PyTorch compiles nothing, so :func:`memory_report` runs ``fn`` once on
the card between ``torch.cuda.reset_peak_memory_stats()`` calls and fills
the same :class:`MemoryReport` from the caching allocator:

- argument bytes = bytes allocated before the call;
- output bytes = allocated after the call minus before (what the call
  left resident: its outputs, and state it grew);
- temp bytes = the peak during the call minus allocated after;
- generated code = 0 (nothing is compiled).

So ``total_bytes`` is the allocator's peak over the call. On a CPU input
it raises, as the JAX function does on a backend with no memory
analysis. ``report_from_compiled`` has no eager counterpart: there is no
compiled executable to read.
"""

import dataclasses
from typing import Optional

import torch

from apex_tpu_torch.monitor.xray.hbm.live import device_memory_limit

__all__ = ["MemoryReport", "memory_report"]


@dataclasses.dataclass(frozen=True)
class MemoryReport:
    """Device-memory breakdown of one call (bytes, from the allocator).

    ``device_memory_bytes`` is the card's capacity, and ``headroom_bytes``
    what remains after the call's peak footprint. For an eager call
    (:func:`memory_report`) ``total_bytes`` is exactly the allocator's
    peak over the call.
    """

    argument_bytes: int
    output_bytes: int
    temp_bytes: int
    generated_code_bytes: int
    alias_bytes: int = 0
    device_memory_bytes: Optional[int] = None

    @property
    def total_bytes(self) -> int:
        """Peak footprint: args + outputs + temps + code, minus buffers
        aliased between args and outputs."""
        return (
            self.argument_bytes + self.output_bytes + self.temp_bytes
            + self.generated_code_bytes - self.alias_bytes
        )

    @property
    def headroom_bytes(self) -> Optional[int]:
        if self.device_memory_bytes is None:
            return None
        return self.device_memory_bytes - self.total_bytes

    def fields(self) -> dict:
        """Flat payload for a ``kind="memory"`` MetricRouter record."""
        return {
            "argument_bytes": self.argument_bytes,
            "output_bytes": self.output_bytes,
            "temp_bytes": self.temp_bytes,
            "generated_code_bytes": self.generated_code_bytes,
            "alias_bytes": self.alias_bytes,
            "total_bytes": self.total_bytes,
            "device_memory_bytes": self.device_memory_bytes,
            "headroom_bytes": self.headroom_bytes,
        }

    def format(self) -> str:
        mib = 2**20

        def f(v):
            return "?" if v is None else f"{v / mib:.2f} MiB"

        lines = [
            "memory report (per device):",
            f"  arguments:      {f(self.argument_bytes)}",
            f"  outputs:        {f(self.output_bytes)}",
            f"  temporaries:    {f(self.temp_bytes)}",
            f"  generated code: {f(self.generated_code_bytes)}",
            f"  aliased (args<->outputs): {f(self.alias_bytes)}",
            f"  peak total:     {f(self.total_bytes)}",
        ]
        if self.device_memory_bytes is not None:
            lines.append(
                f"  device memory:  {f(self.device_memory_bytes)} "
                f"(headroom {f(self.headroom_bytes)})"
            )
        return "\n".join(lines)


def _device_of(args, kwargs) -> Optional[torch.device]:
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, torch.Tensor):
            return a.device
        if isinstance(a, torch.nn.Module):
            for p in a.parameters():
                return p.device
    return None


def memory_report(fn, *args, device=None, **kwargs) -> MemoryReport:
    """Run ``fn(*args, **kwargs)`` once on the card and return its
    device-memory breakdown (module docstring). ``device`` defaults to the
    device of the first tensor (or module) argument, else the current
    card. Raises RuntimeError when that device is not a CUDA card."""
    if device is None:
        device = _device_of(args, kwargs) or torch.device("cuda")
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(
            f"memory_report measures the caching allocator of a CUDA card; "
            f"{device} has none (on the CPU there is no memory analysis)")
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    before = torch.cuda.memory_allocated(device)
    out = fn(*args, **kwargs)  # held until the reads: outputs count
    torch.cuda.synchronize(device)
    after = torch.cuda.memory_allocated(device)
    peak = torch.cuda.max_memory_allocated(device)
    del out
    torch.cuda.reset_peak_memory_stats(device)
    return MemoryReport(
        argument_bytes=before,
        output_bytes=after - before,
        temp_bytes=peak - after,
        generated_code_bytes=0,
        device_memory_bytes=device_memory_limit(device),
    )
