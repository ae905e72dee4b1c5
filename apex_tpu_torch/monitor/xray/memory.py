"""Compat re-export (counterpart of apex_tpu/monitor/xray/memory.py): the
one-call memory report lives in ``hbm/report.py`` and the capacity probe
in ``hbm/live.py``; this keeps the import path
``from apex_tpu_torch.monitor.xray import memory_report``. The JAX
package's ``report_from_compiled`` has no eager counterpart."""

from apex_tpu_torch.monitor.xray.hbm.live import device_memory_limit
from apex_tpu_torch.monitor.xray.hbm.report import (
    MemoryReport,
    memory_report,
)

__all__ = ["MemoryReport", "device_memory_limit", "memory_report"]
