"""Execution introspection (counterpart of apex_tpu/monitor/xray/): the
HBM x-ray (``hbm``: the analytic ledger, one call's allocator report,
live watermarks and OOM forensics) and its compat re-export
(``memory``).

Not ported yet: the collective-traffic ledger (``ledger``), the profiler
timeline analyzer (``timeline``) and the recompile sentinel
(``compile_watch``).
"""

from apex_tpu_torch.monitor.xray import hbm
from apex_tpu_torch.monitor.xray.memory import (
    MemoryReport,
    device_memory_limit,
    memory_report,
)

__all__ = ["MemoryReport", "device_memory_limit", "hbm", "memory",
           "memory_report"]
