"""Execution introspection (counterpart of apex_tpu/monitor/xray/): the
HBM x-ray (``hbm``: the analytic ledger, one call's allocator report,
live watermarks and OOM forensics) and its compat re-export
(``memory``), the collective-traffic ledger (``ledger``), the recompile
sentinel (``compile_watch``) and the profiler timeline analyzer
(``timeline``: ``python -m apex_tpu_torch.monitor.xray.timeline``).
"""

from apex_tpu_torch.monitor.xray import hbm, ledger
from apex_tpu_torch.monitor.xray.compile_watch import CompileWatcher
from apex_tpu_torch.monitor.xray.ledger import (
    CollectiveEntry,
    CommsLedger,
    comms_ledger,
    predict_comms,
)
from apex_tpu_torch.monitor.xray.memory import (
    MemoryReport,
    device_memory_limit,
    memory_report,
)

__all__ = ["CollectiveEntry", "CommsLedger", "CompileWatcher",
           "MemoryReport", "comms_ledger", "device_memory_limit", "hbm",
           "ledger", "memory", "memory_report", "predict_comms"]
