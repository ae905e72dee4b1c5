"""The HBM x-ray: predict -> measure for device memory (counterpart of
apex_tpu/monitor/xray/hbm/).

- ``model``  — the analytic ledger (:class:`HbmBreakdown`,
  :func:`predict_fits`): closed-form per-device peak prediction, pure
  arithmetic.
- ``report`` — :func:`memory_report`, one call's allocator breakdown on
  the card (eager PyTorch compiles nothing, so there is no
  ``report_from_compiled``).
- ``live``   — watermark sampling over ``torch.cuda.memory_stats``,
  ``kind="memory"`` records, KV-pool occupancy.
- ``oom``    — ``torch.cuda.OutOfMemoryError`` forensics: the
  ``kind="oom"`` record and its reader.
"""

from apex_tpu_torch.monitor.xray.hbm.live import (
    HbmWatermarkMonitor,
    device_memory_limit,
    device_watermarks,
    kv_pool_fields,
)
from apex_tpu_torch.monitor.xray.hbm.model import (
    Component,
    FitVerdict,
    HbmBreakdown,
    StashDepth,
    TransformerDims,
    activation_stash_bytes,
    adam_state_bytes,
    distributed_adam_state_bytes,
    gpt_param_elements,
    kv_pool_bytes,
    predict_fits,
    predict_serving_memory,
    predict_train_memory,
    stash_depth,
    zero_padded_total,
    zero_shard_elements,
)
from apex_tpu_torch.monitor.xray.hbm.oom import (
    OomIncident,
    is_oom_error,
    oom_guard,
    oom_record,
    read_oom_records,
    suggest_knobs,
)
from apex_tpu_torch.monitor.xray.hbm.report import MemoryReport, memory_report

__all__ = [
    "Component", "FitVerdict", "HbmBreakdown", "HbmWatermarkMonitor",
    "MemoryReport", "OomIncident", "StashDepth", "TransformerDims",
    "activation_stash_bytes", "adam_state_bytes", "device_memory_limit",
    "device_watermarks", "distributed_adam_state_bytes",
    "gpt_param_elements", "is_oom_error", "kv_pool_bytes", "kv_pool_fields",
    "memory_report", "oom_guard", "oom_record", "predict_fits",
    "predict_serving_memory", "predict_train_memory", "read_oom_records",
    "stash_depth", "suggest_knobs", "zero_padded_total",
    "zero_shard_elements",
]
