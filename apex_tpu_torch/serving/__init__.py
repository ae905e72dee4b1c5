"""Continuous-batching serving over a block-allocated KV pool, its
request records and x-ray (``trace``), the load generator, and the fleet
router over replicas (``fleet``). ``python -m apex_tpu_torch.serving
--selftest [--fleet]`` is the serving gate."""

from apex_tpu_torch.serving.engine import ServingConfig, ServingEngine
from apex_tpu_torch.serving.kvcache import (
    BlockAllocator,
    PagedKV,
    blocks_needed,
)
from apex_tpu_torch.serving.lifecycle import (
    TERMINAL_STATES,
    Request,
    emit_request_record,
    transition,
)
from apex_tpu_torch.serving.loadgen import (
    LoadReport,
    PoissonLoadGenerator,
    percentile,
)

__all__ = [
    "BlockAllocator", "LoadReport", "PagedKV", "PoissonLoadGenerator",
    "Request", "ServingConfig", "ServingEngine", "TERMINAL_STATES",
    "blocks_needed", "emit_request_record", "percentile", "transition",
]
