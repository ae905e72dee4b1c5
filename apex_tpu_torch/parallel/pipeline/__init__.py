"""Pipeline schedules; only the no-pipelining one so far."""

from apex_tpu_torch.parallel.pipeline.schedules import (
    forward_backward_no_pipelining,
)

__all__ = ["forward_backward_no_pipelining"]
