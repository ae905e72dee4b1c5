"""Pipeline parallelism over the pp group (counterpart of
apex_tpu/parallel/pipeline/; ref: apex/transformer/pipeline_parallel):
the stage edges (``p2p``), the micro-batch calculators
(``microbatches``), the schedules (``schedules``: no pipelining, 1F1B,
interleaved, zero bubble, the embedding-and-head wrappers, the
dispatcher and ``build_model``) and their cost model (``algebra``)."""

from apex_tpu_torch.parallel.pipeline.algebra import (
    SCHEDULES,
    ScheduleCost,
    bubble_fraction_1f1b,
    schedule_cost,
)
from apex_tpu_torch.parallel.pipeline.algebra import (
    compare as compare_schedules,
)
from apex_tpu_torch.parallel.pipeline.microbatches import (
    ConstantNumMicroBatchesCalculator,
    RampupBatchsizeNumMicroBatchesCalculator,
    build_num_microbatches_calculator,
    destroy_num_microbatches_calculator,
    get_current_global_batch_size,
    get_num_microbatches,
    setup_microbatch_calculator,
    update_num_microbatches,
)
from apex_tpu_torch.parallel.pipeline.p2p import (
    recv_backward,
    recv_forward,
    ring_forward,
    ring_send_last_to_first,
    send_backward,
    send_backward_recv_backward,
    send_backward_recv_forward,
    send_forward,
    send_forward_recv_backward,
    send_forward_recv_forward,
)
from apex_tpu_torch.parallel.pipeline.schedules import (
    build_model,
    forward_backward_no_pipelining,
    forward_backward_pipelining_with_interleaving,
    forward_backward_pipelining_without_interleaving,
    forward_backward_with_pre_post,
    forward_backward_zero_bubble,
    forward_backward_zero_bubble_with_pre_post,
    get_forward_backward_func,
    pipeline_forward,
    pipeline_forward_interleaved,
)

__all__ = [
    "ConstantNumMicroBatchesCalculator",
    "RampupBatchsizeNumMicroBatchesCalculator",
    "build_num_microbatches_calculator",
    "setup_microbatch_calculator",
    "get_num_microbatches",
    "get_current_global_batch_size",
    "update_num_microbatches",
    "destroy_num_microbatches_calculator",
    "send_forward",
    "recv_forward",
    "send_backward",
    "recv_backward",
    "send_forward_recv_forward",
    "send_backward_recv_backward",
    "send_forward_recv_backward",
    "send_backward_recv_forward",
    "ring_forward",
    "ring_send_last_to_first",
    "forward_backward_no_pipelining",
    "forward_backward_pipelining_without_interleaving",
    "forward_backward_pipelining_with_interleaving",
    "forward_backward_with_pre_post",
    "forward_backward_zero_bubble",
    "forward_backward_zero_bubble_with_pre_post",
    "get_forward_backward_func",
    "pipeline_forward",
    "pipeline_forward_interleaved",
    "build_model",
    "ScheduleCost",
    "SCHEDULES",
    "schedule_cost",
    "compare_schedules",
    "bubble_fraction_1f1b",
]
