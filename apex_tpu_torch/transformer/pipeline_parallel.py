"""``apex.transformer.pipeline_parallel`` import surface (counterpart of
apex_tpu/transformer/pipeline_parallel.py): ``get_forward_backward_func``,
``build_model`` and the schedule entry points, which live in
``apex_tpu_torch.parallel.pipeline``."""

from apex_tpu_torch.parallel.pipeline import (
    build_model,
    build_num_microbatches_calculator,
    forward_backward_no_pipelining,
    forward_backward_pipelining_with_interleaving,
    forward_backward_pipelining_without_interleaving,
    forward_backward_with_pre_post,
    get_forward_backward_func,
    get_num_microbatches,
    setup_microbatch_calculator,
    update_num_microbatches,
)

__all__ = [
    "get_forward_backward_func",
    "build_model",
    "build_num_microbatches_calculator",
    "setup_microbatch_calculator",
    "get_num_microbatches",
    "update_num_microbatches",
    "forward_backward_no_pipelining",
    "forward_backward_pipelining_with_interleaving",
    "forward_backward_pipelining_without_interleaving",
    "forward_backward_with_pre_post",
]
