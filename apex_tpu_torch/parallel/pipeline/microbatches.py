"""Number-of-microbatches calculators, constant and batch-size rampup
(counterpart of apex_tpu/parallel/pipeline/microbatches.py; ref:
apex/transformer/microbatches.py ``ConstantNumMicroBatches`` (:93) and
``RampupBatchsizeNumMicroBatches`` (:112), and the module-level registry
of pipeline_parallel/utils.py:58).

Pure host-side Python with the JAX module's semantics: the global batch
must divide by micro batch x dp, and the rampup grows the global batch
in ``batch_size_increment`` steps, evenly spread over ``ramup_samples``
consumed samples.
"""

from typing import List, Optional, Union


class NumMicroBatchesCalculator:
    def __init__(self):
        self.num_micro_batches: Optional[int] = None
        self.current_global_batch_size: Optional[int] = None

    def get(self) -> int:
        return self.num_micro_batches

    def get_current_global_batch_size(self) -> int:
        return self.current_global_batch_size

    def update(self, consumed_samples, consistency_check) -> None:
        raise NotImplementedError


class ConstantNumMicroBatchesCalculator(NumMicroBatchesCalculator):
    """Fixed global batch (ref: microbatches.py:93)."""

    def __init__(self, global_batch_size: int, micro_batch_size: int, data_parallel_size: int):
        super().__init__()
        micro_batch_times_dp = micro_batch_size * data_parallel_size
        if global_batch_size % micro_batch_times_dp != 0:
            raise ValueError(
                f"global batch size ({global_batch_size}) is not divisible by "
                f"micro batch size ({micro_batch_size}) times data parallel size "
                f"({data_parallel_size})"
            )
        self.num_micro_batches = global_batch_size // micro_batch_times_dp
        if self.num_micro_batches < 1:
            raise ValueError("number of microbatches must be at least 1")
        self.current_global_batch_size = global_batch_size
        self.micro_batch_size = micro_batch_size

    def update(self, consumed_samples, consistency_check) -> None:
        pass


class RampupBatchsizeNumMicroBatchesCalculator(NumMicroBatchesCalculator):
    """Linear batch-size rampup (ref: microbatches.py:112).

    Global batch grows from ``start_batch_size`` to ``global_batch_size`` in
    increments of ``batch_size_increment``, evenly spread over
    ``ramup_samples`` consumed samples.
    """

    def __init__(
        self,
        start_batch_size: int,
        batch_size_increment: int,
        ramup_samples: int,
        global_batch_size: int,
        micro_batch_size: int,
        data_parallel_size: int,
    ):
        super().__init__()
        if global_batch_size <= 0 or start_batch_size <= 0 or batch_size_increment <= 0:
            raise ValueError("batch sizes and increment must be positive")
        if ramup_samples < 0:
            raise ValueError("ramup_samples must be non-negative")
        self.start_batch_size = start_batch_size
        self.batch_size_increment = batch_size_increment
        self.ramup_samples = ramup_samples
        self.global_batch_size = global_batch_size
        self.micro_batch_size = micro_batch_size
        self.data_parallel_size = data_parallel_size
        self.micro_batch_times_data_parallel_size = micro_batch_size * data_parallel_size

        diff_batch_size = global_batch_size - start_batch_size
        if diff_batch_size < 0:
            raise ValueError("global batch size must be >= start batch size")
        if diff_batch_size % batch_size_increment != 0:
            raise ValueError(
                f"expected global batch size interval ({diff_batch_size}) to be divisible "
                f"by the batch size increment ({batch_size_increment})"
            )
        num_increments = diff_batch_size // batch_size_increment
        self.rampup_samples_per_increment = (
            ramup_samples / num_increments if num_increments > 0 else 0
        )
        self.update(0, False)

    def update(self, consumed_samples: int, consistency_check: bool) -> None:
        if consumed_samples > self.ramup_samples or self.rampup_samples_per_increment == 0:
            self.current_global_batch_size = self.global_batch_size
        else:
            steps = int(consumed_samples / self.rampup_samples_per_increment)
            self.current_global_batch_size = (
                self.start_batch_size + steps * self.batch_size_increment
            )
            self.current_global_batch_size = min(
                self.current_global_batch_size, self.global_batch_size
            )
        if consistency_check:
            if (
                self.current_global_batch_size % self.micro_batch_times_data_parallel_size
                != 0
            ):
                raise ValueError(
                    f"current global batch size ({self.current_global_batch_size}) is not "
                    f"divisible by micro-batch-size ({self.micro_batch_size}) times "
                    f"data parallel size ({self.data_parallel_size})"
                )
        self.num_micro_batches = max(
            1, self.current_global_batch_size // self.micro_batch_times_data_parallel_size
        )


def build_num_microbatches_calculator(
    rank: int,
    rampup_batch_size: Optional[List[int]],
    global_batch_size: int,
    micro_batch_size: int,
    data_parallel_size: int,
) -> NumMicroBatchesCalculator:
    """(ref: microbatches.py:24 build_num_microbatches_calculator)"""
    if rampup_batch_size is None:
        return ConstantNumMicroBatchesCalculator(
            global_batch_size, micro_batch_size, data_parallel_size
        )
    if len(rampup_batch_size) != 3:
        raise ValueError(
            "expected the following format: --rampup-batch-size <start batch size> "
            "<batch size increment> <ramp-up samples>"
        )
    start, incr, samples = (int(v) for v in rampup_batch_size)
    return RampupBatchsizeNumMicroBatchesCalculator(
        start, incr, samples, global_batch_size, micro_batch_size, data_parallel_size
    )


# -- module-level registry (ref: pipeline_parallel/utils.py:40-121) ---------

_GLOBAL_NUM_MICROBATCHES_CALCULATOR: Optional[NumMicroBatchesCalculator] = None


def setup_microbatch_calculator(
    rank: int,
    rampup_batch_size: Optional[List[int]],
    global_batch_size: int,
    micro_batch_size: int,
    data_parallel_size: int,
) -> None:
    """(ref: pipeline_parallel/utils.py:58)"""
    global _GLOBAL_NUM_MICROBATCHES_CALCULATOR
    if _GLOBAL_NUM_MICROBATCHES_CALCULATOR is not None:
        raise RuntimeError("num microbatches calculator is already initialized")
    _GLOBAL_NUM_MICROBATCHES_CALCULATOR = build_num_microbatches_calculator(
        rank, rampup_batch_size, global_batch_size, micro_batch_size, data_parallel_size
    )


def _calculator() -> NumMicroBatchesCalculator:
    if _GLOBAL_NUM_MICROBATCHES_CALCULATOR is None:
        raise RuntimeError("num microbatches calculator is not initialized")
    return _GLOBAL_NUM_MICROBATCHES_CALCULATOR


def get_num_microbatches() -> int:
    return _calculator().get()


def get_current_global_batch_size() -> int:
    return _calculator().get_current_global_batch_size()


def update_num_microbatches(consumed_samples: int, consistency_check: bool = True) -> None:
    _calculator().update(consumed_samples, consistency_check)


def destroy_num_microbatches_calculator() -> None:
    global _GLOBAL_NUM_MICROBATCHES_CALCULATOR
    _GLOBAL_NUM_MICROBATCHES_CALCULATOR = None
