"""Megatron-style pretraining batch samplers (counterpart of
apex_tpu/data/batchsampler.py, copied as it is there: pure Python and
numpy, so the index streams are the JAX package's, draw for draw).

Reference parity: apex/transformer/_data/_batchsampler.py
(MegatronPretrainingSampler :38, MegatronPretrainingRandomSampler) — DP-
sharded index samplers supporting resume from ``consumed_samples`` and
dynamic (rampup) batch sizes via the mutable ``local_minibatch_size``.
Pure-Python index generators (framework-agnostic here as there); feed the
yielded indices to any array/dataset indexing, then shard the batch over
the dp mesh axis.
"""

from typing import Iterator, List


class MegatronPretrainingSampler:
    """Sequential sampler (ref :38): walks the dataset in order, skipping
    ``consumed_samples``, yielding this dp rank's slice of each minibatch."""

    def __init__(
        self,
        total_samples: int,
        consumed_samples: int,
        local_minibatch_size: int,
        data_parallel_rank: int,
        data_parallel_size: int,
        drop_last: bool = True,
    ):
        if total_samples <= 0:
            raise RuntimeError(f"no sample to consume: {total_samples}")
        if consumed_samples >= total_samples:
            raise RuntimeError(
                f"no samples left to consume: {consumed_samples} >= {total_samples}"
            )
        if local_minibatch_size <= 0 or data_parallel_size <= 0:
            raise RuntimeError("batch and world sizes must be positive")
        if data_parallel_rank >= data_parallel_size:
            raise RuntimeError(
                f"data_parallel_rank ({data_parallel_rank}) must be smaller than "
                f"data_parallel_size ({data_parallel_size})"
            )
        self.total_samples = total_samples
        self.consumed_samples = consumed_samples
        self._local_minibatch_size = local_minibatch_size
        self.data_parallel_rank = data_parallel_rank
        self.data_parallel_size = data_parallel_size
        self.drop_last = drop_last

    @property
    def local_minibatch_size(self) -> int:
        return self._local_minibatch_size

    @local_minibatch_size.setter
    def local_minibatch_size(self, v: int) -> None:
        """Mutable for batch-size rampup (ref: dynamic batch size POC)."""
        self._local_minibatch_size = v

    def __len__(self) -> int:
        return self.total_samples

    def get_start_end_idx(self):
        start = self.data_parallel_rank * self.local_minibatch_size
        return start, start + self.local_minibatch_size

    def __iter__(self) -> Iterator[List[int]]:
        batch: List[int] = []
        global_bs = self.local_minibatch_size * self.data_parallel_size
        for idx in range(self.consumed_samples, self.total_samples):
            batch.append(idx)
            if len(batch) == global_bs:
                start, end = self.get_start_end_idx()
                yield batch[start:end]
                batch = []
                global_bs = self.local_minibatch_size * self.data_parallel_size
        if len(batch) > 0 and not self.drop_last:
            start, end = self.get_start_end_idx()
            yield batch[start:end]


class MegatronPretrainingRandomSampler:
    """Shuffled sampler (ref: MegatronPretrainingRandomSampler): epoch-
    seeded permutation of the remaining samples, DP-bucketed."""

    def __init__(
        self,
        total_samples: int,
        consumed_samples: int,
        local_minibatch_size: int,
        data_parallel_rank: int,
        data_parallel_size: int,
        seed: int = 0,
    ):
        if total_samples <= 0:
            raise RuntimeError(f"no sample to consume: {total_samples}")
        if local_minibatch_size <= 0 or data_parallel_size <= 0:
            raise RuntimeError("batch and world sizes must be positive")
        if data_parallel_rank >= data_parallel_size:
            raise RuntimeError(
                f"data_parallel_rank ({data_parallel_rank}) must be smaller than "
                f"data_parallel_size ({data_parallel_size})"
            )
        self.total_samples = total_samples
        self.consumed_samples = consumed_samples
        self._local_minibatch_size = local_minibatch_size
        self.data_parallel_rank = data_parallel_rank
        self.data_parallel_size = data_parallel_size
        self.seed = seed
        global_bs = self._local_minibatch_size * self.data_parallel_size
        if total_samples < global_bs:
            raise RuntimeError(
                f"total_samples ({total_samples}) smaller than one global "
                f"batch ({global_bs})"
            )
        self.last_batch_size = self.total_samples % global_bs

    @property
    def local_minibatch_size(self) -> int:
        return self._local_minibatch_size

    @local_minibatch_size.setter
    def local_minibatch_size(self, v: int) -> None:
        self._local_minibatch_size = v

    def __len__(self) -> int:
        return self.total_samples

    def __iter__(self) -> Iterator[List[int]]:
        import numpy as np

        active = self.total_samples - self.last_batch_size
        epoch = self.consumed_samples // active
        current_epoch_samples = self.consumed_samples % active
        global_bs = self.local_minibatch_size * self.data_parallel_size
        # NOTE: no divisibility assert on current_epoch_samples — after a
        # batch-size rampup the old consumed count need not be a multiple
        # of the NEW global batch (the reference deliberately comments the
        # equivalent assert out for this reason)

        # DP-bucketed shuffle (ref: bucket per rank, offset by epoch seed)
        bucket_size = active // self.data_parallel_size
        bucket_offset = current_epoch_samples // self.data_parallel_size
        start_idx = self.data_parallel_rank * bucket_size

        rng = np.random.RandomState(self.seed + epoch)
        random_idx = rng.permutation(bucket_size).tolist()
        idx_range = [
            start_idx + x for x in random_idx[bucket_offset:]
        ]

        batch: List[int] = []
        for idx in idx_range:
            batch.append(idx)
            if len(batch) == self.local_minibatch_size:
                self.consumed_samples += global_bs
                yield batch
                batch = []
