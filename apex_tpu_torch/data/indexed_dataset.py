"""Fixed-length causal-LM samples over a token stream (counterpart of
apex_tpu/data/indexed_dataset.py's ``LMDataset``).

The stream is an in-memory integer array (the memory-mapped file format
and its native gather come with the data slice).
"""

from typing import Sequence, Tuple

import numpy as np

__all__ = ["LMDataset"]


class LMDataset:
    """Sample i = ``tokens[i*seq_len : i*seq_len + seq_len + 1]``, split
    into (inputs, labels) with the next-token shift."""

    def __init__(self, tokens, seq_len: int):
        self.tokens = np.asarray(tokens)
        if self.tokens.ndim != 1 or not np.issubdtype(self.tokens.dtype,
                                                      np.integer):
            raise ValueError("tokens must be a 1-D integer array")
        self.seq_len = int(seq_len)
        n = max((len(self.tokens) - 1) // self.seq_len, 0)
        self.offsets = np.arange(n, dtype=np.int64) * self.seq_len

    def __len__(self) -> int:
        return int(self.offsets.shape[0])

    def batch(self, indices: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
        """(inputs, labels), each (len(indices), seq_len)."""
        offs = self.offsets[np.asarray(indices, np.int64)]
        rows = self.tokens[offs[:, None] + np.arange(self.seq_len + 1)]
        return rows[:, :-1], rows[:, 1:]
