"""Memory-mapped token dataset and LM batch staging on the native host
runtime (counterpart of apex_tpu/data/indexed_dataset.py).

Python owns the metadata; the per-batch token gather and the epoch
shuffles run in the native host library (``apex_tpu_torch._native``,
which raises where the JAX package would fall back to numpy).

Format (the JAX package's, so either package reads the other's files):
``<prefix>.bin`` is a flat little-endian token array (int32 or uint16),
``<prefix>.dtype`` names its dtype, and ``<prefix>.idx.npy`` optionally
holds document start offsets. ``LMDataset`` exposes fixed-length
(tokens, labels) samples with the usual next-token shift.
"""

import os
from typing import Optional, Sequence, Tuple

import numpy as np

from apex_tpu_torch import _native

__all__ = ["IndexedTokenDataset", "LMDataset", "write_token_file"]


def write_token_file(prefix: str, tokens: np.ndarray, doc_offsets=None) -> str:
    """Writer for the binary format. Records the dtype in a ``.dtype``
    sidecar so readers can never misinterpret the raw bytes; returns the
    ``.bin`` path."""
    tokens = np.ascontiguousarray(tokens)
    if tokens.dtype not in (np.int32, np.uint16):
        raise TypeError(f"token files hold int32 or uint16, got "
                        f"{tokens.dtype}")
    with open(prefix + ".bin", "wb") as f:
        f.write(tokens.tobytes())
    with open(prefix + ".dtype", "w") as f:
        f.write(tokens.dtype.name)
    if doc_offsets is not None:
        np.save(prefix + ".idx.npy", np.asarray(doc_offsets, np.int64))
    return prefix + ".bin"


class IndexedTokenDataset:
    """Memory-mapped flat token stream with an optional document index."""

    def __init__(self, prefix: str, dtype=None):
        path = prefix + ".bin"
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        dtype_path = prefix + ".dtype"
        if os.path.exists(dtype_path):
            with open(dtype_path) as f:
                recorded = np.dtype(f.read().strip())
            if dtype is not None and np.dtype(dtype) != recorded:
                raise ValueError(
                    f"requested dtype {np.dtype(dtype)} != recorded {recorded}"
                )
            dtype = recorded
        elif dtype is None:
            dtype = np.int32
        if os.path.getsize(path) % np.dtype(dtype).itemsize != 0:
            raise ValueError(
                f"{path} size is not a multiple of {np.dtype(dtype)} itemsize "
                "— wrong dtype?"
            )
        self.prefix = prefix
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        idx_path = prefix + ".idx.npy"
        self.doc_offsets: Optional[np.ndarray] = (
            np.load(idx_path) if os.path.exists(idx_path) else None
        )

    def __len__(self) -> int:
        return int(self.tokens.shape[0])


class LMDataset:
    """Fixed-length causal-LM view: sample i = ``tokens[i*seq_len :
    i*seq_len + seq_len + 1]`` split into (inputs, labels)."""

    def __init__(self, dataset: IndexedTokenDataset, seq_len: int):
        self.ds = dataset
        self.seq_len = int(seq_len)
        self.offsets = _native.lm_sample_offsets(len(dataset), self.seq_len)

    def __len__(self) -> int:
        return int(self.offsets.shape[0])

    def batch(self, indices: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
        """(inputs, labels), each (len(indices), seq_len): one native
        gather of the samples (+1 token for the label shift)."""
        idx = np.asarray(indices, np.int64)
        offs = self.offsets[idx]
        # lm_sample_offsets guarantees the +1 label token stays in bounds;
        # gather_rows raises IndexError if that invariant is ever broken
        rows = _native.gather_rows(self.ds.tokens, offs, self.seq_len + 1)
        return rows[:, :-1], rows[:, 1:]

    def epoch_permutation(self, epoch: int, seed: int = 0) -> np.ndarray:
        return _native.permutation(len(self), seed * 1_000_003 + epoch)
