"""m:n structured-sparsity masks (counterpart of
apex_tpu/contrib/sparsity/sparse_masklib.py; ref:
apex.contrib.sparsity.sparse_masklib).

The best m:n 1-D pattern of each group of m consecutive elements is
chosen by scoring |w| against every valid pattern with one (groups, m) x
(m, patterns) product and taking the first argmax, so ties resolve as
the reference's do; the 2-D variant scores each m x m block against the
doubly balanced patterns, so a tensor and its transpose are both m:n
sparse. Plain torch on the tensor's device (the JAX package's is jnp,
with no Pallas kernel). The calculators act on the LAST dim; callers
pick the pruned axis with ``create_mask(..., axis=)``.
"""

import itertools

import numpy as np
import torch

__all__ = ["compute_valid_1d_patterns", "compute_valid_2d_patterns",
           "create_mask", "fill", "m4n2_1d", "m4n2_2d_best", "mn_1d_best",
           "mn_2d_best"]

_PATTERN_CACHE = {}


def compute_valid_1d_patterns(m: int, n: int) -> np.ndarray:
    """All 0/1 vectors of length m with exactly n ones, sorted."""
    if (m, n) in _PATTERN_CACHE:
        return _PATTERN_CACHE[(m, n)]
    base = [1.0] * n + [0.0] * (m - n)
    pats = np.array(sorted(set(itertools.permutations(base))),
                    dtype=np.float32)
    _PATTERN_CACHE[(m, n)] = pats
    return pats


def mn_1d_best(matrix, m: int, n: int):
    """Best m:n mask along the LAST dim of ``matrix`` (which must divide
    by m): each group of m keeps its n largest |w|, as an argmax over the
    valid patterns."""
    if matrix.shape[-1] % m != 0:
        raise ValueError(f"last dim ({matrix.shape[-1]}) not divisible by "
                         f"m ({m})")
    pats = torch.as_tensor(compute_valid_1d_patterns(m, n),
                           device=matrix.device)
    groups = matrix.detach().float().abs().reshape(-1, m)
    best = torch.argmax(groups @ pats.t(), dim=1)  # (G,) first maximum
    return pats[best].reshape(matrix.shape)


def m4n2_1d(mat, density: float = 0.5):
    """2:4 along the last dim; ``density`` kept for signature parity."""
    del density
    return mn_1d_best(mat, 4, 2)


def compute_valid_2d_patterns(m: int, n: int) -> np.ndarray:
    """All m x m 0/1 matrices with exactly n ones in each row and column,
    flattened to (P, m*m) (90 for m = 4, n = 2)."""
    if ("2d", m, n) in _PATTERN_CACHE:
        return _PATTERN_CACHE[("2d", m, n)]
    rows = compute_valid_1d_patterns(m, n)
    idx = np.array(list(itertools.product(range(len(rows)), repeat=m)))
    mats = rows[idx]
    valid = mats[(mats.sum(axis=1) == n).all(axis=1)]
    pats = valid.reshape(-1, m * m).astype(np.float32)
    _PATTERN_CACHE[("2d", m, n)] = pats
    return pats


def mn_2d_best(matrix, m: int, n: int):
    """Best m:n mask valid along both of the last two dims (each divisible
    by m): each m x m block takes the doubly balanced pattern that keeps
    the most |w|."""
    *lead, r, c = matrix.shape
    if r % m != 0 or c % m != 0:
        raise ValueError(f"last two dims ({r}, {c}) must both divide by m "
                         f"({m}) for the 2-D pattern")
    pats = torch.as_tensor(compute_valid_2d_patterns(m, n),
                           device=matrix.device)
    a = matrix.detach().float().abs()
    blocks = a.reshape(*lead, r // m, m, c // m, m).transpose(-3, -2)
    best = torch.argmax(blocks.reshape(-1, m * m) @ pats.t(), dim=1)
    mask = pats[best].reshape(*lead, r // m, c // m, m, m)
    return mask.transpose(-3, -2).reshape(matrix.shape)


def m4n2_2d_best(mat, density: float = 0.5):
    """2-D 2:4: the mask holds for the tensor and its transpose."""
    del density
    return mn_2d_best(mat, 4, 2)


_CALCULATORS = {"m4n2_1d": m4n2_1d, "m4n2_2d_best": m4n2_2d_best}


def create_mask(tensor, pattern: str = "m4n2_1d", axis: int = -1):
    """The mask of ``tensor`` by the named calculator along ``axis``, in
    the tensor's dtype (ref: create_mask_from_pattern)."""
    if pattern not in _CALCULATORS:
        raise ValueError(f"unknown pattern {pattern!r}; available: "
                         f"{sorted(_CALCULATORS)}")
    moved = tensor.movedim(axis, -1)
    return _CALCULATORS[pattern](moved).movedim(-1, axis).to(tensor.dtype)


def fill(x) -> float:
    """Density: the fraction of non-zeros."""
    return float((x != 0).float().mean())
