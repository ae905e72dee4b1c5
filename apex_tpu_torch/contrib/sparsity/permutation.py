"""Channel-permutation search for accuracy-preserving 2:4 pruning
(counterpart of apex_tpu/contrib/sparsity/permutation.py; ref:
apex.contrib.sparsity.permutation_lib and
permutation_search_kernels/exhaustive_search.py).

Permuting the input channels of a weight before 2:4 pruning can raise the
magnitude it keeps, and the inverse permutation on the previous layer
keeps the network's function. The search is numpy on the host, the JAX
package's own code, so for the same matrix and seed it returns the same
permutation:

- ``exhaustive_search`` (the default up to 256 columns): the bounded
  stripe-group exhaustive search; the 35 canonical regroupings of every
  stripe pair, the best non-overlapping ones applied greedily, only the
  windows touching a changed stripe searched again, to a fixed point,
  with optional random perturbations (``escape_attempts``);
- ``search_for_good_permutation``: the greedy column-swap search.

The permutation is applied and undone with ``index_select`` on the
tensor's device.
"""

import itertools
from typing import Tuple

import numpy as np
import torch

from apex_tpu_torch.contrib.sparsity.sparse_masklib import mn_1d_best

__all__ = ["apply_permutation", "exhaustive_search", "invert_permutation",
           "permute_and_mask", "search_for_good_permutation"]


def _retained(matrix: np.ndarray) -> float:
    """Total |w| kept by the best 2:4 mask along the last dim."""
    a = np.abs(matrix).reshape(-1, 4)
    # top-2 per group of 4
    return float(np.sort(a, axis=1)[:, 2:].sum())


def _group_score(mat: np.ndarray, g: int) -> float:
    """Retained |w| of column group g (columns 4g..4g+3)."""
    a = np.abs(mat[:, 4 * g : 4 * g + 4])
    return float(np.sort(a, axis=1)[:, 2:].sum())


def search_for_good_permutation(
    matrix, max_iters: int = 1000, seed: int = 0
) -> np.ndarray:
    """Greedy column-swap search; returns a permutation of the columns.

    ``matrix``: (rows, cols) with cols % 4 == 0; the permutation acts on
    the pruned (last) dim. Starts from identity, repeatedly proposes
    swapping two columns from different groups of 4 and accepts strict
    improvements of the retained-|w| objective. A swap only changes its
    two groups, so scoring is incremental: O(rows x 8) per proposal, with
    in-place column swaps — not a full-matrix rescore.
    """
    mat = np.array(matrix, dtype=np.float32, copy=True)
    rows, cols = mat.shape
    if cols % 4 != 0:
        raise ValueError(f"cols ({cols}) not divisible by 4")
    perm = np.arange(cols)
    group_scores = np.array([_group_score(mat, g) for g in range(cols // 4)])
    rng = np.random.RandomState(seed)
    for _ in range(max_iters):
        i, j = rng.randint(0, cols, 2)
        gi, gj = i // 4, j // 4
        if gi == gj:
            continue
        mat[:, [i, j]] = mat[:, [j, i]]
        si, sj = _group_score(mat, gi), _group_score(mat, gj)
        if si + sj > group_scores[gi] + group_scores[gj] + 1e-9:
            group_scores[gi], group_scores[gj] = si, sj
            perm[[i, j]] = perm[[j, i]]
        else:
            mat[:, [i, j]] = mat[:, [j, i]]  # revert
    return perm


def _unique_group_permutations(C: int, M: int = 4) -> np.ndarray:
    """All canonical regroupings of C columns into C/M groups of M.

    Ref exhaustive_search.py:17-80 (is_canonical / generate_unique_
    combinations): within-group order and group order don't affect the 2:4
    objective, so a unique combination is a sorted list of sorted groups —
    C=8, M=4 gives 35 (the count the reference's CUDA kernel enumerates).
    """
    out = []

    def build(perm, remaining):
        if not remaining:
            out.append(list(perm))
            return
        for k, col in enumerate(remaining):
            if len(perm) % M == 0:
                # new group: canonical iff every smaller col already used
                # and the group leader exceeds the previous group's leader
                if any(v < col and v in remaining for v in range(col)):
                    continue
                if perm and col < perm[-M]:
                    continue
            elif col < perm[-1]:
                continue
            build(perm + [col], remaining[:k] + remaining[k + 1 :])

    build([0], list(range(1, C)))
    return np.array(out, dtype=np.int64)


def _kept_per_perm(subset: np.ndarray, perms: np.ndarray) -> np.ndarray:
    """Retained |w| of ``subset`` (rows, C) under each canonical perm
    (P, C): one gather + partition, the numpy twin of the reference's
    build_permute_map CUDA kernel. Returns (P,)."""
    a = np.abs(subset)[:, perms]  # (rows, P, C)
    g = a.reshape(a.shape[0], a.shape[1], -1, 4)
    return np.partition(g, 2, axis=-1)[..., 2:].sum(axis=(0, 2, 3))


def exhaustive_search(
    matrix,
    stripe_group_size: int = 8,
    escape_attempts: int = 0,
    seed: int = 0,
) -> np.ndarray:
    """Bounded stripe-group exhaustive permutation search (ref
    Exhaustive_Search, exhaustive_search.py:311).

    ``stripe_group_size`` columns (= window of stripe_group_size/4 stripes,
    default one stripe pair) are regrouped exhaustively at a time; the
    greedy outer loop applies the best non-overlapping windows, then only
    re-searches windows touching a changed stripe, until no window improves
    (ref build_stripe_map/use_stripe_map). ``escape_attempts`` random
    cross-half swaps perturb out of local minima like the reference's
    sm_perturbations.
    """
    mat = np.array(matrix, dtype=np.float32, copy=True)
    rows, cols = mat.shape
    if cols % 4 != 0:
        raise ValueError(f"cols ({cols}) not divisible by 4")
    if stripe_group_size % 4 != 0 or not 8 <= stripe_group_size <= 12:
        # window=1 has exactly one canonical regrouping (a silent no-op) and
        # window>=4 enumerates >2.6M perms per window (an effective hang)
        raise ValueError(
            f"stripe_group_size ({stripe_group_size}) must be 8 or 12"
        )
    window = stripe_group_size // 4
    num_stripes = cols // 4
    perm = np.arange(cols)
    if num_stripes < window:
        return perm
    rng = np.random.RandomState(seed)

    perms = _unique_group_permutations(4 * window, 4)  # (35, 8) for pairs
    groups = [np.array(g) for g in
              itertools.combinations(range(num_stripes), window)]
    group_cols = np.stack(
        [(g[:, None] * 4 + np.arange(4)[None, :]).ravel() for g in
         (np.asarray(g) for g in groups)]
    )  # (G, 4*window)

    n_groups = len(groups)
    best_gain = np.full(n_groups, -1.0)
    best_perm = np.zeros((n_groups, 4 * window), dtype=np.int64)
    stale = np.ones(n_groups, dtype=bool)
    escapes_left = escape_attempts

    def total_retained():
        a = np.abs(mat).reshape(rows, -1, 4)
        return float(np.partition(a, 2, axis=-1)[..., 2:].sum())

    # perturbations can leave the walk below its high-water mark, so the
    # best-seen permutation is what gets returned (the reference returns
    # whatever state the walk ends in; keeping the argmax is strictly safer)
    best_seen_perm = perm.copy()
    best_seen_val = total_retained()

    while True:
        # (re)build the stripe map for stale windows (ref build_stripe_map)
        for gi in np.nonzero(stale)[0]:
            ci = group_cols[gi]
            kept = _kept_per_perm(mat[:, ci], perms)
            b = kept[0]  # perms[0] is the identity regrouping
            j = int(np.argmax(kept))
            best_gain[gi] = kept[j] - b
            best_perm[gi] = perms[j]
        stale[:] = False

        # greedy non-overlapping application (ref use_stripe_map)
        order = np.argsort(-best_gain)
        used_stripes: set = set()
        applied = False
        for gi in order:
            if best_gain[gi] <= 1e-6:
                break
            g = groups[gi]
            if any(int(s) in used_stripes for s in g):
                continue
            p = best_perm[gi]
            ci = group_cols[gi]
            mat[:, ci] = mat[:, ci[p]]
            perm[ci] = perm[ci[p]]
            applied = True
            # a stripe actually changed unless its new group is the same
            # aligned contiguous run it started as (ref use_stripe_map)
            for s in range(window):
                grp = p[s * 4 : (s + 1) * 4]
                if grp[0] % 4 != 0 or not np.array_equal(
                    grp, np.arange(grp[0], grp[0] + 4)
                ):
                    used_stripes.add(int(g[s]))

        if used_stripes:
            touched = np.array(
                [any(int(s) in used_stripes for s in g) for g in groups]
            )
            stale |= touched
        if applied:
            val = total_retained()
            if val > best_seen_val:
                best_seen_val = val
                best_seen_perm = perm.copy()
        if not applied:
            if escapes_left > 0:
                escapes_left -= 1
                # ref perturbation: swap one column across window halves
                gi = rng.randint(n_groups)
                ci = group_cols[gi]
                # swap one column between two DISTINCT stripes of the window
                # (a within-stripe swap never changes the 2:4 objective and
                # would burn the escape attempt on a no-op)
                s_a, s_b = rng.choice(window, size=2, replace=False)
                src = s_a * 4 + rng.randint(4)
                dst = s_b * 4 + rng.randint(4)
                mat[:, [ci[src], ci[dst]]] = mat[:, [ci[dst], ci[src]]]
                perm[[ci[src], ci[dst]]] = perm[[ci[dst], ci[src]]]
                touched = np.array(
                    [groups[gi][src // 4] in g or groups[gi][dst // 4] in g
                     for g in groups]
                )
                stale |= touched
                continue
            break
    return best_seen_perm


def apply_permutation(tensor, perm, axis: int = -1):
    """``tensor`` with the entries of ``axis`` in the order ``perm``."""
    index = torch.as_tensor(np.asarray(perm), dtype=torch.long,
                            device=tensor.device)
    return tensor.index_select(axis, index)


def invert_permutation(perm) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[np.asarray(perm)] = np.arange(len(perm))
    return inv


def permute_and_mask(matrix, max_iters: int = 1000, method: str = "auto",
                     escape_attempts: int = 10
                     ) -> Tuple[np.ndarray, torch.Tensor]:
    """(the permutation of the columns, the mask in the ORIGINAL column
    order): ``matrix * mask`` is 2:4 along the last dim once ``perm`` is
    applied to the columns. ``matrix``: (rows, cols), a tensor or an
    array, cols the pruned dim (a torch ``Linear.weight``'s input dim).

    ``method``: "auto" (exhaustive up to 256 columns, greedy with
    ``max_iters`` swaps beyond: the exhaustive search's rebuilds grow
    about as cols squared), "exhaustive" or "greedy"."""
    t = torch.as_tensor(matrix)
    host = t.detach().float().cpu().numpy()
    if method == "auto":
        method = "exhaustive" if host.shape[-1] <= 256 else "greedy"
    if method == "exhaustive":
        perm = exhaustive_search(host, escape_attempts=escape_attempts)
    elif method == "greedy":
        perm = search_for_good_permutation(host, max_iters=max_iters)
    else:
        raise ValueError(f"unknown method {method!r}; expected "
                         "auto|exhaustive|greedy")
    mask_p = mn_1d_best(apply_permutation(t, perm, axis=-1), 4, 2)
    return perm, apply_permutation(mask_p, invert_permutation(perm), axis=-1)
