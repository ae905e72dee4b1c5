"""Slope timing of a chained step (counterpart of
apex_tpu/utils/benchmarking.py).

The JAX package times a loop body by its **slope**: run k data-dependent
iterations, force completion with a small host fetch, and difference two
k so that every per-call constant (dispatch, synchronisation, the fetch)
cancels and the body's own time is left. The same method here: ``build(k)``
returns a function that runs k chained iterations eagerly (each reading
the previous one's result, or updating state in place as a training step
does) and returns a small output; each timed call ends with
``torch.cuda.synchronize`` on the card and the fetch of that output to
the host.

``enable_persistent_cache`` has no counterpart: eager torch compiles
nothing, and the kernel libraries are cached on disk by hash already
(``_kernels``).
"""

import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from apex_tpu_torch.utils.pytree import leaf_order

__all__ = [
    "chained_seconds_per_iter",
    "fetch",
    "full_reduce",
    "seconds_per_iter",
]

#: the host clock the timed calls read (a test sets its own)
_timer = time.perf_counter


def _leaves(tree) -> list:
    """``tree``'s leaves in the JAX leaf order: tensors, and anything
    else that is not a dict, list or tuple (a Python or numpy scalar)."""
    if isinstance(tree, dict):
        return [x for k in leaf_order(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def full_reduce(tree) -> torch.Tensor:
    """ONE fp32 scalar depending on every ELEMENT of every tensor leaf: a
    chain's output that reads all of its work and costs one small fetch.
    Use it in every slope-timed ``build``."""
    leaves = [leaf for leaf in _leaves(tree)
              if isinstance(leaf, torch.Tensor)]
    return sum(leaf.detach().float().sum() for leaf in leaves)


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def fetch(out):
    """Waits for the card and materializes every output leaf on the host;
    returns the numpy leaves. Outputs must be small (scalars, short
    vectors): fetching a large tensor would time its copy instead of the
    computation."""
    _sync()
    return [leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor)
            else np.asarray(leaf) for leaf in _leaves(out)]


def _best_of(fn, args, reps):
    out = fetch(fn(*args))  # the first run outside the timed region
    best = float("inf")
    for _ in range(reps):
        _sync()
        t0 = _timer()
        fetch(fn(*args))
        best = min(best, _timer() - t0)
    return best, out


def chained_seconds_per_iter(
    build: Callable[[int], Callable],
    args: Sequence = (),
    reps: int = 5,
    target_signal: float = 0.4,
    max_span: int = 1024,
    return_output: bool = False,
    deadline: Optional[float] = None,
):
    """Seconds per iteration of the loop body that ``build(k)`` chains k
    times.

    ``build(k)`` must return a function of ``*args`` whose (small)
    output depends on all k iterations. The result is the slope
    ``(t(k2) - t(k1)) / (k2 - k1)`` over best-of-``reps`` synchronized
    runs, which cancels every per-call constant and leaves the body's
    own time.

    The span ``k2 - k1`` is sized adaptively: a first span of 32 (or
    ``max_span``, when that is smaller) estimates the time an iteration,
    and a span too short for a signal of ``target_signal`` seconds grows
    (at least 4x a round, at most to ``max_span``) until the signal
    dwarfs the host's jitter.

    Raises ``RuntimeError`` if the final slope comes out non-positive
    even at ``max_span``: a garbage measurement is never recorded as a
    (nonsensical, huge) throughput.

    With ``return_output=True``, returns ``(seconds, last_output)``, the
    fetched output of the longest chain, so callers can gate on the exact
    computation timed.

    ``deadline`` (a ``time.monotonic()`` value) bounds the span's growth:
    past it the next round raises instead of starting; a round in flight
    is never interrupted.
    """

    def _check_deadline(where):
        if deadline is not None and time.monotonic() > deadline:
            raise RuntimeError(f"measurement budget exhausted before {where}")

    _check_deadline("the first chain")
    t1, _ = _best_of(build(1), args, reps)
    span = min(32, max_span)
    while True:
        _check_deadline(f"span={span}")
        t2, out = _best_of(build(1 + span), args, reps)
        signal = t2 - t1
        # accept once the slope signal dwarfs the jitter; otherwise grow
        # the span geometrically, in few large rounds
        if signal >= target_signal or span >= max_span:
            if signal <= 0:
                raise RuntimeError(
                    f"non-positive slope at span={span}: t(1)={t1:.4f}s "
                    f"t({1 + span})={t2:.4f}s — timing is noise, not signal"
                )
            sec = signal / span
            return (sec, out) if return_output else sec
        est = max(signal / span, 1e-6)
        span = min(max_span, max(span * 4, int(target_signal / est) + 1))


def seconds_per_iter(step, carry, xs_like=None, reps: int = 5) -> float:
    """Slope-time one step of ``carry -> carry`` (or ``(carry, x) ->
    carry``): the step chained k times from ``carry``, the final carry
    reduced to one scalar for the fetch."""

    def build(k):
        def run(carry):
            for _ in range(k):
                carry = step(carry) if xs_like is None else step(carry,
                                                                 xs_like)
            return full_reduce(carry)

        return run

    return chained_seconds_per_iter(build, (carry,), reps=reps)
