"""Bounded skip-and-log for flaky host-side batch loading (counterpart
of apex_tpu/data/robust.py, copied as it is there: plain Python).

A week-long run's input pipeline WILL hiccup: a memory-mapped page read
hits a bad sector, an NFS gather times out, a preprocessing worker
throws on one malformed document. Crashing the whole job over one batch
is wasteful — but the opposite failure mode is worse: an unbounded
``except: continue`` around the loader silently converts "the dataset
is gone" into an infinite skip loop that burns goodput while the loss
curve quietly flatlines. :class:`RobustBatches` takes the narrow middle:

- a load failure is LOGGED and the loader advances to the next batch
  (skip-and-log, never skip-silently);
- the skip count is a host metric the caller surfaces next to its
  MetricBag scalars (the examples emit it as ``data_skipped`` in each
  ``kind="metrics"`` record, so a tailer sees the pipeline degrading
  long before the budget blows);
- exceeding ``max_skips`` raises :class:`SkipBudgetExceeded` — at that
  point the pipeline is broken, not flaky, and the run must fail loudly
  (the resilience ladder can then checkpoint/restart it).

``StopIteration`` always propagates: end-of-data is the sampler's
contract, not a load failure, and swallowing it would turn every epoch
boundary into a skip storm.
"""

import logging
from typing import Any, Callable

logger = logging.getLogger("apex_tpu_torch.data")

__all__ = ["RobustBatches", "SkipBudgetExceeded"]


class SkipBudgetExceeded(RuntimeError):
    """The bounded skip budget blew: the input pipeline is broken."""


class RobustBatches:
    """Wrap a host-side batch loader with bounded skip-and-log.

    ``load_fn`` produces one batch per call and is expected to ADVANCE
    on each call (e.g. ``lambda: lm.batch(next(it))``) — a failed load
    is skipped by simply calling it again, which consumes the next
    batch. ``skipped`` is the running count of batches lost this run.

    >>> batches = RobustBatches(lambda: lm.batch(next(it)), max_skips=16)
    >>> x, y = batches()
    """

    def __init__(self, load_fn: Callable[[], Any], max_skips: int = 16):
        if max_skips < 0:
            raise ValueError(f"max_skips must be >= 0, got {max_skips}")
        self.load_fn = load_fn
        self.max_skips = int(max_skips)
        self.skipped = 0

    def __call__(self) -> Any:
        while True:
            try:
                return self.load_fn()
            except StopIteration:
                raise  # end of data is the sampler's contract, not a fault
            except Exception as e:  # noqa: BLE001 - host loaders fail variously
                self.skipped += 1
                logger.warning(
                    "batch load failed (%s: %s); skipping batch "
                    "(%d skipped, budget %d)",
                    type(e).__name__, e, self.skipped, self.max_skips,
                )
                if self.skipped > self.max_skips:
                    raise SkipBudgetExceeded(
                        f"{self.skipped} batch loads failed (budget "
                        f"{self.max_skips}): the input pipeline is broken, "
                        f"not flaky — failing loudly instead of skipping "
                        f"forever"
                    ) from e
