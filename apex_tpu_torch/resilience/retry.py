"""Shared bounded-retry helper: jittered backoff, deadline-aware, loud
(counterpart of apex_tpu/resilience/retry.py, copied as it is there: it
imports no JAX; its ``kind="retry"`` records go through the port's
goodput router).

Extracted from ``integrity.save_with_retry`` (which now delegates here)
so every transient-IO retry loop in the package — checkpoint save
issuance, manifest commits, AutoResume restore IO — shares ONE policy
instead of each caller hand-rolling its own sleep loop:

- **jittered exponential backoff** — the delay doubles per attempt and
  each sleep is multiplied by ``1 ± jitter``: a fleet of hosts retrying
  the same flaky filesystem must not re-stampede it in lockstep (the
  reason ``AutoResume`` passes a nonzero jitter while the single-writer
  ``save_with_retry`` wrapper keeps 0 for deterministic tests).
- **deadline-aware** — with ``deadline_s`` set, a retry whose backoff
  sleep would overrun the budget re-raises immediately instead of
  sleeping into the kill window (the preemption-grace discipline of
  utils/autoresume.py applied to retries: burning the budget asleep is
  strictly worse than failing loudly with budget left).
- **record-emitting** — every failed attempt emits a ``kind="retry"``
  record through the goodput router (``spans.get_router()``, or an
  explicit ``router=``), so a post-mortem can see the flaky-IO stutter
  inside whatever span (``ckpt_save``/``ckpt_restore``) was open around
  it; the enclosing span carries the wall seconds, the retry records
  carry the why. With no router wired the retries cost nothing extra.

The final failure always re-raises the original exception — a retry
helper that converts "save failed five times" into a log line is how
checkpoints get silently lost.
"""

import logging
import random
import time
from typing import Any, Callable, Optional

logger = logging.getLogger("apex_tpu_torch.resilience")

__all__ = ["retry_with_backoff"]


def _emit(router, what: str, attempt: int, retries: int, delay_s, error,
          gave_up: bool) -> None:
    if router is None:
        from apex_tpu_torch.monitor.goodput.spans import get_router

        router = get_router()
    if router is None:
        return
    try:
        router.event(
            "retry", -1, what=str(what), attempt=int(attempt),
            retries=int(retries), delay_s=delay_s, error=str(error),
            gave_up=bool(gave_up),
        )
    except Exception as e:  # noqa: BLE001 - telemetry must not break the retry
        logger.warning("retry record emit failed: %s", e)


def retry_with_backoff(
    fn: Callable[[], Any],
    retries: int = 3,
    backoff: float = 0.1,
    backoff_factor: float = 2.0,
    jitter: float = 0.0,
    deadline_s: Optional[float] = None,
    what: str = "operation",
    router=None,
    rng: Optional[random.Random] = None,
    sleep: Callable[[float], None] = time.sleep,
) -> Any:
    """Run ``fn`` with up to ``retries`` retried attempts (module docstring).

    ``jitter`` is a fraction in [0, 1): each sleep is scaled by a uniform
    draw from ``[1 - jitter, 1 + jitter]`` (``rng`` injectable for
    deterministic tests). ``deadline_s`` bounds the TOTAL wall time this
    call may spend, measured from entry: a backoff sleep that would cross
    it re-raises the last error instead. ``sleep`` is injectable so tests
    can pin the schedule without real waiting.
    """
    if not 0.0 <= jitter < 1.0:
        raise ValueError(f"jitter must be in [0, 1), got {jitter}")
    start = time.monotonic()
    delay = backoff
    for attempt in range(retries + 1):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 - IO errors surface variously
            if attempt >= retries:
                _emit(router, what, attempt + 1, retries + 1, None, e,
                      gave_up=True)
                raise
            pause = delay
            if jitter:
                pause *= 1.0 + jitter * (
                    2.0 * (rng or random).random() - 1.0
                )
            if deadline_s is not None and (
                    time.monotonic() - start) + pause > deadline_s:
                logger.warning(
                    "%s failed (attempt %d/%d): %s; backoff %.2fs would "
                    "overrun the %.2fs deadline — giving up with budget "
                    "left", what, attempt + 1, retries + 1, e, pause,
                    deadline_s,
                )
                _emit(router, what, attempt + 1, retries + 1, None, e,
                      gave_up=True)
                raise
            logger.warning(
                "%s failed (attempt %d/%d): %s; retrying in %.2fs",
                what, attempt + 1, retries + 1, e, pause,
            )
            _emit(router, what, attempt + 1, retries + 1, pause, e,
                  gave_up=False)
            sleep(pause)
            delay *= backoff_factor
    raise AssertionError("unreachable")
