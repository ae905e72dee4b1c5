"""Recompile sentinel: count compiles and compile-seconds per step
(counterpart of apex_tpu/monitor/xray/compile_watch.py).

The JAX package counts XLA's backend compiles (a ``jax.monitoring``
listener). Eager torch compiles nothing a step; what the port builds and
loads at run time is its kernels: each :class:`~apex_tpu_torch._kernels.
Kernel`'s first call builds its library when missing and opens it
(``_kernels.library_loads``, and the seconds those loads took), plus any
graph ``torch.compile`` makes (dynamo's ``unique_graphs``, read only
when dynamo is already imported: importing it costs tens of seconds).
A load after the first step means a kernel escaped the warm-up (a path
that ran no kernel before, such as a new dtype or shape family), and
every such step pays it.

:class:`CompileWatcher` snapshots that process-global counter once per
step: any burst lands in a ``kind="compile"`` record (compiles,
compile-seconds, running totals), and a burst AFTER the first completed
step is flagged ``recompile=True`` and logged loudly, once per offending
step. The serving engine's ``steady_state_compiles`` is one of these
watchers, created at the end of its ``start()``.
"""

import collections
import logging
import sys
from typing import Deque, Optional, Tuple

from apex_tpu_torch import _kernels

__all__ = ["CompileWatcher", "compile_counter"]

logger = logging.getLogger("apex_tpu_torch.monitor")


def _dynamo_graphs() -> int:
    utils = sys.modules.get("torch._dynamo.utils")
    if utils is None:
        return 0
    return int(utils.counters["stats"]["unique_graphs"])


def compile_counter() -> Tuple[int, float]:
    """(compiles, compile-seconds) of this process so far: the kernel
    loads and their seconds, plus dynamo's graphs (their seconds are not
    counted)."""
    return (_kernels.library_loads() + _dynamo_graphs(),
            _kernels.library_load_seconds())


class CompileWatcher:
    """Per-step compile accounting over the process-global counter.

    Drive it from the step loop::

        watcher = CompileWatcher(router=router)
        while ...:
            ... run step ...
            watcher.on_step(step)   # AFTER the step completes

    Each ``on_step`` with new compiles since the last one emits ONE
    ``kind="compile"`` record. The first completed step is warmup: its
    record carries ``recompile=False``. Any burst after it is the
    sentinel firing: ``recompile=True`` plus a loud log line naming the
    step. The counter is process-wide, so ANY post-warmup load is
    flagged, whoever owns it.
    """

    #: records kept on the instance (a WINDOW, like MemorySink)
    MAX_RECORDS = 10_000

    def __init__(self, router=None, warn: bool = True):
        self._last = compile_counter()
        self._baseline = self._last
        self.router = router
        self.warn = warn
        self.steps_completed = 0
        self.records: Deque[dict] = collections.deque(maxlen=self.MAX_RECORDS)

    @property
    def available(self) -> bool:
        """The counter always exists here (JAX's needs jax.monitoring)."""
        return True

    def rebaseline(self) -> None:
        """Swallow the compiles since the last ``on_step`` WITHOUT
        flagging them: a burst another component both owns and books (a
        fleet starting a replica, booked as that replica's ``compile``
        span) must not land on this watcher's violation count."""
        self._last = compile_counter()

    def on_step(self, step: int) -> Optional[dict]:
        """Account compiles since the previous call; returns the emitted
        record (also kept in ``records``) or None when nothing compiled."""
        now = compile_counter()
        d_count = now[0] - self._last[0]
        d_seconds = now[1] - self._last[1]
        self._last = now
        record = None
        if d_count > 0:
            recompile = self.steps_completed >= 1
            fields = {
                "compiles": d_count,
                "compile_seconds": d_seconds,
                "total_compiles": now[0] - self._baseline[0],
                "total_compile_seconds": now[1] - self._baseline[1],
                "recompile": recompile,
            }
            if recompile and self.warn:
                logger.warning(
                    "RECOMPILE at step %d: %d kernel load(s), %.2fs — a "
                    "load after the first step means a kernel escaped the "
                    "warm-up, and EVERY such step pays it",
                    step, d_count, d_seconds,
                )
            if self.router is not None:
                record = self.router.event("compile", step, **fields)
            else:
                from apex_tpu_torch.monitor.router import make_record

                record = make_record("compile", step, **fields)
            self.records.append(record)
        self.steps_completed += 1
        return record
