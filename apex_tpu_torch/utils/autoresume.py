"""The SIGTERM latch of preemption-safe jobs (counterpart of
apex_tpu/utils/autoresume.py): ``GRACE_ENV``, ``_env_grace`` and
:class:`TerminationNotice`, copied as they are there (plain Python).

Not ported yet: ``AutoResume``, the checkpointing poller, which waits for
the port's checkpoint module.
"""

import logging
import os
import signal as _signal
import time
from typing import Optional, Sequence

__all__ = ["GRACE_ENV", "TerminationNotice"]

logger = logging.getLogger("apex_tpu_torch.utils.autoresume")

#: environment default for the preemption grace budget (seconds between
#: SIGTERM and the scheduler's kill); unset or empty means "no budget"
GRACE_ENV = "APEX_TPU_PREEMPTION_GRACE_S"


def _env_grace() -> Optional[float]:
    raw = os.environ.get(GRACE_ENV, "").strip()
    if not raw:
        return None
    try:
        return float(raw)
    except ValueError:
        logger.warning("ignoring unparseable %s=%r", GRACE_ENV, raw)
        return None


class TerminationNotice:
    """Flag-only SIGTERM latch for consumers that only need to KNOW a
    termination arrived, such as the serving engine's graceful drain.

    The handler stores one bool and one monotonic float (async-signal
    safe, no IO) and then CHAINS to the flag-style handler installed
    before it, so stacking loses neither. The one handler it does not
    chain is the router module's SIGTERM teardown hook (marked
    ``_apex_tpu_router_teardown``), which flushes and re-raises the
    signal to die by it: with a notice installed the signal means "drain
    gracefully", not "die". Installed after a notice, that hook stands
    aside by itself (it installs only over the default disposition), so
    the notice wins in either order.

    ``grace_s`` defaults to ``APEX_TPU_PREEMPTION_GRACE_S``;
    :meth:`grace_deadline` is the monotonic instant by which a drain must
    be done.
    """

    def __init__(self, signals: Sequence[int] = (_signal.SIGTERM,),
                 install_handlers: bool = True,
                 grace_s: Optional[float] = None):
        self.grace_s = grace_s if grace_s is not None else _env_grace()
        self._signaled = False
        self._signal_t: Optional[float] = None
        self._prev_handlers = {}
        if install_handlers:
            for sig in signals:
                self._prev_handlers[sig] = _signal.signal(
                    sig, self._on_signal)

    def _on_signal(self, signum, frame):
        self._signaled = True
        if self._signal_t is None:
            self._signal_t = time.monotonic()
        prev = self._prev_handlers.get(signum)
        if (callable(prev)
                and not getattr(prev, "_apex_tpu_router_teardown", False)):
            prev(signum, frame)

    @property
    def signaled(self) -> bool:
        """True once a termination signal arrived (host-local)."""
        return self._signaled

    def request(self) -> None:
        """Arm the latch programmatically (tests; in-process drills)."""
        self._signaled = True
        if self._signal_t is None:
            self._signal_t = time.monotonic()

    def grace_deadline(self) -> Optional[float]:
        """Monotonic deadline for post-signal work (arrival +
        ``grace_s``); None while un-signaled or with no budget."""
        if self._signal_t is None or self.grace_s is None:
            return None
        return self._signal_t + self.grace_s

    def close(self) -> None:
        """Restore the previous handlers (idempotent)."""
        for sig, h in self._prev_handlers.items():
            try:
                _signal.signal(sig, h)
            except (ValueError, OSError):  # non-main thread teardown
                pass
        self._prev_handlers = {}
