"""In-memory rollback: host-side snapshot ring + escalation policy
(counterpart of apex_tpu/resilience/rollback.py).

A checkpoint restore costs a full deserialization and loses every step
since the last save interval; most anomalies (one poisoned batch, a
transient loss spike that slipped a bad update in) only need to rewind a
few steps. ``RollbackBuffer`` keeps the last K known-good states ON HOST
(copies: the card holds one live state, the ring lives in host RAM) and
restores them onto each leaf's own device.

A snapshot must be a copy, never a view: the port's state is the
model's own parameters, which the optimizer updates in place, and a CPU
tensor's ``.cpu()`` is the same storage. So ``snapshot`` clones every
leaf (``utils.checkpoint.host_snapshot``), and ``rollback(into=state)``
writes the snapshot into the live tensors with ``copy_`` (a model keeps
training its own ``Parameter`` objects, which a swapped dict entry would
not reach).

``ResilienceManager`` is the host half of the sentinel loop: it maps the
in-graph verdict (resilience.sentinel) to an action under a bounded
``EscalationPolicy`` —

    skip batch  ->  rollback + LR dampen  ->  halt-and-checkpoint

- retries are bounded (``max_rollbacks`` per run);
- repeated rollback to the SAME snapshot backs off to the next-older
  one (the newest "good" state evidently wasn't);
- each rollback dampens the LR (multiply ``lr_scale`` into the update
  inside the step) so the run re-approaches the cliff more slowly;
- every anomaly is appended to a per-run jsonl anomaly log AND emitted
  through the shared telemetry schema (``apex_tpu_torch.monitor.make_record``):
  pass ``router=`` a :class:`~apex_tpu_torch.monitor.MetricRouter` and the
  anomaly stream lands in the same sinks as the metric stream, joinable
  on ``step`` (one record shape for anomalies and metrics).

The data stream rewinds with the state: ``rollback()`` returns the step
to resume FROM, and the caller rebuilds its sampler/iterator at that
step (the Megatron samplers' ``consumed_samples`` resume mechanism, see
apex_tpu_torch/examples/gpt/pretrain_gpt.py).
"""

import collections
import dataclasses
import json
import logging
import os
from typing import Any, Callable, List, Optional, Tuple

from apex_tpu_torch.resilience.sentinel import (
    VERDICT_OK,
    VERDICT_ROLLBACK,
    VERDICT_SKIP,
)
from apex_tpu_torch.utils.checkpoint import host_snapshot
from apex_tpu_torch.utils.pytree import map_tensors, tree_copy_

logger = logging.getLogger("apex_tpu_torch.resilience")


class RollbackBuffer:
    """Ring of the last ``capacity`` good state snapshots.

    ``snapshot`` copies every leaf to host (a clone, so later in-place
    updates of the live tensors cannot reach it) and records each leaf's
    device; ``rollback`` puts the copy back on those devices, or with
    ``into=`` copies it into the live tensors.
    """

    def __init__(self, capacity: int = 2, interval: int = 1):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if interval < 1:
            raise ValueError(f"interval must be >= 1, got {interval}")
        self.capacity = int(capacity)
        self.interval = int(interval)
        self._ring = collections.deque(maxlen=self.capacity)

    def __len__(self) -> int:
        return len(self._ring)

    @property
    def steps(self) -> List[int]:
        return [s for s, _, _ in self._ring]

    def snapshot(self, step: int, state: Any) -> None:
        devices = []
        map_tensors(lambda t: devices.append(t.device), state)
        self._ring.append((int(step), host_snapshot(state), devices))

    def maybe_snapshot(self, step: int, state: Any) -> bool:
        """Snapshot on the configured cadence; True when one was taken."""
        if step % self.interval == 0:
            self.snapshot(step, state)
            return True
        return False

    def rollback(self, pop: bool = False, into: Any = None
                 ) -> Tuple[int, Any]:
        """(step, state) of the newest snapshot; ``pop=True`` discards it
        first and returns the next-older one (escalation after a rollback
        that failed to clear the anomaly). With ``into`` (the live state,
        of the snapshot's structure) the snapshot is copied into its
        tensors and ``into`` is the state returned; else new tensors on
        the snapshotted devices."""
        if pop and len(self._ring) > 1:
            self._ring.pop()
        if not self._ring:
            raise RuntimeError("rollback requested but no snapshots held")
        step, host, devices = self._ring[-1]
        if into is not None:
            return step, tree_copy_(into, host)
        where = iter(devices)
        return step, map_tensors(lambda h: h.to(next(where), copy=True),
                                 host)

    def clear(self) -> None:
        self._ring.clear()


@dataclasses.dataclass
class EscalationPolicy:
    """Bounds on the skip -> rollback -> halt ladder (host side).

    The IN-GRAPH escalation (how many consecutive anomalies before the
    verdict itself says ROLLBACK/HALT) lives in AnomalySentinel's
    budgets; this bounds what the host will actually do across a run.
    """

    max_rollbacks: int = 3          # per run; beyond this, halt
    lr_dampen: float = 0.5          # lr_scale multiplier per rollback
    min_lr_scale: float = 1.0 / 16  # dampening floor
    # a rollback that lands on the same snapshot as the previous one
    # pops to the next-older snapshot (backoff through history)
    backoff_on_repeat: bool = True


class ResilienceManager:
    """The loop's host side: verdicts in, actions out, anomaly log to disk.

    Usage (see apex_tpu_torch/examples/gpt/pretrain_gpt.py for the full
    wiring)::

        mgr = ResilienceManager(buffer=RollbackBuffer(2, interval=10),
                                policy=EscalationPolicy(),
                                log_path=os.path.join(save_dir, "anomalies.jsonl"))
        while step < total:
            ..., verdict = train_step(..., lr_scale=mgr.lr_scale)
            action = mgr.resolve(step, int(verdict), loss=float(loss))
            if action == "halt":
                save_checkpoint_verified(...); break
            if action == "rollback":
                step, state = mgr.do_rollback(into=state)
                it = make_iterator(step)      # re-wind the data stream
                continue
            mgr.observe_good(step + 1, state) # feeds the snapshot ring
            step += 1
    """

    def __init__(
        self,
        buffer: Optional[RollbackBuffer] = None,
        policy: Optional[EscalationPolicy] = None,
        log_path: Optional[str] = None,
        on_event: Optional[Callable[[dict], None]] = None,
        router=None,
    ):
        self.buffer = buffer
        self.policy = policy or EscalationPolicy()
        self.log_path = log_path
        self.on_event = on_event
        self.router = router
        self.lr_scale = 1.0
        self.rollbacks_used = 0
        self.events: List[dict] = []
        self._last_restore_step: Optional[int] = None
        if log_path:
            os.makedirs(os.path.dirname(os.path.abspath(log_path)), exist_ok=True)

    # -- anomaly log -------------------------------------------------------

    def _record(self, step: int, kind: str, **fields) -> dict:
        # the monitor schema IS the historical anomaly-log line shape
        # ({"t", "step", "kind", ...}), so routing through it keeps every
        # existing anomalies.jsonl consumer working byte-for-byte
        from apex_tpu_torch.monitor.router import make_record

        event = make_record(kind, step, **fields)
        self.events.append(event)
        if self.log_path:
            try:
                with open(self.log_path, "a") as f:
                    f.write(json.dumps(event) + "\n")
            except OSError as e:  # pragma: no cover - log loss is non-fatal
                logger.warning("anomaly log write failed: %s", e)
        if self.router is not None:
            self.router.emit(event)
        if self.on_event:
            self.on_event(event)
        return event

    # -- verdict -> action -------------------------------------------------

    def resolve(self, step: int, verdict: int, loss: Optional[float] = None) -> str:
        """Map a step's verdict to 'ok' | 'skip' | 'rollback' | 'halt'.

        ROLLBACK degrades to 'halt' when retries are exhausted or no
        snapshot exists (nothing to restore is not a recoverable state).
        """
        verdict = int(verdict)
        if verdict == VERDICT_OK:
            return "ok"
        if verdict == VERDICT_SKIP:
            self._record(step, "skip", loss=loss, lr_scale=self.lr_scale)
            logger.warning("anomalous step %d: skipped (loss=%s)", step, loss)
            return "skip"
        if verdict == VERDICT_ROLLBACK:
            if self.buffer is None or len(self.buffer) == 0:
                logger.error("rollback verdict at step %d but no snapshots; halting", step)
                self._record(step, "halt", loss=loss, reason="no snapshots")
                return "halt"
            if self.rollbacks_used >= self.policy.max_rollbacks:
                logger.error(
                    "rollback budget exhausted (%d) at step %d; halting",
                    self.policy.max_rollbacks, step,
                )
                self._record(step, "halt", loss=loss,
                             reason="rollback budget exhausted")
                return "halt"
            self._record(step, "rollback", loss=loss, lr_scale=self.lr_scale)
            return "rollback"
        self._record(step, "halt", loss=loss, reason="sentinel verdict")
        return "halt"

    def do_rollback(self, into: Any = None) -> Tuple[int, Any]:
        """Restore the snapshot chosen by the policy; dampens LR.

        Returns ``(step, state)`` — resume the loop AT ``step`` with the
        data iterator rebuilt for it. ``into`` (the live state) receives
        the snapshot in place (``RollbackBuffer.rollback``).
        """
        assert self.buffer is not None
        pop = (
            self.policy.backoff_on_repeat
            and self._last_restore_step is not None
            and self.buffer.steps
            and self.buffer.steps[-1] == self._last_restore_step
        )
        # goodput span: recovery wall time (snapshot restore +
        # device_put) is rollback badput in the run-level ledger; emitted
        # through THIS manager's router so the span lands in the same
        # stream as the rollback/rollback_restore events below
        from apex_tpu_torch.monitor.goodput.spans import span as _goodput_span

        with _goodput_span("rollback", router=self.router):
            step, state = self.buffer.rollback(pop=bool(pop), into=into)
        self.rollbacks_used += 1
        self.lr_scale = max(
            self.policy.min_lr_scale, self.lr_scale * self.policy.lr_dampen
        )
        self._last_restore_step = step
        self._record(
            step, "rollback_restore",
            lr_scale=self.lr_scale, rollbacks_used=self.rollbacks_used,
            popped=bool(pop),
        )
        logger.warning(
            "rolled back to step %d (rollback %d/%d, lr_scale=%.4f)",
            step, self.rollbacks_used, self.policy.max_rollbacks, self.lr_scale,
        )
        return step, state

    def observe_good(self, step: int, state: Any) -> None:
        """Feed a post-step known-good state to the snapshot ring."""
        if self.buffer is not None:
            self.buffer.maybe_snapshot(step, state)
