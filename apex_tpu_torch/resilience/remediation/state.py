"""Persisted remediation state: what survives between incarnations
(counterpart of apex_tpu/resilience/remediation/state.py).

A quarantine only means something if the NEXT incarnation honors it —
the process that decided to exclude a device is dead by the time the
reduced topology launches. This module is the durable half of the
controller: a small json file next to the checkpoints
(``<save>/remediation-state.json``) holding

- ``excluded``        — device ordinals currently quarantined (the
  supervisor launches the next incarnation with the reduced topology);
- ``restarts``        — controller-driven restarts so far (the bounded
  budget ``RemediationPolicy.max_restarts`` counts against);
- ``cases``           — open cross-incarnation cases (a quarantine in
  probation, a preemption awaiting its clean-step closure, a stall
  still under observation when an unrelated restart cut it short) as
  plain dicts the next controller re-binds;
- ``pending``         — supervisor-written evidence of an UNCLEAN exit
  (an exit-43 incident kill happens on the watchdog thread; the dying
  controller never gets to persist anything, so the supervisor writes
  the adoption note between incarnations);
- ``case_seq``        — monotonically increasing case-id counter, so
  case ids stay unique across incarnations;
- ``history``         — terminal case summaries (audit trail).

Writes are atomic (tmp + rename + fsync, the integrity-manifest
discipline) because the file is read at every launch decision: a torn
state file at the supervisor's next poll would turn a bounded
quarantine into a guess.

``quarantine_checkpoints`` is the reversible evidence-preserving form
of "delete the corrupt checkpoints": step dirs at/after the corruption
boundary are RENAMED into a ``quarantined-<case>/`` subdirectory —
every restore walk (which only reads ``step_*`` dirs) falls back to the
clean anchor automatically, re-saves of the re-run steps cannot collide
with the corrupt dirs, and the bytes stay on disk for forensics.

At world > 1 only the layout's first rank writes the file and moves
checkpoints (the controller's ``writer``); every rank reads it at the
start of an incarnation.
"""

import dataclasses
import json
import logging
import os
from typing import Dict, List, Optional

logger = logging.getLogger("apex_tpu_torch.resilience.remediation")

__all__ = [
    "STATE_FILENAME",
    "RemediationState",
    "state_path",
    "quarantine_checkpoints",
]

#: the state file's conventional name inside a checkpoint directory
STATE_FILENAME = "remediation-state.json"


def state_path(directory: str) -> str:
    """The remediation-state path for a checkpoint ``directory``."""
    return os.path.join(os.path.abspath(directory), STATE_FILENAME)


@dataclasses.dataclass
class RemediationState:
    """The persisted fields (module docstring) plus load/save plumbing.

    ``path=None`` keeps the state in-memory only (tests, in-process
    campaign sequences that carry the object across incarnations
    themselves).
    """

    path: Optional[str] = None
    excluded: List[int] = dataclasses.field(default_factory=list)
    restarts: int = 0
    cases: List[Dict] = dataclasses.field(default_factory=list)
    pending: Optional[Dict] = None
    case_seq: int = 0
    history: List[Dict] = dataclasses.field(default_factory=list)

    # -- persistence ---------------------------------------------------------

    @classmethod
    def load(cls, directory: Optional[str]) -> "RemediationState":
        """The state persisted under ``directory`` (fresh when the file
        is absent or ``directory`` is None). A torn/unparseable file is
        a loud error: guessing a quarantine is worse than stopping."""
        if directory is None:
            return cls()
        path = state_path(directory)
        if not os.path.exists(path):
            return cls(path=path)
        with open(path) as f:
            data = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)} - {"path"}
        return cls(path=path,
                   **{k: v for k, v in data.items() if k in known})

    def save(self) -> None:
        """Atomic persist (tmp + rename + fsync); no-op when in-memory."""
        if self.path is None:
            return
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        data = {
            "excluded": list(self.excluded),
            "restarts": int(self.restarts),
            "cases": list(self.cases),
            "pending": self.pending,
            "case_seq": int(self.case_seq),
            "history": list(self.history),
        }
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    # -- topology ------------------------------------------------------------

    def device_count(self, world: int) -> int:
        """Devices the next incarnation should launch with: the world
        minus the quarantined ordinals (only ordinals < world count —
        an excluded ordinal from a larger former world is moot)."""
        return world - len([d for d in self.excluded if 0 <= d < world])

    def next_case_id(self) -> str:
        """A job-unique case id (the counter persists across
        incarnations, so ids never collide after a restart)."""
        self.case_seq += 1
        return f"case-{self.case_seq}"


def quarantine_checkpoints(directory: str, after_step: int,
                           case: str) -> List[int]:
    """Move every finalized ``step_N`` dir with ``N > after_step`` into
    ``<directory>/quarantined-<case>/`` (module docstring); returns the
    moved step numbers.

    Rename, not delete: the corrupt checkpoints are EVIDENCE (the
    bisector's dirty anchor, the flipped leaf's bytes) and the move is
    reversible by hand. Every restore walk only considers ``step_*``
    dirs directly under ``directory``, so the fallback to the clean
    anchor (``after_step``) is automatic — and a re-run of the same
    steps can re-save them without colliding with the corrupt dirs.
    """
    from apex_tpu_torch.utils.checkpoint import finalized_steps

    directory = os.path.abspath(directory)
    moved: List[int] = []
    dest_root = os.path.join(directory, f"quarantined-{case}")
    for step in finalized_steps(directory):
        if step <= after_step:
            continue
        os.makedirs(dest_root, exist_ok=True)
        src = os.path.join(directory, f"step_{step}")
        dst = os.path.join(dest_root, f"step_{step}")
        os.rename(src, dst)
        moved.append(step)
        logger.warning(
            "remediation %s: quarantined checkpoint step_%d -> %s "
            "(carries the confirmed corruption; bytes preserved for "
            "forensics)", case, step, dst,
        )
    return moved
