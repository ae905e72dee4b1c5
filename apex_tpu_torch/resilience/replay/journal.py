"""Flight recorder: journal every per-step nondeterminism input
(counterpart of apex_tpu/resilience/replay/journal.py; the same record
schema, so either package's ``load_journal`` reads the other's journal).

The trust layer can *detect* numerical trouble — the anomaly sentinel
flags loss spikes, the fleet detector flags cross-host suspects — but a
flagged run used to end with a human staring at metrics jsonl: nothing
could *reproduce* it. Production trainers treat determinism as a
first-class debugging primitive (TorchTitan, arXiv:2410.06511), and the
newly-lossy int8 wire (parallel/compress.py) makes a bit-exact replay
referee the missing piece between "the detector fired" and "here is the
step and the leaf that corrupted".

The :class:`FlightRecorder` journals, per training step, everything the
compiled step's outputs depend on that is not already in the checkpoint:

- the batch actually consumed (sample-id range + a crc32 of its bytes,
  the ``integrity.tree_fingerprint`` leaf convention applied to data) —
  so a ``RobustBatches`` skip that shifted the stream is replayable
  from the journal instead of diverging by construction;
- the host-injected step inputs (``inject_nan`` chaos arm, the
  escalation policy's ``lr_scale``);
- per-step output FINGERPRINTS (loss, verdict, optionally the per-layer
  ``layer_out_rms`` vector and loss scale) the replayer compares
  bitwise on a matching platform;
- ANCHOR marks at every verified checkpoint: the manifest's per-leaf
  crc32 fingerprint (written by ``integrity.write_manifest``) IS the
  anchor's state fingerprint, so anchors cost the journal one line —
  the expensive device->host snapshot was already paid by the save. An
  anchor at step N records the state ENTERING step N (the checkpoint
  convention: ``AutoResume.step(N, state)`` saves post-step-(N-1)
  state);
- EVENT marks for everything that breaks linear re-execution (rollback,
  halt, restart headers): the replayer refuses to span them instead of
  silently diverging.

Records go two places: ``kind="journal"`` records through the shared
MetricRouter (so a tailer joins them with metrics on ``step``) and a
checkpoint-anchored SIDECAR jsonl next to the checkpoints
(``<save>/replay-journal.jsonl``), appended per record and fsync'd at
every anchor/flush point so the journal is durable exactly when the
manifest is. ``AutoResume`` flushes it on the termination save and on
``prepare_incident_exit`` so a post-mortem replay is possible after
exit-43 and preemption paths, not just clean runs.

Overhead: one buffered ~200-byte line write per step plus a crc32 over
the host batch bytes — well under 1% of any real step (measured in the
bench ``ckpt`` section, ``replay_journal_overhead``). The per-step
fingerprints reuse fetches the host loop already pays (the example
fetches loss and verdict every step for the escalation policy).

Host-only: a journal can be read, diffed, and sanity-checked without a
card; only the replayer (replayer.py) runs the step.
"""

import binascii
import json
import logging
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from apex_tpu_torch.monitor.router import make_record

logger = logging.getLogger("apex_tpu_torch.resilience.replay")

__all__ = [
    "JOURNAL_FILENAME",
    "FlightRecorder",
    "Journal",
    "batch_crc",
    "load_journal",
    "journal_path",
]

#: the sidecar's conventional filename inside a checkpoint directory
JOURNAL_FILENAME = "replay-journal.jsonl"


def journal_path(directory: str) -> str:
    """The sidecar journal path for a checkpoint ``directory``."""
    return os.path.join(os.path.abspath(directory), JOURNAL_FILENAME)


def batch_crc(*arrays) -> int:
    """crc32 over the raw bytes of the batch arrays, in order.

    The data-side twin of ``integrity.tree_fingerprint``'s per-leaf
    crc32: cheap (the bytes are already on host), catches any content
    change — a shifted sample window, a corrupted memmap page, a corpus
    regenerated with the wrong seed — and is platform-independent (the
    bytes are the bytes).
    """
    crc = 0
    for a in arrays:
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        crc = binascii.crc32(
            np.ascontiguousarray(np.asarray(a)).tobytes(), crc
        )
    return crc


def _scalar(v):
    """json-safe scalar: numpy arrays and tensors -> python float/int/bool
    (lists for arrays).

    Floats round-trip exactly through json (python serializes the
    shortest repr that reparses to the same double; a float32 value
    widened to float64 is exact), which is what makes the journaled
    fingerprints bitwise-comparable after a disk round trip.
    """
    if v is None or isinstance(v, (str, bool, int, float)):
        return v
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    arr = np.asarray(v)
    if arr.shape == ():
        item = arr.item()
        return item
    return [_scalar(x) for x in arr.tolist()]


class FlightRecorder:
    """Append-only step journal: router records + durable sidecar.

    Thread-safe (the background manifest finalize and the incident
    responder's watchdog thread may flush concurrently with the training
    loop's appends). Every write method returns the record emitted.

    ``router=None`` keeps the sidecar-only mode; ``path=None`` keeps the
    router-only mode (tests); both None is an error.
    """

    def __init__(self, path: Optional[str], router=None):
        if path is None and router is None:
            raise ValueError("FlightRecorder needs a sidecar path, a "
                             "router, or both")
        self.path = os.path.abspath(path) if path else None
        self.router = router
        self._lock = threading.Lock()
        self._f = None
        self._closed = False
        if self.path:
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            self._f = open(self.path, "a")

    # -- record emission ---------------------------------------------------

    def _emit(self, event: str, step: int, **fields) -> dict:
        clean = {k: _scalar(v) for k, v in fields.items()}
        record = make_record("journal", step, event=event, **clean)
        with self._lock:
            if self._closed:
                logger.warning("journal record after close (step %s) — "
                               "dropped", step)
                return record
            if self._f is not None:
                self._f.write(json.dumps(record) + "\n")
                self._f.flush()
        # router fan-out OUTSIDE the lock: a slow sink must not block a
        # concurrent flush (the router has its own isolation lock)
        if self.router is not None:
            self.router.emit(record)
        return record

    def header(self, run_id: str, target: str, config: Optional[dict] = None,
               **fields) -> dict:
        """One per incarnation, FIRST (the run-header convention): the
        replay recipe — target kind, its config, corpus identity, seed,
        platform + numerics flags. A restarted job appends a new header;
        ``load_journal`` treats later records as overriding earlier
        incarnations' same-step records (the restart restored a verified
        checkpoint, so the newer trajectory is the authoritative one)."""
        return self._emit("header", 0, run_id=str(run_id),
                          target=str(target), config=config or {}, **fields)

    def step(self, step: int, **fields) -> dict:
        """Per-step inputs + fingerprints (module docstring)."""
        return self._emit("step", step, **fields)

    def anchor(self, step: int, **fields) -> dict:
        """Checkpoint anchor: the state ENTERING ``step`` is durably
        saved and manifest-fingerprinted. Fsyncs the sidecar — the
        journal is durable exactly when the checkpoint is."""
        rec = self._emit("anchor", step, **fields)
        self.flush()
        return rec

    def event(self, step: int, event: str, **fields) -> dict:
        """Non-linear-execution marks (rollback / halt / bitflip / data
        skip budget...): the replayer refuses to replay across them."""
        return self._emit(event, step, **fields)

    # -- durability --------------------------------------------------------

    def flush(self) -> None:
        """Flush + fsync the sidecar (anchor points, termination saves,
        incident exits). Safe from any thread; never raises — durability
        of the journal must not take down the thing it observes."""
        with self._lock:
            if self._f is None or self._closed:
                return
            try:
                self._f.flush()
                os.fsync(self._f.fileno())
            except OSError as e:
                logger.warning("journal flush failed: %s", e)

    def close(self) -> None:
        self.flush()
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if self._f is not None:
                self._f.close()
                self._f = None


class Journal:
    """A parsed journal: headers + per-step records + anchors + events.

    ``steps`` maps step -> the LAST step record for it (restarted
    incarnations override — see :meth:`FlightRecorder.header`); ``order``
    preserves the raw record sequence for forensics.
    """

    def __init__(self, records: Sequence[dict]):
        self.order: List[dict] = list(records)
        self.headers: List[dict] = [
            r for r in self.order if r.get("event") == "header"
        ]
        self.steps: Dict[int, dict] = {}
        self.anchors: Dict[int, dict] = {}
        self.events: List[dict] = []
        for r in self.order:
            ev = r.get("event")
            if ev == "step":
                self.steps[int(r["step"])] = r
            elif ev == "anchor":
                self.anchors[int(r["step"])] = r
            elif ev != "header":
                self.events.append(r)

    @property
    def header(self) -> dict:
        """The newest incarnation's header (the replay recipe)."""
        if not self.headers:
            raise ValueError("journal has no header record")
        return self.headers[-1]

    def step_range(self) -> Tuple[int, int]:
        """(min, max) journaled step."""
        if not self.steps:
            raise ValueError("journal has no step records")
        return min(self.steps), max(self.steps)

    def breaks_in(self, start: int, stop: int) -> List[dict]:
        """Non-replayable events with start < step <= stop: rollbacks
        rewind state the journal cannot reconstruct (the snapshot ring is
        in-memory), halts end the trajectory."""
        return [
            e for e in self.events
            if e.get("event") in ("rollback", "halt")
            and start < int(e.get("step", -1)) <= stop
        ]


def load_journal(path: str) -> Journal:
    """Parse a journal sidecar (or any jsonl carrying the records).

    Torn trailing lines (a crashed writer) are tolerated with a warning
    — the jsonl-stream discipline of the goodput accountant. Non-journal
    kinds in a mixed stream (a ``--metrics-jsonl`` file) are filtered.
    """
    if os.path.isdir(path):
        path = journal_path(path)
    records = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                logger.warning("journal %s: unparseable line %d skipped",
                               path, i + 1)
                continue
            if rec.get("kind") == "journal":
                records.append(rec)
    if not records:
        raise ValueError(f"no journal records in {path}")
    return Journal(records)
