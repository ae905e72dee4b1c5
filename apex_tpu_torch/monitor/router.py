"""Host-side metric routing: one record schema, pluggable sinks.

Every telemetry producer in the repo — the per-interval :class:`MetricBag`
read, ``Timers.write``, the resilience anomaly stream — emits the SAME
flat record shape (:func:`make_record`), so one consumer (a jsonl tailer,
a dashboard) can join metrics with anomalies on ``step`` without per-
producer parsers:

    {"t": <unix time>, "step": <int>, "kind": <str>, "host": <int>, ...}

``kind`` partitions the stream: "metrics" (interval scalars), "timer"
(named timer averages), the resilience kinds ("skip", "rollback",
"rollback_restore", "halt") which predate this module and keep their
exact historical shape — the schema was chosen to match them — the
xray kinds ("comms", "compile", and "memory" — the HBM x-ray's
per-interval records, ``scope="device"`` watermark rows from
``device.memory_stats()`` with achieved-vs-predicted utilization and
``scope="kv_pool"`` serving-cache occupancy/fragmentation rows, both
from apex_tpu_torch.monitor.xray.hbm.live; plus "oom" — ONE forensic
incident bundle per RESOURCE_EXHAUSTED catch with the analytic
component breakdown, largest-buffers table, and ranked knob
suggestions, apex_tpu_torch.monitor.xray.hbm.oom), "analysis"
(static-auditor findings from apex_tpu_torch.analysis: rule/site/severity
plus the allowlist verdict), the goodput kinds ("run", "span",
"stall", "goodput", "fleet", "bench" — apex_tpu_torch.monitor.goodput), and
the incident-response kinds ("preemption" — the deadline-budgeted
termination decision, utils/autoresume.py; "incident" — forensic
bundles and termination marks from apex_tpu_torch.resilience.health;
"retry" — transient-IO retry stutter, resilience/retry.py), and the
replay kinds ("journal" — the flight recorder's per-step
nondeterminism inputs and fingerprints; "replay" — a re-execution
segment's comparison outcome; "divergence" — the bisector's forensic
verdict, all from apex_tpu_torch.resilience.replay), the serving kind
("request" — one record per request-lifecycle transition from the
apex_tpu_torch.serving scheduler: queued/admitted/prefill/decode plus the
terminal states, docs/serving.md), the request-x-ray kinds ("trace" —
one causal span per wall-clock segment a request occupies, the global
request id as trace id, emitted only by apex_tpu_torch.serving.trace.emit;
"slo" — rolling error-budget burn-rate rows from the SLO monitor,
apex_tpu_torch.serving.trace.slo; "trace_decomp" — the offline analyzer's
per-request critical-path partition, ``python -m
apex_tpu_torch.serving.trace --json``), and the remediation kind
("remediation" — one record per auto-remediation case transition from
apex_tpu_torch.resilience.remediation: detect/verify/quarantine/probation/
readmit/escalate with the triggering detector records attached as
evidence in the incident-bundle idiom, docs/resilience.md
"Auto-remediation"), so pre-flight audit results and run-lifecycle
accounting land in the same jsonl a tailer already reads.

``host`` is the producing process's index so merged multi-process
streams stay attributable: the ``torch.distributed`` rank when a process
group is initialized, else 0 (the JAX package's router reads
``jax.process_index()`` there; the schema is the same, so a stream of
either package reads in the other's accountant and x-ray).

Copied from apex_tpu/monitor/router.py, which imports no JAX.

Sinks are deliberately dumb append-only writers; the router owns fan-out
and failure isolation (one broken sink must not take down training — a
metrics pipeline that can kill the run is worse than no metrics).
"""

import atexit
import collections
import csv
import json
import logging
import os
import signal as _signal
import sys
import threading
import time
import weakref
from typing import Deque, Dict, List, Optional, Sequence

logger = logging.getLogger("apex_tpu_torch.monitor")

def _default_host() -> int:
    """This process's index: ``APEX_TPU_HOST`` when set (producers that
    know better: launchers, tests synthesizing fleets), else the
    ``torch.distributed`` rank when a process group is initialized,
    else 0. ``torch.distributed`` is read only when torch is already
    imported, so the schema stays usable without it."""
    env = os.environ.get("APEX_TPU_HOST")
    if env is not None:
        try:
            return int(env)
        except ValueError:
            pass
    torch = sys.modules.get("torch")
    dist = getattr(torch, "distributed", None)
    try:
        if dist is not None and dist.is_available() and dist.is_initialized():
            return int(dist.get_rank())
    except Exception:  # a group mid-teardown: say host 0
        return 0
    return 0


def make_record(kind: str, step: int, **fields) -> dict:
    """The one shared record shape (see module docstring).

    ``host`` defaults to this process's index (:func:`_default_host`);
    pass ``host=`` explicitly to override (replaying or synthesizing
    another host's stream).
    """
    return {
        "t": time.time(), "step": int(step), "kind": str(kind),
        "host": _default_host(), **fields,
    }


class Sink:
    """Append-only record consumer. Subclasses override :meth:`emit`."""

    def emit(self, record: dict) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class MemorySink(Sink):
    """Records kept in memory — tests and programmatic consumers.

    ``records`` is a bounded deque: a week-long run emitting every few
    seconds must not grow host memory without limit, so the oldest
    records evict once ``max_records`` is reached (the file sinks are
    the durable record; this one is a window). ``max_records=None``
    removes the cap — opt into the leak explicitly. ``kinds`` filters
    to the listed record kinds (the CsvSink convention; default: keep
    everything) so a consumer interested in one slice of the stream —
    the examples' goodput-accounting window keeps only run/span — does
    not spend its window on the rest.
    """

    DEFAULT_MAX_RECORDS = 100_000

    def __init__(self, max_records: Optional[int] = DEFAULT_MAX_RECORDS,
                 kinds=None):
        if max_records is not None and max_records < 1:
            raise ValueError(
                f"max_records must be >= 1 or None, got {max_records}"
            )
        self.max_records = max_records
        self.kinds = None if kinds is None else frozenset(kinds)
        self.records: Deque[dict] = collections.deque(maxlen=max_records)

    def emit(self, record: dict) -> None:
        if self.kinds is not None and record.get("kind") not in self.kinds:
            return
        self.records.append(record)

    def snapshot(self) -> List[dict]:
        """A list copy of the window, safe against concurrent emits.

        ``records`` is a plain deque and the router's daemon-thread
        producers (the stall watchdog, a background finalize) may append
        mid-iteration — CPython then raises "deque mutated during
        iteration". Consumers that read the window from ANOTHER thread
        (the incident bundle, the live fleet check) use this: retry the
        copy a few times, and on a pathologically hot stream return the
        best-effort empty list rather than raise — a reader must never
        take down the producer it is observing.
        """
        for _ in range(8):
            try:
                return list(self.records)
            except RuntimeError:  # concurrent append mid-copy: retry
                continue
        return []


class JsonlSink(Sink):
    """One json object per line, append mode (the anomaly-log format)."""

    def __init__(self, path: str):
        self.path = path
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self._f = open(path, "a")

    def emit(self, record: dict) -> None:
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class CsvSink(Sink):
    """CSV of ONE record kind (default "metrics"), header frozen from the
    first accepted record's keys.

    CSV is a fixed-schema format: other kinds (timer records, anomalies)
    are FILTERED, not errored — pass ``kinds=None`` to accept everything
    at your own risk, or use jsonl for open schemas. Later records may
    omit columns (written empty); a genuinely new key after the header is
    frozen is surfaced via the router's isolation log — EXCEPT the
    schema-plumbing keys in :data:`TOLERATED_EXTRA_KEYS` ("host"), which
    are silently dropped so a CSV written before the schema grew them
    resumes cleanly instead of rejecting every record. Re-opening an
    existing non-empty file adopts ITS header instead of writing a second
    one mid-file (resume with the same --metrics-csv path).
    """

    #: record keys a frozen header may lack without dropping the row:
    #: schema additions that are plumbing, not data (see class docstring).
    #: "data_skipped" (the bounded data-pipeline skip counter,
    #: apex_tpu/data/robust.py) joined the metrics record after CSVs in
    #: the wild froze their headers, exactly like "host" before it —
    #: and "probation"/"remediation_cases" (the auto-remediation
    #: controller's per-interval gauges, resilience.remediation) after
    #: that, for the same frozen-header-resume reason — and the serving
    #: fleet's request-record tags "redispatch_t" (the re-attempt's
    #: local enqueue instant) and "recovery_s" (accumulated failover
    #: envelope seconds), which joined with the request x-ray
    #: (apex_tpu_torch.serving.trace) — and the HBM x-ray's
    #: "peak_hbm_bytes"/"hbm_utilization" (the watermark monitor's
    #: ``metrics_fields()``, monitor.xray.hbm.live), merged into the
    #: metrics record the same way remediation's gauges are.
    TOLERATED_EXTRA_KEYS = frozenset({
        "host", "data_skipped", "probation", "remediation_cases",
        "redispatch_t", "recovery_s", "peak_hbm_bytes", "hbm_utilization",
    })

    def __init__(self, path: str, kinds=("metrics",)):
        self.path = path
        self.kinds = None if kinds is None else frozenset(kinds)
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self._writer: Optional[csv.DictWriter] = None
        header = None
        if os.path.exists(path) and os.path.getsize(path) > 0:
            with open(path, newline="") as f:
                header = next(csv.reader(f), None)
        self._f = open(path, "a", newline="")
        if header:
            self._writer = csv.DictWriter(self._f, fieldnames=header)

    def emit(self, record: dict) -> None:
        if self.kinds is not None and record.get("kind") not in self.kinds:
            return
        if self._writer is None:
            self._writer = csv.DictWriter(self._f, fieldnames=list(record))
            self._writer.writeheader()
        elif not (set(record) - set(self._writer.fieldnames)
                  - self.TOLERATED_EXTRA_KEYS):
            record = {k: v for k, v in record.items()
                      if k in self._writer.fieldnames}
        self._writer.writerow(record)  # raises on (non-tolerated) extra keys
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class StdoutSink(Sink):
    """Human-readable one-liners (the examples' console log).

    "metrics" records render as ``step  NNNN loss   X.XXXX k v ...`` —
    the exact prefix the example tests (and human eyeballs) key on; other
    kinds render as ``[kind] step N k=v ...``. ``skip_kinds`` defaults to
    the goodput plumbing kinds ("span", "run") — they fire per loop
    iteration and exist for the accountant, not the console — plus
    "incident", whose forensic bundle (all-thread stacks, the record-tail
    window) is far too large for a one-liner; the incident responder logs
    a compact summary and the file sinks carry the bundle. "journal"
    (the replay flight recorder, resilience.replay) is skipped for the
    same per-iteration reason: the sidecar jsonl is its durable home —
    as is "request" (the serving scheduler's per-transition lifecycle
    records, apex_tpu_torch.serving): a loaded server emits several per tick,
    and the console surface is the engine's summary line, not the
    firehose. "trace" (the request x-ray's causal spans,
    apex_tpu_torch.serving.trace) and "slo" (its burn-rate rows) are skipped
    for the same per-tick-firehose reason — the jsonl stream is their
    durable home and ``python -m apex_tpu_torch.serving.trace`` their
    console. "remediation" (the auto-remediation controller,
    resilience.remediation) is skipped for the incident reason: each
    record attaches its triggering evidence records wholesale, far too
    large for a one-liner — the controller logs compact action lines
    and the file sinks carry the case history. "memory" (the HBM
    x-ray's per-interval watermark and KV-pool rows,
    monitor.xray.hbm.live) is skipped for the per-interval-firehose
    reason — the examples print their own achieved-vs-predicted banner
    and the jsonl stream is the durable home — and "oom" for the
    incident reason: the bundle carries the full component breakdown
    and largest-buffers table, and the guard logs its own compact
    error line. The ``host`` field is likewise plumbing and never
    rendered.
    """

    def __init__(self, stream=None,
                 skip_kinds=("span", "run", "incident", "journal",
                             "request", "remediation", "trace", "slo",
                             "memory", "oom")):
        self.stream = stream or sys.stdout
        self.skip_kinds = frozenset(skip_kinds or ())

    @staticmethod
    def _fmt(v) -> str:
        if v is None:
            return "-"
        if isinstance(v, float):
            return f"{v:.4g}"
        return str(v)

    def emit(self, record: dict) -> None:
        if record.get("kind") in self.skip_kinds:
            return
        rest = {
            k: v for k, v in record.items()
            if k not in ("t", "step", "kind", "host")
        }
        if record["kind"] == "metrics":
            parts = [f"step {record['step']:5d}"]
            if "loss" in rest:
                loss = rest.pop("loss")
                parts.append(
                    f"loss {loss:8.4f}" if loss is not None else "loss        -"
                )
            parts += [f"{k} {self._fmt(v)}" for k, v in rest.items()]
            line = " ".join(parts)
        else:
            kv = " ".join(f"{k}={self._fmt(v)}" for k, v in rest.items())
            line = f"[{record['kind']}] step {record['step']} {kv}".rstrip()
        print(line, file=self.stream, flush=True)


class TensorBoardSink(Sink):
    """Scalar summaries through ``torch.utils.tensorboard``'s writer,
    imported on first use (it needs the ``tensorboard`` package).
    Construct through :func:`try_tensorboard_sink` to gate on
    availability instead of catching ImportError at every call site.
    """

    def __init__(self, log_dir: str):
        writer_cls = _tb_writer_class()
        if writer_cls is None:
            raise ImportError(
                "no TensorBoard writer importable "
                "(torch.utils.tensorboard needs the tensorboard package)"
            )
        self._writer = writer_cls(log_dir)

    def emit(self, record: dict) -> None:
        step = record["step"]
        kind = record["kind"]
        for k, v in record.items():
            # host is schema plumbing, not a scalar series worth a chart
            if (k in ("t", "step", "kind", "host")
                    or not isinstance(v, (int, float))):
                continue
            self._writer.add_scalar(f"{kind}/{k}", v, step)

    def close(self) -> None:
        self._writer.close()


def _tb_writer_class():
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter
    except ImportError:  # torch without the tensorboard package
        return None


def try_tensorboard_sink(log_dir: str) -> Optional[TensorBoardSink]:
    """A :class:`TensorBoardSink`, or None when no TB writer is importable."""
    if _tb_writer_class() is None:
        return None
    return TensorBoardSink(log_dir)


#: live routers, flushed+closed best-effort at interpreter exit / SIGTERM
_LIVE_ROUTERS: "weakref.WeakSet" = weakref.WeakSet()
#: callables run BEFORE routers close in the teardown path — the goodput
#: span ledger registers its open-span flush here so a SIGTERM-killed run
#: still lands its in-flight spans (marked interrupted) in the stream
_FLUSH_HOOKS: List = []
_TEARDOWN = {"installed": False}


def register_flush_hook(fn) -> None:
    """Run ``fn()`` before routers close in the exit/SIGTERM teardown."""
    if fn not in _FLUSH_HOOKS:
        _FLUSH_HOOKS.append(fn)


def _flush_all_routers() -> None:
    for fn in list(_FLUSH_HOOKS):
        try:
            fn()
        except Exception:  # teardown must never raise
            pass
    for router in list(_LIVE_ROUTERS):
        try:
            router.close()
        except Exception:
            pass


def flush_all_routers() -> None:
    """Run the flush hooks (open goodput spans land ``interrupted=True``)
    and close every live router — the atexit/SIGTERM teardown, callable
    on purpose.

    The incident responder (``apex_tpu_torch.resilience.health``) is the
    deliberate caller: a wedged main thread can never run signal handlers
    or atexit hooks, so the responder's self-termination must perform the
    teardown itself — from the watchdog thread — before ``os._exit``.
    Best-effort and idempotent like the hooks it wraps.
    """
    _flush_all_routers()


def _install_teardown() -> None:
    """Best-effort atexit + SIGTERM flush (installed once, lazily).

    The SIGTERM hook only installs over the DEFAULT handler — anything
    custom (pytest plugins, a launcher) keeps precedence, and
    ``AutoResume`` installing its preemption handler LATER simply
    replaces this one (its flag-and-exit path reaches the normal close).
    Our handler flushes, restores the default disposition, and re-raises
    the signal so the process still dies by SIGTERM — the chaos
    harness's real-SIGTERM drill must not be converted into a survival.
    """
    if _TEARDOWN["installed"]:
        return
    _TEARDOWN["installed"] = True
    atexit.register(_flush_all_routers)
    try:
        if _signal.getsignal(_signal.SIGTERM) == _signal.SIG_DFL:
            def _on_term(signum, frame):
                _flush_all_routers()
                _signal.signal(signum, _signal.SIG_DFL)
                os.kill(os.getpid(), signum)

            # marker for handlers that CHAIN (utils.autoresume.
            # TerminationNotice): this hook exists only to flush before
            # an otherwise-FATAL SIGTERM, and re-raises to preserve the
            # death. A graceful-drain latch installed over it must skip
            # the chain — the signal is no longer fatal, and the flush
            # happens at the drain's normal close/atexit instead.
            _on_term._apex_tpu_router_teardown = True
            _signal.signal(_signal.SIGTERM, _on_term)
    except (ValueError, OSError):  # non-main thread / exotic platform
        pass


class MetricRouter:
    """Fan one record stream out to sinks, isolating sink failures.

    The single mouth of the telemetry pipeline: producers call
    :meth:`metrics` / :meth:`event` / :meth:`emit`, and every configured
    sink sees every record. A sink that raises is logged and skipped for
    that record — it is NOT removed, so a transiently full disk resumes
    logging when space returns. Fan-out is serialized under a lock: the
    stall watchdog (and any other daemon thread) emits concurrently with
    the training loop, and interleaved writes on a shared file object
    would corrupt the stream.

    Lifecycle: usable as a context manager; :meth:`close` is idempotent
    and a record emitted after close is dropped with one warning (a
    daemon thread racing shutdown must not crash it). Every router is
    also registered for a best-effort atexit/SIGTERM flush-and-close
    (:func:`register_flush_hook` runs first), so an abnormal exit cannot
    tear buffered records — or the goodput ledger's final spans — off
    the stream.
    """

    def __init__(self, sinks: Sequence[Sink] = ()):
        self.sinks: List[Sink] = list(sinks)
        # RLock, not Lock: the SIGTERM teardown runs as a signal handler
        # IN the main thread and may interrupt an in-flight emit — a
        # non-reentrant lock would deadlock close() against the very
        # frame it interrupted
        self._lock = threading.RLock()
        self._closed = False
        self._warned_closed = False
        _LIVE_ROUTERS.add(self)
        _install_teardown()

    def add_sink(self, sink: Sink) -> "MetricRouter":
        self.sinks.append(sink)
        return self

    def emit(self, record: dict) -> None:
        with self._lock:
            if self._closed:
                if not self._warned_closed:
                    self._warned_closed = True
                    logger.warning(
                        "record emitted after router close (step %s) — "
                        "dropped", record.get("step"),
                    )
                return
            for sink in self.sinks:
                try:
                    sink.emit(record)
                except Exception as e:  # one sink must not kill the run
                    logger.warning(
                        "sink %s dropped record (step %s): %s",
                        type(sink).__name__, record.get("step"), e,
                    )

    def metrics(self, step: int, **scalars) -> dict:
        """Emit one interval's scalars as a kind='metrics' record."""
        record = make_record("metrics", step, **scalars)
        self.emit(record)
        return record

    def event(self, kind: str, step: int, **fields) -> dict:
        """Emit a non-metrics record (anomalies, stalls, profiler marks)."""
        record = make_record(kind, step, **fields)
        self.emit(record)
        return record

    @property
    def timer_write_fn(self):
        """Adapter with the ``Timers(write_fn=...)`` signature
        ``(name, value, iteration)`` — plugs the dangling callback in
        utils/timers.py into this stream as kind='timer' records."""

        def write(name: str, value: float, iteration: int) -> None:
            self.event("timer", iteration, name=name, seconds=float(value))

        return write

    def close(self) -> None:
        """Close every sink once; later calls (and the exit teardown
        re-closing an already-closed router) are no-ops."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            for sink in self.sinks:
                try:
                    sink.close()
                except Exception as e:  # pragma: no cover - best-effort
                    logger.warning(
                        "sink %s close failed: %s", type(sink).__name__, e
                    )

    def __enter__(self) -> "MetricRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
