"""Trace-pass framework: run one step of a target under a recorder, then
audit what it did (counterpart of apex_tpu/analysis/passes.py).

**The design choice.** JAX's passes trace the step abstractly
(``jax.make_jaxpr``) and never execute it. Eager torch has no abstract
trace of a whole training step: the port's step is Python that branches
on values (the anomaly gate reads the device, the pipeline schedules
loop over ranks and messages), which ``torch.fx``/``torch.export``
cannot capture whole. So the port's passes RUN ONE EAGER STEP of the
target under a recorder (:class:`Recorder`):

- a ``TorchDispatchMode`` sees every aten op the step dispatches,
  forward and backward, with its tensors' dtypes and devices;
- a ``TorchFunctionMode`` (the shape of ``amp/cast_engine.py``) sees the
  ``Tensor`` methods that read a value on the host (:data:`HOST_READS`:
  ``__bool__``, ``item``, ``tolist``, ``numpy``, ``__float__``,
  ``__int__``, ``__index__`` on either device; ``cpu`` and ``.to`` a CPU
  device of a tensor on the card); the dispatch mode adds the other
  host waits a card makes: the ops whose output shape depends on the
  data (``nonzero``, ``masked_select``, ``unique``) on either device,
  and blocking copies of host data to the card (``_to_copy``, ``copy_``,
  ``lift_fresh``: ``torch.tensor(x, device=...)``);
- the collective-traffic ledger (``monitor.xray.ledger``) is active for
  the step with a site function, so it sees every collective and every
  point-to-point edge (with ``src``/``dst``), and its ``dead`` list the
  collectives over one-rank groups;
- for the recorded-step audits (``analysis/hlo``, ``donation.py``), the
  dispatch mode also keeps every ``c10d`` op the step dispatched and
  gloo's host-card staging copies apart, and the context keeps each
  argument leaf's storage and value digest before and after the step and
  the step's outputs (``Recording.module``, ``hlo.parser.HloModule``).

What that changes against JAX: the step executes (the target's state
advances one step; the audit costs a step plus the recorder's Python
per op); only the branch the step took is seen (JAX traces both sides
of a ``cond``); and the card and the CPU record different programs — on
the card a hand-written kernel is one ctypes launch that dispatches no
aten op (as a ``pallas_call`` is one equation), while on the CPU its
plain twin runs as aten ops, so a promotion inside a plain twin shows on
the CPU only (the allowlist's trace entries require no hit).

**Sites.** A forward op resolves to the first frame of the Python stack,
innermost first, inside the repository (``apex_tpu_torch/`` or
``tests/``, each matched as a whole path component) that is not a
wrapper (:data:`_WRAPPER_FRAGMENTS`: the ledger, ``parallel_state``'s
helpers, the pipeline p2p helpers, the recorder and its passes). A
backward op runs in autograd's engine, whose stack holds no user frame:
the step runs under anomaly mode (``detect_anomaly(check_nan=False)``),
which keeps each autograd node's forward traceback, and a backward op
resolves through its node's — as JAX's transposed equations inherit the
forward equation's source info. On the card the step runs a second time under
``torch.cuda.set_sync_debug_mode("warn")`` (the allocator's watermarks
are taken over that warm run); each synchronizing call's
warning is resolved to a site the same way (:attr:`Recording.syncs`),
which the host-sync pass holds to the recorder's reads. Neither counts
the host copies of ``parallel_state``'s helpers themselves: over gloo a
collective stages CUDA tensors through pinned host memory (the
transport's traffic, which ``parallel_state.STAGED`` counts; NCCL moves
them on the card).

Passes register into :data:`TRACE_PASSES` with :func:`trace_pass` (JAX's
``jaxpr_pass``); :func:`run_passes` runs them over a :class:`StepTarget`.
"""

import collections
import contextlib
import dataclasses
import functools
import os
import re
import sys
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from apex_tpu_torch.analysis.findings import Allowlist, Finding, merge_findings
from apex_tpu_torch.analysis.hlo import parser as hlo_parser

__all__ = [
    "HOST_READS",
    "TRACE_PASSES",
    "Recorder",
    "Recording",
    "StepContext",
    "StepTarget",
    "audit_or_exit",
    "op_site",
    "run_passes",
    "trace_pass",
    "world_edges",
]

#: registered trace passes, name -> pass fn(StepContext) -> Iterable[Finding]
TRACE_PASSES: Dict[str, Callable] = {}

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
).replace(os.sep, "/")

#: repo directories whose frames are user code, as whole path components
_ANCHORS = ("/apex_tpu_torch/", "/tests/")

#: wrapper modules whose frames are NOT the interesting call site: the
#: ledger, parallel_state's collective helpers, the pipeline p2p helpers,
#: and this recorder with its passes — a finding names the layer or
#: schedule that called them
_WRAPPER_FRAGMENTS = (
    "/apex_tpu_torch/monitor/xray/ledger.py",
    "/apex_tpu_torch/parallel/parallel_state.py",
    "/apex_tpu_torch/parallel/pipeline/p2p.py",
    "/apex_tpu_torch/analysis/passes.py",
    "/apex_tpu_torch/analysis/precision.py",
    "/apex_tpu_torch/analysis/host_sync.py",
    "/apex_tpu_torch/analysis/collectives.py",
)

#: Tensor methods that read a value on the host
HOST_READS = frozenset({
    "__bool__", "item", "tolist", "cpu", "numpy", "to", "__float__",
    "__int__", "__index__",
})

_TRACEBACK_LINE = re.compile(r'File "(?P<file>[^"]+)", line (?P<line>\d+)')


def trace_pass(name: str):
    """Register a pass under ``name`` (decorator)."""

    def register(fn):
        TRACE_PASSES[name] = fn
        return fn

    return register


@functools.lru_cache(maxsize=4096)
def _norm(path: str) -> str:
    """``path`` normalized, with ``/`` separators. A frame's file is the
    path its module was imported by: a sys.path entry such as
    ``examples/long_context/../..`` (the JAX examples insert one, and a
    spawned rank inherits its parent's sys.path) leaves ``..`` components
    in every frame of the package, which would match neither the repo
    root nor the anchors."""
    return os.path.normpath(path).replace(os.sep, "/")


def _relsite(path: str, line: int) -> str:
    """A repo-relative ``file.py:line`` for an absolute source path."""
    path = _norm(path)
    if path.startswith(_REPO_ROOT + "/"):
        return f"{path[len(_REPO_ROOT) + 1:]}:{line}"
    for anchor in _ANCHORS:
        idx = path.rfind(anchor)
        if idx >= 0:
            return f"{path[idx + 1:]}:{line}"
    return f"{path}:{line}"


@functools.lru_cache(maxsize=4096)
def _user(path: str) -> bool:
    """Is a frame's file user code: under the repository's
    ``apex_tpu_torch/`` or ``tests/`` (any such component when the
    package runs from elsewhere), and no wrapper?"""
    path = _norm(path)
    if any(w in path for w in _WRAPPER_FRAGMENTS):
        return False
    if path.startswith(_REPO_ROOT + "/"):
        return path[len(_REPO_ROOT):].startswith(_ANCHORS)
    return any(a in path for a in _ANCHORS)


def _frames_site(frames) -> str:
    """The first user frame of ``(file, line)`` pairs, innermost first."""
    for path, line in frames:
        if _user(path):
            return _relsite(path, line)
    return "<unknown>"


#: the collective helpers' module: its own host copies (gloo staging CUDA
#: tensors through pinned host memory) are the transport's, which
#: ``parallel_state.STAGED`` counts, not the step's host waits
_TRANSPORT = "/apex_tpu_torch/parallel/parallel_state.py"


def in_transport(skip: int = 1) -> bool:
    """Is the running Python stack inside ``parallel_state``'s helpers?"""
    frame = sys._getframe(skip)
    while frame is not None:
        if frame.f_code.co_filename.replace(os.sep, "/").endswith(_TRANSPORT):
            return True
        frame = frame.f_back
    return False


def op_site(skip: int = 1) -> str:
    """The site of the op running now (module docstring): through the
    autograd node's forward traceback inside a backward, else the Python
    stack."""
    node = torch._C._current_autograd_node()
    if node is not None:
        tb = node.metadata.get("traceback_") if hasattr(
            node, "metadata") else None
        if tb:
            text = "".join(tb) if isinstance(tb, (list, tuple)) else str(tb)
            frames = [(m.group("file"), int(m.group("line")))
                      for m in _TRACEBACK_LINE.finditer(text)]
            return _frames_site(reversed(frames))
    frame = sys._getframe(skip)
    frames = []
    while frame is not None:
        frames.append((frame.f_code.co_filename, frame.f_lineno))
        frame = frame.f_back
    return _frames_site(frames)


@dataclasses.dataclass
class Recording:
    """What one step did. ``ops``: (aten op, input float dtypes, output
    dtypes, site) -> count; ``reads``: (method, site) -> count of host
    reads of values on the step's device; ``ledger``: the step's
    ``CommsLedger``; ``syncs``: (autograd node or "", site) -> count of
    synchronizing calls ``set_sync_debug_mode`` reported (the card only;
    None elsewhere);
    ``edges``: the point-to-point edges by site (:func:`world_edges`)."""

    ops: collections.Counter
    reads: collections.Counter
    ledger: Any
    syncs: Optional[collections.Counter] = None
    #: (site, axis, tag, group size) -> the point-to-point edges sent
    #: there, over every rank of the world (collectives.py)
    edges: Dict[Tuple, set] = dataclasses.field(default_factory=dict)
    #: the step's dispatched c10d ops, state tensors, outputs and
    #: allocator watermarks (``hlo.parser.HloModule``)
    module: Any = None


def _float_dtypes(tensors) -> Tuple[str, ...]:
    return tuple(sorted({str(t.dtype).replace("torch.", "")
                         for t in tensors
                         if isinstance(t, torch.Tensor)
                         and t.is_floating_point()}))


def _flatten(obj) -> List[Any]:
    if isinstance(obj, (list, tuple)):
        out = []
        for o in obj:
            out.extend(_flatten(o))
        return out
    if isinstance(obj, dict):
        return _flatten(list(obj.values()))
    return [obj]


def _reads_host(func, args, kwargs) -> bool:
    """Does ``.to(...)`` move to the CPU (a device, a string or a
    ``device=`` keyword naming it)?"""
    targets = list(args[1:]) + [kwargs.get("device")]
    for t in targets:
        if isinstance(t, torch.device) and t.type == "cpu":
            return True
        if isinstance(t, str) and t.split(":")[0] == "cpu":
            return True
    return False


#: aten ops whose output shape depends on the data: on the card the
#: values reach the host to size it
_HOST_WAITING = frozenset({"nonzero", "masked_select", "_unique2",
                           "unique_consecutive", "unique_dim"})


def _uploads(name, ins, out, kwargs) -> bool:
    """Is the op a blocking copy of a host value to the card
    (``_to_copy``/``copy_`` from the CPU into a CUDA tensor, or a tensor
    made on the card from host data: ``lift_fresh``)?"""
    if name == "lift_fresh":
        return isinstance(out, torch.Tensor) and out.is_cuda
    if name not in ("_to_copy", "copy_") or kwargs.get("non_blocking"):
        return False
    tensors = [t for t in ins if isinstance(t, torch.Tensor)]
    dst = tensors[0] if name == "copy_" else out
    src = tensors[1] if name == "copy_" and len(tensors) > 1 else tensors[0]
    return (isinstance(dst, torch.Tensor) and dst.is_cuda
            and src.device.type == "cpu" and src.numel() > 0)


def _crosses_devices(name, ins, out) -> bool:
    """Is the op a copy between the host and the card (``copy_`` into a
    tensor on another device than its source, or ``_to_copy`` to
    another device)?"""
    if name not in ("copy_", "_to_copy"):
        return False
    tensors = [t for t in ins if isinstance(t, torch.Tensor)]
    dst = tensors[0] if name == "copy_" else out
    src = tensors[1] if name == "copy_" and len(tensors) > 1 else tensors[0]
    return isinstance(dst, torch.Tensor) and dst.device != src.device


class _OpMode(TorchDispatchMode):
    def __init__(self, rec: "Recorder"):
        super().__init__()
        self.rec = rec

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _flatten(list(args) + list(kwargs.values()))
        name = str(func.overloadpacket.__name__)
        site = op_site(2)
        self.rec.ops[(name, _float_dtypes(ins), _float_dtypes(_flatten(out)),
                      site)] += 1
        transport = in_transport(2)
        if (name in _HOST_WAITING or _uploads(name, ins, out, kwargs)) \
                and not transport:
            self.rec.reads[(name, site)] += 1
        if func.namespace == "c10d":
            c = hlo_parser.collective_from_dispatch(
                func, args, site, len(self.rec.collectives), transport)
            if c is not None:
                self.rec.collectives.append(c)
        elif transport and _crosses_devices(name, ins, out):
            # gloo's staging of a collective through host memory
            self.rec.staged.append((name, sum(
                t.numel() * t.element_size() for t in _flatten(out)
                if isinstance(t, torch.Tensor))))
        return out


class _ReadMode(TorchFunctionMode):
    def __init__(self, rec: "Recorder"):
        super().__init__()
        self.rec = rec

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if name in HOST_READS and args and isinstance(args[0], torch.Tensor):
            t = args[0]
            moves = name in ("to", "cpu")
            # a copy to the host reads only a tensor that is not there
            # already; every other read reads a value on either device
            if t.device.type == self.rec.device.type and not (
                    moves and t.device.type == "cpu") and (
                    name != "to" or _reads_host(func, args, kwargs)) and \
                    not in_transport(2):
                self.rec.reads[(name, op_site(2))] += 1
        return func(*args, **kwargs)


class Recorder:
    """Records one call (module docstring): ``with Recorder(device) as
    rec: step()``, then :meth:`recording`."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.ops: collections.Counter = collections.Counter()
        self.reads: collections.Counter = collections.Counter()
        self.collectives: list = []
        self.staged: list = []
        self._stack = None
        self._ledger = None

    def __enter__(self):
        from apex_tpu_torch.monitor.xray import ledger

        self._stack = contextlib.ExitStack()
        self._ledger = self._stack.enter_context(
            ledger.comms_ledger(site_fn=lambda: op_site(2)))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # "anomaly mode is on"
            self._stack.enter_context(
                torch.autograd.detect_anomaly(check_nan=False))
        self._stack.enter_context(_OpMode(self))
        self._stack.enter_context(_ReadMode(self))
        return self

    def __exit__(self, *exc):
        self._stack.close()
        return False

    def recording(self) -> Recording:
        return Recording(self.ops, self.reads, self._ledger)


@contextlib.contextmanager
def sync_warnings():
    """Collects the synchronizing CUDA calls made within
    (``torch.cuda.set_sync_debug_mode("warn")``, under anomaly mode, so a
    backward's resolves to its forward's site): yields a Counter of
    (autograd node or "", site) -> calls, filled as they happen."""
    calls: collections.Counter = collections.Counter()
    previous = torch.cuda.get_sync_debug_mode()
    shown = warnings.showwarning

    def show(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing" in str(message):
            if not in_transport(2):
                node = torch._C._current_autograd_node()
                calls[(type(node).__name__ if node is not None else "",
                       op_site(2))] += 1
        else:
            shown(message, category, filename, lineno, file, line)

    with contextlib.ExitStack() as stack:
        stack.enter_context(warnings.catch_warnings())
        warnings.simplefilter("ignore")  # "anomaly mode is on"
        stack.enter_context(torch.autograd.detect_anomaly(check_nan=False))
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield calls
        finally:
            torch.cuda.set_sync_debug_mode(previous)
            warnings.showwarning = shown


def world_edges(ledger) -> Dict[Tuple, set]:
    """(site, axis, tag, group size) -> {(src, dst)} of the ledger's
    point-to-point sends, united over every rank of an initialized
    ``torch.distributed`` world (a collective: every rank calls it)."""
    import torch.distributed as dist

    local: Dict[Tuple, set] = collections.defaultdict(set)
    for e in ledger.entries + ledger.dead:
        if e.src is not None:
            local[(e.site, e.axis, e.tag, e.axis_size)].add((e.src, e.dst))
    parts = [dict(local)]
    if dist.is_available() and dist.is_initialized():
        from apex_tpu_torch.parallel import parallel_state as ps

        parts = ps.all_gather_object(parts[0], group=dist.group.WORLD)
    out: Dict[Tuple, set] = collections.defaultdict(set)
    for part in parts:
        for key, edges in part.items():
            out[key] |= edges
    return dict(out)


@dataclasses.dataclass
class StepTarget:
    """A step prepared for auditing: ``fn(*args)`` runs one step.

    ``axes`` are the layout's axis sizes (``{"dp": 2, "tp": 2}``; JAX's
    ``mesh``), ``device`` the step's device; ``low_dtypes`` the dtypes a
    promotion OUT of which to f32/f64 is flagged. ``fn`` runs once under
    the recorder, and on a CUDA device once more under
    ``set_sync_debug_mode`` (module docstring)."""

    name: str
    fn: Callable
    args: Tuple = ()
    axes: Optional[Dict[str, int]] = None
    device: Any = "cpu"
    low_dtypes: Tuple = (torch.bfloat16, torch.float16)
    #: the arguments the step updates in place (JAX's ``donate_argnums``;
    #: None: nothing declared, the donation pass skips the target)
    donate_argnums: Optional[Tuple[int, ...]] = None
    #: the analytic HBM prediction (``monitor.xray.hbm.model.HbmBreakdown``)
    #: the hlo-memory pass holds the step to
    hbm: Optional[Any] = None
    #: the sharding and donation auditors' size floors for this target
    #: (None: their 1 MiB defaults)
    sharding_min_bytes: Optional[int] = None
    donation_min_bytes: Optional[int] = None
    #: autofix's hooks (``analysis/autofix``): ``builder(device,
    #: **build_overrides)`` rebuilds the target; ``spec_slots`` names the
    #: builder keyword that shards an argument, ``donate_slot`` the one
    #: that declares in-place updates
    builder: Optional[Callable] = None
    build_overrides: Dict[str, Any] = dataclasses.field(default_factory=dict)
    spec_slots: Dict[int, str] = dataclasses.field(default_factory=dict)
    donate_slot: Optional[str] = None

    @property
    def mesh(self):
        """The layout as ``hlo.attribution`` reads it (JAX: ``mesh``)."""
        if self.axes is None:
            return None
        from apex_tpu_torch.analysis.hlo.attribution import layout_mesh

        return layout_mesh(self.axes)

    def names(self) -> List[str]:
        """The arguments' names (labels' roots): ``fn``'s parameters."""
        import inspect

        try:
            return list(inspect.signature(self.fn).parameters)
        except (TypeError, ValueError):
            return [f"arg{i}" for i in range(len(self.args))]


def _watermarks(device, reset: bool = False):
    """The allocator's watermarks on a card (``hbm.live``), else None;
    ``reset`` starts a new peak first."""
    from apex_tpu_torch.monitor.xray.hbm import live

    if device.type != "cuda":
        return None
    torch.cuda.synchronize(device)
    if reset:
        torch.cuda.reset_peak_memory_stats(device)
    return live.device_watermarks(device)


def _state_before(target: StepTarget, floor: int):
    """Each argument leaf with its storage, and a digest at or above
    ``floor`` bytes, before the step."""
    from apex_tpu_torch.analysis.hlo import parser as hp

    return [(argnum, label, root, t, hp.storage_ptr(t),
             hp.tensor_digest(t) if t.numel() * t.element_size() >= floor
             else None)
            for argnum, label, root, t in hp.state_leaves(target.args,
                                                          target.names())]


def _module(target: StepTarget, before, out, rec: "Recorder", floor: int):
    """The step's ``hlo.parser.HloModule`` from what was recorded: the
    leaves before, the same paths after (a step may rebind them), the
    outputs and the dispatched collectives."""
    from apex_tpu_torch.analysis.hlo import parser as hp

    def digest(t):
        return (hp.tensor_digest(t)
                if t.numel() * t.element_size() >= floor else None)

    after = {label: t for _, label, _, t in hp.state_leaves(
        target.args, target.names())}
    params = []
    for i, (argnum, label, root, t, ptr, dig) in enumerate(before):
        now = after.get(label)
        params.append(hp.HloParam(
            index=i, name=f"%param.{i}", shape=hp._shape(t), label=label,
            argnum=argnum, root=root, ptr_before=ptr,
            ptr_after=None if now is None else hp.storage_ptr(now),
            digest_before=dig,
            digest_after=None if now is None else digest(now)))
    outputs = [hp.HloParam(
        index=j, name=f"%output.{j}", shape=hp._shape(t), label=label,
        ptr_before=None,
        ptr_after=hp.storage_ptr(t), digest_after=digest(t))
        for j, (_, label, _, t) in enumerate(hp.state_leaves((out,),
                                                             ("out",)))]
    by_ptr = {p.ptr_before: p.index for p in params}
    alias = {by_ptr[o.ptr_after]: o.index for o in outputs
             if o.ptr_after in by_ptr}
    return hp.HloModule(
        name=target.name, collectives=list(rec.collectives),
        entry_params=params, entry_root_shapes=[o.shape for o in outputs],
        input_output_alias=alias,
        entry_outputs=outputs, staged=list(rec.staged))


class StepContext:
    """What a pass sees: the target plus its recording, made once."""

    def __init__(self, target: StepTarget):
        self.target = target
        self._recording: Optional[Recording] = None

    @property
    def name(self) -> str:
        return self.target.name

    @property
    def axes(self) -> Optional[Dict[str, int]]:
        return self.target.axes

    @property
    def mesh(self):
        return self.target.mesh

    @property
    def low_dtypes(self) -> Tuple[str, ...]:
        return tuple(str(d).replace("torch.", "")
                     for d in self.target.low_dtypes)

    @property
    def recording(self) -> Recording:
        """The step's :class:`Recording`, run once and cached."""
        if self._recording is None:
            device = torch.device(self.target.device)
            before = _state_before(self.target, self._digest_floor)
            with Recorder(device) as rec:
                out = self.target.fn(*self.target.args)
            self._recording = rec.recording()
            self._recording.module = _module(
                self.target, before, out, rec, self._digest_floor)
            del before, out
            self._recording.edges = world_edges(self._recording.ledger)
            if device.type == "cuda":
                # the allocator's watermarks over this second, warm run
                # (memory_diff.py says why)
                memory = _watermarks(device, reset=True)
                with sync_warnings() as calls:
                    self.target.fn(*self.target.args)
                    torch.cuda.synchronize(device)
                self._recording.syncs = calls
                self._recording.module.memory = {
                    "before": memory, "after": _watermarks(device)}
        return self._recording

    @property
    def _digest_floor(self) -> int:
        """The smallest tensor the auditors look at (their floors)."""
        t = self.target
        return min(t.sharding_min_bytes or 1 << 20,
                   t.donation_min_bytes or 1 << 20)

    def finding(self, rule: str, message: str, **kw) -> Finding:
        kw.setdefault("target", self.name)
        return Finding(rule=rule, message=message, **kw)


#: what an example's ``--audit-*`` flag prints when its pass is clean, and
#: the rule that says the pass could not verify
_AUDIT_OK = {
    "donation": ("donation audit: ok", "donation.unverifiable"),
    "hlo-comms": ("comms audit: ok (dispatched collectives match the "
                  "ledger)", "comms.unverifiable"),
}


def audit_or_exit(ctx: "StepContext", names: Sequence[str], router=None,
                  step: int = 0, say: Callable = print) -> None:
    """The examples' ``--audit-donation`` / ``--audit-comms``: each pass
    of ``names`` over the recorded step, through the repo allowlist, its
    records to ``router``; ok (with its count of allowlisted findings)
    only when nothing is left and the pass verified, else the report and
    ``SystemExit`` (the JAX examples' hardening: never a vacuous ok)."""
    from apex_tpu_torch.analysis.allowlist import repo_allowlist

    for name in names:
        ok_line, unverifiable = _AUDIT_OK[name]
        found = list(TRACE_PASSES[name](ctx))
        result = repo_allowlist().apply(found, check_stale=False)
        if router is not None:
            for rec in result.to_records(step=step):
                router.emit(rec)
        if result.ok and not any(f.rule == unverifiable for f in found):
            say(f"{ok_line}; {len(result.suppressed)} allowlisted "
                f"finding(s)", flush=True)
        else:
            say(result.format(verbose=True), flush=True)
            raise SystemExit(f"{name} audit failed")


def run_passes(
    target: StepTarget,
    passes: Optional[Sequence[str]] = None,
    allowlist: Optional[Allowlist] = None,
) -> List[Finding]:
    """Run ``passes`` (default: all registered) over one target and return
    the merged raw findings; apply an allowlist afterwards via
    ``allowlist.apply`` (kept separate so the CLI can pool findings from
    several targets before the stale-entry check)."""
    names = list(passes) if passes is not None else sorted(TRACE_PASSES)
    unknown = [n for n in names if n not in TRACE_PASSES]
    if unknown:
        raise KeyError(
            f"unknown trace pass(es) {unknown}; registered: "
            f"{sorted(TRACE_PASSES)}"
        )
    ctx = StepContext(target)
    findings: List[Finding] = []
    for name in names:
        findings.extend(TRACE_PASSES[name](ctx))
    merged = merge_findings(findings)
    if allowlist is not None:
        return allowlist.apply(merged, check_stale=False).findings
    return merged


# importing the pass modules registers them; keep at the bottom so the
# registry and decorators above exist first
from apex_tpu_torch.analysis import precision as _precision  # noqa: E402,F401
from apex_tpu_torch.analysis import (  # noqa: E402,F401
    collectives as _collectives,
)
from apex_tpu_torch.analysis import host_sync as _host_sync  # noqa: E402,F401
from apex_tpu_torch.analysis import donation as _donation  # noqa: E402,F401
from apex_tpu_torch.analysis.hlo import (  # noqa: E402,F401
    comms_diff as _comms_diff,
    memory_diff as _memory_diff,
    sharding_audit as _sharding_audit,
)
