"""Unified AST/token lint framework + the port's source-level rules
(counterpart of apex_tpu/analysis/lint.py).

The source-scan half of ``apex_tpu_torch.analysis``: rules that read the
tree instead of a recorded step. Same registry shape as the trace passes
and the same :class:`~apex_tpu_torch.analysis.findings.Finding`/allowlist
machinery, so the CLI and tests drive both identically:

    @lint_rule("lint.raw-collective", scopes=(LIBRARY,))
    def raw_collective(ctx): yield Finding(...)

Rules see a :class:`LintContext` holding every scanned file (repo-
relative path -> source) and filter to their scope; cross-file rules
(registered-taps) see the whole set at once. Tests inject synthetic
``files`` to seed violations without touching disk.

Scopes are path prefixes that end at a whole path component
(``"apex_tpu_torch/"``): ``"apex_tpu"`` is a prefix of
``"apex_tpu_torch"``, so no scope, anchor or module-to-path resolution
here compares a bare package name. The port keeps its examples inside
the package (``apex_tpu_torch/examples/``): a rule the JAX package
scopes to its library alone (``("apex_tpu/",)``) skips them here too,
and a rule that also reads the JAX package's ``examples/`` names
``apex_tpu_torch/examples/`` among its scopes (:func:`in_scope`).

The rules keep the JAX package's names and, where the construct is plain
Python, its logic: ``registered-taps`` (over ``monitor/taps.py``),
``trace-file``, ``signal-handlers``, ``thread-create``,
``silent-except``, ``process-exit``, ``span-phases`` (over
``monitor.goodput.spans.PHASES``), ``nondeterminism``, ``serving-clock``
and ``trace-emit``; each rule's docstring says what it flags. The rules
that name a JAX idiom have a torch twin under the same name, whose
docstring says what it stands for:

- ``lint.raw-collective`` — ``torch.distributed`` collectives and
  point-to-point calls outside ``parallel/parallel_state.py``, whose
  helpers record every collective in the traffic ledger
  (``monitor/xray/ledger.py``) — JAX's ``lax.psum`` & co. outside the
  ledger wrappers.
- ``lint.memory-api`` — ``torch.cuda.memory_stats`` /
  ``memory_snapshot`` outside ``monitor/xray/hbm/`` (JAX's
  ``.memory_stats()`` / ``.memory_analysis()``).
- ``lint.compressed-collective`` and ``lint.prefetch-gather`` — over the
  ``parallel_state`` helper names (:data:`LEDGERED_OPS`) and
  ``parallel/compress.py``'s ``quantize_*``/``dequantize_*``.
- ``lint.float64`` — ``torch.float64``, ``torch.double`` and
  ``.double()`` (JAX's ``jnp.float64``).
- ``lint.jit-donate`` — eager torch donates nothing; the twin is the
  construct that, like a donating ``jax.jit``, compiles or captures a
  step outside the audited entry points: ``torch.compile`` and CUDA
  graph capture (``torch.cuda.graph``, ``CUDAGraph``,
  ``make_graphed_callables``).
- ``lint.hlo-text`` — the port reads no compiler text; the twin is the
  profiler's Chrome-trace export (``export_chrome_trace``) outside
  ``monitor/``, whose ``ProfilerTrigger`` is the one writer of the
  traces a reader takes.
- ``lint.nondeterminism`` also flags torch draws (``torch.rand`` & co.,
  ``Tensor.random_``/``normal_``...) made without ``generator=``: the
  port's dropout and data draw from explicit generators, as JAX draws
  from explicit keys.
"""

import ast
import io
import os
import re
import tokenize
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

from apex_tpu_torch.analysis.findings import Finding, SEV_ERROR

__all__ = [
    "LINT_RULES",
    "lint_rule",
    "LintContext",
    "run_lint",
    "collect_sources",
    "LEDGERED_OPS",
    "RAW_COLLECTIVES",
    "in_scope",
]

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

#: directories scanned by default, relative to the repo root
DEFAULT_SCAN_DIRS = ("apex_tpu_torch",)

LIBRARY = "apex_tpu_torch/"
EXAMPLES = "apex_tpu_torch/examples/"

#: registered rules: name -> (fn, scopes)
LINT_RULES: Dict[str, Tuple[Callable, Tuple[str, ...]]] = {}

#: the parallel_state helpers that record themselves in the traffic
#: ledger (monitor/xray/ledger.py): the collectives the compressed-
#: collective and prefetch-gather rules look for
LEDGERED_OPS = frozenset({
    "all_reduce", "all_gather", "reduce_scatter", "all_to_all", "p2p",
})

#: torch.distributed calls that move bytes between ranks — the calls the
#: raw-collective rule keeps inside parallel/parallel_state.py
#: (``barrier`` moves nothing and is not one)
RAW_COLLECTIVES = frozenset({
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "all_gather_object", "reduce_scatter", "reduce_scatter_tensor",
    "all_to_all", "all_to_all_single", "broadcast", "broadcast_object_list",
    "isend", "irecv", "send", "recv", "batch_isend_irecv", "reduce",
    "gather", "scatter", "gather_object", "scatter_object_list",
})


def in_scope(rel: str, scopes: Sequence[str]) -> bool:
    """Is ``rel`` under one of ``scopes``? A file under
    ``apex_tpu_torch/examples/`` is only when a scope names the examples
    (the JAX package keeps them outside its library; module
    docstring)."""
    if not any(rel.startswith(p) for p in scopes):
        return False
    return not rel.startswith(EXAMPLES) or any(
        p.startswith(EXAMPLES) for p in scopes)


def lint_rule(name: str, scopes: Tuple[str, ...] = (LIBRARY,)):
    """Register a rule (decorator). ``scopes`` are path prefixes the rule
    applies to — the single source of truth: ``run_lint`` hands the rule
    a context containing ONLY files under them, so rule bodies iterate
    ``ctx.files`` without re-filtering."""

    def register(fn):
        LINT_RULES[name] = (fn, scopes)
        return fn

    return register


class LintContext:
    """The scanned file set a rule reads."""

    def __init__(self, files: Dict[str, str]):
        #: repo-relative posix path -> source text
        self.files = files

    def files_in(self, *prefixes: str) -> Iterator[Tuple[str, str]]:
        for rel in sorted(self.files):
            if in_scope(rel, prefixes):
                yield rel, self.files[rel]

    @staticmethod
    def tokens(source: str):
        """NAME/OP tokens of ``source`` (the docstring-safe scan basis)."""
        toks = tokenize.generate_tokens(io.StringIO(source).readline)
        return [t for t in toks if t.type in (tokenize.NAME, tokenize.OP)]


def collect_sources(
    root: Optional[str] = None,
    scan_dirs: Sequence[str] = DEFAULT_SCAN_DIRS,
) -> Dict[str, str]:
    """All ``.py`` sources under ``root``'s scan dirs, as repo-relative
    posix paths."""
    root = root or _REPO_ROOT
    files: Dict[str, str] = {}
    for sub in scan_dirs:
        base = os.path.join(root, sub)
        for dirpath, _, names in os.walk(base):
            for fn in names:
                if not fn.endswith(".py"):
                    continue
                path = os.path.join(dirpath, fn)
                rel = os.path.relpath(path, root).replace(os.sep, "/")
                with open(path, encoding="utf-8") as f:
                    files[rel] = f.read()
    return files


def run_lint(
    root: Optional[str] = None,
    rules: Optional[Sequence[str]] = None,
    files: Optional[Dict[str, str]] = None,
) -> List[Finding]:
    """Run ``rules`` (default all) over ``files`` (default: scan the repo)
    and return raw findings — apply an Allowlist afterwards, exactly like
    the trace passes."""
    names = list(rules) if rules is not None else sorted(LINT_RULES)
    unknown = [n for n in names if n not in LINT_RULES]
    if unknown:
        raise KeyError(
            f"unknown lint rule(s) {unknown}; registered: "
            f"{sorted(LINT_RULES)}"
        )
    all_files = files if files is not None else collect_sources(root)
    findings: List[Finding] = []
    for name in names:
        fn, scopes = LINT_RULES[name]
        # the registry's scopes are the single source of truth: each rule
        # sees ONLY its scoped slice of the tree (rules don't re-filter)
        ctx = LintContext({
            rel: src for rel, src in all_files.items()
            if in_scope(rel, scopes)
        })
        findings.extend(fn(ctx))
    return findings


# -- rules -------------------------------------------------------------------


@lint_rule("lint.raw-collective", scopes=(LIBRARY,))
def raw_collective(ctx: LintContext) -> Iterable[Finding]:
    """``torch.distributed`` calls that move bytes (:data:`RAW_COLLECTIVES`)
    outside ``parallel/parallel_state.py``, whose helpers record each
    collective in the traffic ledger (JAX's rule: ``lax.<collective>``
    outside the ledger wrappers). Token-based, so a docstring naming
    ``dist.all_reduce`` does not trip it: a NAME ``dist`` or
    ``distributed``, a ``.``, then the call's name."""
    for rel, src in sorted(ctx.files.items()):
        toks = ctx.tokens(src)
        for i in range(len(toks) - 2):
            if (
                toks[i].type == tokenize.NAME
                and toks[i].string in ("dist", "distributed")
                and toks[i + 1].string == "."
                and toks[i + 2].string in RAW_COLLECTIVES
            ):
                yield Finding(
                    rule="lint.raw-collective",
                    message=(
                        f"raw torch.distributed.{toks[i + 2].string} "
                        f"bypasses the comms ledger — use the "
                        f"apex_tpu_torch.parallel.parallel_state helper "
                        f"(or allowlist with a reason)"
                    ),
                    site=f"{rel}:{toks[i].start[0]}",
                    severity=SEV_ERROR,
                    data={"op": toks[i + 2].string},
                )


def _tap_sites(ctx: "LintContext", attrs) -> Dict[str, str]:
    """{attribute: first site} of ``self.<attr> = <value>`` assignments
    (a value other than the literal None) for the tap attributes."""
    sites: Dict[str, str] = {}
    for rel, src in sorted(ctx.files.items()):
        try:
            tree = ast.parse(src)
        except SyntaxError:
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets, value = [node.target], node.value
            else:
                continue
            if isinstance(value, ast.Constant) and value.value is None:
                continue
            flat = []
            for t in targets:
                flat.extend(t.elts if isinstance(t, ast.Tuple) else [t])
            for t in flat:
                if (isinstance(t, ast.Attribute) and t.attr in attrs
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"):
                    sites.setdefault(t.attr, f"{rel}:{node.lineno}")
    return sites


@lint_rule("lint.registered-taps", scopes=(LIBRARY,))
def registered_taps(ctx: LintContext) -> Iterable[Finding]:
    """The port's taps against ``monitor.taps.REGISTERED_TAPS``, both
    directions. A JAX tap is a ``sow("intermediates", name)``; the port
    keeps each in a module attribute (``monitor.taps.TAP_ATTRIBUTES``):
    a tap attribute with no registry row is unregistered, and a registry
    row whose attribute no ``self.<attr> = ...`` assigns any more is
    stale."""
    from apex_tpu_torch.monitor.taps import REGISTERED_TAPS, TAP_ATTRIBUTES

    for name in sorted(set(TAP_ATTRIBUTES) - set(REGISTERED_TAPS)):
        yield Finding(
            rule="lint.registered-taps",
            message=(
                f"tap {name!r} is not registered in monitor/taps.py "
                f"REGISTERED_TAPS — a layer refactor could silently drop "
                f"the metric"
            ),
            site="apex_tpu_torch/monitor/taps.py:1", severity=SEV_ERROR,
            data={"tap": name},
        )
    sites = _tap_sites(ctx, set(TAP_ATTRIBUTES.values()))
    for name in sorted(REGISTERED_TAPS):
        if TAP_ATTRIBUTES.get(name) in sites:
            continue
        yield Finding(
            rule="lint.registered-taps",
            message=(
                f"REGISTERED_TAPS entry {name!r} has no tap site left in "
                f"apex_tpu_torch/ — remove it or restore the tap"
            ),
            site="apex_tpu_torch/monitor/taps.py:1", severity=SEV_ERROR,
            data={"tap": name, "stale": True},
        )


#: call names that compile or capture a step (the jit-donate twin)
_CAPTURE_CALLS = frozenset({"compile", "graph", "CUDAGraph",
                            "make_graphed_callables"})


@lint_rule("lint.jit-donate", scopes=(LIBRARY, EXAMPLES))
def jit_donate(ctx: LintContext) -> Iterable[Finding]:
    """``torch.compile`` and CUDA-graph capture outside the audited entry
    points (allowlist). Eager torch has no ``donate_argnums``; what a
    donating ``jax.jit`` is to the JAX package — a step whose buffers
    the runtime manages out of the audit's sight — is a compiled or
    captured step here. AST-based: ``torch.compile(...)``,
    ``torch.cuda.graph(...)``, ``torch.cuda.CUDAGraph()`` and
    ``torch.cuda.make_graphed_callables(...)`` (the base must name
    ``torch``), and ``from torch.cuda import graph/CUDAGraph``."""
    for rel, src in sorted(ctx.files.items()):
        try:
            tree = ast.parse(src)
        except SyntaxError as e:
            yield Finding(
                rule="lint.jit-donate",
                message=f"unparseable file: {e}",
                site=f"{rel}:{e.lineno or 1}", severity=SEV_ERROR,
            )
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module in (
                    "torch", "torch.cuda") and any(
                    a.name in _CAPTURE_CALLS for a in node.names):
                yield Finding(
                    rule="lint.jit-donate",
                    message=(
                        f"'from {node.module} import ...' hides step "
                        f"capture from review — spell it torch.<...> in "
                        f"an audited entry point"
                    ),
                    site=f"{rel}:{node.lineno}", severity=SEV_ERROR,
                    data={"import": node.module},
                )
                continue
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _CAPTURE_CALLS):
                continue
            base = ast.unparse(node.func.value)
            if base.split(".")[0] != "torch" or (
                    node.func.attr == "compile" and base != "torch"):
                continue
            yield Finding(
                rule="lint.jit-donate",
                message=(
                    f"{base}.{node.func.attr} outside the audited entry "
                    f"points — a compiled or captured step manages its "
                    f"buffers out of the passes' sight; add the step to "
                    f"the audited list (and allowlist it here with that "
                    f"reason) or run it eagerly"
                ),
                site=f"{rel}:{node.lineno}", severity=SEV_ERROR,
                data={"call": f"{base}.{node.func.attr}"},
            )


@lint_rule("lint.hlo-text", scopes=(LIBRARY, EXAMPLES))
def hlo_text(ctx: LintContext) -> Iterable[Finding]:
    """``.export_chrome_trace`` outside ``monitor/``. The port reads no
    compiler text (JAX's rule: ``.as_text()`` outside the HLO parser);
    the text it does read is the profiler's Chrome trace, which
    ``monitor.watchdog.ProfilerTrigger`` writes. Token-based, as JAX's:
    the NAME token preceded by a ``.`` operator."""
    for rel, src in sorted(ctx.files.items()):
        if rel.startswith("apex_tpu_torch/monitor/"):
            continue
        toks = ctx.tokens(src)
        for i in range(1, len(toks)):
            if (
                toks[i].type == tokenize.NAME
                and toks[i].string == "export_chrome_trace"
                and toks[i - 1].string == "."
            ):
                yield Finding(
                    rule="lint.hlo-text",
                    message=(
                        "ad-hoc .export_chrome_trace() outside "
                        "apex_tpu_torch/monitor/ — take a capture through "
                        "monitor.ProfilerTrigger so the trace files have "
                        "one writer and one layout"
                    ),
                    site=f"{rel}:{toks[i].start[0]}",
                    severity=SEV_ERROR,
                )


@lint_rule("lint.memory-api", scopes=(LIBRARY, EXAMPLES))
def memory_api(ctx: LintContext) -> Iterable[Finding]:
    """``torch.cuda.memory_stats`` / ``memory_snapshot`` outside the hbm
    package (JAX's rule: ``.memory_stats()`` / ``.memory_analysis()``).
    Token-based (the ``lint.hlo-text`` shape): keys on the NAME tokens
    preceded by a ``.`` operator, so docstrings MENTIONING the APIs do
    not trip it; ``monitor/xray/hbm/live.py`` is the one home
    (``device_watermarks``: None when the device reports nothing)."""
    home = "apex_tpu_torch/monitor/xray/hbm/"
    names = ("memory_stats", "memory_snapshot")
    for rel, src in sorted(ctx.files.items()):
        toks = ctx.tokens(src)
        for i in range(1, len(toks)):
            if (
                toks[i].type == tokenize.NAME
                and toks[i].string in names
                and toks[i - 1].string == "."
            ):
                yield Finding(
                    rule="lint.memory-api",
                    message=(
                        f"raw .{toks[i].string}() outside {home} — route "
                        "through the hbm package (device_watermarks) so "
                        "the None-not-fake-number convention and the "
                        "memory record schema have one home"
                    ),
                    site=f"{rel}:{toks[i].start[0]}",
                    severity=SEV_ERROR,
                )


# string-literal token types: 3.12+ tokenizes f-strings as FSTRING_*
# (the literal text lands in FSTRING_MIDDLE), not STRING — without them
# an f"{host}.trace.json.gz" reader would slip past on newer pythons
_STRING_TOKEN_TYPES = frozenset(
    t for t in (
        tokenize.STRING,
        getattr(tokenize, "FSTRING_START", None),
        getattr(tokenize, "FSTRING_MIDDLE", None),
    ) if t is not None
)


@lint_rule("lint.trace-file", scopes=(LIBRARY, EXAMPLES))
def trace_file(ctx: LintContext) -> Iterable[Finding]:
    """``.trace.json`` in any string/docstring outside the blessed
    timeline parser package — the fingerprint of ad-hoc profiler-trace
    reading (see the module docstring)."""
    for rel, src in sorted(ctx.files.items()):
        try:
            toks = tokenize.generate_tokens(io.StringIO(src).readline)
            strings = [t for t in toks if t.type in _STRING_TOKEN_TYPES]
        except (tokenize.TokenError, SyntaxError) as e:
            yield Finding(
                rule="lint.trace-file",
                message=f"untokenizable file: {e}",
                site=f"{rel}:1", severity=SEV_ERROR,
            )
            continue
        for t in strings:
            if ".trace.json" in t.string:
                yield Finding(
                    rule="lint.trace-file",
                    message=(
                        "profiler trace-event reading outside "
                        "apex_tpu_torch/monitor/xray/timeline/ — the "
                        "timeline "
                        "parser is the one blessed home of the "
                        "*.trace.json[.gz] format (parse_logdir / "
                        "parse_trace_file return structured events); "
                        "ad-hoc readers rot when the profiler's exporter "
                        "changes"
                    ),
                    site=f"{rel}:{t.start[0]}", severity=SEV_ERROR,
                )


@lint_rule("lint.signal-handlers", scopes=(LIBRARY, EXAMPLES))
def signal_handlers(ctx: LintContext) -> Iterable[Finding]:
    """Raw signal-handler registration outside the blessed homes.

    AST-based: flags ``<mod>.signal(...)`` calls where ``<mod>`` is the
    stdlib module's conventional names (``signal`` or the repo's
    ``import signal as _signal`` alias), and ``from signal import
    signal`` imports (which would hide the call sites from the attribute
    match). ``signal.getsignal`` / ``SIGTERM`` attribute reads are fine
    — only REGISTRATION rewires process-global dispatch."""
    for rel, src in sorted(ctx.files.items()):
        try:
            tree = ast.parse(src)
        except SyntaxError as e:
            yield Finding(
                rule="lint.signal-handlers",
                message=f"unparseable file: {e}",
                site=f"{rel}:{e.lineno or 1}", severity=SEV_ERROR,
            )
            continue
        for node in ast.walk(tree):
            if (isinstance(node, ast.ImportFrom) and node.module == "signal"
                    and any(a.name == "signal" for a in node.names)):
                yield Finding(
                    rule="lint.signal-handlers",
                    message=(
                        "'from signal import signal' hides handler "
                        "registration from review — spell it "
                        "signal.signal(...) in one of the blessed homes "
                        "(utils/autoresume.py, monitor/router.py)"
                    ),
                    site=f"{rel}:{node.lineno}", severity=SEV_ERROR,
                )
                continue
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if (
                isinstance(func, ast.Attribute)
                and func.attr == "signal"
                and isinstance(func.value, ast.Name)
                and func.value.id in ("signal", "_signal")
            ):
                yield Finding(
                    rule="lint.signal-handlers",
                    message=(
                        "raw signal.signal(...) registration outside "
                        "utils/autoresume.py and monitor/router.py — the "
                        "last registration silently wins the whole "
                        "process and breaks the SIG_DFL-precedence "
                        "contract the two blessed homes coordinate on; "
                        "route through AutoResume (preemption) or the "
                        "router teardown (span flush) instead"
                    ),
                    site=f"{rel}:{node.lineno}", severity=SEV_ERROR,
                )


#: the threading constructors that create a new concurrency ROOT (locks,
#: events, barriers merely coordinate existing ones and are fine)
_THREAD_CTORS = frozenset({"Thread", "Timer"})


@lint_rule("lint.thread-create", scopes=(LIBRARY,))
def thread_create(ctx: LintContext) -> Iterable[Finding]:
    """Raw thread construction outside the blessed homes.

    AST-based: flags ``threading.Thread(...)`` / ``threading.Timer(...)``
    calls (including the repo's ``import threading as _threading`` alias
    spelling) and ``from threading import Thread/Timer`` (which would
    hide the construction sites from the attribute match). Every thread
    is a concurrency root the static analyzer inventories; the three
    homes that may mint one — monitor/watchdog.py,
    resilience/health/responder.py, utils/checkpoint.py — carry
    require_hit allowlist entries naming their lifecycle discipline.
    Lock/Event/Condition construction is coordination, not a root, and
    is not flagged."""
    for rel, src in sorted(ctx.files.items()):
        try:
            tree = ast.parse(src)
        except SyntaxError as e:
            yield Finding(
                rule="lint.thread-create",
                message=f"unparseable file: {e}",
                site=f"{rel}:{e.lineno or 1}", severity=SEV_ERROR,
            )
            continue
        for node in ast.walk(tree):
            if (isinstance(node, ast.ImportFrom)
                    and node.module == "threading"
                    and any(a.name in _THREAD_CTORS for a in node.names)):
                yield Finding(
                    rule="lint.thread-create",
                    message=(
                        "'from threading import Thread' hides thread "
                        "construction from review — spell it "
                        "threading.Thread(...) in one of the blessed "
                        "homes (monitor/watchdog.py, "
                        "resilience/health/responder.py, "
                        "utils/checkpoint.py)"
                    ),
                    site=f"{rel}:{node.lineno}", severity=SEV_ERROR,
                )
                continue
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if (
                isinstance(func, ast.Attribute)
                and func.attr in _THREAD_CTORS
                and isinstance(func.value, ast.Name)
                and func.value.id in ("threading", "_threading")
            ):
                yield Finding(
                    rule="lint.thread-create",
                    message=(
                        f"raw threading.{func.attr}(...) outside the "
                        "blessed homes (monitor/watchdog.py, "
                        "resilience/health/responder.py, "
                        "utils/checkpoint.py) — every thread is a "
                        "concurrency root the static analyzer must "
                        "inventory and audit; scattered construction "
                        "adds an unaudited root with no join/daemon "
                        "discipline. Route background work through the "
                        "watchdog monitor loop or the checkpoint "
                        "writer's finalize_async instead"
                    ),
                    site=f"{rel}:{node.lineno}", severity=SEV_ERROR,
                )


#: the broad exception names lint.silent-except polices when the handler
#: body is empty (bare ``except:`` is flagged regardless of body)
_BROAD_EXCEPTIONS = frozenset({"Exception", "BaseException"})


def _handler_is_silent(handler: ast.ExceptHandler) -> bool:
    """True when the except body does nothing: only ``pass``,
    ``continue``, or bare constant expressions (``...``, a string)."""
    return all(
        isinstance(stmt, (ast.Pass, ast.Continue))
        or (isinstance(stmt, ast.Expr)
            and isinstance(stmt.value, ast.Constant))
        for stmt in handler.body
    )


@lint_rule("lint.silent-except", scopes=(LIBRARY,))
def silent_except(ctx: LintContext) -> Iterable[Finding]:
    """Bare ``except:`` / do-nothing broad ``except Exception:`` swallows
    (module docstring). AST-based: the handler TYPE and BODY are what
    matter, not spelling — ``except Exception as e: pass`` and
    ``except BaseException: ...`` both count, a handler that logs or
    returns a fallback does not."""
    for rel, src in sorted(ctx.files.items()):
        try:
            tree = ast.parse(src)
        except SyntaxError as e:
            yield Finding(
                rule="lint.silent-except",
                message=f"unparseable file: {e}",
                site=f"{rel}:{e.lineno or 1}", severity=SEV_ERROR,
            )
            continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            t = node.type
            if t is None:
                yield Finding(
                    rule="lint.silent-except",
                    message=(
                        "bare 'except:' catches BaseException — "
                        "KeyboardInterrupt and SystemExit included; name "
                        "the exception class (and if the swallow is "
                        "deliberate, allowlist it with the reason)"
                    ),
                    site=f"{rel}:{node.lineno}", severity=SEV_ERROR,
                    data={"form": "bare"},
                )
                continue
            # tuple handlers count too: `except (Exception,):` is the
            # same swallow wearing parentheses
            exprs = t.elts if isinstance(t, ast.Tuple) else [t]
            names = {
                e.id if isinstance(e, ast.Name)
                else e.attr if isinstance(e, ast.Attribute)
                else None
                for e in exprs
            }
            if (names & _BROAD_EXCEPTIONS) and _handler_is_silent(node):
                name = sorted(names & _BROAD_EXCEPTIONS)[0]
                yield Finding(
                    rule="lint.silent-except",
                    message=(
                        f"'except {name}:' with a do-nothing body "
                        f"silently swallows EVERY failure — log it, "
                        f"narrow the exception, or allowlist the site "
                        f"with the reason the swallow is safe"
                    ),
                    site=f"{rel}:{node.lineno}", severity=SEV_ERROR,
                    data={"form": "silent"},
                )


def _main_gate_spans(tree: ast.Module) -> List[Tuple[int, int]]:
    """(start, end) line spans of top-level ``if __name__ == "__main__":``
    blocks — the one structural exemption lint.process-exit grants."""
    spans: List[Tuple[int, int]] = []
    for node in tree.body:
        if not isinstance(node, ast.If):
            continue
        test = node.test
        if (isinstance(test, ast.Compare)
                and isinstance(test.left, ast.Name)
                and test.left.id == "__name__"
                and any(isinstance(c, ast.Constant)
                        and c.value == "__main__"
                        for c in test.comparators)):
            spans.append((node.lineno, node.end_lineno or node.lineno))
    return spans


@lint_rule("lint.process-exit", scopes=(LIBRARY,))
def process_exit(ctx: LintContext) -> Iterable[Finding]:
    """Raw ``os._exit``/``sys.exit`` usage outside the blessed homes
    (module docstring). AST-based: flags the ATTRIBUTE usage, not just
    calls — ``exit_fn = os._exit`` rewires the same authority — plus
    the ``from os import _exit`` / ``from sys import exit`` imports
    that would hide the attribute from review."""
    for rel, src in sorted(ctx.files.items()):
        try:
            tree = ast.parse(src)
        except SyntaxError as e:
            yield Finding(
                rule="lint.process-exit",
                message=f"unparseable file: {e}",
                site=f"{rel}:{e.lineno or 1}", severity=SEV_ERROR,
            )
            continue
        gates = _main_gate_spans(tree)
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module in (
                    "os", "sys"):
                for a in node.names:
                    if (node.module, a.name) in (("os", "_exit"),
                                                 ("sys", "exit")):
                        yield Finding(
                            rule="lint.process-exit",
                            message=(
                                f"'from {node.module} import {a.name}' "
                                f"hides a process-exit call site from "
                                f"review — spell it "
                                f"{node.module}.{a.name}(...) in a "
                                f"blessed home"
                            ),
                            site=f"{rel}:{node.lineno}",
                            severity=SEV_ERROR,
                        )
                continue
            if not (isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Name)):
                continue
            pair = (node.value.id, node.attr)
            if pair not in (("os", "_exit"), ("sys", "exit")):
                continue
            if pair == ("sys", "exit") and any(
                    lo <= node.lineno <= hi for lo, hi in gates):
                continue  # the __main__-gate CLI convention
            yield Finding(
                rule="lint.process-exit",
                message=(
                    f"raw {node.value.id}.{node.attr} outside the "
                    f"blessed homes — exit codes are a CLOSED taxonomy "
                    f"(resilience/exit_codes.py) that supervisors branch "
                    f"on, and the blessed paths (the __main__ gates, the "
                    f"incident responder's coordinated self-termination) "
                    f"own the teardown discipline; return an ExitCode "
                    f"from main() or route through the responder"
                ),
                site=f"{rel}:{node.lineno}", severity=SEV_ERROR,
                data={"call": f"{node.value.id}.{node.attr}"},
            )


#: goodput span constructors -> position of their ``phase`` argument
#: (emit_span takes the router first). Aliased imports are caught by the
#: ``*_span`` suffix match in :func:`span_phases`.
_SPAN_CALLEES = {"span": 0, "begin_span": 0, "Span": 0, "emit_span": 1}


@lint_rule("lint.span-phases", scopes=(LIBRARY, EXAMPLES))
def span_phases(ctx: LintContext) -> Iterable[Finding]:
    """Goodput span call sites whose phase is not a registry literal.

    AST-based: matches calls whose terminal name is a span constructor
    (``goodput.span(...)``, ``begin_span(...)``, ``Span(...)``,
    ``emit_span(...)``) or an import alias ending in ``_span``; the
    phase argument's string constants must ALL be in
    ``monitor.goodput.spans.PHASES`` (a conditional of two literals is
    fine), and a phase expression with no string constant at all is a
    variable phase — unverifiable, flagged. Calls with no phase argument
    or a non-string constant one (``m.span(1)`` on a regex match) are
    not span-ledger calls and are skipped."""
    from apex_tpu_torch.monitor.goodput.spans import PHASES

    for rel, src in sorted(ctx.files.items()):
        try:
            tree = ast.parse(src)
        except SyntaxError as e:
            yield Finding(
                rule="lint.span-phases",
                message=f"unparseable file: {e}",
                site=f"{rel}:{e.lineno or 1}", severity=SEV_ERROR,
            )
            continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            name = (
                func.id if isinstance(func, ast.Name)
                else func.attr if isinstance(func, ast.Attribute)
                else None
            )
            if name in _SPAN_CALLEES:
                pos = _SPAN_CALLEES[name]
            elif name is not None and name.endswith("_span"):
                pos = 0  # import alias: `from ... import span as _x_span`
            else:
                continue
            phase_expr = None
            for kw in node.keywords:
                if kw.arg == "phase":
                    phase_expr = kw.value
            if phase_expr is None and len(node.args) > pos:
                arg = node.args[pos]
                if not isinstance(arg, ast.Starred):
                    phase_expr = arg
            if phase_expr is None:
                continue  # no phase argument: not a span-ledger call
            if (isinstance(phase_expr, ast.Constant)
                    and not isinstance(phase_expr.value, str)):
                continue  # m.span(1): a regex match-group, not a phase
            strings = [
                n.value for n in ast.walk(phase_expr)
                if isinstance(n, ast.Constant) and isinstance(n.value, str)
            ]
            if not strings:
                yield Finding(
                    rule="lint.span-phases",
                    message=(
                        f"span call {name!r} passes a non-literal phase — "
                        f"the closed taxonomy (goodput.spans.PHASES) is "
                        f"only enforceable on literals; name the phase "
                        f"inline (or allowlist the forwarding helper "
                        f"with its reason)"
                    ),
                    site=f"{rel}:{node.lineno}", severity=SEV_ERROR,
                    data={"callee": name},
                )
                continue
            for s in strings:
                if s not in PHASES:
                    yield Finding(
                        rule="lint.span-phases",
                        message=(
                            f"unknown span phase {s!r} — the taxonomy is "
                            f"closed (goodput.spans.PHASES: "
                            f"{', '.join(PHASES)}); an ad-hoc phase "
                            f"fragments the goodput partition across runs"
                        ),
                        site=f"{rel}:{node.lineno}", severity=SEV_ERROR,
                        data={"callee": name, "phase": s},
                    )


#: quantize/dequantize primitive call names the compressed-collective
#: rule keys on: the compress module's own primitives plus any same-
#: prefixed ad-hoc reimplementation. The PUBLIC wrappers
#: (quantized_psum / quantized_psum_scatter / quantized_all_gather) are
#: deliberately NOT in this set — call sites composing with them are the
#: intended use, not a new compression home.
_QUANT_PRIMITIVE_PREFIXES = ("quantize_", "dequantize_")


@lint_rule("lint.compressed-collective", scopes=(LIBRARY,))
def compressed_collective(ctx: LintContext) -> Iterable[Finding]:
    """Functions composing quantize/dequant primitives with ledgered
    collectives outside parallel/compress.py (module docstring).

    AST-based, function granularity: for every FunctionDef, collect the
    terminal names of all calls; a function calling BOTH a
    ``quantize_*``/``dequantize_*`` primitive and a collective from
    ``LEDGERED_OPS`` is a compressed-collective composition and belongs
    in the audited home (compress.py carries the require_hit allowlist
    entry)."""
    for rel, src in sorted(ctx.files.items()):
        try:
            tree = ast.parse(src)
        except SyntaxError as e:
            yield Finding(
                rule="lint.compressed-collective",
                message=f"unparseable file: {e}",
                site=f"{rel}:{e.lineno or 1}", severity=SEV_ERROR,
            )
            continue
        for node in ast.walk(tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            quant = None
            coll = None
            for call in ast.walk(node):
                if not isinstance(call, ast.Call):
                    continue
                func = call.func
                name = (
                    func.id if isinstance(func, ast.Name)
                    else func.attr if isinstance(func, ast.Attribute)
                    else None
                )
                if name is None:
                    continue
                if name.startswith(_QUANT_PRIMITIVE_PREFIXES):
                    quant = quant or name
                elif name in LEDGERED_OPS:
                    coll = coll or name
            if quant and coll:
                yield Finding(
                    rule="lint.compressed-collective",
                    message=(
                        f"{quant} composed with {coll} outside "
                        f"parallel/compress.py — quantized collectives "
                        f"have ONE audited home (wire-byte accounting, "
                        f"error feedback, found_inf poison semantics); "
                        f"use compress.quantized_psum/"
                        f"quantized_psum_scatter/quantized_all_gather "
                        f"or move the composition there"
                    ),
                    site=f"{rel}:{node.lineno}", severity=SEV_ERROR,
                    data={"quant": quant, "collective": coll,
                          "function": node.name},
                )


#: the gather collectives lint.prefetch-gather polices inside for-loops
#: (all_reduce/p2p in a loop are schedule edges, not bucket pipelines)
_PREFETCH_GATHER_OPS = frozenset({"all_gather", "all_gather_async",
                                  "reduce_scatter"})


@lint_rule("lint.prefetch-gather", scopes=(LIBRARY, EXAMPLES))
def prefetch_gather(ctx: LintContext) -> Iterable[Finding]:
    """Python-for-loop gather pipelines outside the blessed prefetch
    home (module docstring). AST-based, function granularity: a
    ``for``/``async for`` whose body (not a nested function's) calls a
    terminal ``all_gather``/``reduce_scatter`` is the bucketed-prefetch
    fingerprint — the loop traces one collective per iteration, i.e. a
    hand-rolled overlap pipeline whose depth/reconstruction/ledger
    invariants belong in ``optimizers/distributed_fused_adam.py`` (JAX's
    ``zero_prefetch_gather``)."""
    for rel, src in sorted(ctx.files.items()):
        try:
            tree = ast.parse(src)
        except SyntaxError as e:
            yield Finding(
                rule="lint.prefetch-gather",
                message=f"unparseable file: {e}",
                site=f"{rel}:{e.lineno or 1}", severity=SEV_ERROR,
            )
            continue
        for node in ast.walk(tree):
            if not isinstance(node, (ast.For, ast.AsyncFor)):
                continue
            hit = None
            # manual walk that PRUNES nested function defs: a call
            # inside a closure defined in the loop traces when the
            # closure runs, not per loop iteration
            stack = list(ast.iter_child_nodes(node))
            while stack and hit is None:
                sub = stack.pop()
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                    ast.Lambda)):
                    continue
                stack.extend(ast.iter_child_nodes(sub))
                if not isinstance(sub, ast.Call):
                    continue
                func = sub.func
                name = (
                    func.id if isinstance(func, ast.Name)
                    else func.attr if isinstance(func, ast.Attribute)
                    else None
                )
                if name in _PREFETCH_GATHER_OPS:
                    hit = name
            if hit:
                yield Finding(
                    rule="lint.prefetch-gather",
                    message=(
                        f"{hit} issued inside a Python for-loop — a "
                        f"hand-rolled bucketed gather pipeline; route "
                        f"through optimizers.distributed_fused_adam (the "
                        f"one home where overlap depth is roofline-"
                        f"derived and the bucket reconstruction is "
                        f"exact), or allowlist the site with the reason "
                        f"it is not a prefetch pipeline"
                    ),
                    site=f"{rel}:{node.lineno}", severity=SEV_ERROR,
                    data={"op": hit},
                )


#: stdlib ``random`` draw functions the nondeterminism rule polices when
#: called through the module singleton (seeding and seeded-instance
#: construction are exempt — they establish determinism, not break it)
_STDLIB_RANDOM_DRAWS = frozenset({
    "random", "uniform", "randint", "randrange", "choice", "choices",
    "shuffle", "sample", "gauss", "normalvariate", "betavariate",
    "expovariate", "triangular", "vonmisesvariate", "paretovariate",
    "weibullvariate", "lognormvariate", "getrandbits", "randbytes",
})

#: ``np.random`` attributes that are NOT singleton draws: seeded
#: constructors/classes and state plumbing
_NP_RANDOM_SEEDED = frozenset({
    "RandomState", "default_rng", "Generator", "SeedSequence", "PCG64",
    "Philox", "MT19937", "SFC64", "BitGenerator", "get_state",
    "set_state", "seed",
})


#: torch functions that draw from a generator (``generator=`` pins it)
_TORCH_DRAWS = frozenset({
    "rand", "randn", "randint", "randperm", "rand_like", "randn_like",
    "randint_like", "normal", "bernoulli", "multinomial", "poisson",
})

#: tensor methods that draw in place
_TORCH_INPLACE_DRAWS = frozenset({
    "uniform_", "normal_", "random_", "bernoulli_", "exponential_",
    "geometric_", "cauchy_", "log_normal_",
})


@lint_rule("lint.nondeterminism", scopes=(LIBRARY,))
def nondeterminism(ctx: LintContext) -> Iterable[Finding]:
    """Unseeded singleton RNG draws and wall-clock reads in library code
    (module docstring). AST-based:

    - a call whose attribute is a stdlib draw name and whose base
      expression mentions the bare name ``random`` (so
      ``random.uniform(...)`` AND ``(rng or random).random(...)`` are
      caught, while ``torch.random.seed`` — whose base is the
      attribute ``torch.random``, not the name — is not);
    - a call on ``np.random``/``numpy.random`` whose attribute is not a
      seeded constructor;
    - ``time.time(...)`` / ``time.time_ns(...)`` calls;
    - a torch draw without ``generator=``: ``torch.<draw>(...)`` of
      :data:`_TORCH_DRAWS`, or a tensor's in-place draw
      (:data:`_TORCH_INPLACE_DRAWS`) — it draws from torch's global
      generator, which no journal records (the port's own convention).
    """
    for rel, src in sorted(ctx.files.items()):
        try:
            tree = ast.parse(src)
        except SyntaxError as e:
            yield Finding(
                rule="lint.nondeterminism",
                message=f"unparseable file: {e}",
                site=f"{rel}:{e.lineno or 1}", severity=SEV_ERROR,
            )
            continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if not isinstance(func, ast.Attribute):
                continue
            attr = func.attr
            base = func.value
            # time.time / time.time_ns on the stdlib module name
            if (attr in ("time", "time_ns")
                    and isinstance(base, ast.Name)
                    and base.id == "time"):
                yield Finding(
                    rule="lint.nondeterminism",
                    message=(
                        f"wall-clock read time.{attr}() in library code "
                        f"— unreproducible input the replay journal "
                        f"cannot capture; use time.monotonic/"
                        f"perf_counter for durations, or allowlist the "
                        f"site with the reason the value never feeds "
                        f"step math"
                    ),
                    site=f"{rel}:{node.lineno}", severity=SEV_ERROR,
                    data={"call": f"time.{attr}"},
                )
                continue
            # torch draws on the global generator
            if ((attr in _TORCH_DRAWS and isinstance(base, ast.Name)
                 and base.id == "torch") or attr in _TORCH_INPLACE_DRAWS) \
                    and not any(kw.arg == "generator"
                                for kw in node.keywords):
                yield Finding(
                    rule="lint.nondeterminism",
                    message=(
                        f"{ast.unparse(func)}() without generator= draws "
                        f"from torch's GLOBAL generator — process-shared "
                        f"and invisible to the replay journal; pass a "
                        f"seeded torch.Generator"
                    ),
                    site=f"{rel}:{node.lineno}", severity=SEV_ERROR,
                    data={"call": f"torch.{attr}"},
                )
                continue
            # np.random.<draw> / numpy.random.<draw> on the singleton
            if (isinstance(base, ast.Attribute) and base.attr == "random"
                    and isinstance(base.value, ast.Name)
                    and base.value.id in ("np", "numpy")
                    and attr not in _NP_RANDOM_SEEDED):
                yield Finding(
                    rule="lint.nondeterminism",
                    message=(
                        f"np.random.{attr}() draws from numpy's GLOBAL "
                        f"generator — unseeded, process-shared, invisible "
                        f"to the replay journal; construct a seeded "
                        f"np.random.RandomState/default_rng instead"
                    ),
                    site=f"{rel}:{node.lineno}", severity=SEV_ERROR,
                    data={"call": f"np.random.{attr}"},
                )
                continue
            # stdlib singleton draws: a bare name `random` in the base
            # expression (catches `(rng or random).random()`) — but NOT
            # one inside a nested Call, which is a seeded-instance
            # construction (`random.Random(3).random()` is exactly what
            # this rule's message recommends, not a violation)
            in_call = set()
            for sub in ast.walk(base):
                if isinstance(sub, ast.Call):
                    for n2 in ast.walk(sub):
                        if isinstance(n2, ast.Name):
                            in_call.add(id(n2))
            if attr in _STDLIB_RANDOM_DRAWS and any(
                isinstance(n, ast.Name) and n.id == "random"
                and id(n) not in in_call
                for n in ast.walk(base)
            ):
                yield Finding(
                    rule="lint.nondeterminism",
                    message=(
                        f"random.{attr}() draws from the stdlib module "
                        f"singleton — unseeded and process-shared; use a "
                        f"seeded random.Random(seed) instance (or "
                        f"allowlist the host-side site with its reason)"
                    ),
                    site=f"{rel}:{node.lineno}", severity=SEV_ERROR,
                    data={"call": f"random.{attr}"},
                )


#: the clock reads lint.serving-clock polices in serving/ (perf_counter
#: is a duration probe, sleep is not a read — neither feeds deadline
#: math, so neither is in this set)
_SERVING_CLOCK_READS = frozenset({"monotonic", "time", "time_ns",
                                  "monotonic_ns"})


@lint_rule("lint.serving-clock", scopes=("apex_tpu_torch/serving/",))
def serving_clock(ctx: LintContext) -> Iterable[Finding]:
    """Bare clock CALLS in serving scheduling paths (module docstring).

    AST-based: flags ``time.monotonic()``/``time.time()`` (and the
    ``_ns`` variants) called through the stdlib module name or its
    conventional ``_time`` alias, plus ``from time import monotonic/
    time`` imports that would hide those call sites behind bare names.
    A bare ATTRIBUTE reference (``time_fn=time.monotonic`` — the
    injection default idiom) is not a call and not flagged."""
    for rel, src in sorted(ctx.files.items()):
        try:
            tree = ast.parse(src)
        except SyntaxError as e:
            yield Finding(
                rule="lint.serving-clock",
                message=f"unparseable file: {e}",
                site=f"{rel}:{e.lineno or 1}", severity=SEV_ERROR,
            )
            continue
        for node in ast.walk(tree):
            if (isinstance(node, ast.ImportFrom) and node.module == "time"):
                for a in node.names:
                    if a.name in _SERVING_CLOCK_READS:
                        yield Finding(
                            rule="lint.serving-clock",
                            message=(
                                f"'from time import {a.name}' hides bare "
                                f"clock reads from review in serving code "
                                f"— take the clock from the injected "
                                f"``time_fn`` instead"
                            ),
                            site=f"{rel}:{node.lineno}",
                            severity=SEV_ERROR,
                            data={"import": a.name},
                        )
                continue
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if (
                isinstance(func, ast.Attribute)
                and func.attr in _SERVING_CLOCK_READS
                and isinstance(func.value, ast.Name)
                and func.value.id in ("time", "_time")
            ):
                yield Finding(
                    rule="lint.serving-clock",
                    message=(
                        f"bare time.{func.attr}() in serving code — the "
                        f"serving clock is INJECTED (time_fn= on "
                        f"ServingEngine/FleetRouter) so deadlines, drain "
                        f"budgets and failover detection are drivable by "
                        f"a fake clock; read ``self.time_fn()`` (or "
                        f"thread a ``now`` parameter) instead"
                    ),
                    site=f"{rel}:{node.lineno}", severity=SEV_ERROR,
                    data={"call": f"time.{func.attr}"},
                )


#: the record kinds whose CONSTRUCTION is fenced to the trace package
#: (emit.py builds "trace", slo.py builds "slo"); the analyzer's derived
#: offline kind "trace_decomp" is not a span and deliberately not fenced
_FENCED_TRACE_KINDS = frozenset({"trace", "slo"})

#: record-constructor callee names lint.trace-emit inspects (the shared
#: schema's two mouths: MetricRouter.event and make_record)
_RECORD_CONSTRUCTORS = frozenset({"event", "make_record"})


@lint_rule("lint.trace-emit", scopes=(LIBRARY, EXAMPLES))
def trace_emit(ctx: LintContext) -> Iterable[Finding]:
    """Ad-hoc ``kind="trace"``/``"slo"`` record construction outside the
    blessed trace-package homes (module docstring). AST-based: flags
    ``event``/``make_record`` calls whose kind argument (first
    positional, or ``kind=``) is one of the fenced literals, and dict
    literals whose ``"kind"`` key maps to one — both are records
    entering the stream; comparisons and sink filters merely read."""
    for rel, src in sorted(ctx.files.items()):
        try:
            tree = ast.parse(src)
        except SyntaxError as e:
            yield Finding(
                rule="lint.trace-emit",
                message=f"unparseable file: {e}",
                site=f"{rel}:{e.lineno or 1}", severity=SEV_ERROR,
            )
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                func = node.func
                name = (
                    func.id if isinstance(func, ast.Name)
                    else func.attr if isinstance(func, ast.Attribute)
                    else None
                )
                if name not in _RECORD_CONSTRUCTORS:
                    continue
                kind = None
                if node.args:
                    a0 = node.args[0]
                    if (isinstance(a0, ast.Constant)
                            and isinstance(a0.value, str)):
                        kind = a0.value
                for kw in node.keywords:
                    if (kw.arg == "kind"
                            and isinstance(kw.value, ast.Constant)
                            and isinstance(kw.value.value, str)):
                        kind = kw.value.value
                if kind in _FENCED_TRACE_KINDS:
                    yield Finding(
                        rule="lint.trace-emit",
                        message=(
                            f'{name}(kind="{kind}") outside the blessed '
                            f"home — {kind!r} records have ONE "
                            f"construction site (serving/trace/"
                            f"{'emit' if kind == 'trace' else 'slo'}.py) "
                            f"so the span schema the critical-path "
                            f"analyzer re-adds its identity from cannot "
                            f"fork; route through TraceEmitter/SLOMonitor"
                        ),
                        site=f"{rel}:{node.lineno}", severity=SEV_ERROR,
                        data={"kind": kind, "callee": name},
                    )
            elif isinstance(node, ast.Dict):
                for k, v in zip(node.keys, node.values):
                    if (isinstance(k, ast.Constant) and k.value == "kind"
                            and isinstance(v, ast.Constant)
                            and v.value in _FENCED_TRACE_KINDS):
                        yield Finding(
                            rule="lint.trace-emit",
                            message=(
                                f'hand-built record dict with "kind": '
                                f'"{v.value}" — trace/slo records have '
                                f"ONE construction site (serving/trace/) "
                                f"so their schema cannot fork; route "
                                f"through TraceEmitter/SLOMonitor"
                            ),
                            site=f"{rel}:{node.lineno}",
                            severity=SEV_ERROR,
                            data={"kind": v.value, "form": "dict"},
                        )


@lint_rule("lint.float64", scopes=(LIBRARY,))
def float64_literals(ctx: LintContext) -> Iterable[Finding]:
    """``torch.float64`` / ``torch.double`` and ``.double()`` in library
    code (JAX's rule: ``jnp.float64``): the card runs fp64 at a fraction
    of its fp32 rate, and one fp64 tensor promotes every op downstream of
    it. Only the torch spellings: a bare ``np.float64`` is host-side
    index math and exempt, as in JAX — ``float64``/``double`` match when
    preceded by ``torch.``, and ``double`` as a method call."""
    for rel, src in sorted(ctx.files.items()):
        toks = ctx.tokens(src)
        for i in range(len(toks) - 2):
            spelled = (
                toks[i].type == tokenize.NAME
                and toks[i].string == "torch"
                and toks[i + 1].string == "."
                and toks[i + 2].string in ("float64", "double")
            )
            method = (
                toks[i].string == "."
                and toks[i + 1].string == "double"
                and toks[i + 2].string == "("
                and (i == 0 or toks[i - 1].string != "torch")
            )
            if spelled or method:
                yield Finding(
                    rule="lint.float64",
                    message=(
                        "torch.float64 in library code: the card runs fp64 "
                        "at a fraction of its fp32 rate and one fp64 value "
                        "poisons every dtype downstream"
                    ),
                    site=f"{rel}:{toks[i].start[0]}", severity=SEV_ERROR,
                )
