"""apex_tpu_torch's concurrency analyzer against the JAX package's.

The same synthetic sources — an unguarded two-thread counter and its
guarded twin, an A/B-B/A lock-order inversion, a router fan-out under a
lock, an inline ``Event().wait()``, a lock-taking SIGTERM handler, a
flag-only handler, a blocking atexit hook, a dynamic call from a thread
— are written to ``tmp_path`` under each package's prefix
(``apex_tpu/`` and ``apex_tpu_torch/``) and scanned by each package's
``run_concurrency(root=tmp_path)``: equality of the ``(rule, severity,
count)`` multisets, and of each finding's site and data with the prefix
mapped. Then the port's whole package: every finding allowlisted with a
reason, no entry stale, and the scan imports no torch (pure AST).
Everything here is AST; no thread is started.
"""

import collections
import subprocess
import sys
import textwrap

import pytest

from apex_tpu.analysis.concurrency import run_concurrency as jax_run
from apex_tpu_torch.analysis.allowlist import repo_allowlist
from apex_tpu_torch.analysis.concurrency import (
    CONCURRENCY_PASSES,
    SCAN_DIRS,
    run_concurrency,
)

FIXTURES = {
    "counter": """\
        import threading

        class Poller:
            def __init__(self):
                self.count = 0
                self._lock = threading.Lock()
                self._t = threading.Thread(target=self._work, daemon=True)

            def _work(self):
                self.count += 1

            def bump(self):
                self.count += 1
    """,
    "guarded": """\
        import threading

        class Poller:
            def __init__(self):
                self.count = 0
                self._lock = threading.Lock()
                self._t = threading.Thread(target=self._work, daemon=True)

            def _work(self):
                with self._lock:
                    self.count += 1

            def bump(self):
                with self._lock:
                    self.count += 1
    """,
    "locks": """\
        import threading

        A = threading.Lock()
        B = threading.Lock()

        def fwd():
            with A:
                with B:
                    pass

        def rev():
            with B:
                with A:
                    pass
    """,
    "fanout": """\
        import threading

        class Recorder:
            def __init__(self, router):
                self._lock = threading.RLock()
                self.router = router

            def record(self, step):
                with self._lock:
                    self.router.event("m", step)
    """,
    "wedge": """\
        import threading

        def wedge(timeout_s=None):
            threading.Event().wait(timeout_s)
    """,
    "sig": """\
        import signal
        import threading

        _LOCK = threading.Lock()
        _STATE = {}

        def _on_term(signum, frame):
            with _LOCK:
                _STATE["t"] = 1

        signal.signal(signal.SIGTERM, _on_term)
    """,
    "flag": """\
        import signal
        import time

        _FLAG = {"set": False, "t": None}

        def _on_term(signum, frame):
            _FLAG["set"] = True
            _FLAG["t"] = time.monotonic()

        signal.signal(signal.SIGTERM, _on_term)
    """,
    "exit": """\
        import atexit
        import time

        def _teardown():
            time.sleep(0.5)

        atexit.register(_teardown)
    """,
    "dynamic": """\
        import threading

        class Worker:
            def __init__(self, fn):
                self.fn = fn
                self._t = threading.Thread(target=self._run, daemon=True)

            def _run(self):
                self.fn()
    """,
}


def _scan(tmp_path, pkg, names, runner):
    root = tmp_path / pkg
    (root / pkg).mkdir(parents=True)
    for name in names:
        (root / pkg / f"fake_{name}.py").write_text(
            textwrap.dedent(FIXTURES[name]))
    return runner(root=str(root))


def _normal(findings, pkg):
    """(rule, severity, site, target, data) with the prefix taken off."""
    def strip(x):
        return str(x).replace(f"{pkg}/", "<pkg>/")
    return sorted((f.rule, f.severity, strip(f.site), strip(f.target),
                   strip(sorted(f.data.items()))) for f in findings)


@pytest.mark.parametrize("names", [
    ("counter",), ("guarded",), ("locks",), ("fanout",), ("wedge",),
    ("sig",), ("flag",), ("exit",), ("dynamic",), tuple(FIXTURES)],
    ids=lambda n: "+".join(n) if len(n) < 3 else "all")
def test_fixtures_give_jax_findings(tmp_path, names):
    """Equal (rule, severity, count), sites and data, prefix mapped."""
    jax = _scan(tmp_path, "apex_tpu", names, jax_run)
    port = _scan(tmp_path, "apex_tpu_torch", names, run_concurrency)
    assert collections.Counter((f.rule, f.severity, f.count) for f in port) \
        == collections.Counter((f.rule, f.severity, f.count) for f in jax)
    assert _normal(port, "apex_tpu_torch") == _normal(jax, "apex_tpu")
    if names == ("counter",):
        assert [f.rule for f in port if f.severity != "info"] == [
            "concurrency.unguarded-write"]


def test_scan_reads_the_port_prefix_only(tmp_path):
    """``apex_tpu`` is a prefix of ``apex_tpu_torch``: a source under the
    JAX package's directory is not the port's."""
    assert SCAN_DIRS == ("apex_tpu_torch",)
    (tmp_path / "apex_tpu").mkdir()
    (tmp_path / "apex_tpu" / "fake_counter.py").write_text(
        textwrap.dedent(FIXTURES["counter"]))
    assert run_concurrency(root=str(tmp_path)) == []


def test_pass_registry_is_jax_s():
    from apex_tpu.analysis.concurrency import CONCURRENCY_PASSES as jax_passes

    assert sorted(CONCURRENCY_PASSES) == sorted(jax_passes)


@pytest.fixture(scope="module")
def port_findings():
    return run_concurrency()


def test_port_concurrency_fully_explained(port_findings):
    """Every finding over the port's host runtime carries a reason-bearing
    entry, and no concurrency entry is stale (the lint entries' hits are
    checked with the lint, tests/test_torch_analysis_lint.py)."""
    allow = repo_allowlist()
    result = allow.apply(port_findings, check_stale=False)
    assert result.findings == [], "\n".join(f.format()
                                            for f in result.findings)
    hit = {id(e) for _, e in result.suppressed}
    stale = [e for e in allow.entries
             if e.rule.startswith("concurrency.") and e.require_hit
             and id(e) not in hit]
    assert stale == []


def test_the_async_writer_needs_no_allowlist(port_findings):
    """AsyncCheckpointWriter's _thread/_error handshake holds its lock on
    every access (the JAX twin has no thread of its own)."""
    assert not [f for f in port_findings
                if f.rule == "concurrency.unguarded-write"
                and "utils/checkpoint.py" in f.site]


def test_scan_is_pure_ast():
    code = ("import sys; from apex_tpu_torch.analysis.concurrency import "
            "run_concurrency; run_concurrency(); "
            "assert 'torch' not in sys.modules, sorted(sys.modules)")
    subprocess.run([sys.executable, "-c", code], check=True)
