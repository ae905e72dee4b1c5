"""apex_tpu_torch's AST lint against the JAX package's.

Each rule runs over a synthetic source tree written to ``tmp_path``
under each package's prefix (``apex_tpu/`` or ``examples/`` for JAX,
``apex_tpu_torch/`` or ``apex_tpu_torch/examples/`` for the port) and
the two give equal ``(rule, severity, count)`` multisets. A rule that is
plain Python reads the same source in both; a rule that names a JAX
idiom reads its torch twin (``lax.psum`` / ``dist.all_reduce``,
``donate_argnums`` / ``torch.compile``, ``.as_text()`` /
``.export_chrome_trace()``, ``.memory_stats()`` /
``torch.cuda.memory_stats``, ``jnp.float64`` / ``torch.float64``, the
ledger wrappers / ``parallel_state``'s helpers). Then the port's whole
package: every lint finding allowlisted with a reason and no lint entry
stale (the gate's own check, ``python -m apex_tpu_torch.analysis``).
"""

import collections
import textwrap

import pytest

from apex_tpu.analysis.lint import LINT_RULES as JAX_RULES
from apex_tpu.analysis.lint import run_lint as jax_lint
from apex_tpu_torch.analysis import lint
from apex_tpu_torch.analysis.allowlist import repo_allowlist

PLAIN = {
    "lint.trace-file": 'PATH = "run/host.trace.json.gz"\n',
    "lint.signal-handlers": (
        "import signal\n\n\ndef h(signum, frame):\n    pass\n\n\n"
        "signal.signal(signal.SIGTERM, h)\nfrom signal import signal\n"),
    "lint.thread-create": (
        "import threading\n\nt = threading.Thread(target=print)\n"
        "u = threading.Timer(1.0, print)\nlock = threading.Lock()\n"),
    "lint.silent-except": (
        "def f():\n    try:\n        pass\n    except:\n        pass\n"
        "    try:\n        pass\n    except Exception:\n        pass\n"
        "    try:\n        pass\n    except Exception as e:\n"
        "        print(e)\n"),
    "lint.process-exit": (
        "import os\nimport sys\n\n\ndef die():\n    os._exit(3)\n\n\n"
        "if __name__ == \"__main__\":\n    sys.exit(0)\n"),
    "lint.span-phases": (
        "from {pkg}.monitor.goodput import span\n\n\ndef f(p):\n"
        "    with span(\"bogus\"):\n        pass\n    with span(p):\n"
        "        pass\n    with span(\"step\"):\n        pass\n"),
    "lint.nondeterminism": (
        "import random\nimport time\n\nimport numpy as np\n\n\ndef f():\n"
        "    random.random()\n    np.random.rand(3)\n    time.time()\n"
        "    np.random.RandomState(0).rand(3)\n    time.monotonic()\n"),
    "lint.trace-emit": (
        "def f(router, make_record):\n    router.event(\"trace\", 1)\n"
        "    make_record(kind=\"slo\", step=1)\n"
        "    return {{\"kind\": \"trace\"}}\n"),
}

#: rule -> (JAX's source, the torch twin)
TWINS = {
    "lint.raw-collective": (
        "from jax import lax\n\n\ndef f(x):\n    return lax.psum(x, 'dp')\n",
        "import torch.distributed as dist\n\n\ndef f(x):\n"
        "    dist.all_reduce(x)\n"),
    "lint.jit-donate": (
        "import jax\n\nstep = jax.jit(print, donate_argnums=(0,))\n",
        "import torch\n\nstep = torch.compile(print)\n"),
    "lint.hlo-text": (
        "def f(compiled):\n    return compiled.as_text()\n",
        "def f(prof, path):\n    prof.export_chrome_trace(path)\n"),
    "lint.memory-api": (
        "def f(device):\n    return device.memory_stats()\n",
        "import torch\n\n\ndef f():\n    return torch.cuda.memory_stats()\n"),
    "lint.float64": (
        "import jax.numpy as jnp\n\nX = jnp.float64\n",
        "import torch\n\nX = torch.float64\n"),
    "lint.compressed-collective": (
        "from jax import lax\n\n\ndef f(x):\n"
        "    q = quantize_blockwise(x)\n    return lax.psum(q, 'dp')\n",
        "from apex_tpu_torch.parallel import parallel_state as ps\n\n\n"
        "def f(x, g):\n    q = quantize_blockwise(x)\n"
        "    return ps.all_reduce(q, g)\n"),
    "lint.prefetch-gather": (
        "def f(bs):\n    for b in bs:\n        all_gather(b, 'dp')\n",
        "from apex_tpu_torch.parallel import parallel_state as ps\n\n\n"
        "def f(bs, g):\n    for b in bs:\n        ps.all_gather(b, g)\n"),
}

TAPS = (
    "class L:\n    def f(self, a, r):\n"
    "        self.sow('intermediates', 'moe_aux_loss', a)\n"
    "        self.sow('intermediates', 'layer_out_rms', r)\n",
    "class L:\n    def f(self, a, r):\n"
    "        self.aux_loss, self.dropped = a, 0\n"
    "        self.layer_out_rms = r\n")


def _tree(root, files):
    for rel, src in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(src))
    return str(root)


def _counts(findings):
    return collections.Counter((f.rule, f.severity, f.count)
                               for f in findings)


def _both(tmp_path, rule, jax_files, port_files):
    jax = jax_lint(root=_tree(tmp_path / "jax", jax_files), rules=[rule])
    port = lint.run_lint(root=_tree(tmp_path / "port", port_files),
                         rules=[rule])
    return jax, port


def test_the_port_registers_jax_s_rules():
    assert sorted(lint.LINT_RULES) == sorted(JAX_RULES)


@pytest.mark.parametrize("rule", sorted(PLAIN))
def test_plain_rules_give_jax_findings(tmp_path, rule):
    src = PLAIN[rule]
    jax, port = _both(tmp_path, rule,
                      {"apex_tpu/fake.py": src.format(pkg="apex_tpu")},
                      {"apex_tpu_torch/fake.py":
                       src.format(pkg="apex_tpu_torch")})
    assert jax and _counts(port) == _counts(jax)
    assert sorted(f.site.split("/", 1)[1] for f in port) == sorted(
        f.site.split("/", 1)[1] for f in jax)


@pytest.mark.parametrize("rule", sorted(TWINS))
def test_torch_twins_give_jax_findings(tmp_path, rule):
    jax_src, port_src = TWINS[rule]
    jax, port = _both(tmp_path, rule, {"apex_tpu/fake.py": jax_src},
                      {"apex_tpu_torch/fake.py": port_src})
    assert jax and _counts(port) == _counts(jax)


def test_serving_clock_gives_jax_findings(tmp_path):
    src = ("import time\n\n\ndef f(time_fn=time.monotonic):\n"
           "    return time.monotonic() + time_fn()\n")
    jax, port = _both(tmp_path, "lint.serving-clock",
                      {"apex_tpu/serving/fake.py": src},
                      {"apex_tpu_torch/serving/fake.py": src})
    assert len(jax) == 1 and _counts(port) == _counts(jax)


@pytest.mark.parametrize("with_taps", [True, False])
def test_registered_taps_give_jax_findings(tmp_path, with_taps):
    """Both registries hold the same two taps; a tree that keeps both is
    clean, one that keeps neither has two stale rows."""
    jax_src, port_src = TAPS if with_taps else ("X = 1\n", "X = 1\n")
    jax, port = _both(tmp_path, "lint.registered-taps",
                      {"apex_tpu/fake.py": jax_src},
                      {"apex_tpu_torch/fake.py": port_src})
    assert len(jax) == (0 if with_taps else 2)
    assert _counts(port) == _counts(jax)


@pytest.mark.parametrize("rule,expected", [
    ("lint.thread-create", 0), ("lint.signal-handlers", 2)])
def test_examples_are_scoped_as_jax_s(tmp_path, rule, expected):
    """The port's examples live in the package: a library-only rule skips
    them, as JAX's skips its examples/, and a rule of both reads them."""
    src = PLAIN[rule]
    jax, port = _both(tmp_path, rule, {"examples/fake.py": src},
                      {"apex_tpu_torch/examples/fake.py": src})
    assert len(jax) == expected and _counts(port) == _counts(jax)


def test_scan_dirs_match_whole_components(tmp_path):
    """A file of the JAX package's directory is not the port's."""
    root = _tree(tmp_path, {"apex_tpu/fake.py": PLAIN["lint.trace-file"]})
    assert lint.collect_sources(root) == {}
    assert lint.in_scope("apex_tpu_torch/x.py", ("apex_tpu_torch/",))
    assert not lint.in_scope("apex_tpu/x.py", ("apex_tpu_torch/",))


def test_port_only_flags(tmp_path):
    """The float64 twin's ``.double()`` and the nondeterminism twin's
    torch draws without ``generator=`` (the port's convention)."""
    root = _tree(tmp_path, {"apex_tpu_torch/fake.py": (
        "import torch\n\n\ndef f(x, g):\n    y = x.double()\n"
        "    torch.randn(3)\n    torch.randn(3, generator=g)\n"
        "    x.uniform_()\n    np.float64(1.0)\n")})
    found = lint.run_lint(root=root, rules=["lint.float64",
                                            "lint.nondeterminism"])
    assert sorted((f.rule, f.site) for f in found) == [
        ("lint.float64", "apex_tpu_torch/fake.py:5"),
        ("lint.nondeterminism", "apex_tpu_torch/fake.py:6"),
        ("lint.nondeterminism", "apex_tpu_torch/fake.py:8")]


def test_port_lint_fully_explained():
    """The gate's lint half over the port: every finding allowlisted with
    a reason, and no lint entry stale."""
    allow = repo_allowlist()
    result = allow.apply(lint.run_lint(), check_stale=False)
    assert result.findings == [], "\n".join(f.format()
                                            for f in result.findings)
    hit = {id(e) for _, e in result.suppressed}
    stale = [(e.rule, e.match) for e in allow.entries
             if e.rule.startswith("lint.") and id(e) not in hit]
    assert stale == []
    assert all(e.reason.strip() for e in allow.entries)
