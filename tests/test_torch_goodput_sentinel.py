"""apex_tpu_torch's perf-regression sentinel against the JAX package's.

The same synthetic history (``BENCH_r*.json`` rounds written to
``tmp_path``: a CPU round, TPU rounds that repeat within noise, and a
round with no parsed headline) and the same fresh records
(``kind="bench"``, ``"metrics"`` and ``"goodput"``, in jsonl files under
``tmp_path``) go through both packages: equal histories, measurements,
tolerances and findings (rule, severity, site and data, exactly), and
equal exit statuses of ``--check`` with and without ``--baseline``,
including a ``gpu`` measurement, which no recorded round compares with
(``perf.no-baseline``, info) until a baseline of its own is given. No
test reads the repository's own ``BENCH_r*.json``.
"""

import json

import pytest

from apex_tpu.monitor.goodput import sentinel as jax_sentinel
from apex_tpu.monitor.goodput.__main__ import main as jax_main
from apex_tpu_torch.monitor.goodput import sentinel
from apex_tpu_torch.monitor.goodput.__main__ import main
from apex_tpu_torch.monitor.router import make_record

METRIC = "rn50_train_imgs_per_sec_per_chip_ampO2"

ROUNDS = {
    "BENCH_r01.json": {"parsed": None},
    "BENCH_r02.json": {"parsed": {"metric": METRIC, "value": 23.3,
                                  "platform": "cpu_fallback"}},
    "BENCH_r03.json": {"parsed": {"metric": METRIC, "value": 2601.0,
                                  "platform": "tpu_harvested"}},
    "BENCH_r04.json": {"parsed": {"metric": METRIC, "value": 2626.5,
                                  "platform": "tpu"}},
    "BENCH_r05.json": {"parsed": {"metric": METRIC, "value": 2611.0,
                                  "platform": "tpu"}},
}


@pytest.fixture
def history_root(tmp_path, monkeypatch):
    root = tmp_path / "history"
    root.mkdir()
    for name, data in ROUNDS.items():
        (root / name).write_text(json.dumps(data))
    monkeypatch.setattr(sentinel, "_REPO_ROOT", str(root))
    monkeypatch.setattr(jax_sentinel, "_REPO_ROOT", str(root))
    return str(root)


def _records(tmp_path, name, records):
    path = tmp_path / name
    path.write_text("".join(json.dumps(r) + "\n" for r in records))
    return str(path)


def _fresh(tpu=2500.0, gpu=3000.0, tokens=(900.0, 1000.0, 950.0)):
    recs = [make_record("bench", 0, metric=METRIC, value=tpu,
                        unit="imgs/sec/chip", platform="tpu"),
            make_record("bench", 0, metric=METRIC, value=gpu,
                        unit="imgs/sec/chip", platform="gpu")]
    recs += [make_record("metrics", i, tokens_per_s=t, step_ms=1e6 / t,
                         mfu=t / 2e4) for i, t in enumerate(tokens)]
    recs.append(make_record("goodput", 0, goodput_fraction=0.9))
    return recs


def _key(findings):
    return sorted((f.rule, f.severity, f.site, json.dumps(f.data,
                                                          sort_keys=True))
                  for f in findings)


def test_history_and_tolerances_are_jax_s(history_root):
    hist = sentinel.load_bench_history()
    assert hist == jax_sentinel.load_bench_history()
    assert [m["source"] for m in hist] == [
        "BENCH_r02.json", "BENCH_r03.json", "BENCH_r04.json",
        "BENCH_r05.json"]
    for values in ([], [100.0], [100.0, 110.0, 90.0], [23.0, 2626.0,
                                                       2601.0, 2611.0]):
        for hib in (True, False):
            assert sentinel.noise_tolerance(values, higher_better=hib) == \
                jax_sentinel.noise_tolerance(values, higher_better=hib)
    for name in ("tokens_per_s", "step_ms", "peak_hbm_bytes", METRIC,
                 "kv_pool_peak_blocks", "goodput_fraction"):
        assert sentinel.higher_is_better(name) == \
            jax_sentinel.higher_is_better(name)


@pytest.mark.parametrize("tpu,gpu", [(2600.0, 3000.0), (2000.0, 3000.0),
                                     (2000.0, 1.0)])
def test_verdicts_are_jax_s(history_root, tpu, gpu):
    recs = _fresh(tpu=tpu, gpu=gpu)
    fresh = sentinel.measurements_from_records(recs, source="run")
    assert fresh == jax_sentinel.measurements_from_records(recs,
                                                           source="run")
    hist = sentinel.load_bench_history()
    port = sentinel.check_regression(fresh, hist)
    jax = jax_sentinel.check_regression(fresh, hist)
    assert _key(port) == _key(jax)
    # a gpu value compares with no recorded round (they are tpu and cpu)
    by_metric = {(f.rule, f.data.get("platform")) for f in port}
    assert ("perf.no-baseline", "gpu") in by_metric
    assert (("perf.regression", "tpu") in by_metric) == (tpu < 2500.0)


@pytest.mark.parametrize("slow", [1.0, 0.8])
def test_check_cli_exits_as_jax_s(history_root, tmp_path, slow, capsys):
    """A gpu measurement against a baseline of itself passes; 20% slower
    fails, in both packages."""
    base = _records(tmp_path, "base.jsonl", [make_record(
        "bench", 0, metric=METRIC, value=3000.0, platform="gpu")])
    run = _records(tmp_path, "run.jsonl", [make_record(
        "bench", 0, metric=METRIC, value=3000.0 * slow, platform="gpu")])
    argv = ["--check", run, "--baseline", base]
    rc = main(argv)
    assert rc == jax_main(argv) == (0 if slow == 1.0 else 1)
    assert "perf.regression" in capsys.readouterr().out or slow == 1.0


def test_check_without_streams_is_jax_s(history_root, capsys):
    """The newest recorded round against the prior ones."""
    assert main(["--check"]) == jax_main(["--check"]) == 0
    assert "BENCH_r05.json" in capsys.readouterr().out


def test_account_and_fleet_modes_are_jax_s(tmp_path, history_root):
    recs = _records(tmp_path, "run.jsonl", _fresh())
    assert main([recs]) == jax_main([recs]) == 1  # no span records
    assert main(["--fleet", recs]) == jax_main(["--fleet", recs])


def test_allowlist_is_empty():
    assert len(sentinel.goodput_allowlist()) == 0 == len(
        jax_sentinel.goodput_allowlist())
