"""Perf-regression sentinel (counterpart of
apex_tpu/monitor/goodput/sentinel.py): the referee of recorded
performance.

``python -m apex_tpu_torch.monitor.goodput --check`` compares fresh
measurements with a recorded history and exits nonzero on a regression
— the same discipline as ``python -m apex_tpu_torch.analysis``.

Inputs:

- **history** — the repo's recorded rounds (``BENCH_r*.json``,
  :func:`load_bench_history`): one headline measurement per round with
  its platform tag, plus an optional ``--baseline`` recording.
- **fresh** — measurements under test: ``kind="bench"`` records, plus
  ``kind="metrics"`` (tokens/s, MFU, step time — medians over the run)
  and ``kind="goodput"`` (goodput fraction) records from a training run.

**Only values from the same platform compare.** The recorded rounds are
the JAX package's, tagged ``tpu`` or ``cpu``. The port's records say
``gpu`` (``chip_smoke.py`` writes its ResNet-50 measurement as a
``kind="bench"`` record through ``monitor.router.make_record``), and no
``BENCH_r*.json`` round does, so a port measurement is checked against
a ``--baseline`` recording of its own; with a one-value history the
floor alone is the tolerance, and a metric with no same-platform
history is ``perf.no-baseline`` (info), never a failure.

Thresholds are noise-aware, not bare percentages: the tolerance for a
metric is ``max(floor, 3 * MAD_rel)`` where ``MAD_rel`` is the robust
relative spread of the history's repeat measurements (values within
``repeat_band`` of the best — an improving trajectory's early rounds are
progress, not noise, and must not widen the gate). With fewer than two
repeats the floor alone applies.

Intentional regressions pass through the same reason-carrying
:class:`~apex_tpu_torch.analysis.findings.Allowlist` as every other gate:
an entry names the metric and says why the slowdown is accepted; bare
suppressions are a constructor error. :data:`GOODPUT_ALLOWLIST` is empty.

Host-only (findings.py is stdlib-only and ``apex_tpu_torch.analysis`` is
PEP-562 lazy): the gate imports no torch and runs on any box.
"""

import glob
import json
import os
from statistics import median
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from apex_tpu_torch.analysis.findings import (
    Allowlist,
    Finding,
    SEV_ERROR,
    SEV_INFO,
)

__all__ = [
    "load_bench_history",
    "measurements_from_records",
    "noise_tolerance",
    "check_regression",
    "canon_platform",
    "goodput_allowlist",
    "GOODPUT_ALLOWLIST",
]

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))

#: metrics-kind scalar fields the sentinel gates, with direction
#: (True = higher is better)
_METRIC_FIELDS = {"tokens_per_s": True, "mfu": True, "step_ms": False}

#: platform-tag aliases folded together for baseline matching: the
#: recorded rounds tag a value by HOW it reached the file
#: ("tpu_harvested" = replayed from a capture, "cpu_fallback" = the
#: device was unreachable), but the number itself was measured on the
#: aliased backend, so a live capture's plain tag gates against it
_PLATFORM_ALIASES = {"tpu_harvested": "tpu", "cpu_fallback": "cpu"}


def canon_platform(platform: str) -> str:
    """Canonical platform tag for baseline comparability (see
    :data:`_PLATFORM_ALIASES`)."""
    return _PLATFORM_ALIASES.get(platform, platform)


def higher_is_better(metric: str) -> bool:
    """Direction of a metric by name: times and memory footprints are
    lower-better, rates and fractions higher-better."""
    if metric in _METRIC_FIELDS:
        return _METRIC_FIELDS[metric]
    if metric.endswith(("_ms", "_s", "_s_per_step", "_seconds")):
        return False
    # memory footprints (the HBM x-ray's peak_hbm_bytes and the serving
    # KV pool's kv_pool_peak_blocks): a regression is the number GROWING
    if metric.endswith(("_bytes", "_blocks")):
        return False
    return True


def load_bench_history(root: Optional[str] = None) -> List[dict]:
    """The recorded rounds: one measurement per ``BENCH_r*.json`` that
    carries a parsed numeric headline, in round order. Each is
    ``{metric, value, unit, platform, source}``."""
    root = root or _REPO_ROOT
    out: List[dict] = []
    for path in sorted(glob.glob(os.path.join(root, "BENCH_r*.json"))):
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            continue
        parsed = data.get("parsed") if isinstance(data, dict) else None
        if not isinstance(parsed, dict):
            continue
        value = parsed.get("value")
        metric = parsed.get("metric")
        if not isinstance(value, (int, float)) or not metric:
            continue
        out.append({
            "metric": str(metric),
            "value": float(value),
            "unit": parsed.get("unit"),
            "platform": str(parsed.get("platform", "unknown")),
            "source": os.path.basename(path),
        })
    return out


def measurements_from_records(
    records: Iterable[dict], source: str = "records",
) -> List[dict]:
    """Gateable measurements from a record stream.

    - ``kind="bench"``: one measurement per record (metric/value/
      platform — the bench harnesses' emission).
    - ``kind="metrics"``: the run's MEDIAN per gated field (one fast
      interval must not mask a slow run, one slow one must not fail it);
      platform tag "run".
    - ``kind="goodput"``: median ``goodput_fraction``; platform "run".
    """
    out: List[dict] = []
    per_field: Dict[str, List[float]] = {}
    goodput_fracs: List[float] = []
    for rec in records:
        kind = rec.get("kind")
        if kind == "bench":
            value = rec.get("value")
            metric = rec.get("metric")
            if isinstance(value, (int, float)) and metric:
                out.append({
                    "metric": str(metric), "value": float(value),
                    "unit": rec.get("unit"),
                    "platform": str(rec.get("platform", "unknown")),
                    "source": source,
                })
        elif kind == "metrics":
            for field in _METRIC_FIELDS:
                v = rec.get(field)
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    per_field.setdefault(field, []).append(float(v))
        elif kind == "goodput":
            v = rec.get("goodput_fraction")
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                goodput_fracs.append(float(v))
    for field, vals in sorted(per_field.items()):
        out.append({
            "metric": field, "value": median(vals), "unit": None,
            "platform": "run", "source": source,
        })
    if goodput_fracs:
        out.append({
            "metric": "goodput_fraction", "value": median(goodput_fracs),
            "unit": None, "platform": "run", "source": source,
        })
    return out


def noise_tolerance(
    history_values: Sequence[float],
    floor: float = 0.05,
    repeat_band: float = 0.15,
    k: float = 3.0,
    higher_better: bool = True,
) -> float:
    """Relative regression tolerance for a metric given its history.

    Repeats = history values within ``repeat_band`` (relative) of the
    best — re-measurements of the same configuration; earlier, worse
    values are trajectory progress and excluded (they would claim the
    improvement itself as "noise" and let a matching regression pass).
    Tolerance = ``max(floor, k * MAD_rel(repeats))``.
    """
    if not history_values:
        return floor
    best = max(history_values) if higher_better else min(history_values)
    if best == 0:
        return floor
    repeats = [v for v in history_values
               if abs(v - best) <= repeat_band * abs(best)]
    if len(repeats) < 2:
        return floor
    med = median(repeats)
    if med == 0:
        return floor
    mad_rel = median(abs(v - med) for v in repeats) / abs(med)
    return max(floor, k * mad_rel)


def _baseline_key(m: dict) -> Tuple[str, str]:
    return (m["metric"], canon_platform(m["platform"]))


def check_regression(
    fresh: Sequence[dict],
    history: Sequence[dict],
    floor: float = 0.05,
) -> List[Finding]:
    """Compare fresh measurements to same-(metric, platform) history.

    One finding per fresh measurement: ``perf.regression`` (error) when
    it falls outside the noise-aware band around the historical best,
    ``perf.no-baseline`` (info) when nothing comparable is recorded —
    advisory, because a NEW metric must not fail the gate, but visible,
    because a silently un-gated metric is how trajectories rot.
    """
    by_key: Dict[Tuple[str, str], List[float]] = {}
    for m in history:
        by_key.setdefault(_baseline_key(m), []).append(m["value"])

    findings: List[Finding] = []
    for m in fresh:
        key = _baseline_key(m)
        hist = by_key.get(key)
        site = f"{m['source']}:{m['metric']}"
        if not hist:
            findings.append(Finding(
                rule="perf.no-baseline",
                message=(
                    f"no recorded baseline for metric {m['metric']!r} on "
                    f"platform {m['platform']!r} — value "
                    f"{m['value']:.6g} accepted unchecked"
                ),
                site=site, severity=SEV_INFO,
                data={"metric": m["metric"], "value": m["value"],
                      "platform": m["platform"]},
            ))
            continue
        hib = higher_is_better(m["metric"])
        tol = noise_tolerance(hist, floor=floor, higher_better=hib)
        best = max(hist) if hib else min(hist)
        value = m["value"]
        if hib:
            regressed = value < best * (1.0 - tol)
            change = value / best - 1.0 if best else 0.0
        else:
            regressed = value > best * (1.0 + tol)
            change = best / value - 1.0 if value else 0.0
        if regressed:
            findings.append(Finding(
                rule="perf.regression",
                message=(
                    f"{m['metric']} = {value:.6g} regressed "
                    f"{-100.0 * change:.1f}% vs recorded best {best:.6g} "
                    f"(tolerance {100.0 * tol:.1f}%, platform "
                    f"{m['platform']!r}) — fix it, or allowlist the "
                    f"metric with the reason the slowdown is intentional"
                ),
                site=site, severity=SEV_ERROR,
                data={"metric": m["metric"], "value": value,
                      "baseline": best, "tolerance": tol,
                      "change": change, "platform": m["platform"]},
            ))
    return findings


#: Intentional, documented perf regressions — the reason-carrying
#: mute button, same contract as analysis/allowlist.py. Match is on the
#: finding site (``<source>:<metric>``). EMPTY today: the recorded
#: trajectory stands un-waived, and any entry added here is a reviewable
#: claim that a specific slowdown buys something worth more.
GOODPUT_ALLOWLIST: List = []


def goodput_allowlist() -> Allowlist:
    """A fresh copy of the perf-regression allowlist (callers may
    :meth:`~apex_tpu_torch.analysis.findings.Allowlist.extended` it)."""
    return Allowlist(list(GOODPUT_ALLOWLIST))
