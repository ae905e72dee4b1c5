"""Fleet health: per-host divergence detection over merged record
streams (counterpart of apex_tpu/monitor/goodput/fleet.py, copied as it
is there: plain Python).

- **Stragglers** — one host's steps run slower and every other host
  blocks on it at the next collective. Detected with a ROBUST z-score
  (median/MAD) over each host's median ``phase="step"`` span duration.
- **Silent corruption** — values REPLICATED by construction (the
  dp-averaged loss, the global grad norm in ``kind="metrics"`` records)
  disagree across hosts beyond float noise.

Input: records carrying the ``host`` field, one merged stream or several
per-host files concatenated; order does not matter.
"""

import dataclasses
import math
from statistics import median
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["FleetReport", "detect_divergence"]

#: MAD -> sigma for normal data (the robust-statistics constant)
_MAD_SCALE = 1.4826


def _robust_z(values: Dict[int, float]) -> Dict[int, float]:
    """Per-host robust z-scores of ``values`` (host -> statistic)."""
    med = median(values.values())
    mad = median(abs(v - med) for v in values.values())
    scale = _MAD_SCALE * mad
    out = {}
    for host, v in values.items():
        dev = v - med
        if scale > 0.0:
            out[host] = dev / scale
        else:
            # every other host identical: any deviation is infinitely
            # many "MADs" out — flag it, don't divide by zero
            out[host] = 0.0 if dev == 0.0 else math.copysign(math.inf, dev)
    return out


@dataclasses.dataclass
class FleetReport:
    hosts: Tuple[int, ...]
    #: hosts whose median step duration z-scores ABOVE threshold (slower)
    stragglers: List[dict]          # {host, median_step_s, z}
    #: replicated-value disagreements: {step, field, host, value, median}
    suspects: List[dict]
    step_medians: Dict[int, float]  # host -> median step seconds

    @property
    def ok(self) -> bool:
        return not self.stragglers and not self.suspects

    def summary(self) -> str:
        lines = [
            f"fleet: {len(self.hosts)} host(s)"
            + (" — healthy" if self.ok else " — DIVERGENT")
        ]
        for host in sorted(self.step_medians):
            lines.append(
                f"  host {host}: median step "
                f"{self.step_medians[host]:.4f}s"
            )
        for s in self.stragglers:
            lines.append(
                f"  STRAGGLER host {s['host']}: median step "
                f"{s['median_step_s']:.4f}s (robust z={s['z']:.1f})"
            )
        for s in self.suspects:
            lines.append(
                f"  CORRUPTION SUSPECT host {s['host']} step {s['step']}: "
                f"{s['field']}={s['value']!r} vs cross-host median "
                f"{s['median']!r}"
            )
        return "\n".join(lines)

    def to_records(self, step: int = 0) -> List[dict]:
        """``kind="fleet"`` records in the shared MetricRouter schema."""
        from apex_tpu_torch.monitor.router import make_record

        records = []
        for s in self.stragglers:
            records.append(make_record(
                "fleet", step, check="straggler", flagged_host=s["host"],
                median_step_s=s["median_step_s"], z=s["z"],
            ))
        for s in self.suspects:
            records.append(make_record(
                "fleet", s["step"], check="corruption", field=s["field"],
                flagged_host=s["host"], value=s["value"], median=s["median"],
            ))
        return records


def detect_divergence(
    records: Iterable[dict],
    z_threshold: float = 4.0,
    rtol: float = 1e-5,
    fields: Sequence[str] = ("loss", "grad_norm"),
    min_hosts_for_straggler: int = 3,
) -> FleetReport:
    """Merge per-host streams and flag stragglers + corruption suspects.

    Straggler detection needs >= ``min_hosts_for_straggler`` hosts with
    step spans (a median over two points cannot name an outlier).
    Corruption checks each (step, field) present on >= 2 hosts: a value
    deviating from the cross-host median by more than ``rtol``
    relative (or non-finite while the median is finite) flags its host.
    ``rtol`` defaults well above float32 noise but far below any real
    divergence; replicated values should agree bit-for-bit.
    """
    step_durs: Dict[int, List[float]] = {}
    metric_vals: Dict[Tuple[int, str], Dict[int, float]] = {}
    for rec in records:
        host = int(rec.get("host", 0))
        kind = rec.get("kind")
        if kind == "span" and rec.get("phase") == "step":
            try:
                step_durs.setdefault(host, []).append(float(rec["dur_s"]))
            except (KeyError, TypeError, ValueError):
                continue
        elif kind == "metrics":
            for field in fields:
                v = rec.get(field)
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    metric_vals.setdefault(
                        (int(rec.get("step", -1)), field), {}
                    )[host] = float(v)

    hosts = sorted(
        set(step_durs) | {h for vals in metric_vals.values() for h in vals}
    )
    step_medians = {h: median(d) for h, d in step_durs.items() if d}

    stragglers: List[dict] = []
    if len(step_medians) >= min_hosts_for_straggler:
        zs = _robust_z(step_medians)
        for host in sorted(zs):
            # one-sided: a straggler is SLOWER; an anomalously fast host
            # is interesting but blocks nobody
            if zs[host] > z_threshold:
                stragglers.append({
                    "host": host,
                    "median_step_s": step_medians[host],
                    "z": zs[host],
                })

    suspects: List[dict] = []
    for (step, field) in sorted(metric_vals):
        vals = metric_vals[(step, field)]
        if len(vals) < 2:
            continue
        finite = [v for v in vals.values() if math.isfinite(v)]
        if not finite:
            continue  # ALL hosts non-finite: diverged together, not SDC
        med = median(finite)
        tol = rtol * max(abs(med), 1e-30)
        for host in sorted(vals):
            v = vals[host]
            if not math.isfinite(v) or abs(v - med) > tol:
                suspects.append({
                    "step": step, "field": field, "host": host,
                    "value": v, "median": med,
                })
    return FleetReport(
        hosts=tuple(hosts),
        stragglers=stragglers,
        suspects=suspects,
        step_medians=step_medians,
    )
