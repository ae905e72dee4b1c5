"""In-step metric taps: a device-resident bag of named scalar aggregates
(counterpart of apex_tpu/monitor/metrics.py).

The step folds each scalar into a tiny aggregate on the device (sum,
last or max per metric) with no host read, and the host fetches ONE
packed vector per log interval through :func:`read_bag`, which counts
itself (:func:`host_fetch_count`) so tests can assert the
one-fetch-per-interval contract. In eager PyTorch a stray ``.item()``,
``float()`` or ``bool()`` on a bag tensor would be a silent extra sync:
the bag's methods make none.
"""

import threading
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from apex_tpu_torch._kernels import resolve_device
from apex_tpu_torch.monitor.taps import TAP_ATTRIBUTES
from apex_tpu_torch.ops.multi_tensor import multi_tensor_l2norm

__all__ = [
    "MODES", "MetricBag", "global_grad_norm", "host_fetch_count",
    "metric_bag", "per_layer_grad_norms", "read_bag", "reset_bag",
    "taps_from_intermediates",
]

#: Aggregation modes. "mean" divides the running sum by the finite-fold
#: count at read time; "sum" reports the raw sum (event counts); "last"
#: keeps the most recent value (gauges like the loss scale); "max" the
#: running max.
MODES = ("mean", "sum", "last", "max")

_fetch_lock = threading.Lock()
_fetches = 0


def host_fetch_count() -> int:
    """Device-to-host fetches performed by :func:`read_bag` in this
    process (monotonic)."""
    return _fetches


def _zero(spec, device):
    # one tensor per leaf: the folds below write them in place
    values = {
        n: torch.full((), -torch.inf if m == "max" else 0.0,
                      dtype=torch.float32, device=device)
        for n, m in spec
    }
    counts = {n: torch.zeros((), dtype=torch.int32, device=device)
              for n, _ in spec}
    return values, counts, torch.zeros((), dtype=torch.int32, device=device)


class MetricBag:
    """Named fp32 scalar aggregates on one device.

    ``values`` maps each metric to its 0-d aggregate and ``counts`` to the
    number of FINITE folds it received (a non-finite value is excluded on
    the device with ``torch.where``, so one NaN step cannot poison an
    interval's mean); ``count`` totals :meth:`add` calls. ``spec`` fixes
    the key set and each metric's mode.
    """

    def __init__(self, spec: Tuple[Tuple[str, str], ...], device):
        self.spec = spec
        self.device = torch.device(device)
        self.values, self.counts, self.count = _zero(spec, self.device)

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.spec)

    def mode(self, name: str) -> str:
        return dict(self.spec)[name]

    def add(self, **scalars) -> "MetricBag":
        """Fold one step's scalars in, in place (no host read); returns
        the bag. Unknown names raise; omitted names do not advance."""
        unknown = set(scalars) - set(self.names)
        if unknown:
            raise KeyError(
                f"metrics {sorted(unknown)} not in bag spec {self.names}")
        modes = dict(self.spec)
        for name, x in scalars.items():
            x = torch.as_tensor(x, device=self.device).to(torch.float32)
            if x.ndim != 0:
                raise ValueError(
                    f"metric {name!r} must be a scalar, got shape "
                    f"{tuple(x.shape)}")
            ok = torch.isfinite(x)
            v = self.values[name]
            mode = modes[name]
            if mode in ("mean", "sum"):
                v.add_(torch.where(ok, x, 0.0))
            elif mode == "last":
                v.copy_(torch.where(ok, x, v))
            else:  # max
                torch.maximum(v, torch.where(ok, x, -torch.inf), out=v)
            self.counts[name].add_(ok.to(torch.int32))
        self.count.add_(1)
        return self

    def merge(self, other: "MetricBag") -> "MetricBag":
        """A new bag combining two with the same spec; ``other`` is the
        newer one for "last" metrics."""
        if self.spec != other.spec:
            raise ValueError("cannot merge bags with different specs")
        out = MetricBag(self.spec, self.device)
        for name, mode in self.spec:
            a, b = self.values[name], other.values[name]
            if mode in ("mean", "sum"):
                out.values[name].copy_(a + b)
            elif mode == "last":
                out.values[name].copy_(torch.where(other.counts[name] > 0,
                                                   b, a))
            else:
                out.values[name].copy_(torch.maximum(a, b))
            out.counts[name].copy_(self.counts[name] + other.counts[name])
        out.count.copy_(self.count + other.count)
        return out

    def pack(self) -> torch.Tensor:
        """The finalized metrics as ONE flat fp32 vector in spec order, on
        the device. A metric with no finite fold packs as NaN."""
        out = []
        for name, mode in self.spec:
            v = self.values[name]
            c = self.counts[name].to(torch.float32)
            out.append(v / c if mode == "mean"
                       else torch.where(c > 0, v, torch.nan))
        return torch.stack(out)


def metric_bag(spec: Mapping[str, str], device="cuda") -> MetricBag:
    """Fresh zeroed bag from ``{name: mode}`` on ``device`` (the card
    unless the caller names another)."""
    bad = {n: m for n, m in spec.items() if m not in MODES}
    if bad:
        raise ValueError(f"unknown metric modes {bad}; valid: {MODES}")
    return MetricBag(tuple(sorted(spec.items())), resolve_device(device))


def reset_bag(bag: MetricBag) -> MetricBag:
    """Zero ``bag`` in place for the next log interval; returns it."""
    for name, mode in bag.spec:
        bag.values[name].fill_(-torch.inf if mode == "max" else 0.0)
        bag.counts[name].zero_()
    bag.count.zero_()
    return bag


def read_bag(bag: MetricBag) -> Dict[str, float]:
    """Fetch the bag to the host: ``{name: float}`` in ONE device-to-host
    transfer (the packed vector), counted in :func:`host_fetch_count`.
    A metric never folded (or non-finite) reads as None."""
    global _fetches
    packed = bag.pack().cpu().numpy()  # the single transfer
    with _fetch_lock:
        _fetches += 1
    out = {}
    for (name, _), v in zip(bag.spec, packed):
        f = float(v)
        out[name] = None if np.isnan(f) or np.isinf(f) else f
    return out


# -- grad-norm taps --------------------------------------------------------


def global_grad_norm(grads: Any) -> torch.Tensor:
    """Global L2 norm over every leaf, 0-d fp32 on the leaves' device: on
    CUDA tensors each leaf's sum of squares is kernel #9
    (``ops.multi_tensor.multi_tensor_l2norm``)."""
    return multi_tensor_l2norm(grads)


def per_layer_grad_norms(grads: Any, prefix: str = "grad_norm/"
                         ) -> Dict[str, torch.Tensor]:
    """L2 norm per TOP-LEVEL entry of a params-like dict (``params``
    unwrapped when present). A dotted key (``dict(model.
    named_parameters())``) stands for the nested dicts it names, so its
    first component is its top-level entry. Anything else gets one
    ``prefix + 'all'`` entry."""
    if isinstance(grads, Mapping):
        inner = grads.get("params", grads)
        if isinstance(inner, Mapping) and inner:
            groups: Dict[str, list] = {}
            for key, sub in inner.items():
                groups.setdefault(str(key).split(".")[0], []).append(sub)
            return {f"{prefix}{k}": global_grad_norm(v)
                    for k, v in groups.items()}
    return {prefix + "all": global_grad_norm(grads)}


# -- tap reader ------------------------------------------------------------


def _module_taps(model: torch.nn.Module) -> Dict[str, list]:
    taps: Dict[str, list] = {}
    for mod in model.modules():
        for name, attr in TAP_ATTRIBUTES.items():
            v = getattr(mod, attr, None)
            if isinstance(v, torch.Tensor):
                taps.setdefault(name, []).append(v)
    return taps


def taps_from_intermediates(intermediates: Any, reduce: str = "mean"
                            ) -> Dict[str, torch.Tensor]:
    """``{tap_name: 0-d fp32}``, each tap averaged over every site.

    ``intermediates`` is either a module, whose layers' kept taps
    (:data:`~apex_tpu_torch.monitor.taps.REGISTERED_TAPS`) are read from
    its last forward, or the JAX package's nested-mapping shape: dicts
    whose leaves are tuples of tensors, each leaf reduced to the mean of
    its tensors' means under its last key. Either way the stream stays
    O(taps), not O(taps x layers).
    """
    if reduce != "mean":
        raise ValueError("only reduce='mean' is supported")
    if isinstance(intermediates, torch.nn.Module):
        return {name: torch.stack([v.float() for v in vals]).mean()
                for name, vals in _module_taps(intermediates).items()}
    out: Dict[str, list] = {}

    def visit(node):
        if isinstance(node, Mapping):
            for key, sub in node.items():
                if isinstance(sub, Mapping):
                    visit(sub)
                else:
                    vals = sub if isinstance(sub, (tuple, list)) else (sub,)
                    terms = [torch.as_tensor(v).float().mean() for v in vals]
                    out.setdefault(key, []).append(sum(terms) / len(terms))

    visit(intermediates)
    return {name: sum(parts) / len(parts) for name, parts in out.items()}
