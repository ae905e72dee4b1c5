"""Device time by kernel from a ``torch.profiler`` run on the card."""

import time
from typing import Sequence

import torch

__all__ = ["profile_device"]


def profile_device(fn, top: int = 15, spans: Sequence[str] = ()) -> dict:
    """Runs ``fn()`` under ``torch.profiler`` (CPU and CUDA activities)
    and returns the wall time, the device time summed over kernels, the
    device's idle share of the wall time, the ``top`` kernels (and
    copies) by device time and the ``top`` host operations by their own
    (self) CPU time; for each name of ``spans`` (``record_function``
    ranges), its calls, host time and the device time of the kernels
    launched inside it.
    ``fn`` should end in ``torch.cuda.synchronize()``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only: a CPU op's device time repeats its kernels'.
    # Gloo's point-to-point records come filed under the device too, with
    # a send's whole wait for its receiver as their time: not device work
    # and a span's own device-side range repeats the kernels inside it
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and not e.key.startswith("gloo:") and e.key not in spans]
    rows.sort(key=lambda r: -r[1])
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU), key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    named = {name: {"calls": 0, "host_ms": 0.0, "device_ms": 0.0}
             for name in spans}
    for e in prof.key_averages():
        if e.key in named and e.device_type == DeviceType.CPU:
            named[e.key]["calls"] += e.count
            named[e.key]["host_ms"] += e.cpu_time_total / 1e3
            named[e.key]["device_ms"] += e.device_time_total / 1e3
    return {
        "gpu": torch.cuda.get_device_name(0),
        "wall_ms": wall * 1e3, "device_ms": device_ms,
        "device_idle_share": 1.0 - device_ms / (wall * 1e3),
        "top": [{"name": k[:80], "device_ms": ms, "calls": n}
                for k, ms, n in rows[:top]],
        "host_top": [{"name": k[:80], "self_cpu_ms": ms, "calls": n}
                     for k, ms, n in host[:top]],
        "spans": named,
    }
