"""Device time by kernel from a ``torch.profiler`` run on the card."""

import time

import torch

__all__ = ["profile_device"]


def profile_device(fn, top: int = 15) -> dict:
    """Runs ``fn()`` under ``torch.profiler`` (CPU and CUDA activities)
    and returns the wall time, the device time summed over kernels, the
    device's idle share of the wall time, the ``top`` kernels by device
    time and the ``top`` host operations by their own (self) CPU time.
    ``fn`` should end in ``torch.cuda.synchronize()``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only: a CPU op's device time repeats its kernels'
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU), key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    return {
        "gpu": torch.cuda.get_device_name(0),
        "wall_ms": wall * 1e3, "device_ms": device_ms,
        "device_idle_share": 1.0 - device_ms / (wall * 1e3),
        "top": [{"name": k[:80], "device_ms": ms, "calls": n}
                for k, ms, n in rows[:top]],
        "host_top": [{"name": k[:80], "self_cpu_ms": ms, "calls": n}
                     for k, ms, n in host[:top]],
    }
