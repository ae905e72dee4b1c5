"""Named timers + profiler annotations (counterpart of
apex_tpu/utils/timers.py).

Reference parity: apex/transformer/pipeline_parallel/_timers.py (`_Timer`
:6 with cuda synchronize, `Timers` with log/write). The barrier is
``torch.cuda.synchronize`` on the card (a no-op on the CPU), and the
annotations are ``torch.profiler.record_function`` ranges.

Three timing layers, three questions (don't conflate them):

- ``Timers``/``_Timer`` here — named INTERVAL averages ("how long is a
  step lately"), barriered, reported per log interval as
  ``kind="timer"`` records (``MetricRouter.timer_write_fn``).
- ``step_annotation``/``annotate``/``trace`` — DEVICE-time markers a
  profiler capture segments on: a step's range is named
  ``ProfilerStep#<N>``, the name ``torch.profiler`` gives its own step
  marks, so ``utils.profiling.profile_device(spans=...)`` and the Chrome
  traces ``monitor.ProfilerTrigger`` writes split into steps on it.
- ``apex_tpu_torch.monitor.goodput.span`` — run-LIFECYCLE wall-clock
  spans the goodput accountant partitions into productive/badput. The
  examples wrap each loop iteration in BOTH a step span and a step
  annotation — same boundaries, different consumers.
"""

import time
from contextlib import contextmanager
from typing import Dict

import torch

__all__ = ["Timers", "annotate", "step_annotation", "trace"]


def _barrier(on) -> None:
    """Wait for the device work ``on`` (a tensor, or anything truthy)
    hangs on: the whole card, as the reference's timers do."""
    if on is None:
        return
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class _Timer:
    """(ref: _timers.py:6)"""

    def __init__(self, name: str):
        self.name = name
        self.elapsed_ = 0.0
        self.started_ = False
        self.start_time = 0.0

    def start(self, barrier_on=None):
        assert not self.started_, f"timer {self.name} already started"
        _barrier(barrier_on)
        self.start_time = time.perf_counter()
        self.started_ = True

    def stop(self, barrier_on=None):
        assert self.started_, f"timer {self.name} not started"
        _barrier(barrier_on)
        self.elapsed_ += time.perf_counter() - self.start_time
        self.started_ = False

    def reset(self):
        self.elapsed_ = 0.0
        self.started_ = False

    def elapsed(self, reset: bool = True) -> float:
        started = self.started_
        if started:
            self.stop()
        e = self.elapsed_
        if reset:
            self.reset()
        if started:
            self.start()
        return e


class Timers:
    """(ref: _timers.py Timers — log() prints "time (ms)"; the TB writer
    becomes an optional callback so any metrics sink plugs in)."""

    def __init__(self, write_fn=None):
        self.timers: Dict[str, _Timer] = {}
        self.write_fn = write_fn

    def __call__(self, name: str) -> _Timer:
        if name not in self.timers:
            self.timers[name] = _Timer(name)
        return self.timers[name]

    def write(self, names, iteration: int, normalizer: float = 1.0,
              reset: bool = True):
        """Push each named timer's elapsed seconds (over ``normalizer``)
        to ``write_fn``; ``reset`` (the default, as the reference's
        ``Timers.write``) makes each write report its own interval."""
        assert normalizer > 0.0
        for name in names:
            value = self.timers[name].elapsed(reset=reset) / normalizer
            if self.write_fn is not None:
                self.write_fn(f"{name}-time", value, iteration)

    def log(self, names=None, normalizer: float = 1.0, reset: bool = True) -> str:
        names = names if names is not None else list(self.timers)
        assert normalizer > 0.0
        string = "time (ms)"
        for name in names:
            t = self.timers[name].elapsed(reset=reset) * 1000.0 / normalizer
            string += f" | {name}: {t:.2f}"
        print(string, flush=True)
        return string


def annotate(name: str):
    """NVTX-range analogue: a ``record_function`` range, named ``name``
    in a profiler capture (ref: DDP prof ranges,
    parallel/distributed.py:363-364)."""
    return torch.profiler.record_function(name)


def step_annotation(step: int, name: str = "ProfilerStep"):
    """Step marker for profiler traces: a ``record_function`` range named
    ``ProfilerStep#<step>``. Wrap the WHOLE step including its host sync,
    or the step's device tail is attributed to the next step."""
    return torch.profiler.record_function(f"{name}#{int(step)}")


@contextmanager
def trace(log_dir: str, **kwargs):
    """Capture a ``torch.profiler`` trace of the enclosed block into
    ``<log_dir>/trace.json`` (a Chrome trace); ``annotate`` and
    ``step_annotation`` ranges inside the block appear as named spans.
    The card is synchronized before the profiler stops, so in-flight
    kernels land in the window. ``**kwargs`` go to
    ``torch.profiler.profile`` (``activities`` defaults to the CPU, and
    CUDA where a card is present)."""
    import os

    if "activities" not in kwargs:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        kwargs["activities"] = acts
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(**kwargs)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
