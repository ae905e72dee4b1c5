"""apex_tpu_torch.analysis.donation: declared in-place state against the
storage the step really reused.

Three small steps over a 1 MiB fp32 state (262,144 elements) on the CPU,
each recorded once (``passes.StepContext``): a step that updates its
declared state in place is clean; one that rebinds a declared tensor to
a new one gives ``donation.rejected`` (``rebound``), and one that returns
the new value of a declared tensor in a fresh storage gives it too
(``fresh-output``); one that returns a new copy of an undeclared 1 MiB
state gives ``donation.missed`` (JAX's "a second copy of the model"),
and a state under the floor gives nothing. A target that declares
nothing is not audited, as in JAX.
"""

import types

import torch

from apex_tpu_torch.analysis import passes

N = 1 << 18  # fp32 elements: 1 MiB


def _run(fn, state, donate, floor=None):
    target = passes.StepTarget("t", fn, state, donate_argnums=donate,
                               donation_min_bytes=floor)
    return passes.run_passes(target, passes=["donation"])


def test_in_place_update_is_clean():
    def step(w, m):
        m.mul_(0.9).add_(w)
        w.add_(m, alpha=-0.1)
        return w, m

    assert _run(step, (torch.ones(N), torch.zeros(N)), (0, 1)) == []


def test_rebinding_a_declared_tensor_is_rejected():
    state = types.SimpleNamespace()

    def step(holder):
        holder.m = holder.m * 0.9  # a new tensor under the old name

    # a dataclass-like holder: the recorder walks its fields
    import dataclasses

    @dataclasses.dataclass
    class Opt:
        m: torch.Tensor

    opt = Opt(torch.zeros(N))
    found = _run(step, (opt,), (0,))
    assert [(f.rule, f.severity, f.data["leaf"], f.data["stage"])
            for f in found] == [("donation.rejected", "error", "holder.m",
                                 "rebound")]
    del state


def test_returning_a_declared_tensor_anew_is_rejected():
    def step(w):
        return w * 2.0

    found = _run(step, (torch.ones(N),), (0,))
    assert [(f.rule, f.data["stage"]) for f in found] == [
        ("donation.rejected", "fresh-output")]


def test_copying_an_undeclared_state_is_missed():
    def step(w, m):
        w.add_(1.0)
        return w, m + 1.0  # m's new value in a fresh storage

    found = _run(step, (torch.ones(N), torch.zeros(N)), (0,))
    assert [(f.rule, f.severity, f.data["leaf"], f.data["bytes"])
            for f in found] == [("donation.missed", "warning", "m", 4 * N)]


def test_small_state_and_undeclared_targets_are_quiet():
    def step(w):
        return w + 1.0

    assert _run(step, (torch.ones(1000),), ()) == []
    assert _run(step, (torch.ones(N),), None) == []
    # under its floor a rejected donation is advisory
    found = _run(step, (torch.ones(1000),), (0,))
    assert [(f.rule, f.severity) for f in found] == [
        ("donation.rejected", "info")]
