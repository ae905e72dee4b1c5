"""Precision auditor: unintended low -> high dtype promotions, any f64
(counterpart of apex_tpu/analysis/precision.py).

The invariant (the amp design): in a bf16/fp16 step the wide-dtype
islands are CHOSEN — master weights and optimizer moments, norm and
softmax statistics, loss and cross-entropy math — and everything else
stays in the compute dtype. A stray ``.float()`` (or an op that silently
promotes a bf16 tensor against an f32 one) on a hidden-sized tensor
doubles its bandwidth and memory, and loss curves do not show it. This
pass reads the step's recorded aten ops (``passes.Recorder``):

- ``precision.promotion``: an op with a low-dtype floating input
  (bf16/fp16 by default) and an f32/f64 output — an explicit copy
  (``_to_copy``, ``copy_``) or an implicit promotion. Ops that only take
  their input's shape (``empty_like`` & co.) are not promotions. A
  backward op resolves to its forward op's line (``passes.op_site``), so
  the master-gradient copy of a weight cast is reported AT the cast, and
  allowlisted there with the master-weight reason.
- ``precision.f64``: any op producing an f64 value — nothing in the port
  computes in double precision.

On the card a hand-written kernel is one ctypes launch, which dispatches
no aten op: its internal f32 is as invisible as a ``pallas_call``'s body
is one equation. On the CPU its plain twin runs as aten ops and its f32
statistics show; the allowlist's precision entries carry that reason and
require no hit (``allowlist.py``).
"""

import collections
from typing import Iterable

from apex_tpu_torch.analysis.findings import Finding, SEV_ERROR
from apex_tpu_torch.analysis.passes import trace_pass

__all__ = ["precision_pass"]

_WIDE = ("float32", "float64")

#: ops whose outputs take only their inputs' shape (factories)
_SHAPE_ONLY = frozenset({
    "empty_like", "zeros_like", "ones_like", "full_like", "new_empty",
    "new_zeros", "new_ones", "new_full", "empty_strided", "rand_like",
    "randn_like", "randint_like",
})


@trace_pass("precision")
def precision_pass(ctx) -> Iterable[Finding]:
    low = set(ctx.low_dtypes)
    promos = collections.Counter()
    f64s = collections.Counter()
    for (op, ins, outs, site), count in ctx.recording.ops.items():
        lows = sorted(low.intersection(ins))
        wides = [d for d in outs if d in _WIDE]
        if lows and wides and op not in _SHAPE_ONLY:
            promos[(site, lows[0], wides[-1])] += count
            continue
        if "float64" in outs:
            f64s[(site, op)] += count
    for (site, old, new), count in sorted(promos.items()):
        yield ctx.finding(
            "precision.promotion",
            f"{old} -> {new} promotion in a low-precision step",
            site=site, severity=SEV_ERROR, count=count,
            data={"from": old, "to": new},
        )
    for (site, op), count in sorted(f64s.items()):
        yield ctx.finding(
            "precision.f64",
            f"float64 value produced by '{op}' "
            f"(double precision is never intentional here)",
            site=site, severity=SEV_ERROR, count=count,
            data={"primitive": op},
        )
