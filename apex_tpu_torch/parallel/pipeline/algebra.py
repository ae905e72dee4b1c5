"""Schedule algebra: tick counts and bubble fractions of the pipeline
schedules (counterpart of apex_tpu/parallel/pipeline/algebra.py, with
its numbers exactly).

The JAX module counts the ticks of its compiled scans; the host-driven
schedules of ``schedules.py`` run the same dependence graph, so the
counts are the same model of them: per stage, one microbatch-stage of
forward work F, activation-gradient work B and weight-gradient work W
each cost one unit, and a fused backward (``torch.autograd.backward``
computes B and W together) costs two. One step is ``3 M`` useful units
a stage.

- ``no_pipelining``: gradient accumulation, ``3 M`` units, no bubble;
- ``1f1b``: span ``3 (M + P - 1)``, bubble ``(P - 1) / (M + P - 1)``;
- ``interleaved``: span ``3 (V M + P - 1)``, bubble
  ``(P - 1) / (V M + P - 1)``, the 1F1B bubble shrunk by 1/V (M % P == 0);
- ``zero_bubble``: the B/W split (``forward_backward_zero_bubble``), F
  and B on the critical path and W deferred into the ``2 (P - 1)`` bubble
  slots: bubble ``max(0, 2 (P - 1) - M)`` units, zero at
  ``M >= 2 (P - 1)``.

These are dependence-graph bounds; what a run realizes is measured on
the card.
"""

import dataclasses
from typing import Callable, Dict, List

__all__ = [
    "ScheduleCost",
    "SCHEDULES",
    "schedule_cost",
    "compare",
    "bubble_fraction_1f1b",
]


@dataclasses.dataclass(frozen=True)
class ScheduleCost:
    """Predicted cost of one schedule at (P, M, V), in work units.

    ``forward_ticks``/``backward_ticks`` are the actual scan lengths the
    schedule compiles; ``span_units`` is the per-stage wall span in F/B/W
    units (a fused-backward tick counts 2); ``useful_units`` is always
    3·M·V per rank. The identity ``span_units == useful_units +
    bubble_units`` holds by construction and is test-pinned.
    """

    name: str
    num_stages: int  # P
    num_microbatches: int  # M
    num_model_chunks: int  # V
    forward_ticks: int
    backward_ticks: int
    filler_ticks: int  # trailing deferred-W ticks the bubbles couldn't hold
    span_units: int
    useful_units: int

    @property
    def bubble_units(self) -> int:
        return self.span_units - self.useful_units

    @property
    def bubble_fraction(self) -> float:
        return self.bubble_units / self.span_units if self.span_units else 0.0


def _validate(P: int, M: int, V: int) -> None:
    if P < 1 or M < 1 or V < 1:
        raise ValueError(
            f"schedule algebra needs P, M, V >= 1; got P={P} M={M} V={V}"
        )


def no_pipelining_cost(
    num_stages: int, num_microbatches: int, num_model_chunks: int = 1
) -> ScheduleCost:
    """Grad accumulation: M forward + M fused-backward iterations, no
    stages, no bubble (``forward_backward_no_pipelining``)."""
    P, M, V = num_stages, num_microbatches, num_model_chunks
    _validate(P, M, V)
    return ScheduleCost(
        name="no_pipelining", num_stages=1, num_microbatches=M,
        num_model_chunks=1, forward_ticks=M, backward_ticks=M,
        filler_ticks=0, span_units=3 * M, useful_units=3 * M,
    )


def one_f_one_b_cost(
    num_stages: int, num_microbatches: int, num_model_chunks: int = 1
) -> ScheduleCost:
    """The compiled 1F1B-equivalent
    (``forward_backward_pipelining_without_interleaving``): forward scan
    of M + P - 1 ticks at 1 unit, reversed scan at 2 units (B and W
    fused by the grad transpose). Bubble fraction (P-1)/(M+P-1)."""
    P, M, V = num_stages, num_microbatches, num_model_chunks
    _validate(P, M, V)
    T = M + P - 1
    return ScheduleCost(
        name="1f1b", num_stages=P, num_microbatches=M, num_model_chunks=1,
        forward_ticks=T, backward_ticks=T, filler_ticks=0,
        span_units=3 * T, useful_units=3 * M,
    )


def interleaved_cost(
    num_stages: int, num_microbatches: int, num_model_chunks: int = 2
) -> ScheduleCost:
    """Virtual PP (``forward_backward_pipelining_with_interleaving``):
    one scan of V*M + P - 1 one-chunk ticks per direction; P - 1 of them
    are bubble, so the fraction shrinks by 1/V. Requires M % P == 0, as
    the schedule itself asserts."""
    P, M, V = num_stages, num_microbatches, num_model_chunks
    _validate(P, M, V)
    if V < 2:
        raise ValueError(
            f"interleaved schedule needs num_model_chunks >= 2 (got {V}): "
            f"V=1 is just 1F1B, and silently computing its bubble here "
            f"would mislabel the prediction"
        )
    if M % P != 0:
        raise ValueError(
            f"interleaved schedule requires num_microbatches ({M}) % "
            f"pipeline size ({P}) == 0"
        )
    T = V * M + P - 1
    return ScheduleCost(
        name="interleaved", num_stages=P, num_microbatches=M,
        num_model_chunks=V, forward_ticks=T, backward_ticks=T,
        filler_ticks=0, span_units=3 * T, useful_units=3 * M * V,
    )


def zero_bubble_cost(
    num_stages: int, num_microbatches: int, num_model_chunks: int = 1
) -> ScheduleCost:
    """The B/W split (``forward_backward_zero_bubble``): F and B each
    run an M + P - 1 tick scan on the p2p critical path; every stage
    holds P - 1 bubble slots in each, and the M deferred-W units fill
    them. W the 2(P-1) slots can't hold runs as trailing filler ticks.

    span = 2(M+P-1) + max(0, M - 2(P-1)); bubble = max(0, 2(P-1) - M).
    Zero bubble at M >= 2(P-1); always < 1F1B's (P-1)/(M+P-1).

    W is charged one unit, the weight-gradient GEMMs alone. The port's W
    (``torch.autograd.grad`` over the parameters) also repeats B's
    activation backward, so this model undercounts its work.
    """
    P, M, V = num_stages, num_microbatches, num_model_chunks
    _validate(P, M, V)
    T = M + P - 1
    slots = 2 * (P - 1)  # per-stage bubble slots across the F and B scans
    filler = max(0, M - slots)
    return ScheduleCost(
        name="zero_bubble", num_stages=P, num_microbatches=M,
        num_model_chunks=1, forward_ticks=T, backward_ticks=T,
        filler_ticks=filler, span_units=2 * T + filler,
        useful_units=3 * M,
    )


#: registered schedule cost models — keys are the names the bench
#: section and the timeline join use
SCHEDULES: Dict[str, Callable[..., ScheduleCost]] = {
    "no_pipelining": no_pipelining_cost,
    "1f1b": one_f_one_b_cost,
    "interleaved": interleaved_cost,
    "zero_bubble": zero_bubble_cost,
}


def schedule_cost(
    name: str,
    num_stages: int,
    num_microbatches: int,
    num_model_chunks: int = 1,
) -> ScheduleCost:
    """Cost of one registered schedule at (P, M, V)."""
    if name not in SCHEDULES:
        raise KeyError(
            f"unknown schedule {name!r}; registered: {sorted(SCHEDULES)}"
        )
    return SCHEDULES[name](num_stages, num_microbatches, num_model_chunks)


def compare(
    num_stages: int, num_microbatches: int, num_model_chunks: int = 2
) -> List[ScheduleCost]:
    """Every registered schedule's cost at one (P, M, V), bubble-sorted
    (best first) — the table the bench section prints and the docs
    quote. The interleaved row is skipped when M % P != 0 (the schedule
    itself would refuse that shape)."""
    out = []
    for name in SCHEDULES:
        try:
            out.append(schedule_cost(
                name, num_stages, num_microbatches, num_model_chunks
            ))
        except ValueError:
            continue
    return sorted(out, key=lambda c: (c.bubble_fraction, c.name))


def bubble_fraction_1f1b(num_stages: int, num_microbatches: int) -> float:
    """The classic (P-1)/(M+P-1) — the number every zero-bubble claim is
    measured against."""
    _validate(num_stages, num_microbatches, 1)
    return (num_stages - 1) / (num_microbatches + num_stages - 1)
