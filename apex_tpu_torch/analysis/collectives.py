"""Collective-safety validator: groups, permutations, pipeline edges
(counterpart of apex_tpu/analysis/collectives.py).

Every collective of the port goes through ``parallel_state``'s helpers
(lint.raw-collective), which record themselves in the traffic ledger, so
the ledger of the audited step IS the step's communication program. This
pass reads it (``passes.Recording.ledger``) against the layout's axes and
the pipeline edge grammar (``parallel/pipeline/p2p.py``):

- ``collective.unknown-axis`` — a collective over a group that is none
  of the layout's axes (``monitor.xray.ledger.axis_of`` says ``group``):
  traffic on a group the layout does not know.
- ``collective.dead-traffic`` — a collective over a group of one rank
  (the ledger's ``dead`` list, which no byte total reads). It moves
  nothing, but it is a call site to gate before the group grows —
  warning severity.
- ``collective.non-permutation`` — the point-to-point edges one site
  sends under one tag over one axis are no partial permutation:
  duplicate sources, duplicate destinations, self-edges, or ranks
  outside the group.
- ``collective.mismatched-edge`` — the static deadlock check for
  pipeline schedules: those edges form a linear chain shift with a
  missing interior link, so the stream stops at the gap. Full rings and
  the last -> first wrap edge are valid; other edge sets get the
  permutation check only.

JAX's ``ppermute`` equation carries the whole axis's edges. A port rank
records only its own sends (``src``/``dst`` in the group), so on a world
of several ranks the recording gathers every rank's edges first
(``passes.StepContext``); a site's edges are the union over the step and
the ranks, keyed by its axis and tag (a schedule sends both of its
streams from one helper, each under its own tag).
"""

from typing import Iterable, List, Optional, Sequence, Tuple

from apex_tpu_torch.analysis.findings import Finding, SEV_ERROR, SEV_WARNING
from apex_tpu_torch.analysis.passes import trace_pass

__all__ = ["collective_pass", "check_perm", "chain_gaps"]

#: the ledger's axis names that are the layout's own groups
_LAYOUT_GROUPS = ("world",)


def check_perm(
    perm: Sequence[Tuple[int, int]], axis_size: Optional[int]
) -> List[str]:
    """Problems making ``perm`` not a partial permutation (empty = ok)."""
    problems = []
    srcs = [s for s, _ in perm]
    dsts = [d for _, d in perm]
    dup_src = sorted({s for s in srcs if srcs.count(s) > 1})
    dup_dst = sorted({d for d in dsts if dsts.count(d) > 1})
    if dup_src:
        problems.append(f"duplicate source rank(s) {dup_src}")
    if dup_dst:
        problems.append(f"duplicate destination rank(s) {dup_dst}")
    selfed = sorted({s for s, d in perm if s == d})
    if selfed:
        problems.append(f"self-edge(s) at rank(s) {selfed}")
    if axis_size is not None:
        oob = sorted({r for r in srcs + dsts if not 0 <= r < axis_size})
        if oob:
            problems.append(
                f"rank(s) {oob} outside the axis (size {axis_size})"
            )
    return problems


def chain_gaps(
    perm: Sequence[Tuple[int, int]], axis_size: int
) -> Optional[List[int]]:
    """Interior gaps of a linear pipeline chain, or None when ``perm`` is
    not a linear chain (ring, wrap edge, arbitrary shuffle — no chain
    semantics to check).

    A linear chain is a uniform +-1 shift with NO wrap edge: the
    ``p2p.forward_edges``/``backward_edges`` grammar. A gap is a stage
    strictly inside the chain's span whose outgoing edge is missing —
    everything past it waits on data that never crosses the gap.
    """
    if not perm or axis_size < 3:
        return None
    for sig in (1, -1):
        if all(d - s == sig for s, d in perm):
            srcs = sorted(s for s, _ in perm)
            return [
                r for r in range(srcs[0] + 1, srcs[-1])
                if r not in set(srcs)
            ]
    return None


@trace_pass("collective")
def collective_pass(ctx) -> Iterable[Finding]:
    rec = ctx.recording
    axes = ctx.axes
    known = None if axes is None else set(axes) | set(_LAYOUT_GROUPS)
    seen = set()
    for e in rec.ledger.entries + rec.ledger.dead:
        if known is not None and e.axis not in known and \
                (e.site, e.op, e.axis) not in seen:
            seen.add((e.site, e.op, e.axis))
            yield ctx.finding(
                "collective.unknown-axis",
                f"'{e.op}' over a group that is none of the layout's axes "
                f"{tuple(sorted(axes))}",
                site=e.site, severity=SEV_ERROR,
                data={"op": e.op, "axis": e.axis},
            )
    for e in rec.ledger.dead:
        yield ctx.finding(
            "collective.dead-traffic",
            f"'{e.op}' over a one-rank {e.axis!r} group is dead traffic — "
            f"it moves nothing today; gate the call site so it does not "
            f"become real bytes when the group grows",
            site=e.site, severity=SEV_WARNING,
            data={"op": e.op, "axis": e.axis},
        )
    for (site, axis, tag, size), edges in sorted(rec.edges.items()):
        perm = sorted(edges)
        problems = check_perm(perm, size)
        if problems:
            yield ctx.finding(
                "collective.non-permutation",
                f"p2p over axis {axis!r} (tag {tag}) with invalid edges "
                f"{perm}: " + "; ".join(problems),
                site=site, severity=SEV_ERROR,
                data={"axis": axis, "perm": str(perm)},
            )
            continue
        gaps = chain_gaps(perm, size)
        if gaps:
            yield ctx.finding(
                "collective.mismatched-edge",
                f"pipeline chain over axis {axis!r} has no edge out of "
                f"stage(s) {gaps}: downstream stages' receives wait but "
                f"the stream never crosses the gap (static deadlock) — "
                f"edges {perm}",
                site=site, severity=SEV_ERROR,
                data={"axis": axis, "gaps": str(gaps), "perm": str(perm)},
            )
