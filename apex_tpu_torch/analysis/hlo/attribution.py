"""Process-group ranks -> layout-axis attribution (counterpart of
apex_tpu/analysis/hlo/attribution.py).

A dispatched c10d op carries no axis name, only its process group's
global ranks (``parser.HloCollective.replica_groups``, the one group the
rank saw) or, for point-to-point, its edge of global ranks. For a given
layout every subset of its axes induces exactly one partition of the
ranks (the groups that vary along those axes and agree on all others),
so the mapping inverts: build the partition of every subset of the
>1-sized axes and look the observed groups up. A group that fits no
subset is ``"unknown"``: communication along a shape the layout does not
express.

The layout (the ``mesh`` argument, made by :func:`layout_mesh`) orders
its axes as ``parallel_state`` lays out the ranks, ``dp, pp, cp, tp``:
rank ``((d * pp + p) * cp + c) * tp + t``, the row-major order of JAX's
``reshape(dp, pp, cp, tp)``, so positions here are global ranks (over
the leading ranks of a sub-world layout).

Size-1 axes are dropped everywhere: a collective over them moves no
bytes (the ledger puts it among its dead entries), and a composite like
``"pp,cp,tp"`` at pp = cp = 1 canonicalizes to ``"tp"``. The ledger's
``world`` (a group of every rank of the layout) canonicalizes to the
live axes together, the label that group's partition carries.
"""

import dataclasses
import itertools
from typing import Dict, FrozenSet, Mapping, Sequence, Tuple

__all__ = [
    "AXIS_NONE",
    "AXIS_UNKNOWN",
    "LayoutMesh",
    "axis_of_collective",
    "canon_axis_key",
    "classify_replica_groups",
    "classify_source_target_pairs",
    "layout_mesh",
    "mesh_axis_partitions",
]

#: singleton groups: no traffic (a collective over a size-1 axis)
AXIS_NONE = "none"
#: a group set matching no subset of the layout's axes
AXIS_UNKNOWN = "unknown"

#: parallel_state's axis order (its AXIS_ORDER)
LAYOUT_ORDER = ("dp", "pp", "cp", "tp")

GroupKey = FrozenSet[FrozenSet[int]]


@dataclasses.dataclass(frozen=True)
class LayoutMesh:
    """The layout as the attribution reads it: axis names in rank-layout
    order and their sizes (JAX's ``mesh.axis_names`` and ``mesh.shape``)."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def layout_mesh(axes: Mapping[str, int]) -> LayoutMesh:
    """The :class:`LayoutMesh` of axis sizes (``targets.layout_axes()``),
    in ``parallel_state``'s order; a missing axis is of size 1."""
    names = tuple(n for n in LAYOUT_ORDER if n in axes) + tuple(
        n for n in axes if n not in LAYOUT_ORDER)
    return LayoutMesh(names, tuple(int(axes[n]) for n in names))


def _live_axes(mesh) -> Tuple[str, ...]:
    shape = dict(mesh.shape)
    return tuple(n for n in mesh.axis_names if shape[n] > 1)


def mesh_axis_partitions(mesh) -> Dict[GroupKey, str]:
    """``{rank partition: axis label}`` for every non-empty subset of the
    layout's >1-sized axes; labels join the subset's names in layout
    order (``"dp,tp"``), and a partition reachable with fewer axes keeps
    the shorter label."""
    shape = dict(mesh.shape)
    names = list(mesh.axis_names)
    sizes = [shape[n] for n in names]
    total = 1
    for s in sizes:
        total *= s
    strides = [1] * len(sizes)
    for i in range(len(sizes) - 2, -1, -1):
        strides[i] = strides[i + 1] * sizes[i + 1]
    live = _live_axes(mesh)
    out: Dict[GroupKey, str] = {}
    for r in range(1, len(live) + 1):
        for subset in itertools.combinations(live, r):
            axes = [names.index(n) for n in subset]
            groups: Dict[Tuple[int, ...], set] = {}
            for rank in range(total):
                coord = [(rank // strides[i]) % sizes[i]
                         for i in range(len(sizes))]
                rest = tuple(c for i, c in enumerate(coord) if i not in axes)
                groups.setdefault(rest, set()).add(rank)
            key: GroupKey = frozenset(frozenset(g) for g in groups.values())
            out.setdefault(key, ",".join(subset))
    return out


def classify_replica_groups(
        mesh, replica_groups: Sequence[Sequence[int]],
        partitions: Dict[GroupKey, str] = None) -> str:
    """The axis label of a collective's groups: an axis-subset label
    (``"tp"``, ``"dp,tp"``), :data:`AXIS_NONE` for singleton groups, or
    :data:`AXIS_UNKNOWN`. Every group of a partition (the JAX package's
    HLO view) looks the partition up; fewer groups (a rank's view: the
    one group it saw) take the smallest subset whose partition holds
    each of them. No groups at all is the whole layout."""
    if not replica_groups:
        live = _live_axes(mesh)
        return ",".join(live) if live else AXIS_NONE
    if len(replica_groups[0]) <= 1:
        return AXIS_NONE
    if partitions is None:
        partitions = mesh_axis_partitions(mesh)
    key: GroupKey = frozenset(frozenset(int(x) for x in g)
                              for g in replica_groups)
    if key in partitions:
        return partitions[key]
    for part, label in sorted(partitions.items(),
                              key=lambda kv: (kv[1].count(",") + 1, kv[1])):
        if key <= part:
            return label
    return AXIS_UNKNOWN


def classify_source_target_pairs(
        mesh, pairs: Sequence[Sequence[int]],
        partitions: Dict[GroupKey, str] = None) -> str:
    """The axis label of point-to-point edges: the smallest axis subset
    one of whose groups holds both ends of every edge;
    :data:`AXIS_NONE` for no edge and :data:`AXIS_UNKNOWN` when no subset
    holds them all."""
    if not pairs:
        return AXIS_NONE
    if partitions is None:
        partitions = mesh_axis_partitions(mesh)
    for key, label in sorted(partitions.items(),
                             key=lambda kv: (kv[1].count(",") + 1, kv[1])):
        if all(any(int(s) in g and int(d) in g for g in key)
               for s, d in pairs):
            return label
    return AXIS_UNKNOWN


def axis_of_collective(mesh, c, partitions=None) -> str:
    """The axis label of one ``parser.HloCollective``."""
    if c.source_target_pairs:
        return classify_source_target_pairs(mesh, c.source_target_pairs,
                                            partitions)
    return classify_replica_groups(mesh, c.replica_groups, partitions)


def canon_axis_key(mesh, axis_key: str) -> str:
    """A ledger axis key (names joined in call order, ``"pp,cp,tp"``)
    onto the attribution labels: size-1 axes dropped, layout order; the
    ledger's ``world`` is every live axis. Names the layout does not know
    are kept (sorted last), so a mismatch stays visible."""
    names = [n for n in axis_key.split(",") if n]
    shape = dict(mesh.shape)
    if "world" in names:
        names = [n for n in names if n != "world"] + list(_live_axes(mesh))
    known = [n for n in mesh.axis_names if n in names and shape[n] > 1]
    foreign = sorted(n for n in set(names) if n not in shape)
    out = known + foreign
    return ",".join(out) if out else AXIS_NONE
