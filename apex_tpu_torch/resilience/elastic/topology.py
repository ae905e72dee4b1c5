"""Checkpoint topology block: the manifest's record of how the state was
laid out (counterpart of apex_tpu/resilience/elastic/topology.py).

A checkpoint saved on layout A restores on layout B only if the restore
can answer, per leaf: what was its GLOBAL shape and dtype, and how was
it split over the ranks. The ZeRO flat buffers bake the data-parallel
size into their very length (the flat parameter vector is zero-padded
to a multiple of dp before it is sharded), so without the block a change
of layout is invisible until the restore fails, or silently misloads.
:func:`topology_block` records it at save time from the live state and
this process's ``parallel_state`` (``elastic.layout``), and
``resilience.integrity.write_manifest`` embeds it in the manifest under
``"topology"`` (manifest version 2, as the JAX package's):

    {"version": 1,
     "mesh": {"axes": {"dp": 4, "pp": 1, "cp": 1, "tp": 1}, "devices": 4},
     "leaves": [{"path": "[0]['transformer']['layer_0']...",
                 "shape": [768, 2304], "dtype": "float32", "spec": null,
                 "zero_shard_axis": null, "ef": false}, ...]}

``shape`` is the leaf's global shape, ``spec`` its partition in the JAX
block's form (a list with an axis name per split dim; null for a
replicated leaf), ``zero_shard_axis`` (``"dp"``) marks the ZeRO flat
buffers, the only leaves whose global shape may change across a change
of layout (``reshard`` regroups them), and ``ef`` marks the
error-feedback residuals (the ``ef_residual`` naming contract), advisory
state the restore resets rather than refuses over.

Manifests written before the block existed lack the key; the elastic
restore treats them as predating the manifest-format upgrade and falls
back to the newest checkpoint that carries one.
"""

from typing import Any, Dict, Optional

__all__ = ["TOPOLOGY_VERSION", "ElasticRestoreError", "is_ef_path",
           "live_mesh", "same_mesh", "topology_block"]

TOPOLOGY_VERSION = 1


class ElasticRestoreError(RuntimeError):
    """A checkpoint/target layout mismatch the elastic restore refuses to
    guess through. A ``RuntimeError``, so the examples' incompatible-
    payload ``ValueError`` handling never turns a refusal into a fresh
    start."""


def is_ef_path(path_str: str) -> bool:
    """Is a keystr path an error-feedback residual leaf (its final
    segment ``.ef_residual`` or ``['ef_residual']``)?"""
    return path_str.endswith((".ef_residual", "['ef_residual']"))


def live_mesh() -> Dict[str, Any]:
    """``{"axes": {"dp", "pp", "cp", "tp"}, "devices"}`` of this process's
    ``parallel_state`` layout, every axis recorded as JAX's
    ``mesh_axes`` records its mesh's (a world of one when it is not
    initialized; ``devices`` counts the layout's ranks, which may be a
    leading subset of the world)."""
    from apex_tpu_torch.parallel import parallel_state as ps

    if not ps.model_parallel_is_initialized():
        return {"axes": {"dp": 1, "pp": 1, "cp": 1, "tp": 1}, "devices": 1}
    tp = ps.get_tensor_model_parallel_world_size()
    pp = ps.get_pipeline_model_parallel_world_size()
    dp = ps.get_data_parallel_world_size()
    cp = ps.get_context_parallel_world_size()
    return {"axes": {"dp": dp, "pp": pp, "cp": cp, "tp": tp},
            "devices": dp * tp * pp * cp}


def same_mesh(a: Optional[dict], b: Optional[dict]) -> bool:
    """Do two topology meshes describe one layout? An axis a mesh leaves
    out has size 1 (manifests written before every axis was recorded
    lack ``cp``)."""
    if a is None or b is None:
        return a is b

    def axes(m):
        return {k: v for k, v in (m.get("axes") or {}).items() if v != 1}
    return axes(a) == axes(b) and a.get("devices") == b.get("devices")


def topology_block(tree: Any, mesh: Optional[dict] = None,
                   layout=None) -> dict:
    """The manifest topology block of a live state tree (module
    docstring): each leaf's global shape and split under ``layout``
    (default: ``elastic.layout.StateLayout`` of ``tree`` on this
    process's layout). ``mesh`` defaults to :func:`live_mesh`. Leaf
    paths are the integrity fingerprint's, so the two blocks join per
    leaf."""
    from apex_tpu_torch.resilience.elastic.layout import ZERO, StateLayout
    from apex_tpu_torch.utils.pytree import tree_leaves_with_path

    mesh = live_mesh() if mesh is None else mesh
    layout = StateLayout(tree) if layout is None else layout
    leaves = []
    for i, (path, leaf) in enumerate(tree_leaves_with_path(tree)):
        split = layout.splits[i]
        leaves.append({
            "path": path,
            "shape": [int(d) for d in layout.global_shape(i)],
            "dtype": str(leaf.dtype).replace("torch.", ""),
            "spec": layout.spec(i),
            "zero_shard_axis": "dp" if split == ZERO else None,
            "ef": is_ef_path(path),
        })
    return {"version": TOPOLOGY_VERSION, "mesh": mesh, "leaves": leaves}
