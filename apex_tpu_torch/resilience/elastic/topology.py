"""Checkpoint topology block: the manifest's record of how the state was
laid out (counterpart of apex_tpu/resilience/elastic/topology.py).

A checkpoint is restorable as it is only onto the layout that saved it:
the same world, the same tensor-, pipeline- and data-parallel sizes, and
each leaf in the same global shape and dtype. :func:`topology_block`
records that at save time, and ``resilience.integrity.write_manifest``
embeds it in the manifest under ``"topology"`` (manifest version 2, as
the JAX package's):

    {"version": 1,
     "mesh": {"axes": {"dp": 1, "tp": 1, "pp": 1}, "devices": 1},
     "leaves": [{"path": "[0]['transformer']['layer_0']...",
                 "shape": [768, 2304], "dtype": "float32", "spec": null,
                 "zero_shard_axis": null, "ef": false}, ...]}

The port saves at a world of one, where every leaf is whole on its
rank: ``spec`` is null (replicated, the JAX package's reading of a leaf
without a named sharding) and the global shape is the leaf's own. The
resharder that restores across a change of layout
(``resilience/elastic/reshard.py`` in the JAX package), and checkpoints
at world > 1, come with a later slice of the port; until then
:func:`check_restorable` refuses a restore whose saved layout differs
from the live one (:class:`ElasticRestoreError`), and never loads a
misplaced state.
"""

from typing import Any, Dict, Optional

from apex_tpu_torch.utils.pytree import tree_leaves_with_path

__all__ = ["TOPOLOGY_VERSION", "ElasticRestoreError", "check_restorable",
           "is_ef_path", "live_mesh", "topology_block"]

TOPOLOGY_VERSION = 1

#: where a restore across a change of layout will come from
RESHARD_SLICE = ("the elastic resharder (resilience/elastic/reshard.py), "
                 "which a later slice of the port brings with checkpoints "
                 "at world > 1")


class ElasticRestoreError(RuntimeError):
    """A restore whose saved layout differs from the live one. A
    ``RuntimeError``, so the examples' incompatible-payload ``ValueError``
    handling never turns a refusal into a fresh start."""


def is_ef_path(path_str: str) -> bool:
    """Is a keystr path an error-feedback residual leaf (its final
    segment ``.ef_residual`` or ``['ef_residual']``)?"""
    return path_str.endswith((".ef_residual", "['ef_residual']"))


def live_mesh() -> Dict[str, Any]:
    """``{"axes": {"dp", "tp", "pp"}, "devices"}`` of this process's
    ``parallel_state`` (a world of one when it is not initialized)."""
    from apex_tpu_torch.parallel import parallel_state as ps

    if not ps.model_parallel_is_initialized():
        return {"axes": {"dp": 1, "tp": 1, "pp": 1}, "devices": 1}
    tp = ps.get_tensor_model_parallel_world_size()
    pp = ps.get_pipeline_model_parallel_world_size()
    dp = ps.get_data_parallel_world_size()
    cp = ps.get_context_parallel_world_size()
    axes = {"dp": dp, "tp": tp, "pp": pp}
    if cp > 1:
        axes["cp"] = cp
    return {"axes": axes, "devices": dp * tp * pp * cp}


def topology_block(tree: Any, mesh: Optional[dict] = None) -> dict:
    """The manifest topology block of a live state tree (module
    docstring); ``mesh`` defaults to :func:`live_mesh`. Leaf paths are
    the integrity fingerprint's, so the two blocks join per leaf."""
    mesh = live_mesh() if mesh is None else mesh
    leaves = []
    for path, leaf in tree_leaves_with_path(tree):
        leaves.append({
            "path": path,
            "shape": [int(d) for d in leaf.shape],
            "dtype": str(leaf.dtype).replace("torch.", ""),
            "spec": None,
            "zero_shard_axis": None,
            "ef": is_ef_path(path),
        })
    return {"version": TOPOLOGY_VERSION, "mesh": mesh, "leaves": leaves}


def check_restorable(saved: Optional[dict], mesh: Optional[dict] = None
                     ) -> None:
    """Raise :class:`ElasticRestoreError` when the saved topology block's
    layout (world and parallel sizes) differs from the live one
    (``mesh``, default :func:`live_mesh`). A manifest without a block
    (written before the block existed) passes; a leaf of another shape
    or dtype is refused by the restore's own structure check."""
    if saved is None:
        return
    mesh = live_mesh() if mesh is None else mesh
    if saved.get("mesh") is not None and saved["mesh"] != mesh:
        raise ElasticRestoreError(
            f"the checkpoint was saved on {saved['mesh']}, this process "
            f"runs {mesh}: restoring across a change of layout needs "
            f"{RESHARD_SLICE}")
