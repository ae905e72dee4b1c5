"""Elastic restore: load a checkpoint saved on layout A onto layout B
(counterpart of apex_tpu/resilience/elastic/reshard.py).

A job stopped on 4 ranks must resume on 2 (or 8) without a human
re-slicing its checkpoints. A checkpoint holds every leaf as its global
array (``elastic.layout``), so two problems remain:

- **Plain re-layout.** Parameters and replicated scalars keep their
  global shape across a change of layout: restoring them is cutting the
  new rank's part out of the global array. The manifest's topology
  block is checked leaf by leaf first, and any mismatch the restore
  cannot prove safe is refused with a reason
  (:class:`ElasticRestoreError`) instead of guessed at.
- **Pipeline and context parallelism.** A restore at the saved pp
  reshards over dp (and cp: every leaf but the per-rank residuals is
  replicated over cp, so a change of cp is a change of dp for the ZeRO
  buffers, as in JAX); a change of pp is refused with an error that
  names the axis, as JAX's restore refuses it (the stacked stage leaves
  change shape and the stages' trees their leaves).
- **ZeRO regrouping.** The ZeRO flat buffers bake the dp size into
  their global length (zero padding to a multiple of dp), so a change
  of dp regroups them: strip or extend the padding to the new dp's
  padded length (``optimizers.zero_regroup_flat``), then take the new
  shard. Only leaves the block marks ``zero_shard_axis`` may change
  shape so, and only by re-padding one common unpadded length; a
  truncation that would drop a nonzero value is state, not padding, and
  refuses.

Integrity survives the trip: the step's files are verified against
their manifest first (deep, on the layout's first rank, whose verdict
every rank takes), and each restored leaf's crc32 is checked against the
save-time fingerprint over the global array, the bytes that are then
regrouped and cut. A newest step whose manifest predates the topology
block is skipped with a warning and the walk falls back to the newest
one that carries a block; a mismatch on a topology-bearing step raises
(older steps would mismatch the same way, and silently resuming stale
state is worse than stopping).

Error-feedback residuals are advisory: a target-only residual leaf
(compression newly on) is zero-filled, a checkpoint-only one
(compression turned off) is not restored, and a residual whose layout
changed is reset to zero with a warning, never refused over.

Every rank of the layout calls :func:`restore_resharded` together; the
result is new tensors in the target's structure, on its leaves' devices
(copy them into the live state with ``utils.pytree.tree_copy_``).
"""

import logging
import os
import zlib
from typing import Any, Dict, List, Optional, Tuple

import torch

from apex_tpu_torch.resilience.elastic.topology import (
    ElasticRestoreError,
    is_ef_path,
    live_mesh,
    same_mesh,
)
from apex_tpu_torch.utils.pytree import (
    keystr,
    map_tensors,
    state_fields,
    tree_leaves_with_path,
)

__all__ = ["ElasticRestoreError", "needs_reshard", "restore_resharded"]

logger = logging.getLogger("apex_tpu_torch.resilience.elastic")


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"step_{step}")


def needs_reshard(directory: str, mesh: Optional[dict] = None,
                  step: Optional[int] = None) -> Optional[bool]:
    """Does the newest verified checkpoint's layout differ from ``mesh``
    (default: this process's, ``live_mesh``)? None when undecidable (no
    checkpoint, or the newest verified one predates the topology
    block)."""
    from apex_tpu_torch.resilience import integrity
    from apex_tpu_torch.utils.checkpoint import finalized_steps

    mesh = live_mesh() if mesh is None else mesh
    steps = [step] if step is not None else list(
        reversed(finalized_steps(directory)))
    for s in steps:
        sd = _step_dir(directory, s)
        if not integrity.verify_checkpoint(sd, deep=False)[0]:
            continue
        topo = (integrity.read_manifest(sd) or {}).get("topology")
        if not topo or not topo.get("mesh"):
            return None
        return not same_mesh(topo["mesh"], mesh)
    return None


def _saved_by_path(target: Any, plain: Any, leaves: list,
                   path=()) -> Dict[str, torch.Tensor]:
    """The saved tensors under ``target``'s paths: the checkpoint's
    plain tree (a state class saved as the dict of its fields) walked
    beside the target; a path the checkpoint lacks is absent, a saved
    entry the target lacks is never read."""
    out: Dict[str, torch.Tensor] = {}
    if isinstance(target, torch.Tensor):
        if isinstance(plain, dict) and set(plain) == {"__leaf__"}:
            out[keystr(path)] = leaves[plain["__leaf__"]]
        return out
    fields = state_fields(target)
    if fields is not None:
        items = [(((name,),), v, plain.get(name)
                  if isinstance(plain, dict) else None)
                 for name, v in fields]
    elif isinstance(target, dict):
        items = [(tuple(str(k).split(".")), v,
                  plain.get(k) if isinstance(plain, dict) else None)
                 for k, v in target.items()]
    elif isinstance(target, (list, tuple)):
        items = [((i,), v, plain[i] if isinstance(plain, list)
                  and i < len(plain) else None)
                 for i, v in enumerate(target)]
    else:
        return out
    for key, sub, saved in items:
        out.update(_saved_by_path(sub, saved, leaves, path + key))
    return out


def _check_spec_fits(path: str, shape, spec, axes: dict) -> None:
    """Refuse a spec naming an absent axis, outranking the leaf, or not
    dividing its dims — before anything is copied, so every refusal is
    an :class:`ElasticRestoreError` with the reason."""
    entries = list(spec or [])
    for entry in entries:
        if entry is None:
            continue
        for name in ([entry] if isinstance(entry, str) else list(entry)):
            if name not in axes:
                raise ElasticRestoreError(
                    f"leaf {path}: target spec {spec} names mesh axis "
                    f"{name!r} absent from the restore mesh (axes {axes})")
    if len(entries) > len(shape):
        raise ElasticRestoreError(
            f"leaf {path}: target spec {spec} has more entries than the "
            f"leaf has dims (shape {tuple(shape)})")
    for dim, entry in zip(shape, entries):
        if entry is None:
            continue
        total = 1
        for name in ([entry] if isinstance(entry, str) else list(entry)):
            total *= axes[name]
        if dim % total:
            raise ElasticRestoreError(
                f"leaf {path}: dim {dim} not divisible by the product "
                f"{total} of mesh axes {entry} (spec {spec})")


def _regroup(path: str, arr: torch.Tensor, saved_shape: tuple,
             tgt_shape: tuple, old_size: Optional[int], new_size: int
             ) -> torch.Tensor:
    """A ZeRO flat buffer (or its per-tp rows) re-padded from the saved
    layout's length to the target's (module docstring)."""
    from apex_tpu_torch.optimizers.distributed_fused_adam import (
        zero_regroup_flat,
    )

    if len(tgt_shape) != len(saved_shape) or tgt_shape[:-1] != \
            saved_shape[:-1]:
        raise ElasticRestoreError(
            f"leaf {path}: ZeRO buffer rows changed {saved_shape} -> "
            f"{tgt_shape} (a change of tp is a migration, not a ZeRO "
            f"regroup)")
    saved_len, tgt_len = saved_shape[-1], tgt_shape[-1]
    # the length change must be explainable as padding ONE common
    # unpadded length T to each side's multiple: the two half-open
    # T-ranges (len - size, len] must intersect
    if old_size is None or (max(tgt_len - new_size, saved_len - old_size)
                            >= min(tgt_len, saved_len)):
        raise ElasticRestoreError(
            f"leaf {path}: length change {saved_len} -> {tgt_len} is not "
            f"explainable as re-padding one unpadded length to the shard "
            f"axis (saved axis 'dp' size {old_size}, target shard size "
            f"{new_size}) — a grown/shrunk buffer is a migration, not a "
            f"ZeRO regroup")
    try:
        if arr.dim() == 1:
            return zero_regroup_flat(arr, tgt_len)
        rows = arr.reshape(-1, saved_len)
        return torch.stack([zero_regroup_flat(row, tgt_len) for row in rows]
                           ).reshape(tgt_shape)
    except ValueError as e:
        raise ElasticRestoreError(f"leaf {path}: {e}") from e


def _reshard_step(directory: str, step: int, target: Any, layout,
                  mesh: dict, specs: List[Any], topology: dict) -> Any:
    from apex_tpu_torch.resilience import integrity
    from apex_tpu_torch.utils.checkpoint import read_plain

    axes = mesh["axes"]
    saved_axes = (topology.get("mesh") or {}).get("axes") or {}
    if saved_axes.get("pp", 1) != axes.get("pp", 1):
        # a stage's layers are its slice of the stacked pp axis: another
        # pp regroups layers between stages (JAX refuses it too: the
        # stacked leaves change shape and the stage trees their leaves)
        raise ElasticRestoreError(
            f"step_{step}: the checkpoint was saved at pp "
            f"{saved_axes.get('pp', 1)} and the target runs at pp "
            f"{axes.get('pp', 1)} — a change of the pipeline axis 'pp' "
            f"moves layers between stages: a migration, not a reshard")
    target_flat = list(tree_leaves_with_path(target))
    got = [p for p, _ in target_flat]
    topo_leaves = topology.get("leaves", [])
    want = [leaf["path"] for leaf in topo_leaves]
    if got != want:
        extra = sorted(set(got) - set(want))
        missing = sorted(set(want) - set(got))
        # the migration shim across the compression toggle, both ways
        # (EF state is advisory): target-only EF leaves are zero-filled,
        # checkpoint-only EF leaves are not restored; any other
        # structure difference refuses
        if not ((extra or missing)
                and all(is_ef_path(p) for p in extra + missing)):
            raise ElasticRestoreError(
                f"step_{step}: restore target structure differs from the "
                f"saved topology (target-only leaves {extra[:3]}, "
                f"checkpoint-only leaves {missing[:3]}) — a state-layout "
                f"change needs a migration, not a reshard")
        if extra:
            logger.warning(
                "elastic restore step_%d: checkpoint predates the "
                "compressed-collective EF state; zero-filling advisory "
                "residual leaves %s", step, extra)
        if missing:
            logger.warning(
                "elastic restore step_%d: checkpoint carries EF residual "
                "leaves %s the (compression-off) target does not — "
                "advisory state, not restored", step, missing)

    manifest = integrity.read_manifest(_step_dir(directory, step)) or {}
    fp_crc = {leaf["path"]: leaf["crc32"]
              for leaf in (manifest.get("fingerprint") or {}).get(
                  "leaves", [])}
    topo_by_path = {leaf["path"]: leaf for leaf in topo_leaves}
    old_dp = ((topology.get("mesh") or {}).get("axes") or {}).get("dp")
    plain, leaves = read_plain(directory, step)
    saved = _saved_by_path(target, plain, leaves)
    out = []
    for i, (path, tgt_leaf) in enumerate(target_flat):
        tgt_shape = layout.global_shape(i)
        spec = specs[i]
        topo = topo_by_path.get(path)
        if topo is None:
            # a zero-filled advisory EF leaf: nothing on disk to verify
            _check_spec_fits(path, tgt_shape, spec, axes)
            out.append(torch.zeros_like(tgt_leaf))
            continue
        arr = saved.get(path)
        saved_shape = tuple(topo["shape"])
        dtype = str(arr.dtype).replace("torch.", "") if arr is not None \
            else None
        if arr is None or tuple(arr.shape) != saved_shape or \
                dtype != topo["dtype"]:
            raise ElasticRestoreError(
                f"leaf {path}: restored bytes are "
                f"{dtype}{tuple(arr.shape) if arr is not None else None} "
                f"but the manifest recorded {topo['dtype']}{saved_shape} — "
                f"checkpoint and manifest disagree; refusing")
        tgt_dtype = str(tgt_leaf.dtype).replace("torch.", "")
        if tgt_dtype != topo["dtype"]:
            raise ElasticRestoreError(
                f"leaf {path}: target dtype {tgt_dtype} != saved dtype "
                f"{topo['dtype']} — dtype migration is not a reshard")
        # crc32 over the global array, the bytes about to be regrouped
        # and cut (for a regrouped ZeRO leaf: the fingerprinted buffer)
        if path in fp_crc:
            crc = zlib.crc32(arr.contiguous().reshape(-1).view(
                torch.uint8).numpy())
            if crc != fp_crc[path]:
                raise ElasticRestoreError(
                    f"leaf {path}: crc32 mismatch against the save-time "
                    f"fingerprint ({crc} != {fp_crc[path]}) — restored "
                    f"bytes differ from the state that was saved")
        if tuple(tgt_shape) != saved_shape:
            if topo.get("ef"):
                # advisory residual (topology.py): re-padded where the
                # change is padding only, otherwise reset to zero —
                # never a refusal
                try:
                    if arr.dim() != 1 or len(tgt_shape) != 1:
                        raise ValueError(f"shape {saved_shape} -> "
                                         f"{tuple(tgt_shape)}")
                    from apex_tpu_torch.optimizers.distributed_fused_adam \
                        import zero_regroup_flat
                    arr = zero_regroup_flat(arr, tgt_shape[0])
                except ValueError as e:
                    logger.warning(
                        "elastic restore: EF residual %s not regroupable "
                        "(%s); resetting to zero — the compressed path "
                        "re-accumulates it", path, e)
                    arr = torch.zeros(tgt_shape, dtype=arr.dtype)
            elif topo.get("zero_shard_axis") is None:
                raise ElasticRestoreError(
                    f"leaf {path}: global shape changed {saved_shape} -> "
                    f"{tuple(tgt_shape)} but the leaf is not a ZeRO flat "
                    f"shard buffer (no zero_shard_axis in the manifest) — "
                    f"refusing to guess a re-layout")
            else:
                arr = _regroup(path, arr, saved_shape, tuple(tgt_shape),
                               old_dp, layout.dp)
        _check_spec_fits(path, arr.shape, spec, axes)
        out.append(layout.local_part(i, arr).to(
            device=tgt_leaf.device, dtype=tgt_leaf.dtype).clone())
    by_id = {id(t): o for (_, t), o in zip(target_flat, out)}
    return map_tensors(lambda t: by_id[id(t)], target)


def _walk(directory: str, candidates: List[int], deep: bool) -> dict:
    """The newest candidate step that verifies and carries a topology
    block (the first rank's verdict, taken by every rank)."""
    from apex_tpu_torch.resilience import integrity

    pre_topology = []
    for s in candidates:
        sd = _step_dir(directory, s)
        ok, reason = integrity.verify_checkpoint(sd, deep=deep)
        if not ok:
            logger.warning(
                "elastic restore skipping unverified step_%d: %s", s, reason)
            continue
        topo = (integrity.read_manifest(sd) or {}).get("topology")
        if not topo:
            logger.warning(
                "elastic restore skipping step_%d: manifest predates the "
                "topology block (pre-upgrade checkpoint); falling back to "
                "an older step that carries one", s)
            pre_topology.append(s)
            continue
        return {"step": s, "topology": topo}
    return {"step": None, "pre_topology": pre_topology}


def restore_resharded(directory: str, target: Any,
                      mesh: Optional[dict] = None, target_specs: Any = None,
                      step: Optional[int] = None, deep: bool = True,
                      layout=None) -> Tuple[int, Any]:
    """Restore the newest verified checkpoint onto ``target``'s layout.

    ``target`` is the live state on the NEW layout (this rank's part):
    its leaves give the wanted shapes, dtypes and devices, and with this
    process's ``parallel_state`` (``layout``, default
    ``elastic.layout.StateLayout(target)``) the wanted split. ``mesh``
    overrides the live mesh (``live_mesh``); ``target_specs``, a list of
    one JAX-form spec a leaf (None: replicated), is checked against it in
    place of the layout's own specs. ``step`` pins one step instead of
    walking newest-first.

    Walk semantics: steps failing file verification are skipped; verified
    steps whose manifest predates the topology block are skipped with a
    warning; the first topology-bearing verified step is restored, and
    any mismatch there raises :class:`ElasticRestoreError` rather than
    walking further. Raises ``FileNotFoundError`` when no checkpoint
    exists at all. Every rank of the layout calls it together.
    """
    from apex_tpu_torch.resilience.elastic.layout import StateLayout
    from apex_tpu_torch.utils.checkpoint import finalized_steps

    layout = StateLayout(target) if layout is None else layout
    mesh = live_mesh() if mesh is None else mesh
    specs = (list(target_specs) if target_specs is not None
             else [layout.spec(i) for i in range(len(layout.paths))])
    candidates = [step] if step is not None else list(
        reversed(finalized_steps(directory)))
    if not candidates:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    pick = layout.broadcast_object(
        _walk(directory, candidates, deep) if layout.is_writer else None)
    if pick["step"] is None:
        raise ElasticRestoreError(
            f"no topology-bearing verified checkpoint under {directory} "
            f"(steps considered: {candidates}; verified-but-pre-topology: "
            f"{pick['pre_topology']}) — cannot reshard without the saved "
            f"layout")
    restored = _reshard_step(directory, pick["step"], target, layout, mesh,
                             specs, pick["topology"])
    return pick["step"], restored
