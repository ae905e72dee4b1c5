"""Checkpoint integrity: manifests, verified restore, retention, retry
(counterpart of apex_tpu/resilience/integrity.py).

A step directory is written under a temporary name and renamed into
place (``utils.checkpoint``), but that only protects against one
failure mode. A partially copied directory, a bit-flipped or truncated
file on a flaky disk, or a non-atomic backend all leave a ``step_N``
that *looks* restorable and isn't, and a torn restore is worse than
none, because it silently resumes garbage.

The manifest closes that hole:

- ``write_manifest(step_dir, ...)`` records a per-file sha256 digest of
  everything the save wrote, plus (optionally) a structure hash and a
  per-leaf crc32 fingerprint of the saved tree, and the topology block
  (``resilience.elastic.topology``). It is written LAST, as the sibling
  file ``step_N.apex-manifest.json``, itself via tmp+rename, so its
  presence IS the commit marker: no manifest, no durable checkpoint.
- ``verify_checkpoint(step_dir)`` re-hashes the files against the
  manifest; truncation, bit flips, and missing files all fail it.
- ``verified_latest_step`` / ``load_checkpoint_verified`` walk step
  directories newest-first and restore from the newest step that
  VERIFIES, skipping torn/corrupt ones instead of crashing on them.
- ``apply_retention(dir, keep_last_n)`` bounds disk growth, deleting
  oldest steps (and their manifests, and stale temporary dirs) while
  never touching the newest verified step, and counting the keep window
  over VERIFIED steps too.
- ``save_with_retry`` wraps the write in bounded retries with
  exponential backoff for transient IO errors.

The per-leaf crc32 is taken over each tensor's bytes as they lie in
memory (little-endian, row-major), the bytes ``np.ascontiguousarray``
gives the JAX package: the same tree gives the same fingerprint in
either package. The leaves' crc32s and the files' sha256s are computed
on threads of their own (``zlib`` and ``hashlib`` release the GIL).

At world > 1 (``utils.checkpoint``) a step is the whole world's global
tree, written by the layout's first rank: its fingerprint is taken over
the GLOBAL arrays (:func:`global_fingerprint`), so a step saved at dp 4
verifies, leaf by leaf, at dp 2; the first rank commits the manifest
and every rank waits for it. A verified step saved on another layout
restores through ``resilience.elastic.restore_resharded``.
"""

import hashlib
import json
import logging
import os
import shutil
import zlib
from typing import Any, Callable, List, Optional, Tuple

import torch

from apex_tpu_torch.utils.checkpoint import (
    TMP_MARKER,
    finalized_steps,
    load_checkpoint,
    parallel_io,
    save_checkpoint,
)
from apex_tpu_torch.utils.pytree import tree_leaves_with_path

logger = logging.getLogger("apex_tpu_torch.resilience")

__all__ = [
    "MANIFEST_SUFFIX", "MANIFEST_VERSION", "apply_retention",
    "global_fingerprint", "leaf_crc32",
    "load_checkpoint_verified", "manifest_path", "read_manifest",
    "save_checkpoint_verified", "save_with_retry", "tree_fingerprint",
    "verified_latest_step", "verified_steps", "verify_checkpoint",
    "verify_restored", "write_abandoned_marker", "write_manifest",
]

MANIFEST_SUFFIX = ".apex-manifest.json"
# version 2 added the "topology" block (resilience.elastic.topology) and
# the "autoresume" save-duration EMAs; verification is version-agnostic
# (every version-1 field kept its meaning), and the elastic restore
# treats a manifest WITHOUT a topology block as predating the upgrade
MANIFEST_VERSION = 2


def manifest_path(step_dir: str) -> str:
    """Manifest file for a ``.../step_N`` directory (a sibling file)."""
    return os.path.abspath(step_dir).rstrip(os.sep) + MANIFEST_SUFFIX


def _sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def _files(step_dir: str) -> List[str]:
    return sorted(os.path.join(r, n) for r, _, fs in os.walk(step_dir)
                  for n in fs)


def _file_digests(step_dir: str) -> dict:
    """size and sha256 of every file, the files hashed on threads of
    their own (``hashlib`` releases the GIL while it hashes)."""
    paths = _files(step_dir)
    digests = parallel_io(_sha256_file, paths)
    return {os.path.relpath(p, step_dir): {"size": os.path.getsize(p),
                                           "sha256": d}
            for p, d in zip(paths, digests)}


def _is_rank0() -> bool:
    return (not torch.distributed.is_initialized()
            or torch.distributed.get_rank() == 0)


def leaf_crc32(t: torch.Tensor) -> int:
    """crc32 of a tensor's bytes in row-major order (a device tensor is
    read back to the host); ``zlib.crc32``, the same checksum as
    ``binascii.crc32``, releases the GIL while it sums."""
    t = t.detach().contiguous()
    if t.device.type != "cpu":
        t = t.cpu()
    return zlib.crc32(t.reshape(-1).view(torch.uint8).numpy())


def tree_fingerprint(tree: Any) -> dict:
    """Structure hash + per-leaf checksums of an in-memory tree.

    The structure hash covers key paths (``jax.tree_util.keystr``'s
    form, ``utils.pytree.tree_leaves_with_path``), dtypes and shapes, so
    a restore target mismatch is detectable; each leaf gets a crc32 over
    its raw bytes. Use ``verify_restored`` to check a restored tree
    against it.
    """
    flat = list(tree_leaves_with_path(tree))
    crcs = parallel_io(leaf_crc32, [leaf for _, leaf in flat])
    leaves = []
    for (path, leaf), crc in zip(flat, crcs):
        leaves.append({
            "path": path,
            "dtype": str(leaf.dtype).replace("torch.", ""),
            "shape": list(leaf.shape),
            "crc32": crc,
        })
    structure = [(l["path"], l["dtype"], l["shape"]) for l in leaves]
    structure_hash = hashlib.sha256(
        json.dumps(structure, sort_keys=True).encode()
    ).hexdigest()
    return {"structure_hash": structure_hash, "leaves": leaves}


def global_fingerprint(tree: Any) -> dict:
    """:func:`tree_fingerprint` of the global tree ``tree`` stands for:
    at world > 1 it is gathered to the layout's first rank, which
    fingerprints it, and every rank returns that fingerprint
    (collective); at a world of one, ``tree``'s own."""
    from apex_tpu_torch.utils.checkpoint import multi_rank_layout

    layout = multi_rank_layout(tree)
    if layout is None:
        return tree_fingerprint(tree)
    host = layout.gather(tree)
    return layout.broadcast_object(
        tree_fingerprint(host) if layout.is_writer else None)


def verify_restored(tree: Any, manifest: dict) -> Tuple[bool, str]:
    """Deep-check a RESTORED pytree against the manifest's fingerprint."""
    fp = manifest.get("fingerprint")
    if not fp:
        return True, "no fingerprint recorded"
    got = tree_fingerprint(tree)
    if got["structure_hash"] != fp["structure_hash"]:
        return False, "structure hash mismatch"
    want = {l["path"]: l["crc32"] for l in fp["leaves"]}
    for l in got["leaves"]:
        if want.get(l["path"]) != l["crc32"]:
            return False, f"leaf checksum mismatch at {l['path']}"
    return True, "ok"


def write_manifest(
    step_dir: str, tree: Any = None, fingerprint: Optional[dict] = None,
    extra: Optional[dict] = None, topology: Optional[dict] = None,
) -> str:
    """Hash every file under ``step_dir`` and commit the manifest.

    Call strictly AFTER the checkpoint write is durable (sync save
    returned, or ``AsyncCheckpointWriter.wait()``). ``tree`` (or a
    pre-computed ``fingerprint`` taken from the host snapshot that was
    written, for async saves whose live tensors change afterwards) adds
    the fingerprint; a ``topology`` block (or ``tree``, from which one is
    derived, resilience.elastic.topology) records the layout a restore
    must match.
    The manifest itself is written tmp-then-rename so a crash mid-write
    never leaves a parseable-but-wrong commit marker.
    """
    step_dir = os.path.abspath(step_dir)
    if not os.path.isdir(step_dir):
        raise FileNotFoundError(f"checkpoint dir missing: {step_dir}")
    if fingerprint is None and tree is not None:
        fingerprint = tree_fingerprint(tree)
    if topology is None and tree is not None:
        # best-effort at SAVE time: a topology introspection failure must
        # never cost the commit marker (the refuse-don't-guess happens at
        # RESTORE, where a missing block reads as pre-upgrade)
        try:
            from apex_tpu_torch.resilience.elastic.topology import (
                topology_block,
            )

            topology = topology_block(tree)
        except Exception as e:  # noqa: BLE001 - save durability outranks it
            logger.warning("topology block skipped for %s: %s", step_dir, e)
    manifest = {
        "version": MANIFEST_VERSION,
        "files": _file_digests(step_dir),
        "fingerprint": fingerprint,
    }
    if topology is not None:
        manifest["topology"] = topology
    if extra:
        manifest.update(extra)
    target = manifest_path(step_dir)
    tmp = target + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, target)
    return target


def write_abandoned_marker(step_dir: str) -> str:
    """Tombstone manifest for a DELIBERATELY-uncommitted async save.

    The deadline-budgeted preemption path (utils/autoresume.py) may
    decide there is no time to finalize an in-flight save. Without a
    marker the background write could still complete the step dir, and a
    later verified restore with ``allow_unverified=True`` would accept
    it as a pre-manifest LEGACY checkpoint — un-fingerprinted state the
    job explicitly chose not to vouch for. The tombstone is a manifest
    whose ``"abandoned"`` flag makes :func:`verify_checkpoint` fail it
    and whose existence defeats the legacy test, so every restore path
    skips the dir cleanly. Written tmp+rename like the real manifest;
    safe to write before the background rename lands (it is a sibling
    file), and a later re-save of the same step overwrites it with a
    real manifest at finalize.
    """
    target = manifest_path(step_dir)
    tmp = target + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"version": MANIFEST_VERSION, "abandoned": True}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, target)
    return target


def read_manifest(step_dir: str) -> Optional[dict]:
    """Parsed manifest for ``step_dir``, or None (missing/corrupt json)."""
    try:
        with open(manifest_path(step_dir)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def verify_checkpoint(step_dir: str, deep: bool = True) -> Tuple[bool, str]:
    """Is ``step_dir`` a committed, uncorrupted checkpoint?

    Shallow (``deep=False``): manifest present + file set and sizes
    match (catches torn writes and truncation for free). Deep: re-hash
    every file (catches bit flips; costs a read of the checkpoint).
    """
    step_dir = os.path.abspath(step_dir)
    if not os.path.isdir(step_dir):
        return False, "not a directory"
    if TMP_MARKER in os.path.basename(step_dir):
        return False, "in-progress temporary directory"
    manifest = read_manifest(step_dir)
    if manifest is None:
        return False, "no manifest (uncommitted or pre-manifest checkpoint)"
    if manifest.get("abandoned"):
        return False, "abandoned (deadline-budgeted preemption skip)"
    want = manifest.get("files", {})
    have = {
        os.path.relpath(os.path.join(r, n), step_dir)
        for r, _, fs in os.walk(step_dir) for n in fs
    }
    missing = set(want) - have
    if missing:
        return False, f"missing files: {sorted(missing)[:3]}"
    for rel, meta in want.items():
        if os.path.getsize(os.path.join(step_dir, rel)) != meta["size"]:
            return False, f"size mismatch: {rel}"
    if deep:
        rels = sorted(want)
        digests = parallel_io(
            _sha256_file, [os.path.join(step_dir, r) for r in rels])
        for rel, digest in zip(rels, digests):
            if digest != want[rel]["sha256"]:
                return False, f"digest mismatch: {rel}"
    return True, "ok"


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"step_{step}")


def verified_steps(directory: str, deep: bool = False) -> List[int]:
    """Ascending steps in ``directory`` that pass :func:`verify_checkpoint`."""
    out = []
    for s in finalized_steps(directory):
        ok, _ = verify_checkpoint(_step_dir(directory, s), deep=deep)
        if ok:
            out.append(s)
    return out


def verified_latest_step(directory: str, deep: bool = True) -> Optional[int]:
    """Newest step that verifies; torn/corrupt/uncommitted dirs are skipped."""
    for s in reversed(finalized_steps(directory)):
        ok, reason = verify_checkpoint(_step_dir(directory, s), deep=deep)
        if ok:
            return s
        logger.warning("skipping unverified checkpoint step_%d: %s", s, reason)
    return None


def save_with_retry(
    save_fn: Callable[[], Any],
    retries: int = 3,
    backoff: float = 0.1,
    backoff_factor: float = 2.0,
) -> Any:
    """Run ``save_fn`` with bounded retries + exponential backoff.

    For transient IO errors (NFS hiccup, GCS 5xx surfaced as OSError).
    The final failure re-raises — checkpoint loss must be loud. Thin
    wrapper over the shared :func:`resilience.retry.retry_with_backoff`
    (jitter pinned to 0 so single-writer save schedules stay
    deterministic; multi-host callers use the shared helper directly
    with a nonzero jitter).
    """
    from apex_tpu_torch.resilience.retry import retry_with_backoff

    return retry_with_backoff(
        save_fn, retries=retries, backoff=backoff,
        backoff_factor=backoff_factor, jitter=0.0, what="checkpoint save",
    )


def save_checkpoint_verified(
    directory: str,
    step: int,
    tree: Any,
    retries: int = 3,
    backoff: float = 0.1,
    keep_last_n: Optional[int] = None,
    extra: Optional[dict] = None,
) -> str:
    """Durable save: write (with retry) + manifest + retention.

    ``extra`` merges additional keys into the manifest (AutoResume
    persists its save-duration EMAs this way). The manifest commit and
    retention sweep are rank-0-only (every rank racing ``os.replace`` on
    the same manifest tmp file would corrupt the commit marker). At
    world > 1 the save is collective: the global tree is gathered, the
    layout's first rank writes, fingerprints and commits it, and every
    rank returns once the manifest is in.
    """
    from apex_tpu_torch.utils.checkpoint import (
        layout_barrier,
        multi_rank_layout,
        write_host_tree,
    )

    layout = multi_rank_layout(tree)
    if layout is not None:
        from apex_tpu_torch.resilience.elastic.topology import (
            topology_block,
        )

        topology = topology_block(tree, layout=layout)
        host = layout.gather(tree)
        path = os.path.join(os.path.abspath(directory), f"step_{step}")
        if layout.is_writer:
            save_with_retry(lambda: write_host_tree(directory, step, host),
                            retries=retries, backoff=backoff)
            write_manifest(path, host, topology=topology, extra=extra)
            if keep_last_n is not None:
                apply_retention(directory, keep_last_n)
        layout_barrier()
        return path
    path = save_with_retry(
        lambda: save_checkpoint(directory, step, tree),
        retries=retries, backoff=backoff,
    )
    if _is_rank0():
        write_manifest(path, tree, extra=extra)
        if keep_last_n is not None:
            apply_retention(directory, keep_last_n)
    return path


def load_checkpoint_verified(
    directory: str,
    target: Any = None,
    deep: bool = True,
    allow_unverified: bool = False,
    mesh: Optional[dict] = None,
) -> Tuple[int, Any]:
    """Restore the newest checkpoint that passes verification.

    Walks steps newest-first: verified steps restore; torn / corrupt /
    uncommitted ones are skipped with a warning. At world > 1, or from a
    verified step saved on another layout (world, tp, dp, pp) than
    ``mesh`` (default: this process's, ``elastic.live_mesh``), the
    restore is ``elastic.restore_resharded``'s (collective; its refusals
    are ``elastic.ElasticRestoreError``). The restored tree is new
    tensors on the target's devices. ``allow_unverified``
    additionally accepts pre-manifest (legacy) checkpoints — file
    corruption in those is undetectable, so it is opt-in. Raises
    ``FileNotFoundError`` when nothing restorable exists.
    """
    from apex_tpu_torch.resilience.elastic import (
        live_mesh,
        restore_resharded,
    )
    from apex_tpu_torch.resilience.elastic.topology import same_mesh
    from apex_tpu_torch.utils.checkpoint import multi_rank_layout

    if target is not None and multi_rank_layout(target) is not None:
        return restore_resharded(directory, target, mesh=mesh, deep=deep)
    candidates = list(reversed(finalized_steps(directory)))
    for s in candidates:
        sd = _step_dir(directory, s)
        ok, reason = verify_checkpoint(sd, deep=deep)
        # "legacy" means the manifest FILE never existed (pre-manifest
        # checkpoint); a present-but-unparseable manifest is corruption
        # and must fall back like any other verification failure
        legacy = (
            (not ok) and allow_unverified
            and not os.path.exists(manifest_path(sd))
        )
        if not ok and not legacy:
            logger.warning("skipping unverified checkpoint step_%d: %s", s, reason)
            continue
        topo = (read_manifest(sd) or {}).get("topology") if ok else None
        if (target is not None and topo and topo.get("mesh") is not None
                and not same_mesh(topo["mesh"], live_mesh() if mesh is None
                                  else mesh)):
            # saved on another layout: resharded, never loaded as it is
            # (its refusals are ElasticRestoreError, outside the
            # fallback below)
            return restore_resharded(directory, target, mesh=mesh,
                                     step=s, deep=deep)
        try:
            tree = load_checkpoint(directory, s, target=target)
        except Exception as e:  # noqa: BLE001 - a corrupt payload raises variously
            logger.warning("restore of step_%d failed (%s); falling back", s, e)
            continue
        if ok and target is not None:
            # leaf-level re-verification needs the caller's structure back
            # (a target-less restore returns plain containers whose key
            # paths cannot match the fingerprint taken at save time)
            manifest = read_manifest(sd)
            good, why = verify_restored(tree, manifest)
            if not good:
                logger.warning(
                    "restored step_%d failed leaf verification (%s); falling back",
                    s, why,
                )
                continue
        return s, tree
    raise FileNotFoundError(
        f"no restorable checkpoint under {directory} "
        f"(candidates considered: {candidates})"
    )


def apply_retention(directory: str, keep_last_n: int) -> List[int]:
    """Delete all but the newest ``keep_last_n`` steps; returns deleted.

    Also sweeps orphaned temporary dirs (crashed async saves) and
    manifests whose step directory is gone. Two safety rules beyond the
    raw window (shallow verification — this runs on the save path):

    - the keep window is ALSO counted over VERIFIED steps, so torn or
      uncommitted newer step dirs cannot push verified restore points
      out of it (with ``keep_last_n=2`` and two torn dirs on top you
      still keep two *restorable* checkpoints, not two piles of garbage
      and one checkpoint);
    - nothing at or past the newest verified step is ever deleted: an
      unverified NEWER dir may be an in-flight async save whose manifest
      has not landed yet (finalize commits it after this sweep's
      ordering point), and sweeping it would tear the save.
    """
    if keep_last_n < 1:
        raise ValueError(f"keep_last_n must be >= 1, got {keep_last_n}")
    directory = os.path.abspath(directory)
    if not os.path.isdir(directory):
        return []
    steps = finalized_steps(directory)
    verified = [
        s for s in steps
        if verify_checkpoint(_step_dir(directory, s), deep=False)[0]
    ]
    keep = set(steps[-keep_last_n:]) | set(verified[-keep_last_n:])
    if verified:
        keep.update(s for s in steps if s >= verified[-1])
    deleted = []
    for s in steps:
        if s in keep:
            continue
        shutil.rmtree(_step_dir(directory, s), ignore_errors=True)
        try:
            os.remove(manifest_path(_step_dir(directory, s)))
        except OSError:
            pass
        deleted.append(s)
    for name in os.listdir(directory):
        p = os.path.join(directory, name)
        if TMP_MARKER in name and os.path.isdir(p):
            shutil.rmtree(p, ignore_errors=True)
        elif name.endswith(MANIFEST_SUFFIX):
            if not os.path.isdir(p[: -len(MANIFEST_SUFFIX)]):
                try:
                    os.remove(p)
                except OSError:
                    pass
    return deleted
