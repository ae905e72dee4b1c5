"""Checkpoint save and restore on ``torch.save`` (counterpart of
apex_tpu/utils/checkpoint.py, which is built on orbax).

A checkpoint of ``tree`` at ``step`` is the directory
``<directory>/step_<N>``: :data:`TREE_FILE` holds the tree in plain
containers (dicts, lists, None and Python scalars) with each tensor
replaced by ``{"__leaf__": i}``, and ``shard_<k>.pt`` files hold the
tensors, in leaf order, grouped into shards of about
:data:`SHARD_BYTES` (a larger tensor is a shard of its own). Every file
is a ``torch.save`` that ``torch.load(weights_only=True)`` reads. The
shards are written, read (and hashed, ``resilience.integrity``) on
threads of their own, so a large state's IO runs in parallel. A state
class (a dataclass or a named tuple) is saved as the dict of its fields
and rebuilt from the ``target`` a restore is given, as orbax rebuilds a
custom pytree node. The directory is written under a temporary name
(:data:`TMP_MARKER`) and renamed into place when every file is on disk,
so a step directory that exists is whole; what it holds is vouched for
by the manifest of ``resilience.integrity``.

Every tensor crosses to the host as a copy (a CPU tensor's ``.cpu()``
would share its storage, and the step after the save updates parameters
in place), and a restore puts each leaf on the device and in the dtype
of the target's leaf. :class:`AsyncCheckpointWriter` takes that copy
before ``save`` returns (into pinned buffers it reuses, on the card) and
writes the files on a thread of its own.

At world > 1 (a ``parallel_state`` layout of more than one rank) one
step directory holds the whole world's state: every leaf is written as
its global array (``resilience.elastic.layout``), gathered from the
ranks to the layout's first rank, which alone writes it; a save is
collective, and a restore across layouts goes through
``resilience.elastic.restore_resharded``. The directory appears under
its final name only once the whole global tree is in it, so a torn
multi-rank step is never ``latest_step``.
"""

import logging
import os
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Optional

import torch

from apex_tpu_torch.utils.pytree import map_tensors, state_fields

logger = logging.getLogger("apex_tpu_torch.utils.checkpoint")

__all__ = [
    "IO_THREADS", "SHARD_BYTES", "TMP_MARKER", "TREE_FILE",
    "AsyncCheckpointWriter", "finalized_steps", "global_snapshot",
    "host_snapshot", "latest_step", "layout_barrier", "load_checkpoint",
    "multi_rank_layout", "parallel_io", "read_plain", "save_checkpoint",
    "write_host_tree",
]

#: the tree file inside a step directory; the tensors are in shard files
TREE_FILE = "tree.pt"
#: the bytes of tensors a shard file gathers (a larger tensor: its own)
SHARD_BYTES = 256 << 20
#: threads a save or restore writes and reads its shard files on
IO_THREADS = 8
#: an in-progress save lives at ``step_N<TMP_MARKER><ns>`` until renamed
TMP_MARKER = ".torch-checkpoint-tmp-"


def _plain(tree, leaves: list):
    """``tree`` in plain containers (a state class as the dict of its
    fields, a tuple as a list), each tensor appended to ``leaves`` and
    replaced by ``{"__leaf__": its index}``."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return {"__leaf__": len(leaves) - 1}
    fields = state_fields(tree)
    if fields is not None:
        return {k: _plain(v, leaves) for k, v in fields}
    if isinstance(tree, dict):
        return {k: _plain(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_plain(v, leaves) for v in tree]
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    raise TypeError(f"cannot checkpoint a {type(tree).__name__}")


def _shards(leaves: list) -> list:
    """Consecutive runs of leaf indices of about SHARD_BYTES each."""
    shards, run, size = [], [], 0
    for i, t in enumerate(leaves):
        nbytes = t.numel() * t.element_size()
        if run and size + nbytes > SHARD_BYTES:
            shards.append(run)
            run, size = [], 0
        run.append(i)
        size += nbytes
    if run:
        shards.append(run)
    return shards


def _save_file(path: str, obj: Any) -> None:
    with open(path, "wb") as f:
        torch.save(obj, f)
        f.flush()
        os.fsync(f.fileno())


def parallel_io(fn, items: list) -> list:
    """``[fn(x) for x in items]`` on up to IO_THREADS threads."""
    if len(items) <= 1:
        return [fn(x) for x in items]
    with ThreadPoolExecutor(min(IO_THREADS, len(items))) as pool:
        return list(pool.map(fn, items))


def host_snapshot(tree: Any, pinned: Optional[list] = None) -> Any:
    """``tree`` (its own structure kept) with every tensor copied to the
    host: a CPU tensor cloned, a device tensor copied into a pinned
    buffer, all device copies behind one event that is synchronized
    before this returns, so the caller may update the live tensors at
    once. ``pinned`` (a list the caller keeps across snapshots) lends
    the previous snapshot's buffers, each reused where the one in the
    same order has the shape and dtype, and receives this snapshot's."""
    slots = iter(pinned if pinned is not None else [])
    fresh = []

    def copy(t):
        t = t.detach()
        if t.device.type != "cuda":
            return t.clone()
        buf = next(slots, None)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        fresh.append(buf)
        buf.copy_(t, non_blocking=True)
        return buf

    out = map_tensors(copy, tree)
    if fresh:
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
    if pinned is not None:
        pinned[:] = fresh
    return out


def multi_rank_layout(tree: Any):
    """The ``elastic.layout.StateLayout`` of ``tree`` when this process
    is a rank of a layout of several, else None."""
    from apex_tpu_torch.parallel import parallel_state as ps

    if ps.get_model_world_size() <= 1:
        return None
    from apex_tpu_torch.resilience.elastic.layout import StateLayout

    return StateLayout(tree)


def global_snapshot(tree: Any, pinned: Optional[list] = None):
    """``(host tree, is_writer)``: at a world of one the
    :func:`host_snapshot` of ``tree`` and True; on a rank of a layout of
    several, the global tree on the layout's first rank (the writer) and
    None elsewhere (collective: every rank calls it)."""
    layout = multi_rank_layout(tree)
    if layout is None:
        return host_snapshot(tree, pinned), True
    return layout.gather(tree), layout.is_writer


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"step_{step}")


def write_host_tree(directory: str, step: int, host_tree: Any,
                    overwrite: bool = True) -> str:
    """Write a host tree to ``step_<N>`` through a temporary directory."""
    path = _step_dir(directory, step)
    if os.path.exists(path) and not overwrite:
        raise FileExistsError(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}{TMP_MARKER}{time.monotonic_ns()}"
    os.makedirs(tmp)
    leaves: list = []
    plain = _plain(host_tree, leaves)
    shards = _shards(leaves)
    parallel_io(lambda k: _save_file(os.path.join(tmp, f"shard_{k:04d}.pt"),
                                   [leaves[i] for i in shards[k]]),
              list(range(len(shards))))
    _save_file(os.path.join(tmp, TREE_FILE),
               {"tree": plain, "shards": len(shards)})
    if os.path.isdir(path):
        shutil.rmtree(path)
    elif os.path.lexists(path):
        os.remove(path)
    os.replace(tmp, path)
    return path


def save_checkpoint(directory: str, step: int, tree: Any,
                    overwrite: bool = True) -> str:
    """Write ``tree`` to ``directory/step_<N>``; returns the path. The
    tree may hold tensors on any device and state classes of them. On a
    rank of a layout of several the save is collective: the global tree
    is gathered and written by the layout's first rank, and every rank
    returns once it is on disk."""
    host, writer = global_snapshot(tree)
    path = _step_dir(directory, step)
    if writer:
        path = write_host_tree(directory, step, host, overwrite)
    layout_barrier()
    return path


def layout_barrier() -> None:
    """Wait for every rank of a layout of several (a no-op otherwise)."""
    from apex_tpu_torch.parallel import parallel_state as ps

    if ps.get_model_world_size() > 1:
        torch.distributed.barrier(group=ps.get_model_world_group())


def _unleaf(plain: Any, leaves: list) -> Any:
    """The tree file's plain tree with its leaf references resolved."""
    if isinstance(plain, dict):
        if set(plain) == {"__leaf__"}:
            return leaves[plain["__leaf__"]]
        return {k: _unleaf(v, leaves) for k, v in plain.items()}
    if isinstance(plain, list):
        return [_unleaf(v, leaves) for v in plain]
    return plain


def read_plain(directory: str, step: int):
    """``(plain tree, leaves)`` of ``step_<N>``: the tree file's plain
    containers, each tensor a ``{"__leaf__": i}`` of ``leaves`` (host
    tensors, read on threads of their own)."""
    path = _step_dir(directory, step)

    def load(name):
        return torch.load(os.path.join(path, name), map_location="cpu",
                          weights_only=True)

    head = load(TREE_FILE)
    leaves = [t for shard in parallel_io(
        load, [f"shard_{k:04d}.pt" for k in range(head["shards"])])
        for t in shard]
    return head["tree"], leaves


def load_checkpoint(directory: str, step: Optional[int] = None,
                    target: Any = None) -> Any:
    """Restore the tree saved at ``step`` (default: the latest).

    With ``target`` (a tree of the same structure, e.g. the freshly
    initialized state) the result has the target's structure, state
    classes included, and each tensor on its target leaf's device; a
    saved tree of another structure, shape or dtype raises
    ``ValueError``. The result is new tensors: copy them into live ones
    with ``utils.pytree.tree_copy_``. Without a target, plain containers
    of CPU tensors."""
    directory = os.path.abspath(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    plain, leaves = read_plain(directory, step)
    if target is None:
        return _unleaf(plain, leaves)
    want: list = []
    if _plain(target, want) != plain:
        raise ValueError(f"step_{step}: the saved tree's structure differs "
                         f"from the target's")
    for i, (t, saved) in enumerate(zip(want, leaves)):
        if saved.shape != t.shape or saved.dtype != t.dtype:
            raise ValueError(
                f"step_{step}: leaf {i} saved {tuple(saved.shape)} "
                f"{saved.dtype}, the target's {tuple(t.shape)} {t.dtype}")
    restored = iter(leaves)
    return map_tensors(lambda t: next(restored).to(t.device), target)


class AsyncCheckpointWriter:
    """Checkpoint writes overlapped with training.

    ``save`` copies the tree to the host (the copy is complete when it
    returns, so the next step may update the live tensors) and hands the
    write to a thread; ``wait`` blocks until every write is on disk and
    re-raises a write's error. One writer runs one write at a time: a
    save waits for the previous one first, so ``step_N`` directories
    never interleave, and the pinned host buffers of the previous save
    are then free to reuse. :attr:`snapshot` is the host tree of the
    newest save, the very bytes its file holds. On a rank of a layout of
    several, ``save`` gathers the global tree (collective) and only the
    layout's first rank writes it; elsewhere :attr:`snapshot` is None
    and nothing is written.
    """

    def __init__(self):
        # _thread and _error are touched by the caller, the write thread
        # and finalize_async's thread: every access holds _lock, and a
        # waiter clears _thread only if it is still the thread it joined
        # (a save may have started the next one meanwhile)
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pinned: list = []
        self.snapshot: Any = None

    def save(self, directory: str, step: int, tree: Any,
             overwrite: bool = True) -> str:
        self.wait()
        self.snapshot, writer = global_snapshot(tree, self._pinned)
        host, path = self.snapshot, _step_dir(directory, step)
        if not writer:
            return path

        def run():
            try:
                write_host_tree(directory, step, host, overwrite)
            except BaseException as e:  # noqa: BLE001 - re-raised by wait
                with self._lock:
                    self._error = e

        thread = threading.Thread(
            target=run, name="apex-torch-ckpt-write", daemon=True)
        with self._lock:
            self._thread = thread
        thread.start()
        return path

    def wait(self) -> None:
        with self._lock:
            thread = self._thread
        if thread is not None:
            thread.join()
        with self._lock:
            if self._thread is thread:
                self._thread = None
            error, self._error = self._error, None
        if error is not None:
            raise error

    def finalize_async(
        self,
        fn: Callable[[], None],
        on_error: Optional[Callable[[BaseException], None]] = None,
        name: str = "apex-torch-ckpt-finalize",
    ) -> threading.Thread:
        """Run ``fn()`` on a background thread once every pending write
        is on disk: the background half of verified checkpointing (the
        manifest's hashes and its commit). Returns the daemon thread;
        errors from the wait or ``fn`` go to ``on_error`` (default: a
        warning)."""

        def run() -> None:
            try:
                self.wait()
                fn()
            except Exception as e:  # noqa: BLE001 - surfaced via on_error
                if on_error is not None:
                    on_error(e)
                else:
                    logger.warning(
                        "background checkpoint finalize failed: %s", e)

        thread = threading.Thread(target=run, name=name, daemon=True)
        thread.start()
        return thread

    def close(self) -> None:
        self.wait()
        self._pinned = []
        self.snapshot = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _is_complete_step_dir(path: str) -> bool:
    """Reject step directories still being written (the temporary name
    of an interrupted save) and empty or file-typed ``step_N`` entries
    (a torn copy). Content-level corruption needs the checksum manifest
    (``resilience.integrity.verify_checkpoint``)."""
    if TMP_MARKER in os.path.basename(path):
        return False
    if not os.path.isdir(path):
        return False
    try:
        return bool(os.listdir(path))
    except OSError:
        return False


def finalized_steps(directory: str) -> list:
    """Ascending step numbers of complete ``step_N`` dirs in
    ``directory``."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for d in os.listdir(directory):
        if not d.startswith("step_"):
            continue
        tail = d.split("_", 1)[1]
        if not tail.isdigit():
            continue
        if _is_complete_step_dir(os.path.join(directory, d)):
            steps.append(int(tail))
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    steps = finalized_steps(directory)
    return steps[-1] if steps else None
