"""Spawned multi-process worlds for tests (counterpart of the reference's
apex/transformer/testing/distributed_test_base.py).

:func:`spawn` starts ``world_size`` processes (the ``spawn`` start method)
that join one ``torch.distributed`` world over a file-store rendezvous in
a fresh temporary directory, so concurrent test workers never contend for
a port. Each rank runs ``fn(rank, world_size, *args)``, a function of an
importable module, and its return value comes back to the caller by rank.
Every rank destroys ``parallel_state``'s groups and the process group
when ``fn`` ends or fails. The caller waits for all of them at most
``timeout`` seconds, or until one fails, then kills what is left and
raises, so a failed or hung rank fails the test instead of stalling the
run (the other ranks would wait in their next collective).
"""

import multiprocessing
import os
import pickle
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence

__all__ = ["jobs_worker", "spawn"]


def _rank_main(rank: int, world_size: int, backend: str, store: str,
               out_dir: str, fn: Callable, args: Sequence,
               threads: int) -> None:
    import torch
    import torch.distributed as dist

    from apex_tpu_torch.parallel import parallel_state

    torch.set_num_threads(threads)  # ranks share the host's cores
    result, error = None, None
    try:
        dist.init_process_group(backend, init_method=f"file://{store}",
                                world_size=world_size, rank=rank)
        result = fn(rank, world_size, *args)
    except BaseException:  # reported to the caller, who raises it
        error = traceback.format_exc()
    finally:
        try:
            parallel_state.destroy_model_parallel()
            if dist.is_initialized():
                dist.destroy_process_group()
        except Exception:  # the teardown's failure must not hide fn's
            error = (error or "") + traceback.format_exc()
    path = os.path.join(out_dir, f"rank{rank}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump((result, error), f)
    os.replace(path + ".tmp", path)  # whole or absent, even if killed
    if error:
        raise SystemExit(1)


def spawn(fn: Callable, world_size: int, args: Sequence = (),
          timeout: float = 180.0, backend: str = "gloo",
          threads: int = 1) -> List[Any]:
    """``[fn(0, world_size, *args), ..., fn(world_size - 1, ...)]``, each
    run in its own process of one ``backend`` world with ``threads``
    intra-op CPU threads (one by default: test workers run worlds side by
    side). Raises with the ranks' tracebacks if any rank raised, or
    ``TimeoutError`` if the world has not ended after ``timeout``
    seconds."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="apex_tpu_torch_world_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world_size, backend, store, tmp, fn,
                                   tuple(args), threads), daemon=True)
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while True:
                codes = [p.exitcode for p in procs]
                if None not in codes or any(c not in (None, 0)
                                            for c in codes):
                    break
                if time.monotonic() > deadline:
                    hung = [r for r, c in enumerate(codes) if c is None]
                    raise TimeoutError(f"ranks {hung} of {world_size} still "
                                       f"ran after {timeout} s")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(5.0)
        results, errors = [], []
        for r in range(world_size):
            path = os.path.join(tmp, f"rank{r}.pkl")
            if not os.path.exists(path):
                errors.append(f"rank {r} ended (exit code "
                              f"{procs[r].exitcode}) with no result")
                continue
            with open(path, "rb") as f:
                result, error = pickle.load(f)
            if error:
                errors.append(f"rank {r}:\n{error}")
            results.append(result)
        if errors:
            raise RuntimeError("spawned world failed:\n" + "\n".join(errors))
        return results


def jobs_worker(rank: int, world_size: int, jobs: Sequence) -> List[Any]:
    """Runs ``jobs``, pairs (``"package.module:function"`` of a rank
    function, its extra arguments), one after another in one world, with
    ``parallel_state``'s groups destroyed after each; returns their
    results in order. One spawned world serves rank functions of several
    modules, so a run pays the processes' start once. Each job's cached
    device memory goes back to the card when it ends (worlds may share
    one card), and rank 0 writes each job's seconds to standard error."""
    import importlib
    import sys

    import torch

    from apex_tpu_torch.parallel import parallel_state

    out = []
    for name, args in jobs:
        module, fn = name.split(":")
        t0 = time.perf_counter()
        out.append(getattr(importlib.import_module(module), fn)(
            rank, world_size, *args))
        parallel_state.destroy_model_parallel()
        if torch.cuda.is_initialized():
            torch.cuda.empty_cache()
        if rank == 0:
            print(f"world of {world_size}: {fn} ran "
                  f"{time.perf_counter() - t0:.1f} s", file=sys.stderr,
                  flush=True)
    return out
