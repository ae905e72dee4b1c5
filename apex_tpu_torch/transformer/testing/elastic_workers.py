"""Rank functions of the elastic-restart and self-healing paths, for the
spawned worlds of the tests and of ``chip_smoke.py``'s ``gpt_elastic``
phase (every rank of one world of 4 runs them, one after another,
through ``distributed_test_base.jobs_worker``).

- :func:`elastic_trip_worker`: the GPT training step (``build_gpt_training``,
  ZeRO-2) trained at dp 4, saved, restored at dp 2 on the world's first
  two ranks (``parallel_state``'s sub-world; the others sit out),
  trained and saved, restored at dp 4 and trained again, beside an
  uninterrupted dp-4 run from the first save. Each restore is held to
  the checkpoint it came from: every leaf equal, every ZeRO flat buffer
  equal on the common prefix with zero padding, every leaf's crc32 that
  of its manifest.
- :func:`remediation_worker`: the remediation selftest's clean
  reference, its silent bit flip (detected by the canary, quarantined 4
  -> 2 and readmitted 2 -> 4) and its false-positive clear, at the
  caller's GPT config.
- :func:`campaign_worker` and :func:`acceptance_drill_worker`: the
  remediation campaign's seeded sequences, and one run with a SIGTERM,
  a hang and a silent bit flip, against the clean reference.

Each returns, on rank 0, what the caller checks and prints (the
kernels' launch counts of the job included); the other ranks return
their own timings.
"""

import gc
import os
import time

import numpy as np

__all__ = ["acceptance_drill_worker", "campaign_worker",
           "elastic_trip_worker", "remediation_worker"]


def _sync(device):
    import torch

    if device == "cuda":
        torch.cuda.synchronize()


def _release(device):
    import torch

    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()


def _held_to(directory, step, state):
    """(leaves equal, flat buffers prefix-equal, crc32s equal) of the
    restored ``state`` against ``step_<step>`` on disk: the global tree
    gathered to rank 0 (collective), None on the other ranks."""
    from apex_tpu_torch.resilience import integrity
    from apex_tpu_torch.resilience.elastic.layout import ZERO, StateLayout
    from apex_tpu_torch.resilience.elastic.reshard import _saved_by_path
    from apex_tpu_torch.utils.checkpoint import read_plain
    from apex_tpu_torch.utils.pytree import tree_leaves_with_path

    tree = state.as_tuple()
    layout = StateLayout(tree)
    host = layout.gather(tree)
    fp = integrity.global_fingerprint(tree)
    if not layout.is_writer:
        return None
    plain, leaves = read_plain(directory, step)
    saved = _saved_by_path(host, plain, leaves)
    manifest = integrity.read_manifest(
        os.path.join(directory, f"step_{step}"))
    want_crc = {leaf["path"]: leaf["crc32"]
                for leaf in manifest["fingerprint"]["leaves"]}
    got_crc = {leaf["path"]: leaf["crc32"] for leaf in fp["leaves"]}
    equal, prefix, crc = True, True, True
    for (path, t), split in zip(tree_leaves_with_path(host), layout.splits):
        s = saved[path]
        if split == ZERO:
            a, b = s.reshape(-1).numpy(), t.reshape(-1).numpy()
            n = min(a.shape[0], b.shape[0])
            prefix &= bool(np.array_equal(a[:n], b[:n])
                           and not a[n:].any() and not b[n:].any())
            same_len = a.shape == b.shape
        else:
            equal &= bool(s.shape == t.shape and s.dtype == t.dtype
                          and np.array_equal(s.view(-1).numpy(),
                                             t.view(-1).numpy()))
            same_len = True
        if same_len:
            crc &= got_crc[path] == want_crc[path]
    return {"leaves_equal": equal, "flat_prefix_equal": prefix,
            "crc32_equal": crc, "leaves": len(saved)}


def _global_state(state):
    """The global state tree, gathered to the layout's first rank as host
    tensors (collective); None on the other ranks."""
    from apex_tpu_torch.resilience.elastic.layout import StateLayout

    tree = state.as_tuple()
    return StateLayout(tree).gather(tree)


def _rel(x, y) -> float:
    """``|x - y| / |y|`` in fp64 2-norms; 0 where both are zero, inf where
    only ``y`` is."""
    import torch

    x, y = x.double(), y.double()
    diff = float(torch.linalg.vector_norm(x - y))
    ref = float(torch.linalg.vector_norm(y))
    return diff / ref if ref else (0.0 if diff == 0 else float("inf"))


def _rel_diffs(a, b, heads: int) -> dict:
    """:func:`_rel` of every floating-point leaf of two global state trees
    of one structure, by path. A fused QKV bias (each of ``heads`` heads
    ``[q | k | v]``) is taken as its three parts, ``<path> q``, ``k`` and
    ``v``: the key bias's gradient is zero in exact arithmetic (a softmax
    is blind to a constant added to a row's scores), so Adam moves it by
    the rounding of that zero, in steps of the learning rate whose signs
    any change of summation order redraws."""
    from apex_tpu_torch.utils.pytree import tree_leaves_with_path

    out = {}
    for (path, x), (_, y) in zip(tree_leaves_with_path(a),
                                 tree_leaves_with_path(b)):
        if not x.is_floating_point():
            continue
        if path.endswith("['query_key_value']['bias']"):
            for i, part in enumerate("qkv"):
                out[f"{path} {part}"] = _rel(x.reshape(heads, 3, -1)[:, i],
                                             y.reshape(heads, 3, -1)[:, i])
        else:
            out[path] = _rel(x, y)
    return out


def elastic_trip_worker(rank: int, world: int, cfg_kw: dict,
                        directory: str, device: str = "cuda",
                        steps=(3, 2, 2), sub: int = 2) -> dict:
    """The elastic trip (module docstring): ``steps`` = (at dp ``world``,
    then at dp ``sub``, then at dp ``world`` again). Rank 0 returns the
    losses of the trip and of the uninterrupted run, the checks of each
    restore, the bytes each checkpoint holds, and every rank's save and
    restore times (ms) and the bytes of its own part of the state. It also
    holds the state after the trip against the uninterrupted run's, leaf
    by leaf: ``state_rel_diff`` is each floating-point leaf's
    ``|trip - uninterrupted| / |uninterrupted|`` (:func:`_rel_diffs`), and
    ``state_moved`` the
    same of the uninterrupted run's last state against the first save's
    (how far the steps after the save move each leaf: the scale that a
    lost update or a wrong gradient would show)."""
    import torch
    import torch.distributed as dist

    from apex_tpu_torch import _kernels
    from apex_tpu_torch.data import IndexedTokenDataset, LMDataset
    from apex_tpu_torch.parallel import parallel_state as ps
    from apex_tpu_torch.resilience import integrity
    from apex_tpu_torch.resilience.elastic import restore_resharded
    from apex_tpu_torch.resilience.replay.targets import (
        GPTTargetConfig,
        build_gpt_training,
        synthetic_corpus,
    )
    from apex_tpu_torch.utils.pytree import (
        tree_copy_,
        tree_leaves_with_path,
    )

    if device == "cuda":
        torch.cuda.set_device(0)
    start = time.perf_counter()
    first, middle, last = steps
    gb = cfg_kw["global_batch"]
    lm = LMDataset(IndexedTokenDataset(synthetic_corpus(cfg_kw["vocab"], max(
        200_000, (sum(steps) + middle + last + 1) * gb * cfg_kw["seq_len"]
        + 1))), cfg_kw["seq_len"])
    out = {"rank": rank, "save_ms": {}, "restore_ms": {}, "state_bytes": {},
           "checks": {}, "losses": {}, "ckpt_bytes": {}}
    _kernels.reset_launch_counts()

    def build(n):
        _release(device)
        return build_gpt_training(GPTTargetConfig(**cfg_kw, max_devices=n),
                                  device=device)

    def train(training, state, s0, n):
        losses = []
        for s in range(s0, s0 + n):
            x, y = training.reshape_batch(*lm.batch(range(s * gb,
                                                          (s + 1) * gb)))
            _, loss, verdict, _ = training.train_step(state, x, y)
            if verdict != 0:
                raise AssertionError(f"step {s}: verdict {verdict}")
            losses.append(loss)
        return losses

    def save(state, step):
        _sync(device)
        t0 = time.perf_counter()
        integrity.save_checkpoint_verified(directory, step, state.as_tuple())
        out["save_ms"][step] = 1e3 * (time.perf_counter() - t0)
        out["state_bytes"][step] = sum(
            t.numel() * t.element_size() for _, t in tree_leaves_with_path(
                state.as_tuple()))
        if rank == 0:
            sd = os.path.join(directory, f"step_{step}")
            out["ckpt_bytes"][step] = sum(
                os.path.getsize(os.path.join(sd, f)) for f in os.listdir(sd))

    def restore(state, want):
        _sync(device)
        t0 = time.perf_counter()
        step, loaded = restore_resharded(directory, state.as_tuple())
        tree_copy_(state.as_tuple(), loaded)
        _sync(device)
        out["restore_ms"][want] = 1e3 * (time.perf_counter() - t0)
        if step != want:
            raise AssertionError(f"restored step {step}, not {want}")
        held = _held_to(directory, step, state)
        if held is not None:
            out["checks"][f"restore {step} at dp "
                          f"{ps.get_data_parallel_world_size()}"] = held

    # dp = world: `first` steps, saved; then the uninterrupted reference
    training = build(world)
    state = training.init_state()
    out["losses"]["first"] = train(training, state, 0, first)
    save(state, first)
    saved = _global_state(state)
    out["losses"]["reference"] = train(training, state, first,
                                       middle + last)
    reference = _global_state(state)
    del training, state
    # dp = sub on the first `sub` ranks: restore, `middle` steps, saved
    training = build(sub)
    if training is not None:
        state = training.init_state()
        restore(state, first)
        out["losses"]["sub"] = train(training, state, first, middle)
        save(state, first + middle)
        del state
    del training
    dist.barrier()
    # dp = world again: restore, `last` steps
    training = build(world)
    state = training.init_state()
    restore(state, first + middle)
    out["losses"]["back"] = train(training, state, first + middle, last)
    _sync(device)
    out["launches"] = _kernels.launch_counts()
    after = _global_state(state)
    if after is not None:
        out["state_rel_diff"] = _rel_diffs(after, reference,
                                           cfg_kw["heads"])
        out["state_moved"] = _rel_diffs(reference, saved, cfg_kw["heads"])
    del saved, reference, after
    del training, state
    _release(device)
    out["seconds"] = time.perf_counter() - start
    return out


def remediation_worker(rank: int, world: int, directory: str,
                       device: str = "cuda", overrides=None,
                       steps: int = 8, flip_step: int = 3,
                       probation: int = 3, clear_segments=None) -> dict:
    """The remediation selftest's checks 1-3 (``resilience.remediation
    .__main__.selftest_rank``) at ``overrides`` of the campaign config,
    with the job's launch counts."""
    from apex_tpu_torch import _kernels
    from apex_tpu_torch.resilience.remediation.__main__ import (
        selftest_rank,
    )

    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = selftest_rank(rank, world, directory, device, steps=steps,
                        overrides=overrides, flip_step=flip_step,
                        probation=probation, clear_segments=clear_segments)
    _sync(device)
    out["launches"] = _kernels.launch_counts()
    out["seconds"] = time.perf_counter() - t0
    _release(device)
    return out


def campaign_worker(rank: int, world: int, workroot: str, n: int,
                    seed: int = 0, device: str = "cuda"):
    """``run_campaign`` of ``n`` sequences from ``seed`` (rank 0's
    report)."""
    from apex_tpu_torch.resilience.remediation.campaign import run_campaign

    report = run_campaign(workroot, n_sequences=n, seed=seed,
                          minimize=True, device=device)
    return report if rank == 0 else None


def acceptance_drill_worker(rank: int, world: int, workroot: str,
                            device: str = "cuda", steps: int = 8):
    """The clean reference and one sequence with a SIGTERM after step 2,
    a hang at 4 and a silent bit flip after 6 (rank 0's results and the
    invariant checker's violations)."""
    from apex_tpu_torch.resilience.remediation.campaign import (
        FaultEvent,
        TrainingCache,
        campaign_config,
        campaign_corpus,
        check_invariants,
        run_sequence,
    )

    cfg = campaign_config()
    cache = TrainingCache(cfg, device)
    lm, corpus = campaign_corpus(cfg, steps)
    reference = run_sequence([], os.path.join(workroot, "reference"),
                             cache, lm, corpus, steps=steps)
    faults = [FaultEvent("sigterm", 2), FaultEvent("hang", 4),
              FaultEvent("bitflip", 6)]
    result = run_sequence(faults, os.path.join(workroot, "drill"), cache,
                          lm, corpus, steps=steps)
    if rank != 0:
        return None
    return {"reference": reference, "result": result,
            "violations": check_invariants(
                result, reference_losses=reference.losses,
                final_step=steps - 1)}
