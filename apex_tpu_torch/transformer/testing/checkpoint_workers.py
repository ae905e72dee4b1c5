"""Rank functions of the checkpoints at pp x tp and at cp, for the
spawned worlds of ``tests/test_torch_checkpoint_pp.py`` and of
``chip_smoke.py``'s ``gpt_checkpoint_pp`` job (through
``distributed_test_base.jobs_worker``).

- :func:`pipeline_checkpoint_worker`: ``standalone_gpt``'s
  ``GPTPipelineTraining`` (1F1B, ``fused_adam``) at pp x tp, optionally
  from given weights: ``warmup`` steps, a save through ``AutoResume``
  (async, fingerprinted, the global tree gathered to rank 0, its
  ``pp``-stacked stages), a rollback snapshot, ``steps`` uninterrupted
  steps, a rollback held to the save, a restore through ``AutoResume``
  and ``steps`` more, held to the uninterrupted run, and every rank's
  restored state held to its own state at the save; then the same
  checkpoint restored at pp 1 (refused, naming ``pp``).
- :func:`cp_checkpoint_worker`: the long-context example's
  ``RingCPTraining`` at cp x dp, each dp rank on its rows of the batch
  and ``distributed_fused_adam`` over dp in place of its ``fused_adam``,
  the same trip, then a restore of the checkpoint at cp 1 (dp over the
  whole world), which regroups the ZeRO buffers as a change of dp.
- :func:`tp_change_worker`: the GPT training step with ZeRO saved at tp
  2 and restored at tp 1 (refused: the ZeRO buffers' rows are per tp
  rank).

Each returns, on rank 0, what the caller checks (the saved global tree
and its manifest's blocks where asked); the other ranks return their
own timings and sizes. Where the tree is asked for, every rank also
returns its own state at the save under ``"local"`` (numpy, by the
global tree's paths), from which the caller lays out the reference's
global arrays.
"""

import os
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

__all__ = ["cp_checkpoint_worker", "pipeline_checkpoint_worker",
           "tp_change_worker"]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.float().numpy()
    return t.numpy()


def _refusal(fn) -> Optional[str]:
    from apex_tpu_torch.resilience.elastic import ElasticRestoreError

    try:
        fn()
    except ElasticRestoreError as e:
        return str(e)
    return None


def _leaves(tree) -> Dict[str, torch.Tensor]:
    from apex_tpu_torch.utils.pytree import tree_leaves_with_path

    return dict(tree_leaves_with_path(tree))


def _equal_trees(a, b) -> bool:
    """Are two host trees of one structure equal bit for bit?"""
    from apex_tpu_torch.utils.pytree import tree_leaves_with_path

    la, lb = list(tree_leaves_with_path(a)), list(tree_leaves_with_path(b))
    return [p for p, _ in la] == [p for p, _ in lb] and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(x.view(-1).view(torch.uint8) if x.dim() else x,
                        y.view(-1).view(torch.uint8) if y.dim() else y)
        for (_, x), (_, y) in zip(la, lb))


def _max_rel(a, b) -> float:
    """The largest ``|a - b| / |b|`` (fp32 2-norms) over two host trees."""
    from apex_tpu_torch.utils.pytree import tree_leaves_with_path

    worst = 0.0
    for (_, x), (_, y) in zip(tree_leaves_with_path(a),
                              tree_leaves_with_path(b)):
        if not x.is_floating_point():
            continue
        x, y = x.float(), y.float()
        diff = float(torch.linalg.vector_norm(x - y))
        ref = float(torch.linalg.vector_norm(y))
        worst = max(worst, diff / ref if ref else (0.0 if diff == 0
                                                   else float("inf")))
    return worst


def _trip(state_fn: Callable, step_fn: Callable, directory: str, device,
          warmup: int, steps: int, want_tree: bool) -> Dict:
    """The trip of the module docstring over a live state: ``state_fn()``
    gives the live tree, ``step_fn(i)`` trains once on batch ``i`` and
    returns its loss (the restored run takes the uninterrupted run's
    batches).
    Rank 0 gets the checks; every rank its own timings and bytes."""
    from apex_tpu_torch.parallel import parallel_state as ps
    from apex_tpu_torch.resilience import integrity
    from apex_tpu_torch.resilience.elastic.layout import StateLayout
    from apex_tpu_torch.resilience.elastic.reshard import _saved_by_path
    from apex_tpu_torch.resilience.rollback import RollbackBuffer
    from apex_tpu_torch.utils.autoresume import AutoResume
    from apex_tpu_torch.utils.checkpoint import read_plain
    from apex_tpu_torch.utils.pytree import tree_leaves_with_path

    def global_tree():
        tree = state_fn()
        return StateLayout(tree).gather(tree)

    warm = [step_fn(i) for i in range(warmup)]
    saved_step = warmup
    at_save = {p: t.detach().clone()
               for p, t in tree_leaves_with_path(state_fn())}
    ar = AutoResume(directory, interval=1, install_handlers=False)
    _sync(device)
    t0 = time.perf_counter()
    ar.step(saved_step, state_fn())  # the async save's blocking slice
    save_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ar.finalize()
    finalize_ms = (time.perf_counter() - t0) * 1e3
    rollback = RollbackBuffer(capacity=1)
    rollback.snapshot(saved_step, state_fn())
    local_bytes = sum(t.numel() * t.element_size()
                      for _, t in tree_leaves_with_path(state_fn()))

    losses_a = [step_fn(warmup + j) for j in range(steps)]
    after_a = global_tree()
    rollback.rollback(into=state_fn())
    rolled = global_tree()
    _sync(device)
    t0 = time.perf_counter()
    step, _ = ar.restore(state_fn())
    _sync(device)
    restore_ms = (time.perf_counter() - t0) * 1e3
    # this rank's own leaves, not the gathered tree: a replica saved from
    # another rank that had drifted from this one shows here
    restores_its_save = _equal_trees(
        {p: t.detach() for p, t in tree_leaves_with_path(state_fn())},
        at_save)
    restored = global_tree()
    losses_b = [step_fn(warmup + j) for j in range(steps)]
    after_b = global_tree()
    ar.close()

    mine = {"save_blocking_ms": save_ms, "finalize_ms": finalize_ms,
            "restore_ms": restore_ms, "local_bytes": local_bytes,
            "restores_its_save": restores_its_save}
    dist = torch.distributed
    ranks = ps.all_gather_object(mine, group=dist.group.WORLD)
    local = {p: _np(t) for p, t in at_save.items()} if want_tree else None
    del at_save
    if dist.get_rank() != 0:
        return dict(mine, local=local) if want_tree else mine
    plain, leaves = read_plain(directory, saved_step)
    saved = _saved_by_path(restored, plain, leaves)
    saved_tree = {p: saved[p] for p, _ in tree_leaves_with_path(restored)}
    manifest = integrity.read_manifest(
        os.path.join(directory, f"step_{saved_step}"))
    out = {
        "restored_step": step, "saved_step": saved_step,
        "warmup_losses": warm, "losses": losses_a,
        "restored_losses": losses_b,
        "losses_equal": losses_a == losses_b,
        "state_equal": _equal_trees(after_b, after_a),
        "state_max_rel": _max_rel(after_b, after_a),
        "restore_equals_save": all(
            torch.equal(saved_tree[p], t)
            for p, t in tree_leaves_with_path(restored)),
        "rollback_equals_save": _equal_trees(rolled, restored),
        "every_rank_restores_its_save": all(
            r["restores_its_save"] for r in ranks),
        "ranks": ranks,
        "checkpoint_bytes": sum(
            os.path.getsize(os.path.join(d, f))
            for d, _, fs in os.walk(os.path.join(
                directory, f"step_{saved_step}")) for f in fs),
        "mesh": manifest["topology"]["mesh"],
    }
    if want_tree:
        out["tree"] = {p: _np(t) for p, t in saved_tree.items()}
        out["crc"] = {leaf["path"]: leaf["crc32"]
                      for leaf in manifest["fingerprint"]["leaves"]}
        out["topology"] = {leaf["path"]: leaf for leaf in
                           manifest["topology"]["leaves"]}
        out["local"] = local
    return out


def pipeline_checkpoint_worker(rank: int, world_size: int,
                               argv: Sequence[str], directory: str,
                               params: Optional[Sequence] = None,
                               device: str = "cpu", warmup: int = 0,
                               steps: int = 2, want_tree: bool = False
                               ) -> Dict:
    """The pipelined trip (module docstring) of ``standalone_gpt``'s
    arguments ``argv`` on ``device``, from ``params[rank]`` (the
    ``{"pre", "stages", "post"}`` of ``gpt_pipeline_params_from_jax``)
    where given; then the checkpoint restored at pp 1, whose refusal
    rank 0 returns under ``"pp_refusal"``, with the kernels' launch
    counts of the trip."""
    from apex_tpu_torch import _kernels
    from apex_tpu_torch.resilience.elastic import restore_resharded
    from apex_tpu_torch.transformer.testing.pipeline_workers import _args
    from apex_tpu_torch.transformer.testing.standalone_gpt import (
        GPTPipelineTraining,
    )

    args = _args(argv, world_size)
    run = GPTPipelineTraining(args, device)
    if params is not None:
        run.load(params[rank])
    _kernels.reset_launch_counts()
    out = _trip(run.state, lambda i: run.step(i % run.steps),
                directory, device, warmup, steps, want_tree)
    launches = _kernels.launch_counts()
    del run
    flat = list(argv)
    flat[flat.index("--pipeline-model-parallel-size") + 1] = "1"
    one = GPTPipelineTraining(_args(flat, world_size), device)
    refusal = _refusal(lambda: restore_resharded(directory, one.state()))
    if rank == 0:
        out["pp_refusal"] = refusal
        out["launches"] = launches
    return out


def cp_checkpoint_worker(rank: int, world_size: int, config: Dict,
                         batch: Dict[str, np.ndarray], directory: str,
                         params: Optional[Dict[str, np.ndarray]] = None,
                         cp: int = 2, device: str = "cpu", lr: float = 1e-3,
                         warmup: int = 0, steps: int = 2,
                         want_tree: bool = False) -> Dict:
    """The cp x dp trip (module docstring): a ``GPTModel`` of ``config``
    (ring attention) from ``params`` where given, ``RingCPTraining`` on
    this dp rank's rows of ``batch`` with ZeRO over dp; then the
    checkpoint restored at cp 1 over the whole world (dp = world), whose
    restored global state rank 0 returns under ``"cp1"`` (or the refusal
    under ``"cp1_refusal"``)."""
    from apex_tpu_torch.examples.long_context.train_ring_cp import (
        RingCPTraining,
    )
    from apex_tpu_torch.models.gpt import GPTModel
    from apex_tpu_torch.optimizers import distributed_fused_adam
    from apex_tpu_torch.parallel import parallel_state as ps
    from apex_tpu_torch.resilience.elastic import (
        ElasticRestoreError,
        restore_resharded,
    )
    from apex_tpu_torch.resilience.elastic.layout import StateLayout
    from apex_tpu_torch.transformer.config import TransformerConfig

    def build(cp_size):
        ps.initialize_model_parallel(context_parallel_size=cp_size)
        model = GPTModel(TransformerConfig(**config), device=device, seed=0)
        if params is not None:
            model.load_state_dict({k: torch.as_tensor(v)
                                   for k, v in params.items()})
        dp_group = ps.get_data_parallel_group()
        rows = batch["tokens"].shape[0] // ps.group_size(dp_group)
        d = ps.get_data_parallel_rank()
        run = RingCPTraining(model, {k: v[d * rows:(d + 1) * rows]
                                     for k, v in batch.items()}, lr=lr)
        # ZeRO over dp: the Adam state sharded over dp and replicated over
        # cp, as JAX's distributed_fused_adam over "dp" keeps it
        run.opt = distributed_fused_adam(lr=lr, group=dp_group)
        run.state = run.opt.init({n: p.detach()
                                  for n, p in run.params.items()})
        return run

    run = build(cp)
    out = _trip(lambda: (run.params, run.state), lambda i: run.step(),
                directory, device, warmup, steps, want_tree)
    del run
    one = build(1)
    tree = (one.params, one.state)
    try:
        _, restored = restore_resharded(directory, tree)
        host = StateLayout(restored).gather(restored)
        if rank == 0:
            out["cp1"] = {p: _np(t) for p, t in _leaves(host).items()}
    except ElasticRestoreError as e:
        if rank == 0:
            out["cp1_refusal"] = str(e)
    return out


def tp_change_worker(rank: int, world_size: int, cfg_kw: Dict,
                     directory: str, device: str = "cpu") -> Optional[str]:
    """The GPT training step with ZeRO (``build_gpt_training``) saved at
    tp 2 and restored at tp 1: the refusal's message on rank 0 (None if
    the restore went through)."""
    from apex_tpu_torch.resilience import integrity
    from apex_tpu_torch.resilience.elastic import restore_resharded
    from apex_tpu_torch.resilience.replay.targets import (
        GPTTargetConfig,
        build_gpt_training,
    )

    two = build_gpt_training(GPTTargetConfig(tp=2, zero=True, **cfg_kw),
                             device)
    integrity.save_checkpoint_verified(directory, 1,
                                       two.init_state().as_tuple())
    one = build_gpt_training(GPTTargetConfig(tp=1, zero=True, **cfg_kw),
                             device)
    refusal = _refusal(lambda: restore_resharded(
        directory, one.init_state().as_tuple()))
    return refusal if rank == 0 else None
