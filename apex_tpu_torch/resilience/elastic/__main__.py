"""``python -m apex_tpu_torch.resilience.elastic`` — the elastic round-trip
gate (counterpart of ``python -m apex_tpu.resilience.elastic``).

Exit-nonzero selftest of the restore across a change of layout, in one
spawned world of 4 gloo ranks (the JAX gate's 8 -> 4 -> 8 devices, here
4 -> 2 -> 4 ranks through ``parallel_state``'s sub-world):

1. build JAX's toy: a real ZeRO-2 state (``distributed_fused_adam``)
   beside replicated params, a loss scale and an RNG key (param total
   225). Save it as it starts (step 0), train 3 steps at dp 4 and save
   with the integrity manifest (topology block included);
2. restore it at dp 2 on ranks {0, 1} (``restore_resharded``): params
   re-laid-out, the ZeRO flat buffers regrouped, each leaf's crc32
   verified over its global array; one more step proves the state live,
   and it is saved; then back at dp 4 the same way. Both packages pad
   the flat buffer to the flatten's 65,536-element chunk before padding
   to dp, so 4 -> 2 -> 4 keeps its length (65,536); the legs 4 -> 3 ->
   4 on ranks {0, 1, 2} change it (65,538 at dp 3) and regroup it both
   ways. Every restore is checked bit for bit on the unpadded prefix,
   with zero padding (JAX's ``flat_prefix_equal``);
3. refusals at dp 2: a non-ZeRO global-shape change, a spec naming an
   absent mesh axis, a structure change, and a corrupted newest step
   (skipped: the walk falls back to the verified step before it);
4. a newest step whose manifest predates the topology block is skipped
   and the walk falls back to the newest one that carries it.

Runs on the card (4 ranks over gloo on ``cuda:0``) unless ``--device
cpu``; without a card it exits nonzero. Any failed check prints its
reason and exits 1.
"""

import argparse
import importlib
import os
import sys
import tempfile

import numpy as np

WORLD = 4
SUB = 2
ODD = 3
#: the flat buffers' length at dp 1, 2 and 4: 225 padded to the
#: flatten's chunk (``ops.multi_tensor.CHUNK_SIZE``)
CHUNK = 65536


def toy_init(device="cpu"):
    """JAX's toy parameters' shapes, drawn from a seeded generator:
    ``w`` (12, 16) and ``emb`` (8, 4) normal, ``b`` (1,) zero (param total
    225)."""
    import torch

    g = torch.Generator().manual_seed(0)
    return {"w": torch.randn(12, 16, generator=g).numpy(),
            "b": np.zeros((1,), np.float32),
            "emb": torch.randn(8, 4, generator=g).numpy()}


def _toy(init, device):
    """(state, train) on the live layout: ZeRO-2 Adam at lr 0.1 over dp,
    loss the sum of the parameters' squares (JAX's toy)."""
    import torch

    from apex_tpu_torch.optimizers import distributed_fused_adam

    params = {k: torch.tensor(np.asarray(v, np.float32), device=device)
              for k, v in init.items()}
    opt = distributed_fused_adam(lr=0.1, axis_name="dp")
    state = {"params": params, "opt": opt.init(params),
             "loss_scale": torch.tensor(1024.0, device=device),
             "rng": torch.tensor([0, 7], dtype=torch.uint32, device=device)}

    @torch.no_grad()
    def train():
        grads = {k: 2.0 * p for k, p in state["params"].items()}
        updates, state["opt"] = opt.update(grads, state["opt"],
                                           state["params"])
        for k, p in state["params"].items():
            p.add_(updates[k])

    return state, train


def _global(state):
    """The global tree as numpy on the layout's first rank (collective),
    None elsewhere: ``{path: array}``."""
    from apex_tpu_torch.resilience.elastic.layout import StateLayout
    from apex_tpu_torch.utils.pytree import tree_leaves_with_path

    host = StateLayout(state).gather(state)
    if host is None:
        return None
    return {p: t.numpy() for p, t in tree_leaves_with_path(host)}


def flat_prefix_equal(a, b) -> bool:
    """JAX's check: equal on the common prefix, zeros past it."""
    a, b = np.asarray(a), np.asarray(b)
    n = min(a.shape[0], b.shape[0])
    return bool(np.array_equal(a[:n], b[:n]) and not np.any(a[n:])
                and not np.any(b[n:]))


def _refusal(fn):
    """(refused, message): JAX's verdict shape for one refusal case."""
    from apex_tpu_torch.resilience.elastic import ElasticRestoreError

    try:
        fn()
    except ElasticRestoreError as e:
        return True, str(e)
    return False, ""


ZERO_FIELDS = ("master_shard", "exp_avg", "exp_avg_sq")


def selftest_rank(rank: int, world: int, directory: str, init: dict,
                  device: str = "cpu") -> dict:
    """One rank of the selftest's world (module docstring); returns what
    it saw: the checks (rank 0's are the gate's), the global arrays at
    each save and after each restore (``saved``/``restored``, by step),
    the manifests' crc32s (``crc``, by step) and the refusals."""
    import torch
    import torch.distributed as dist

    from apex_tpu_torch.parallel import parallel_state as ps
    from apex_tpu_torch.resilience import chaos, integrity
    from apex_tpu_torch.resilience.elastic import restore_resharded
    from apex_tpu_torch.utils.checkpoint import save_checkpoint
    from apex_tpu_torch.utils.pytree import tree_copy_, tree_leaves_with_path

    if device == "cuda":
        torch.cuda.set_device(0)
    checks = []
    out = {"checks": checks, "saved": {}, "restored": {}, "crc": {}}

    def check(ok, label):
        checks.append((bool(ok), label))

    def restore(target, **kw):
        step, loaded = restore_resharded(directory, target, **kw)
        tree_copy_(target, loaded)
        return step

    def save(state, step):
        integrity.save_checkpoint_verified(directory, step, state)
        g = _global(state)
        if rank == 0:
            out["saved"][step] = g
            out["crc"][step] = {leaf["path"]: leaf["crc32"] for leaf in
                                integrity.read_manifest(os.path.join(
                                    directory, f"step_{step}"))[
                                        "fingerprint"]["leaves"]}

    def leg(devices, want_step, steps, save_step):
        """Restore onto ``devices`` ranks (the newest step, which must be
        ``want_step``), check it against what was saved, train
        ``steps`` steps and save ``save_step``; sitting-out ranks wait."""
        ps.initialize_model_parallel(devices=devices)
        if ps.participates():
            state, train = _toy(init, device)
            step = restore(state)
            g = _global(state)
            if rank == 0:
                was = out["saved"][want_step]
                tag = f"{world}->{devices}" if devices < world else \
                    f"->{devices}"
                check(step == want_step,
                      f"{tag} restored the saved step {want_step}")
                check(all(np.array_equal(was[p], g[p]) for p in g
                          if p.startswith("['params']")),
                      f"{tag} params bit-identical")
                for field in ZERO_FIELDS:
                    p = f"['opt'].{field}"
                    check(flat_prefix_equal(was[p], g[p]),
                          f"{tag} ZeRO {field} regrouped "
                          f"{was[p].shape[0]} -> {g[p].shape[0]} "
                          f"(unpadded prefix identical, pads zero)")
                check(int(g["['opt'].step"]) == int(was["['opt'].step"]),
                      f"{tag} optimizer step counter survived")
                check(np.array_equal(g["['rng']"], was["['rng']"])
                      and float(g["['loss_scale']"]) == 1024.0,
                      f"{tag} RNG key and loss scale survived")
                out["restored"][step] = g
            try:
                for _ in range(steps):
                    train()
                check(True, f"dp {devices} step on the regrouped state "
                            f"runs")
            except Exception as e:  # noqa: BLE001 - the gate reports
                check(False, f"dp {devices} step on the regrouped state: "
                             f"{e!r}")
            save(state, save_step)
        dist.barrier()

    # 1) dp 4: the initial state saved (step 0), three steps, saved
    ps.initialize_model_parallel(devices=world)
    state4, train4 = _toy(init, device)
    save(state4, 0)
    for _ in range(3):
        train4()
    save(state4, 3)
    if rank == 0:
        topo = integrity.read_manifest(
            os.path.join(directory, "step_3"))["topology"]
        check(bool(topo), "manifest carries the topology block")
        zero = [leaf for leaf in topo["leaves"]
                if leaf.get("zero_shard_axis") == "dp"]
        check(len(zero) == 3,
              "ZeRO master+moment leaves marked zero_shard_axis=dp")
        check(all(leaf["shape"] == [CHUNK] for leaf in zero),
              f"dp {world} flat buffers hold {CHUNK} (225 padded to the "
              f"flatten's chunk, a multiple of {world})")
    dist.barrier()
    # 2) 4 -> 2 -> 4, and 4 -> 3 -> 4, where the flat length changes
    # (65,536 is no multiple of 3: 65,538 at dp 3)
    leg(SUB, 3, 1, 4)
    leg(world, 4, 1, 5)
    leg(ODD, 5, 1, 6)
    if rank == 0:
        check(out["saved"][6]["['opt'].master_shard"].shape == (CHUNK + 2,),
              f"dp {ODD} flat buffers hold {CHUNK + 2}")
    leg(world, 6, 0, 7)

    # 3) refusals and fallbacks at dp 2 (the newest step, 7, saved at dp 4)
    ps.initialize_model_parallel(devices=SUB)
    if ps.participates():
        target, _ = _toy(init, device)
        refusals = {}
        bad = dict(target, params=dict(target["params"]))
        bad["params"]["w"] = torch.zeros((12, 17), device=device)
        refusals["shape"] = _refusal(
            lambda: restore_resharded(directory, bad))
        n_leaves = len(list(tree_leaves_with_path(target)))
        refusals["axis"] = _refusal(lambda: restore_resharded(
            directory, target, target_specs=[["ep"]] * n_leaves))
        extra = dict(target, bonus=torch.zeros((2,), device=device))
        refusals["structure"] = _refusal(
            lambda: restore_resharded(directory, extra))
        out["refusals"] = refusals
        if rank == 0:
            check(refusals["shape"][0]
                  and "refusing to guess" in refusals["shape"][1],
                  "refuses a non-ZeRO shape change (reasoned)")
            check(refusals["axis"][0]
                  and "absent from the restore mesh" in refusals["axis"][1],
                  "refuses a spec naming an absent axis (reasoned)")
            check(refusals["structure"][0]
                  and "structure differs" in refusals["structure"][1],
                  "refuses a structure change (reasoned)")
            # corruption: the newest step's payload bit-flipped
            chaos.corrupt_checkpoint(os.path.join(directory, "step_7"),
                                     mode="bitflip")
        dist.barrier(group=ps.get_model_world_group())
        step = restore(target)
        if rank == 0:
            check(step == 6,
                  "corrupted newest step skipped; fell back to verified "
                  "step")
        # a newest manifest that predates the topology block (legacy)
        save_checkpoint(directory, 8, target)
        if rank == 0:
            integrity.write_manifest(os.path.join(directory, "step_8"))
        dist.barrier(group=ps.get_model_world_group())
        step = restore(target)
        if rank == 0:
            check(step == 6, "pre-topology newest manifest skipped "
                             "(format-upgrade rollback)")
    dist.barrier()
    ps.destroy_model_parallel()
    # the world made each group once, whatever the layouts it ran
    out["groups_made"] = ps.groups_made()
    return out


def selftest(directory=None, device="cuda", timeout=600.0) -> int:
    from apex_tpu_torch._kernels import resolve_device
    from apex_tpu_torch.resilience.exit_codes import ExitCode
    from apex_tpu_torch.transformer.testing.distributed_test_base import (
        spawn,
    )

    device = resolve_device(device).type
    directory = directory or tempfile.mkdtemp(
        prefix="apex_torch_elastic_")
    print(f"elastic selftest (dir {directory}, {WORLD} -> {SUB} -> "
          f"{WORLD} -> {ODD} -> {WORLD} ranks, {device})", flush=True)
    # the rank function by its module's own name: a spawned child does
    # not re-import a package's __main__ (multiprocessing skips it)
    rank_fn = importlib.import_module(
        "apex_tpu_torch.resilience.elastic.__main__").selftest_rank
    outs = spawn(rank_fn, WORLD, args=(directory, toy_init(), device),
                 timeout=timeout)
    failures = []
    for ok, label in outs[0]["checks"]:
        print(f"  [{'ok' if ok else 'FAIL'}] {label}", flush=True)
        if not ok:
            failures.append(label)
    if failures:
        print(f"elastic selftest: {len(failures)} check(s) FAILED:",
              flush=True)
        for f in failures:
            print(f"  - {f}", flush=True)
        return int(ExitCode.FAILURE)
    print("elastic selftest: all checks passed", flush=True)
    return int(ExitCode.OK)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.resilience.elastic",
        description="elastic-restart round-trip self-test, 4 -> 2 -> 4 "
                    "ranks (exit nonzero on any failed check)")
    parser.add_argument("--selftest", action="store_true",
                        help="run the self-test (the default and only mode)")
    parser.add_argument("--dir", default=None,
                        help="checkpoint scratch dir (default: a temp dir, "
                             "kept for inspection)")
    parser.add_argument("--device", default="cuda",
                        help="where the ranks' tensors live (cuda unless "
                             "cpu is asked for)")
    args = parser.parse_args(argv)
    return selftest(args.dir, device=args.device)


if __name__ == "__main__":
    sys.exit(main())
