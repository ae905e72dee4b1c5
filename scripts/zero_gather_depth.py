"""Times one ZeRO Adam update (``distributed_fused_adam``) at
``param_gather_buckets`` 1 and 2 over data-parallel groups that gloo
stages through host memory, every rank on one card, as the multi-rank
worlds of ``chip_smoke.py`` run it.

    PYTHONPATH=. python3 scripts/zero_gather_depth.py [--ranks 4]
        [--tp 2] [--elements 34000000] [--reps 5]

(from a checkout's root, with it on ``PYTHONPATH``).

Each rank holds ``--elements`` fp32 parameters in one tensor (the
default is about a tp rank's share of GPT-2 small at depth 4 and tp 2)
and a gradient drawn from its rank's seed. After one warm-up update at
each depth, the two depths alternate (1, 2, 1, 2, ...) ``--reps`` times,
each update timed on the host clock between two device synchronisations
behind a barrier. Prints one JSON line: the card's name and power limit,
the dp group's size, each depth's times in ms (rank 0's, and the slowest
rank's median), and whether the two depths' updates are bit for bit
equal. Needs a card.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time


def rank_fn(rank, world_size, elements, tp, reps):
    import torch
    import torch.distributed as dist

    from apex_tpu_torch.optimizers import distributed_fused_adam
    from apex_tpu_torch.parallel import parallel_state as ps

    ps.initialize_model_parallel(tp)
    dev = torch.device("cuda")
    # the parameters are replicated over dp: one seed a tp rank
    gen = torch.Generator().manual_seed(ps.get_tensor_model_parallel_rank())
    params = {"w": torch.randn(elements, generator=gen).to(dev)}
    gen = torch.Generator().manual_seed(1000 + rank)
    grads = {"w": torch.randn(elements, generator=gen).to(dev)}
    opts, states, last = {}, {}, {}
    for nb in (1, 2):
        opts[nb] = distributed_fused_adam(lr=1e-3, param_gather_buckets=nb)
        states[nb] = opts[nb].init(params)
        opts[nb].update(grads, states[nb], params)  # warm-up
    times = {1: [], 2: []}
    for _ in range(reps):
        for nb in (1, 2):
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            upd, _ = opts[nb].update(grads, states[nb], params)
            torch.cuda.synchronize()
            times[nb].append((time.perf_counter() - t0) * 1e3)
            last[nb] = upd["w"]
    return {"times": times, "bitwise": bool(torch.equal(last[1], last[2])),
            "dp": ps.get_data_parallel_world_size()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--tp", type=int, default=2)
    ap.add_argument("--elements", type=int, default=34_000_000)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("zero_gather_depth: no CUDA device")
    from apex_tpu_torch.transformer.testing.distributed_test_base import (
        spawn,
    )

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    ranks = spawn(rank_fn, args.ranks,
                  args=(args.elements, args.tp, args.reps), timeout=600.0)
    out = {"gpu": smi, "ranks": args.ranks, "dp": ranks[0]["dp"],
           "elements": args.elements, "transport": "gloo, staged through "
           "host memory", "bitwise": all(r["bitwise"] for r in ranks)}
    for nb in (1, 2):
        out[f"depth_{nb}_ms_rank0"] = ranks[0]["times"][nb]
        out[f"depth_{nb}_median_ms_slowest_rank"] = max(
            statistics.median(r["times"][nb]) for r in ranks)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
