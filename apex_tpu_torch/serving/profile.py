"""Where the serving run's time goes on the card.

    python -m apex_tpu_torch.serving.profile [--requests 24] [--seed 0]

Serves the same workload as ``chip_smoke.py`` (GPT-2 small at full
width, seeded random weights, compute bf16; prompts of 32-768 tokens and
32-64 new tokens each, all submitted at once to an 8-lane engine) under
``torch.profiler`` and prints one JSON line: the wall time, the device
time summed over kernels, the device's idle share of the wall time, and
the kernels that took the most device time, by name.
"""

import argparse
import json
import time

import numpy as np
import torch

from apex_tpu_torch.serving.engine import ServingConfig, ServingEngine


def serving_config(seed: int = 0) -> ServingConfig:
    """The engine of the GPT-2 small serving run: 8 lanes, a 1024-token
    window, 64 blocks of 16 tokens per lane."""
    return ServingConfig(lanes=8, block_size=16, max_seq_len=1024,
                         num_blocks=8 * 64, max_queue_depth=32, seed=seed)


def make_requests(n: int, vocab: int, rs: np.random.RandomState):
    """``n`` (prompt, max_new_tokens): prompts of 32-768 random tokens,
    32-64 new tokens each."""
    return [(rs.randint(0, vocab, size=int(rs.randint(32, 769))),
             int(rs.randint(32, 65))) for _ in range(n)]


def serve(model, requests, cfg: ServingConfig):
    """Submits every request, ticks until idle; (engine, requests, wall
    seconds)."""
    eng = ServingEngine(model, cfg, device=model.device)
    reqs = [eng.submit(p, n) for p, n in requests]
    t0 = time.perf_counter()
    while not eng.idle:
        eng.tick()
    torch.cuda.synchronize()
    return eng, reqs, time.perf_counter() - t0


def main(argv=None) -> None:
    from apex_tpu_torch.models import GPTModel, gpt2_small_config
    from apex_tpu_torch.utils.profiling import profile_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the profile measures the card")

    mcfg = gpt2_small_config()
    model = GPTModel(mcfg, device="cuda", seed=args.seed)
    rs = np.random.RandomState(args.seed)
    cfg = serving_config(args.seed)
    serve(model, make_requests(1, mcfg.vocab_size, rs), cfg)  # warm-up
    requests = make_requests(args.requests, mcfg.vocab_size, rs)
    out = {}
    report = profile_device(
        lambda: out.update(eng=serve(model, requests, cfg)[0]))
    print(json.dumps({"requests": args.requests,
                      "tokens_out": out["eng"].stats()["tokens_out"],
                      **report}))


if __name__ == "__main__":
    main()
