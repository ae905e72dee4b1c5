"""Pretrain a GPT on the synthetic token stream (the core loop of the JAX
package's examples/gpt/pretrain_gpt.py).

    python -m apex_tpu_torch.examples.gpt.pretrain_gpt --steps 20
    python -m apex_tpu_torch.examples.gpt.pretrain_gpt --vocab 50257 \\
        --seq-len 1024 --layers 12 --hidden 768 --heads 12 \\
        --micro-batch 8 --global-batch 16 --steps 9 --profile-steps 2
    python -m torch.distributed.run --nproc_per_node 4 \\
        -m apex_tpu_torch.examples.gpt.pretrain_gpt --tp 2 --zero \\
        --vocab 50304 --seq-len 1024 --layers 12 --hidden 768 --heads 12 \\
        --micro-batch 4 --global-batch 16 --steps 4

Builds the step with ``build_gpt_training`` (resilience/replay/targets.py),
walks the JAX package's synthetic stream in order, ``global_batch``
samples a step, and prints one line per step:
``step N loss L grad_norm G loss_scale S tokens_per_s T step_ms M
verdict V``. ``--profile-steps N`` runs N further steps under
``torch.profiler`` and prints the device time by kernel as one JSON line
(needs the card). Runs on the card unless ``--device cpu``.

Under ``torch.distributed.run`` (which sets ``WORLD_SIZE``) every process
is one rank of a ``--dist-backend`` world (NCCL by default; gloo where
NCCL cannot run, such as several ranks on one card, moves CUDA tensors
through host memory) at tensor-parallel size ``--tp``, with sequence
parallelism unless ``--no-sequence-parallel``, and data-parallel size the
rest; ``--zero`` shards Adam's state over dp (ZeRO-2). Rank r takes card
``LOCAL_RANK`` modulo the cards it sees. Only rank 0 prints; its last
line is one JSON object with its kernel launch counts of the run, every
rank's peak device memory, what rank 0 staged through host memory
(gloo with CUDA tensors) and, under ZeRO, the length of a rank's
optimizer-state shard. Telemetry, journaling, checkpoints and
remediation are not ported yet.
"""

import argparse
import json
import os
import time

import torch
import torch.distributed as dist

from apex_tpu_torch import _kernels
from apex_tpu_torch.data import LMDataset
from apex_tpu_torch.parallel import parallel_state as ps
from apex_tpu_torch.resilience.replay.targets import (
    GPTTargetConfig,
    build_gpt_training,
    synthetic_corpus,
)
from apex_tpu_torch.resilience.sentinel import verdict_name
from apex_tpu_torch.transformer.testing.commons import initialize_distributed


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--vocab", type=int, default=512)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--sequence-parallel",
                   action=argparse.BooleanOptionalAction, default=True,
                   help="Megatron SP over tp (--no-sequence-parallel to "
                        "disable)")
    p.add_argument("--micro-batch", type=int, default=4)
    p.add_argument("--global-batch", type=int, default=16)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--weight-decay", type=float, default=0.01)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--zero", action="store_true",
                   help="ZeRO-2 optimizer (distributed_fused_adam): Adam "
                        "moments and the fp32 master sharded 1/dp over dp")
    p.add_argument("--dist-backend", default="nccl",
                   choices=["nccl", "gloo"],
                   help="torch.distributed backend under "
                        "torch.distributed.run")
    p.add_argument("--profile-steps", type=int, default=0,
                   help="after the run, profile this many more steps")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    """Runs the loop; returns the per-step records it printed."""
    args = parse_args(argv)
    distributed = "WORLD_SIZE" in os.environ  # under torch.distributed.run
    device = torch.device(args.device)
    if distributed:
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get(
                "LOCAL_RANK", 0)) % torch.cuda.device_count())
            torch.cuda.set_device(device)
        initialize_distributed(args.dist_backend,
                               tensor_model_parallel_size=args.tp)
    try:
        return _run(args, device, distributed)
    finally:
        if distributed:
            ps.destroy_model_parallel()
            dist.destroy_process_group()


def _run(args, device, distributed):
    cfg = GPTTargetConfig(
        vocab=args.vocab, seq_len=args.seq_len, layers=args.layers,
        hidden=args.hidden, heads=args.heads, tp=args.tp,
        sequence_parallel=args.sequence_parallel,
        micro_batch=args.micro_batch, global_batch=args.global_batch,
        lr=args.lr, weight_decay=args.weight_decay, seed=args.seed,
        zero=args.zero)
    training = build_gpt_training(cfg, device=device)
    main_rank = not distributed or dist.get_rank() == 0
    say = print if main_rank else (lambda *a, **k: None)
    if training.device.type == "cuda":
        _kernels.build_all()  # every nvcc at once, not one per first launch
    state = training.init_state()
    lm = LMDataset(synthetic_corpus(args.vocab), args.seq_len)
    if len(lm) < cfg.global_batch:
        raise SystemExit(f"the stream holds {len(lm)} samples, fewer than "
                         f"one global batch ({cfg.global_batch})")
    if training.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    sync = (torch.cuda.synchronize if training.device.type == "cuda"
            else lambda: None)
    tokens_per_step = cfg.global_batch * cfg.seq_len

    def run_step(i):
        first = (i * cfg.global_batch) % (len(lm) - cfg.global_batch + 1)
        x, y = training.reshape_batch(
            *lm.batch(range(first, first + cfg.global_batch)))
        return training.train_step(state, x, y)

    records = []
    for i in range(args.steps):
        t0 = time.perf_counter()
        _, loss, verdict, metrics = run_step(i)
        sync()
        secs = time.perf_counter() - t0
        rec = dict(step=i, **metrics, tokens_per_s=tokens_per_step / secs,
                   step_ms=secs * 1e3, verdict=verdict_name(verdict))
        records.append(rec)
        say(f"step {i:5d} loss {loss:.4f} grad_norm "
            f"{metrics['grad_norm']:.4f} loss_scale "
            f"{metrics['loss_scale']:.1f} tokens_per_s "
            f"{rec['tokens_per_s']:.1f} step_ms {rec['step_ms']:.2f} "
            f"verdict {rec['verdict']}", flush=True)
    if args.profile_steps > 0:
        from apex_tpu_torch.utils.profiling import profile_device

        report = profile_device(lambda: [
            run_step(args.steps + j) for j in range(args.profile_steps)])
        say(json.dumps({"profile_steps": args.profile_steps,
                        "tokens_per_step": tokens_per_step, **report}),
            flush=True)
    if distributed:
        peak = torch.tensor([torch.cuda.max_memory_allocated(device) / 1e9
                             if device.type == "cuda" else 0.0])
        peaks = ps.all_gather(peak.to(device), dist.group.WORLD).tolist()
        say(json.dumps({
            "world": dist.get_world_size(), "tp": cfg.tp,
            "dp": training.dp, "zero": cfg.zero,
            "sequence_parallel": training.transformer_config
            .sequence_parallel,
            "backend": args.dist_backend,
            "launch_counts_rank0": _kernels.launch_counts(),
            "peak_mem_gb_by_rank": peaks,
            "staged_through_host_rank0": dict(ps.STAGED),
            "zero_shard_len": (state.opt.master_shard.numel() if cfg.zero
                               else None)}), flush=True)
    return records


if __name__ == "__main__":
    main()
