"""Fine-tune a Llama on one GPU (the core loop of the JAX package's
examples/llama/finetune_llama.py).

    python -m apex_tpu_torch.examples.llama.finetune_llama --steps 20
    python -m apex_tpu_torch.examples.llama.finetune_llama \\
        --model tinyllama-1.1b --bf16 --batch 4 --seq-len 2048 --steps 6 \\
        --profile-steps 1
    python -m apex_tpu_torch.examples.llama.finetune_llama \\
        --checkpoint TinyLlama/TinyLlama-1.1B-intermediate-step-1431k-3T --bf16

Without ``--checkpoint`` a Llama with random weights from ``--seed``
stands in: ``--model demo`` (the default) is the JAX demo's shape (2
layers, hidden 64, 4 heads over 2 KV heads, SwiGLU 160, vocab 256,
untied head), ``--model tinyllama-1.1b`` is TinyLlama-1.1B at full
width and depth (``models.tinyllama_1_1b_config``). ``--checkpoint``
imports a transformers checkpoint (``models.hf_import``) and needs the
``transformers`` package. One fixed batch of random tokens is revisited
every step, so the loss falls from ln(vocab) by memorisation. Each step
takes the mean token loss, backpropagates it through the RMSNorm and
flash-attention backward kernels, and updates with
``distributed_fused_adam(lr, max_grad_norm=clip)``, ZeRO-2 at a
data-parallel world of one, which clips through the sum-of-squares
kernel. It prints ``step N loss L step_ms M`` per step and runs on the
card unless ``--device cpu``. ``--profile-steps N`` runs N further steps
under ``torch.profiler`` and prints the device time by kernel as one
JSON line.

:class:`LlamaFinetune` is the loop's state and step, so other programs
(``chip_smoke.py``) run it on a config of their own. The monitor,
goodput, journal, audits, x-ray, checkpoints and remediation of the JAX
script are not ported yet.
"""

import argparse
import json
import time
import types
from typing import List, Optional

import numpy as np
import torch

from apex_tpu_torch import _kernels
from apex_tpu_torch.models.gpt import (
    GPTModel,
    gpt_loss_fn,
    tinyllama_1_1b_config,
)
from apex_tpu_torch.models.hf_import import config_from_hf_llama, llama_from_hf
from apex_tpu_torch.optimizers import distributed_fused_adam
from apex_tpu_torch.transformer import TransformerConfig

__all__ = ["LlamaFinetune", "demo_config", "load_model", "main"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint", default=None,
                   help="transformers name/path; omit for a random model")
    p.add_argument("--model", choices=("demo", "tinyllama-1.1b"),
                   default="demo", help="the random model's shape")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seq-len", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--clip", type=float, default=1.0)
    p.add_argument("--bf16", action=argparse.BooleanOptionalAction,
                   default=False, help="bf16 compute (fp32 params)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--profile-steps", type=int, default=0,
                   help="after the run, profile this many more steps")
    return p.parse_args(argv)


def demo_config(seq_len: int, **overrides) -> TransformerConfig:
    """The JAX demo's LlamaConfig, mapped as ``config_from_hf_llama``
    maps it."""
    hf = types.SimpleNamespace(
        vocab_size=256, hidden_size=64, intermediate_size=160,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=seq_len, rms_norm_eps=1e-6,
        rope_theta=10000.0, tie_word_embeddings=False)
    return config_from_hf_llama(hf, **overrides)


def load_model(args) -> GPTModel:
    overrides = {"compute_dtype": torch.bfloat16} if args.bf16 else {}
    if args.checkpoint:
        import transformers

        hf = transformers.AutoModelForCausalLM.from_pretrained(args.checkpoint)
        return llama_from_hf(hf, device=args.device, **overrides)
    if args.model == "tinyllama-1.1b":
        cfg = tinyllama_1_1b_config(
            compute_dtype=torch.bfloat16 if args.bf16 else torch.float32)
    else:
        cfg = demo_config(args.seq_len, **overrides)
    return GPTModel(cfg, device=args.device, seed=args.seed)


class LlamaFinetune:
    """The fine-tuning loop's state: the model, its ZeRO-2 Adam state at
    dp = 1, and one fixed (batch, seq_len) batch of random tokens from
    ``seed`` whose labels are the tokens shifted left by one."""

    def __init__(self, model: GPTModel, batch: int, seq_len: int,
                 lr: float = 1e-3, clip: Optional[float] = 1.0,
                 seed: int = 0):
        self.model = model
        self.params = dict(model.named_parameters())
        self.opt = distributed_fused_adam(lr=lr, max_grad_norm=clip)
        self.state = self.opt.init(
            {n: p.detach() for n, p in self.params.items()})
        rs = np.random.RandomState(seed)
        tokens = rs.randint(0, model.config.vocab_size, (batch, seq_len))
        self.tokens = torch.as_tensor(tokens, device=model.device)
        self.labels = torch.roll(self.tokens, -1, dims=1)

    def step(self, check_grads: bool = False):
        """One step; returns the loss before the update and, with
        ``check_grads``, the names of parameters whose gradient is
        missing or not finite (a host sync)."""
        loss = gpt_loss_fn(self.model(self.tokens, labels=self.labels))
        loss.backward()
        grads = {n: p.grad for n, p in self.params.items()}
        bad: List[str] = []
        if check_grads:
            bad = [n for n, g in grads.items()
                   if g is None or not bool(torch.isfinite(g).all())]
        updates, self.state = self.opt.update(
            grads, self.state, {n: p.detach() for n, p in self.params.items()})
        with torch.no_grad():
            for n, p in self.params.items():
                p.add_(updates[n])
                p.grad = None
        return float(loss.detach()), bad


def main(argv=None):
    """Runs the loop; returns the per-step records it printed."""
    args = parse_args(argv)
    model = load_model(args)
    if model.device.type == "cuda":
        _kernels.build_all()  # every nvcc at once, not one per first launch
    cfg = model.config
    print(f"vocab={cfg.vocab_size} layers={cfg.num_layers} "
          f"hidden={cfg.hidden_size} device={model.device}", flush=True)
    run = LlamaFinetune(model, args.batch, args.seq_len, lr=args.lr,
                        clip=args.clip, seed=args.seed)
    sync = (torch.cuda.synchronize if model.device.type == "cuda"
            else lambda: None)
    records = []
    for i in range(args.steps):
        t0 = time.perf_counter()
        loss, _ = run.step()
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        records.append({"step": i, "loss": loss, "step_ms": ms})
        print(f"step {i:5d} loss {loss:.4f} step_ms {ms:.2f}", flush=True)
    if args.profile_steps > 0:
        from apex_tpu_torch.utils.profiling import profile_device

        report = profile_device(lambda: [
            run.step() for _ in range(args.profile_steps)])
        print(json.dumps({"profile_steps": args.profile_steps,
                          "tokens_per_step": args.batch * args.seq_len,
                          **report}), flush=True)
    return records


if __name__ == "__main__":
    main()
