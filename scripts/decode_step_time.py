"""Host time of one decode step of TinyLlama-1.1B and GPT-2 small (8
lanes at position 512, bf16, seeded random weights) through
``GPTModel.hidden_states``: 5 rounds of 200 steps, wall ms a step, sorted;
run from a checkout's root with it on ``PYTHONPATH`` (the argument labels
the JSON line)."""
import json
import sys
import time

import torch

from apex_tpu_torch import _kernels
from apex_tpu_torch.models import (
    GPTModel,
    gpt2_small_config,
    tinyllama_1_1b_config,
)

_kernels.build_all()
out = {"tree": sys.argv[1]}
for name, cfg in (("tinyllama", tinyllama_1_1b_config()),
                  ("gpt2", gpt2_small_config())):
    model = GPTModel(cfg, device="cuda", seed=0)
    cache = model.new_cache(8, 1024)
    gen = torch.Generator(device="cuda").manual_seed(0)
    prompt = torch.randint(0, cfg.vocab_size, (8, 512), generator=gen,
                           device="cuda")
    tok = prompt[:, :1].contiguous()
    rounds = []
    with torch.no_grad():
        model.hidden_states(prompt, cache=cache)
        for _ in range(20):
            model.hidden_states(tok, cache=cache, decode_step=True)
        for _ in range(5):
            cache.index.fill_(512)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                model.hidden_states(tok, cache=cache, decode_step=True)
            torch.cuda.synchronize()
            rounds.append((time.perf_counter() - t0) / 200 * 1e3)
    out[name] = sorted(rounds)
    del model, cache
    torch.cuda.empty_cache()
print(json.dumps(out))
