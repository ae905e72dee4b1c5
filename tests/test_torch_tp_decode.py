"""apex_tpu_torch's KV-cache prefill and decode at tensor-parallel size 2,
with and without sequence parallelism and with GQA, held as JAX holds its
own (``tests/test_tensor_parallel.py``
``test_tp_kv_cache_decode_matches_full_forward`` and
``test_sp_kv_cache_decode_matches_full_forward``): every prefill and
decode step's logits equal the full forward's at those positions on each
rank's vocab shard, to JAX's bound, 2e-5 (fp32).

The weights are JAX's: a small GPT (2 layers, hidden 64, 4 heads, or 4
over 2 KV groups, vocab 128) initialised inside ``shard_map`` on 2
devices of the CPU mesh, read per device with
``gpt_tp_params_from_jax``; the port's full forward is held to JAX's on
each rank's shard at 1e-5. The port runs in a spawned world of 2 gloo
ranks on the CPU. Each rank's cache holds its own heads (2 of 4, or 1 of
2 KV groups).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from apex_tpu.compat import shard_map
from apex_tpu.models import GPTModel as JaxGPT
from apex_tpu.parallel import parallel_state as jps
from apex_tpu.transformer import TransformerConfig as JaxConfig
from apex_tpu_torch.models import gpt_tp_params_from_jax
from apex_tpu_torch.transformer.testing.distributed_test_base import (
    jobs_worker,
    spawn,
)

TP = 2
V = 128
TINY = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
            vocab_size=V, max_position_embeddings=16, hidden_dropout=0.0,
            attention_dropout=0.0)
CASES = {
    "tp": dict(extra={}, prompt=5, total=12),
    "tp gqa": dict(extra=dict(num_query_groups=2), prompt=5, total=12),
    "sp": dict(extra=dict(sequence_parallel=True), prompt=8, total=16),
}


def _jax_case(extra, total):
    rs = np.random.RandomState(4)
    tokens = rs.randint(0, V, (2, total)).astype(np.int32)
    model = JaxGPT(config=JaxConfig(compute_dtype=jnp.float32, **TINY,
                                    **extra))
    mesh = Mesh(np.asarray(jax.devices()[:TP]).reshape(1, 1, 1, TP),
                jps.AXIS_ORDER)

    @jax.jit
    @functools.partial(shard_map, mesh=mesh, in_specs=P(), out_specs=P(),
                       check_vma=False)
    def init(tok):
        return model.init(jax.random.PRNGKey(0), tok[:, :8])["params"]

    params = init(jnp.asarray(tokens))

    @jax.jit
    @functools.partial(shard_map, mesh=mesh, in_specs=(P(), P()),
                       out_specs=P(("dp", "pp", "cp", "tp")),
                       check_vma=False)
    def full(p, tok):
        return model.apply({"params": p}, tok)[None]

    return tokens, params, np.asarray(full(params, jnp.asarray(tokens)))


@pytest.fixture(scope="module")
def both():
    jps.initialize_model_parallel(tensor_model_parallel_size=TP,
                                  devices=jax.devices()[:TP])
    refs, jobs = {}, []
    try:
        for name, c in CASES.items():
            tokens, params, logits = _jax_case(c["extra"], c["total"])
            refs[name] = logits
            jobs.append(("apex_tpu_torch.transformer.testing.tp_workers:"
                         "decode_tp_worker", (
                TP, dict(TINY, compute_dtype=torch.float32, **c["extra"]),
                [{k: v.numpy() for k, v in
                  gpt_tp_params_from_jax(params, r).items()}
                 for r in range(TP)], tokens, c["prompt"], c["total"])))
    finally:
        jps.destroy_model_parallel()
    ports = spawn(jobs_worker, TP, args=(jobs,), timeout=180.0)
    return refs, {name: [p[i] for p in ports]
                  for i, name in enumerate(CASES)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_at_tp2_matches_the_full_forward(both, case):
    refs, ports = both
    c = CASES[case]
    heads = c["extra"].get("num_query_groups", TINY["num_attention_heads"])
    for r, got in enumerate(ports[case]):
        assert got["vocab_local"] == V // TP
        assert got["cache_heads"] == heads // TP
        np.testing.assert_allclose(got["full"], refs[case][r], rtol=1e-5,
                                   atol=1e-5, err_msg=f"{case} rank {r}")
        assert got["steps"].shape[1] == c["total"] - c["prompt"]
        assert got["worst"] < 2e-5, (case, r, got["worst"])
    # the ranks hold different vocab shards of the same positions
    assert not np.allclose(ports[case][0]["steps"], ports[case][1]["steps"])
