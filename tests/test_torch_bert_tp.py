"""apex_tpu_torch's BERT at tensor-parallel size 2 against the JAX
package's, with and without sequence parallelism, and the standalone
BERT at tp 2 x dp 2.

The JAX model (2 layers, hidden 64, 4 heads, vocab 128, seq 32) is
initialised inside ``shard_map`` on a (dp, 1, 1, tp) mesh of the CPU
devices (``check_vma=False``, each device keeping its own tp shards,
the replicated heads the same on every device), and
``bert_tp_params_from_jax`` reads device r's shards into port rank r.
The port runs in spawned gloo worlds on the CPU, fp32.

Checked: the per-token LM losses and the binary logits 1e-5, and every
gradient of ``mean(lm) + mean(binary ** 2)`` 1e-5 relative (2e-6
absolute), on every rank: the loss reaches the binary head and the LM
head through the sequence gather, whose backward must be a split
(``to_model_parallel=False``); a reduce-scatter there would give the
pooler and everything under it tp times the binary path's gradient.
Then three steps of ``standalone_bert`` at tp 2 x dp 2 with sequence
parallelism (``BertPretraining`` from the JAX run's weights and batches)
against JAX's ``run_bert`` on the same 4 devices: the dp-mean losses
1e-5 relative. Pipelined BERT still raises, with JAX's message.
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
from apex_tpu.models.bert import BertModel as JaxBert
from apex_tpu.parallel import parallel_state as jps
from apex_tpu.transformer import TransformerConfig as JaxConfig
from apex_tpu.transformer.testing import standalone_bert as jax_sb
from apex_tpu.transformer.testing.arguments import (
    parse_args as jax_parse_args,
)
from apex_tpu.transformer.testing.standalone_gpt import (
    gpt_config_from_args as jax_config_from_args,
)
from apex_tpu_torch.models import bert_tp_params_from_jax, gpt_params_from_jax
from apex_tpu_torch.transformer.testing import parse_args, standalone_bert
from apex_tpu_torch.transformer.testing.distributed_test_base import (
    jobs_worker,
    spawn,
)

WORKERS = "apex_tpu_torch.transformer.testing.tp_workers"
TP = 2
B, S, V = 2, 32, 128
SMALL = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
             vocab_size=V, max_position_embeddings=S, hidden_dropout=0.0,
             attention_dropout=0.0)
ALL = P(("dp", "pp", "cp", "tp"))
RUN_ARGV = ("--num-layers 2 --hidden-size 64 --num-attention-heads 4 "
            "--seq-length 32 --max-position-embeddings 32 "
            "--micro-batch-size 2 --global-batch-size 8 --train-iters 3 "
            "--lr 1e-3 --tensor-model-parallel-size 2 "
            "--sequence-parallel").split()


def _mesh(dp):
    return Mesh(np.asarray(jax.devices()[:dp * TP]).reshape(dp, 1, 1, TP),
                jps.AXIS_ORDER)


def _model_case(sp):
    """The port's case and JAX's per-device results for one model at tp
    2 (a world of 2)."""
    rs = np.random.RandomState(3)
    tokens = rs.randint(0, V, (B, S)).astype(np.int32)
    labels = rs.randint(0, V, (B, S)).astype(np.int32)
    jmodel = JaxBert(config=JaxConfig(compute_dtype=jnp.float32,
                                      sequence_parallel=sp, **SMALL))
    mesh = _mesh(1)

    @jax.jit
    @functools.partial(shard_map, mesh=mesh, in_specs=P(), out_specs=P(),
                       check_vma=False)
    def init(tok):
        return jmodel.init(jax.random.PRNGKey(0), tok)["params"]

    params = init(jnp.asarray(tokens))

    @jax.jit
    @functools.partial(shard_map, mesh=mesh, in_specs=(P(), P(), P()),
                       out_specs=(ALL, ALL, ALL), check_vma=False)
    def run(p, tok, lab):
        def loss_fn(p):
            lm, binary = jmodel.apply({"params": p}, tok, lm_labels=lab)
            return jnp.mean(lm) + jnp.mean(binary ** 2), (lm, binary)

        (_, (lm, binary)), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        return lm[None], binary[None], jax.tree_util.tree_map(
            lambda a: a[None], g)

    lm, binary, grads = run(params, jnp.asarray(tokens), jnp.asarray(labels))
    case = dict(config=dict(SMALL, sequence_parallel=sp,
                            compute_dtype=torch.float32),
                tokens=tokens, labels=labels,
                params=[{k: v.numpy() for k, v in
                         bert_tp_params_from_jax(params, r).items()}
                        for r in range(TP)])
    ref = dict(lm=np.asarray(lm), binary=np.asarray(binary),
               grads=[gpt_params_from_jax(jax.tree_util.tree_map(
                   lambda a: np.asarray(a)[r], grads)) for r in range(TP)])
    return case, ref


def _run_bert_case(monkeypatch):
    """JAX's ``run_bert`` at tp 2 x dp 2 on 4 devices, and its weights and
    batches rebuilt the way it builds them."""
    jargs = jax_parse_args(args=RUN_ARGV)
    devices = jax.devices()[:4]
    monkeypatch.setattr(
        jax_sb.parallel_state, "initialize_model_parallel", functools.partial(
            jps.initialize_model_parallel, devices=devices))
    losses = jax_sb.run_bert(jargs, log=lambda _: None)
    mesh = jps.initialize_model_parallel(tensor_model_parallel_size=TP,
                                         devices=devices)
    try:
        dp = jps.get_data_parallel_world_size()
        cfg = jax_config_from_args(jargs)
        model = JaxBert(config=cfg, add_binary_head=jargs.bert_binary_head)
        mb, seq = jargs.micro_batch_size, jargs.seq_length
        num_micro = max(1, jargs.global_batch_size // (mb * dp))
        key = jax.random.PRNGKey(jargs.seed)
        shape = (3, num_micro, mb * dp, seq)
        tokens = jax.random.randint(key, shape, 0, cfg.vocab_size)
        labels = jax.random.randint(jax.random.fold_in(key, 1), shape, 0,
                                    cfg.vocab_size)

        @jax.jit
        @functools.partial(shard_map, mesh=mesh,
                           in_specs=(P(None, None, "dp"),) * 2,
                           out_specs=P(), check_vma=False)
        def init(tok, lab):
            return model.init(jax.random.PRNGKey(jargs.seed), tok[0, 0],
                              lm_labels=lab[0, 0])["params"]

        params = init(tokens, labels)
        per_rank = [{k: v.numpy() for k, v in
                     bert_tp_params_from_jax(params, r).items()}
                    for r in range(4)]
    finally:
        jps.destroy_model_parallel()
    return dict(losses=losses, params=per_rank, tokens=np.asarray(tokens),
                labels=np.asarray(labels), dp=dp)


@pytest.fixture(scope="module")
def both():
    cases, refs = {}, {}
    jps.initialize_model_parallel(tensor_model_parallel_size=TP,
                                  devices=jax.devices()[:TP])
    try:
        for sp in (False, True):
            name = "sp" if sp else "tp"
            cases[name], refs[name] = _model_case(sp)
    finally:
        jps.destroy_model_parallel()
    mp = pytest.MonkeyPatch()
    try:
        run = _run_bert_case(mp)
    finally:
        mp.undo()
    models = spawn(jobs_worker, TP, args=([
        (f"{WORKERS}:bert_tp_worker", (TP, cases))],), timeout=240.0)
    runs = spawn(jobs_worker, 4, args=([
        (f"{WORKERS}:run_bert_worker", (RUN_ARGV, run["params"],
                                        run["tokens"], run["labels"]))],),
        timeout=240.0)
    return refs, [m[0] for m in models], run, [r[0] for r in runs]


@pytest.mark.parametrize("mode", ["tp", "sp"])
def test_bert_tp2_matches_jax(both, mode):
    refs, models, _, _ = both
    ref = refs[mode]
    for r in range(TP):
        got = models[r][mode]
        np.testing.assert_allclose(got["lm"], ref["lm"][r], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got["binary"], ref["binary"][r],
                                   rtol=1e-5, atol=1e-5)
        want = ref["grads"][r]
        assert set(got["grads"]) == set(want), mode
        for name, g in want.items():
            np.testing.assert_allclose(got["grads"][name], g.numpy(),
                                       rtol=1e-4, atol=2e-6,
                                       err_msg=f"{mode} rank {r} {name}")
        # the binary head is reached: its gradient is not zero
        assert np.abs(got["grads"]["binary_head.kernel"]).max() > 0


def test_standalone_bert_tp2_dp2_matches_jax_run_bert(both):
    _, _, run, ports = both
    assert run["dp"] == 2
    for r, got in enumerate(ports):
        assert (got["tp"], got["dp"]) == (2, 2)
        np.testing.assert_allclose(got["losses"], run["losses"], rtol=1e-5,
                                   err_msg=f"rank {r}")
        assert all(np.isfinite(g).all() for g in got["grads"].values())
    # the dp ranks of a tp rank hold the same (dp-mean) gradients
    for name, g in ports[0]["grads"].items():
        np.testing.assert_array_equal(g, ports[2]["grads"][name], name)


def test_pipelined_bert_still_raises_jaxs_refusal():
    args = parse_args(args=RUN_ARGV[:-3] + [
        "--pipeline-model-parallel-size", "2"], ignore_unknown_args=True)
    with pytest.raises(NotImplementedError, match="dp x tp configuration"):
        standalone_bert.BertPretraining(args, device="cpu")
