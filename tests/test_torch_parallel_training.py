"""The GPT training step at tp = 2 x dp = 2 with sequence parallelism,
under plain DDP (``fused_adam``) and under ZeRO-2
(``distributed_fused_adam``), against the JAX package's
``build_gpt_training(tp=2, max_devices=4, sequence_parallel=True,
zero=z)`` on 4 devices of the CPU mesh.

The JAX parameters are initialized as its ``init_state`` does, inside
``shard_map`` with each device keeping its own tp shards, and port rank r
loads device r's (``gpt_tp_params_from_jax``). Both run 3 clean steps and
one ``inject_nan`` step on the same batches of the synthetic stream, at
``test_torch_training.py``'s size (vocab 512, seq 64, 2 layers, hidden
128, 2 heads, micro batch 2) with a global batch of 4 x dp. The port runs
in one spawned world of 4 gloo ranks on the CPU. Tolerances are
``test_torch_training.py``'s: losses 2e-3 relative and grad norms 2e-2
(bf16 activations rounded at the same points, summed in another order),
every rank's final parameters 2e-3 absolute, and verdicts, loss scales
and the skip exact on every rank.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from apex_tpu_torch.data import LMDataset
from apex_tpu_torch.models import gpt_tp_params_from_jax
from apex_tpu_torch.resilience import VERDICT_OK, VERDICT_SKIP
from apex_tpu_torch.resilience.replay import synthetic_corpus
from apex_tpu_torch.transformer.testing.distributed_test_base import spawn
from apex_tpu_torch.transformer.testing.parallel_workers import (
    sequence_worker,
)

WORLD = 4
TARGET = dict(vocab=512, seq_len=64, layers=2, hidden=128, heads=2,
              micro_batch=2, global_batch=8, tp=2, max_devices=WORLD,
              sequence_parallel=True)
NAN = [0, 0, 0, 1]


def _per_device(x):
    """Each device's buffer of a JAX array, by device id."""
    return [np.asarray(s.data) for s in
            sorted(x.addressable_shards, key=lambda s: s.device.id)]


def _batches():
    lm = LMDataset(synthetic_corpus(512, 20_000), 64)
    out = []
    for step, nan in enumerate(NAN):
        x, y = lm.batch(range(8 * step, 8 * step + 8))
        out.append((x.reshape(2, 4, 64), y.reshape(2, 4, 64), float(nan)))
    return out


def _jax_run(zero, batches):
    from apex_tpu.parallel import parallel_state
    from apex_tpu.resilience.replay.targets import GPTTargetConfig as JaxCfg
    from apex_tpu.resilience.replay.targets import (
        build_gpt_training as jbuild,
    )

    jt = jbuild(JaxCfg(**TARGET, zero=zero))
    try:
        params, opt_state, scaler_state, sent_state = jt.init_state()
        init = [{k: v.numpy() for k, v in
                 gpt_tp_params_from_jax(params["params"], r).items()}
                for r in range(WORLD)]
        steps = []
        for x, y, nan in batches:
            out = jt.train_step(params, opt_state, scaler_state, sent_state,
                                jt.init_bag(), jnp.asarray(x, jnp.int32),
                                jnp.asarray(y, jnp.int32), jnp.float32(nan),
                                jnp.float32(1.0))
            params, opt_state, scaler_state, sent_state, bag, loss, v = out
            steps.append(dict(
                loss=_per_device(loss), verdict=_per_device(v),
                **{k: _per_device(bag.values[k]) for k in
                   ("grad_norm", "loss_scale", "skipped")}))
        final = [{k: v.numpy() for k, v in
                  gpt_tp_params_from_jax(params["params"], r).items()}
                 for r in range(WORLD)]
    finally:
        parallel_state.destroy_model_parallel()
    return init, steps, final


@pytest.fixture(scope="module")
def runs():
    """{zero: (JAX steps, JAX final params by rank, the port's results by
    rank)}: the JAX runs first, then one spawned world for both of the
    port's."""
    batches = _batches()
    jax_runs = {z: _jax_run(z, batches) for z in (False, True)}
    ports = spawn(sequence_worker, WORLD, args=([
        ("training_worker", (dict(TARGET, zero=z), jax_runs[z][0], batches))
        for z in (False, True)],), timeout=300.0)
    return {z: (jax_runs[z][1], jax_runs[z][2], [p[i] for p in ports])
            for i, z in enumerate((False, True))}


@pytest.mark.parametrize("zero", [False, True], ids=["ddp", "zero"])
def test_parallel_step_losses_and_verdicts_match_jax(runs, zero):
    jsteps, _, ports = runs[zero]
    for step, (js, nan) in enumerate(zip(jsteps, NAN)):
        for r in range(WORLD):
            got = ports[r]["steps"][step]
            assert got["verdict"] == int(js["verdict"][r]), (step, r)
            assert got["loss_scale"] == float(js["loss_scale"][r])
            assert got["skipped"] == float(js["skipped"][r]) == float(nan)
            if nan:
                assert got["verdict"] == VERDICT_SKIP
                assert np.isnan(got["loss"])
                assert got["loss_scale"] == 2.0**15
            else:
                assert got["verdict"] == VERDICT_OK
                np.testing.assert_allclose(got["loss"], float(js["loss"][r]),
                                           rtol=2e-3)
                # ZeRO's norm is of each dp rank's own gradients, as in JAX
                np.testing.assert_allclose(got["grad_norm"],
                                           float(js["grad_norm"][r]),
                                           rtol=2e-2)
        # the loss is the same on every rank
        assert len({p["steps"][step]["loss"] for p in ports
                    if not nan}) <= 1


@pytest.mark.parametrize("zero", [False, True], ids=["ddp", "zero"])
def test_parallel_step_final_params_match_jax_on_every_rank(runs, zero):
    _, jfinal, ports = runs[zero]
    for r in range(WORLD):
        got = ports[r]["params"]
        assert set(got) == set(jfinal[r])
        assert ports[r]["opt_step"] == 3  # the NaN step was skipped
        for name, want in jfinal[r].items():
            np.testing.assert_allclose(got[name], want, atol=2e-3, rtol=0,
                                       err_msg=f"rank {r} {name}")
    # the tp ranks keep their norms equal (their gradients are tp sums);
    # the dp ranks keep every parameter equal
    norm = "transformer.final_layernorm.scale"
    np.testing.assert_array_equal(ports[0]["params"][norm],
                                  ports[1]["params"][norm])
    for name in ports[0]["params"]:
        np.testing.assert_array_equal(ports[0]["params"][name],
                                      ports[2]["params"][name])
