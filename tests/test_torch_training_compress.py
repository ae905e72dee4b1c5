"""The GPT training step with compressed gradient collectives and the
layer-RMS taps at tp = 2 x dp = 2 with sequence parallelism, under DDP
(int8, the residual in the optimizer slot) and under ZeRO-2 (fp8, the
residual in the optimizer's state), against the JAX package's
``build_gpt_training(..., compression=c, collect_layer_rms=True)`` on 4
devices of the CPU mesh.

As ``tests/test_torch_parallel_training.py``: the JAX parameters are
initialized inside ``shard_map`` by its ``init_state`` and port rank r
loads device r's (``gpt_tp_params_from_jax``); both run 3 clean steps and
one ``inject_nan`` step on the same batches, and the port runs in one
spawned world of 4 gloo ranks. Tolerances are that file's: losses 2e-3
relative, grad norms 2e-2 (bf16 activations rounded at the same points,
summed in another order; the quantized sync adds at most a code step
where a code flips), every rank's final parameters 2e-3 absolute,
verdicts, loss scales and the skip exact. The layer RMS vector (2
values, depth order) 2e-3 relative on every rank and step, the same on
every rank. The residuals are nonzero after the run, and the NaN step
leaves every residual finite (poisoned elements reset).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from apex_tpu_torch.data import IndexedTokenDataset, LMDataset
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
              sequence_parallel=True, collect_layer_rms=True)
RUNS = {"ddp int8": dict(zero=False, compression="int8"),
        "zero fp8": dict(zero=True, compression="fp8",
                         compression_block=64)}
NAN = [0, 0, 1, 0]


def _per_device(x):
    return [np.asarray(s.data) for s in
            sorted(x.addressable_shards, key=lambda s: s.device.id)]


def _batches():
    lm = LMDataset(IndexedTokenDataset(synthetic_corpus(512, 20_000)), 64)
    out = []
    for step, nan in enumerate(NAN):
        x, y = lm.batch(range(8 * step, 8 * step + 8))
        out.append((x.reshape(2, 4, 64), y.reshape(2, 4, 64), float(nan)))
    return out


def _jax_run(extra, batches):
    from apex_tpu.parallel import parallel_state
    from apex_tpu.resilience.replay.targets import GPTTargetConfig as JaxCfg
    from apex_tpu.resilience.replay.targets import (
        build_gpt_training as jbuild,
    )

    jt = jbuild(JaxCfg(**TARGET, **extra))
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
            (params, opt_state, scaler_state, sent_state, bag, loss, v,
             rms) = out
            steps.append(dict(
                loss=_per_device(loss), verdict=_per_device(v),
                layer_rms=_per_device(rms),
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
    batches = _batches()
    jax_runs = {name: _jax_run(extra, batches)
                for name, extra in RUNS.items()}
    ports = spawn(sequence_worker, WORLD, args=([
        ("training_worker", (dict(TARGET, **extra), jax_runs[name][0],
                             batches))
        for name, extra in RUNS.items()],), timeout=300.0)
    return {name: (jax_runs[name][1], jax_runs[name][2],
                   [p[i] for p in ports])
            for i, name in enumerate(RUNS)}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_compressed_step_and_layer_rms_match_jax(runs, run):
    jsteps, jfinal, ports = runs[run]
    for step, (js, nan) in enumerate(zip(jsteps, NAN)):
        for r in range(WORLD):
            got = ports[r]["steps"][step]
            assert got["verdict"] == int(js["verdict"][r]), (step, r)
            assert got["loss_scale"] == float(js["loss_scale"][r])
            assert got["skipped"] == float(js["skipped"][r]) == float(nan)
            np.testing.assert_allclose(got["layer_rms"], js["layer_rms"][r],
                                       rtol=2e-3, err_msg=f"{run} {step}")
            assert len(got["layer_rms"]) == TARGET["layers"]
            if nan:
                assert got["verdict"] == VERDICT_SKIP
                assert np.isnan(got["loss"])
            else:
                assert got["verdict"] == VERDICT_OK
                np.testing.assert_allclose(got["loss"], float(js["loss"][r]),
                                           rtol=2e-3)
                np.testing.assert_allclose(got["grad_norm"],
                                           float(js["grad_norm"][r]),
                                           rtol=2e-2)
        # the RMS vector is global: the same on every rank
        assert len({tuple(p["steps"][step]["layer_rms"])
                    for p in ports}) == 1
    for r in range(WORLD):
        assert ports[r]["opt_step"] == 3
        for name, want in jfinal[r].items():
            np.testing.assert_allclose(ports[r]["params"][name], want,
                                       atol=2e-3, rtol=0,
                                       err_msg=f"{run} rank {r} {name}")
        ef = ports[r]["ef_residual"]
        leaves = list(ef.values()) if isinstance(ef, dict) else [ef]
        assert all(np.isfinite(e).all() for e in leaves)
        assert max(np.abs(e).max() for e in leaves) > 0
