"""apex_tpu_torch's training slice against the JAX package: the loss, the
loss scaler, the sentinel, GPT gradients and the whole training step.

Inputs come from seeded numpy RNGs and go through both frameworks; the
JAX side runs on the CPU (its Pallas kernels only where a test says so).
Tolerances are stated beside each comparison.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.amp.scaler import LossScaler as JaxLossScaler
from apex_tpu.models import GPTModel as JaxGPT
from apex_tpu.models import gpt_loss_fn as jax_gpt_loss_fn
from apex_tpu.parallel.cross_entropy import (
    vocab_parallel_cross_entropy as jax_ce,
)
from apex_tpu.resilience.sentinel import AnomalySentinel as JaxSentinel
from apex_tpu.transformer import TransformerConfig as JaxConfig
from apex_tpu.transformer import calc_params_l2_norm as jax_l2_norm
from apex_tpu_torch.amp import GradScaler, LossScaler
from apex_tpu_torch.data import IndexedTokenDataset, LMDataset
from apex_tpu_torch.examples.gpt import pretrain_gpt
from apex_tpu_torch.models import (
    GPTModel,
    fused_adam_state_from_jax,
    gpt_loss_fn,
    gpt_params_from_jax,
    scaler_state_from_jax,
)
from apex_tpu_torch.parallel.cross_entropy import vocab_parallel_cross_entropy
from apex_tpu_torch.resilience import (
    VERDICT_OK,
    VERDICT_SKIP,
    AnomalySentinel,
    poison_loss,
    verdict_name,
)
from apex_tpu_torch.resilience.replay import (
    GPTTargetConfig,
    build_gpt_training,
    synthetic_corpus,
)
from apex_tpu_torch.transformer import TransformerConfig
from apex_tpu_torch.transformer.utils import calc_params_l2_norm


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# -- cross entropy -----------------------------------------------------------
# fp32 losses and logit grads; 1e-5 (logsumexp and the softmax in another
# summation order, over an odd vocabulary of 37).

@pytest.mark.parametrize("label_smoothing", [0.0, 0.1])
def test_cross_entropy_matches_jax(label_smoothing):
    rs = np.random.RandomState(0)
    logits = (rs.randn(2, 5, 37) * 3).astype(np.float32)
    target = rs.randint(0, 37, (2, 5))
    ct = rs.rand(2, 5).astype(np.float32)
    ref, vjp = jax.vjp(lambda lg: jax_ce(lg, jnp.asarray(target),
                                         label_smoothing), jnp.asarray(logits))
    (ref_g,) = vjp(jnp.asarray(ct))
    lt = torch.from_numpy(logits).requires_grad_(True)
    out = vocab_parallel_cross_entropy(lt, torch.from_numpy(target),
                                       label_smoothing)
    out.backward(torch.from_numpy(ct))
    assert out.dtype == torch.float32 and out.shape == (2, 5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(ref_g),
                               atol=1e-5, rtol=1e-5)


# -- loss scaler and sentinel: scripted sequences, exact states ---------------

def _scaler_fields(state):
    return (float(state.scale), int(state.growth_tracker), int(state.skipped),
            int(state.hysteresis_tracker))


@pytest.mark.parametrize("loss_scale", ["dynamic", 128.0])
def test_loss_scaler_schedule_matches_jax(loss_scale):
    kw = dict(loss_scale=loss_scale, init_scale=2.0**10, growth_interval=3,
              hysteresis=2, min_loss_scale=2.0**8, max_loss_scale=2.0**12)
    js, ts = JaxLossScaler(**kw), GradScaler(**kw)
    jst, tst = js.init(), ts.init(device="cpu")
    flags = [0, 0, 0, 1, 0, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1,
             1, 1, 1]
    for f in flags:
        jst = js.update(jst, jnp.asarray(bool(f)))
        tst = ts.update(tst, torch.tensor(bool(f)))
        assert _scaler_fields(tst) == _scaler_fields(jst)
    assert ts.state_dict(tst) == js.state_dict(jst)
    back = ts.load_state_dict(ts.state_dict(tst), device="cpu")
    assert _scaler_fields(back) == _scaler_fields(tst)
    assert _scaler_fields(scaler_state_from_jax(_np(jst), device="cpu")) == \
        _scaler_fields(tst)


def test_unscale_flags_the_scaled_grads():
    ts = LossScaler(init_scale=4.0)
    st = ts.init(device="cpu")
    grads = {"a": torch.tensor([8.0, -4.0]), "b": torch.tensor([2.0])}
    out, found = ts.unscale(st, grads)
    assert not bool(found)
    assert torch.equal(out["a"], torch.tensor([2.0, -1.0]))
    grads["b"][0] = float("inf")
    assert bool(ts.unscale(st, grads)[1])


def test_sentinel_verdicts_match_jax():
    kw = dict(ema_decay=0.9, z_threshold=3.0, warmup_steps=4, skip_budget=1,
              rollback_budget=1)
    js, ts = JaxSentinel(**kw), AnomalySentinel(**kw)
    jst, tst = js.init(), ts.init(device="cpu")
    losses = [5.0, 4.9, 4.8, 4.85, 4.7, 4.75, 40.0, 4.6, float("nan"),
              float("nan"), float("nan"), 4.5, 4.4, float("inf"), 4.3]
    bad = [False] * 12 + [True] + [False] * 2
    names = []
    for loss, b in zip(losses, bad):
        ja = js.is_anomalous_loss(jst, jnp.float32(loss))
        ta = ts.is_anomalous_loss(tst, torch.tensor(loss))
        assert bool(ta) == bool(ja)
        jst, jv = js.update(jst, jnp.float32(loss), ja, bad_params=b)
        tst, tv = ts.update(tst, torch.tensor(loss), ta, bad_params=b)
        assert int(tv) == int(jv)
        names.append(verdict_name(tv))
        for f in ("count", "consecutive", "anomalies"):
            assert int(getattr(tst, f)) == int(getattr(jst, f))
        for f in ("ema", "var"):
            np.testing.assert_allclose(float(getattr(tst, f)),
                                       float(getattr(jst, f)), rtol=1e-6)
    assert {"ok", "skip", "rollback", "halt"} <= set(names)
    # the one-call form: found_inf, the loss check and the params check
    for found, params in ((True, None), (False, [np.array([1.0, np.nan])])):
        jst, jv = js.check(jst, jnp.float32(4.2), found_inf=found,
                           params=None if params is None
                           else [jnp.asarray(a) for a in params])
        tst, tv = ts.check(tst, torch.tensor(4.2), found_inf=found,
                           params=None if params is None
                           else [torch.from_numpy(a) for a in params])
        assert int(tv) == int(jv) and int(tst.anomalies) == int(jst.anomalies)


def test_poison_loss_and_l2_norm():
    x = torch.tensor(2.0, requires_grad=True)
    poison_loss(x * 3, 1.0).backward()
    assert torch.isnan(x.grad)
    assert float(poison_loss(torch.tensor(2.0), torch.tensor(0.0))) == 2.0
    tree = {"b": np.arange(4.0, dtype=np.float32),
            "a": {"w": np.ones((2, 3), np.float32)}}
    ref = jax_l2_norm(jax.tree_util.tree_map(jnp.asarray, tree))
    out = calc_params_l2_norm(gpt_params_from_jax(tree))
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-7)


# -- data --------------------------------------------------------------------

def test_synthetic_corpus_and_lm_dataset_match_jax(tmp_path):
    from apex_tpu.data import IndexedTokenDataset as JaxIndexedTokenDataset
    from apex_tpu.data import LMDataset as JaxLMDataset
    from apex_tpu.resilience.replay.targets import (
        synthetic_corpus as jax_synthetic_corpus,
    )

    prefix = synthetic_corpus(100, 5000)
    toks = IndexedTokenDataset(prefix).tokens
    rng = np.random.RandomState(0)
    want = np.cumsum(rng.randint(1, 5, size=(5000,)), dtype=np.int64) % 100
    np.testing.assert_array_equal(toks, want.astype(np.int32))
    # the two packages' token files hold the same bytes
    with open(prefix + ".bin", "rb") as a, \
            open(jax_synthetic_corpus(100, 5000) + ".bin", "rb") as b:
        assert a.read() == b.read()
    jlm = JaxLMDataset(JaxIndexedTokenDataset(prefix), seq_len=64)
    lm = LMDataset(IndexedTokenDataset(prefix), 64)
    assert len(lm) == len(jlm)
    for got, ref in zip(lm.batch([0, 5, len(lm) - 1]),
                        jlm.batch([0, 5, len(jlm) - 1])):
        np.testing.assert_array_equal(got, ref)


# -- GPT loss and gradients, fp32 ---------------------------------------------
# 2 layers, hidden 128, 2 heads, vocab 512, 2 x 16 tokens; the JAX model
# initialises, its weights carry over. Loss 1e-5 relative; gradients
# 1e-4 relative plus 2e-6 absolute (fp32 matmul chains summed in another
# order; the smallest gradients are ~1e-4).

SMALL = dict(num_layers=2, hidden_size=128, num_attention_heads=2,
             vocab_size=512, max_position_embeddings=64, hidden_dropout=0.0,
             attention_dropout=0.0)


def test_gpt_loss_and_every_gradient_match_jax():
    jmodel = JaxGPT(config=JaxConfig(compute_dtype=jnp.float32, **SMALL))
    rs = np.random.RandomState(3)
    tokens = rs.randint(0, 512, (2, 16)).astype(np.int32)
    labels = rs.randint(0, 512, (2, 16)).astype(np.int32)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.asarray(tokens))["params"]

    def loss_fn(p):
        return jax_gpt_loss_fn(jmodel.apply({"params": p}, jnp.asarray(tokens),
                                            labels=jnp.asarray(labels)))

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    model = GPTModel(TransformerConfig(compute_dtype=torch.float32, **SMALL),
                     device="cpu")
    model.load_state_dict(gpt_params_from_jax(_np(params)), strict=True)
    loss = gpt_loss_fn(model(torch.from_numpy(tokens).long(),
                             labels=torch.from_numpy(labels).long()))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    ref = gpt_params_from_jax(_np(ref_grads))
    named = dict(model.named_parameters())
    assert set(named) == set(ref) and len(named) == 2 * 12 + 4
    for name, p in named.items():
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(),
                                   atol=2e-6, rtol=1e-4, err_msg=name)


# -- the whole training step ---------------------------------------------------
# The JAX build_gpt_training and the port's, from the same weights and the
# same batches (bf16 compute, fp32 params), for 3 clean steps and then one
# inject_nan step. Losses agree to 2e-3 relative and grad norms to 2e-2
# (bf16 activations rounded at the same points but accumulated in another
# order); verdicts and loss scales exactly; the final params to 2e-3
# absolute, a few times lr = 3e-4 (Adam's first steps move every element by
# about lr, so an element whose small gradient differs in sign moves the
# other way).

TARGET = dict(vocab=512, seq_len=64, layers=2, hidden=128, heads=2,
              micro_batch=2, global_batch=4, max_devices=1)


@pytest.fixture(scope="module")
def jax_training():
    from apex_tpu.parallel import parallel_state
    from apex_tpu.resilience.replay.targets import GPTTargetConfig as JaxCfg
    from apex_tpu.resilience.replay.targets import build_gpt_training as jbuild

    training = jbuild(JaxCfg(**TARGET))
    yield training
    parallel_state.destroy_model_parallel()


def test_training_step_matches_jax(jax_training):
    from apex_tpu import monitor

    jt = jax_training
    # init_state's recipe without its eager shard_map (slow on the CPU)
    params = jax.jit(jt.model.init)(jax.random.PRNGKey(0),
                                   jnp.zeros((2, 64), jnp.int32))
    opt_state = jax.jit(jt.opt.init)(params)
    scaler_state, sent_state = jt.scaler.init(), jt.sentinel.init()
    pt = build_gpt_training(GPTTargetConfig(**TARGET), device="cpu")
    state = pt.init_state()
    pt.model.load_state_dict(gpt_params_from_jax(_np(params["params"])),
                             strict=True)
    lm = LMDataset(IndexedTokenDataset(synthetic_corpus(512, 20_000)), 64)
    for step, nan in enumerate([0, 0, 0, 1]):
        x, y = pt.reshape_batch(*lm.batch(range(4 * step, 4 * step + 4)))
        out = jt.train_step(params, opt_state, scaler_state, sent_state,
                            jt.init_bag(), jnp.asarray(x, jnp.int32),
                            jnp.asarray(y, jnp.int32), jnp.float32(nan),
                            jnp.float32(1.0))
        params, opt_state, scaler_state, sent_state, bag, jloss, jverdict = out
        jm = monitor.read_bag(bag)
        before = {n: p.detach().clone() for n, p in state.params.items()}
        m_before = {n: t.clone() for n, t in state.opt.exp_avg.items()}
        state, loss, verdict, metrics = pt.train_step(state, x, y,
                                                      inject_nan=nan)
        assert verdict == int(jverdict)
        assert metrics["loss_scale"] == jm["loss_scale"]
        assert metrics["skipped"] == jm["skipped"] == float(nan)
        if nan:
            assert verdict == VERDICT_SKIP and np.isnan(loss)
            assert metrics["loss_scale"] == 2.0**15
            for n, p in state.params.items():
                assert torch.equal(p, before[n]), n
                assert torch.equal(state.opt.exp_avg[n], m_before[n]), n
            assert int(state.opt.step) == 3
        else:
            assert verdict == VERDICT_OK
            np.testing.assert_allclose(loss, float(jloss), rtol=2e-3)
            np.testing.assert_allclose(metrics["grad_norm"],
                                       jm["grad_norm"], rtol=2e-2)
    ref = gpt_params_from_jax(_np(params["params"]))
    for n, p in state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), ref[n].numpy(),
                                   atol=2e-3, rtol=0, err_msg=n)
    # the JAX Adam state (over the flax variables tree) converts onto the
    # port's names, so either framework can resume from the other's state
    conv = fused_adam_state_from_jax(_np(opt_state), device="cpu")
    ref_m = gpt_params_from_jax(_np(opt_state.exp_avg["params"]))
    assert int(conv.step) == int(state.opt.step) == 3
    assert set(conv.exp_avg) == set(state.opt.exp_avg) == set(ref_m)
    for n, m in conv.exp_avg.items():
        assert torch.equal(m, ref_m[n]) and m.shape == state.params[n].shape


def test_training_refuses_what_is_not_ported():
    # tp, zero and max_devices are ported (tests/test_torch_parallel_
    # training.py), pipeline parallelism (tests/test_torch_pipeline*.py),
    # context parallelism (tests/test_torch_context_parallel.py), and
    # compression and the layer-RMS taps (tests/test_torch_training_
    # compress.py): at a world of one they build, the DDP residual rides
    # in the optimizer slot, and the taps give one finite RMS a layer
    from apex_tpu_torch.parallel import parallel_state

    tiny = dict(vocab=64, seq_len=16, layers=2, hidden=32, heads=2,
                micro_batch=2, global_batch=4)
    for extra in (dict(compression="int8"), dict(collect_layer_rms=True)):
        tr = build_gpt_training(GPTTargetConfig(**tiny, **extra),
                                device="cpu")
        state = tr.init_state()
        assert isinstance(state.opt, dict) == ("compression" in extra)
        x = np.arange(4 * 16).reshape(4, 16) % 64
        out = tr.train_step(state, *tr.reshape_batch(x, np.roll(x, -1, 1)))
        assert len(out) == (5 if "collect_layer_rms" in extra else 4)
        if len(out) == 5:
            assert len(out[4]) == 2 and np.isfinite(out[4]).all()
    # pp = 2 needs a world of that many processes, as tp = 2 does
    with pytest.raises(RuntimeError, match="world"):
        parallel_state.initialize_model_parallel(
            pipeline_model_parallel_size=2)
    # tp = 2 and 4 devices need a world of that many processes
    with pytest.raises(RuntimeError, match="world"):
        build_gpt_training(GPTTargetConfig(tp=2), device="cpu")
    with pytest.raises(ValueError, match="max_devices"):
        build_gpt_training(GPTTargetConfig(max_devices=4), device="cpu")
    with pytest.raises(AssertionError, match="divide evenly"):
        build_gpt_training(GPTTargetConfig(micro_batch=3, global_batch=16),
                           device="cpu")


def test_example_trains_on_cpu(capsys):
    records = pretrain_gpt.main([
        "--device", "cpu", "--steps", "3", "--layers", "1", "--hidden", "32",
        "--heads", "2", "--seq-len", "16", "--micro-batch", "2",
        "--global-batch", "4", "--vocab", "64"])
    out = capsys.readouterr().out
    assert out.count("step ") == 3 and "loss_scale 65536.0" in out
    assert [r["verdict"] for r in records] == ["ok"] * 3
    assert all(np.isfinite(r["loss"]) for r in records)
