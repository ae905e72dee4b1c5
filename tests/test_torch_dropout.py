"""Dropout in apex_tpu_torch against the JAX package's, and its statistics.

Torch cannot draw JAX's PRNG masks, so the train-mode comparison hands
both sides the same keep masks: ``jax.random.bernoulli`` (which the JAX
``ShardAwareDropout`` calls) and the port's one mask draw
(``transformer.layer.keep_mask``) are patched, inside the test only, to
pop seeded numpy masks from one queue, in JAX's order: the embedding's,
then in each layer the attention probabilities', after attention and
after the MLP. A small BERT (2 layers, hidden 64, 4 heads, vocab 128,
batch 2, seq 32) with the JAX package's weights; its logits, NSP logits,
losses and every gradient are held to 1e-5 (fp32 arithmetic summed in
another order).

The port's own draws are held statistically: over n = 2^20 elements at
rate 0.1 the kept share lies within 4 sigma = 4 sqrt(0.9 * 0.1 / n)
(about 1.2e-3) of 0.9, and every kept element is x / (1 - rate) with the
divisor rounded to x's dtype, so the mean of the kept scale is 1/0.9 to
that rounding.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models.bert import BertModel as JaxBert
from apex_tpu.parallel.random import model_parallel_seed as jax_mp_seed
from apex_tpu.transformer import TransformerConfig as JaxConfig
from apex_tpu_torch.models import BertModel, bert_params_from_jax
from apex_tpu_torch.parallel import random as prandom
from apex_tpu_torch.transformer import TransformerConfig, layer
from apex_tpu_torch.transformer.layer import ShardAwareDropout

TOL = 1e-5
B, S, V, H, NP = 2, 32, 128, 64, 4
SMALL = dict(num_layers=2, hidden_size=H, num_attention_heads=NP,
             vocab_size=V, max_position_embeddings=S)


def _mask_shapes(attention_dropout):
    shapes = [(S, B, H)]  # the embedding's
    for _ in range(SMALL["num_layers"]):
        if attention_dropout:
            shapes.append((B, NP, S, S))
        shapes += [(S, B, H), (S, B, H)]
    return shapes


def _inputs(seed=0):
    rs = np.random.RandomState(seed)
    tokens = rs.randint(0, V, (B, S)).astype(np.int32)
    mask = (np.arange(S)[None, :] < np.array([S, 20])[:, None]).astype(
        np.int32)
    types = (np.arange(S)[None, :] >= 10).astype(np.int32) * mask
    labels = rs.randint(0, V, (B, S)).astype(np.int32)
    return tokens, mask, types, labels


@pytest.mark.parametrize("attention_dropout", [0.1, 0.0],
                         ids=["core-attention", "flash-hidden-only"])
def test_train_mode_matches_jax_with_shared_masks(monkeypatch,
                                                  attention_dropout):
    """With attention dropout, BERT's padding takes the dense extended
    mask through CoreAttention; with hidden dropout alone it stays on the
    flash path's key-padding row."""
    rate = 0.1
    kw = dict(SMALL, hidden_dropout=rate, attention_dropout=attention_dropout)
    jmodel = JaxBert(config=JaxConfig(compute_dtype=jnp.float32,
                                      attention_impl="pallas", **kw))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 8), jnp.int32))["params"]
    model = BertModel(TransformerConfig(compute_dtype=torch.float32, **kw),
                      device="cpu")
    model.load_state_dict(bert_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)
    assert model.training

    rs = np.random.RandomState(1)
    masks = [rs.rand(*s) < 1.0 - rate
             for s in _mask_shapes(attention_dropout)]
    jqueue, tqueue = list(masks), list(masks)

    def jax_bernoulli(key, p, shape):
        m = jqueue.pop(0)
        assert tuple(shape) == m.shape and math.isclose(p, 1.0 - rate)
        return jnp.asarray(m)

    def port_keep_mask(generator, keep_prob, shape, device):
        m = tqueue.pop(0)
        assert tuple(shape) == m.shape and math.isclose(keep_prob, 1 - rate)
        assert isinstance(generator, torch.Generator)
        return torch.from_numpy(m).to(device)

    monkeypatch.setattr(jax.random, "bernoulli", jax_bernoulli)
    monkeypatch.setattr(layer, "keep_mask", port_keep_mask)

    tokens, mask, types, labels = _inputs()

    def jloss(p):
        losses, nsp = jmodel.apply(
            {"params": p}, jnp.asarray(tokens), jnp.asarray(mask),
            jnp.asarray(types), lm_labels=jnp.asarray(labels),
            deterministic=False, rngs={"dropout": jax.random.PRNGKey(2)})
        return jnp.mean(losses * mask) + 0.1 * jnp.sum(nsp), (losses, nsp)

    (ref_total, (ref_losses, ref_nsp)), ref_grads = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(params)
    assert not jqueue
    t = {k: torch.from_numpy(v).long()
         for k, v in dict(tokens=tokens, mask=mask, types=types,
                          labels=labels).items()}
    losses, nsp = model(t["tokens"], t["mask"], t["types"],
                        lm_labels=t["labels"])
    total = (losses * t["mask"]).mean() + 0.1 * nsp.sum()
    total.backward()
    assert not tqueue
    np.testing.assert_allclose(losses.detach().numpy(),
                               np.asarray(ref_losses), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(nsp.detach().numpy(), np.asarray(ref_nsp),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(total.item(), float(ref_total), rtol=TOL)
    want = bert_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                       ref_grads))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=TOL, rtol=TOL, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kept_share_and_scale(dtype):
    n, rate = 1 << 20, 0.1
    drop = ShardAwareDropout(rate, generator=prandom.data_parallel_generator(
        5))
    out = drop(torch.ones(n, dtype=dtype))
    assert out.dtype == dtype
    kept = out != 0
    share = kept.float().mean().item()
    sigma = math.sqrt(rate * (1 - rate) / n)
    assert abs(share - (1 - rate)) < 4 * sigma
    scale = torch.tensor(1 - rate, dtype=dtype)
    want = (torch.ones((), dtype=dtype) / scale).item()
    assert bool((out[kept] == want).all())
    assert out[kept].double().mean().item() == pytest.approx(
        1 / (1 - rate), rel=2 ** -7 if dtype == torch.bfloat16 else 1e-7)


def _bert(seed=0, **kw):
    cfg = TransformerConfig(compute_dtype=torch.float32, **dict(SMALL, **kw))
    return BertModel(cfg, device="cpu", seed=seed)


def _run(model):
    tokens, mask, types, _ = _inputs(3)
    with torch.no_grad():
        return model(*(torch.from_numpy(x).long()
                       for x in (tokens, mask, types)))


def test_eval_is_bit_equal_to_rate_zero():
    on = _bert(hidden_dropout=0.1, attention_dropout=0.1).eval()
    off = _bert(hidden_dropout=0.0, attention_dropout=0.0).train()
    off.load_state_dict(on.state_dict())
    for a, b in zip(_run(on), _run(off)):
        assert torch.equal(a, b)


def test_same_seed_same_masks_and_another_seed_others():
    a = _run(_bert(seed=3, hidden_dropout=0.1, attention_dropout=0.1))
    b = _run(_bert(seed=3, hidden_dropout=0.1, attention_dropout=0.1))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    # the same weights, the dropout generators of another seed
    model = _bert(seed=3, hidden_dropout=0.1, attention_dropout=0.1)
    layer.seed_dropout(model, 4, "cpu")
    c = _run(model)
    assert not torch.equal(a[0], c[0])
    g1, g2 = (prandom.model_parallel_generator(7) for _ in range(2))
    m1, m2 = (layer.keep_mask(g, 0.9, (64, 64), "cpu") for g in (g1, g2))
    assert torch.equal(m1, m2)


def test_generators_follow_the_seed_math():
    for seed, rank in ((0, 0), (1234, 0), (1234, 3)):
        assert prandom.model_parallel_seed(seed, rank) == jax_mp_seed(seed,
                                                                      rank)
    mp = prandom.model_parallel_generator(5, 2)
    assert mp.initial_seed() == 5 + 2718 + 2
    assert prandom.data_parallel_generator(5).initial_seed() == 5
    gen = prandom.data_parallel_generator(5)
    assert prandom.shard_aware_generator(gen, ("tp", "cp")) is gen
    model = _bert(seed=11, hidden_dropout=0.1, attention_dropout=0.1)
    drops = [m for m in model.modules() if isinstance(m, ShardAwareDropout)]
    # the embedding's, and per layer the attention probabilities' and the
    # hidden one
    assert len(drops) == 1 + 2 * SMALL["num_layers"]
    for m in drops:
        want = 11 + 2718 if m.model_parallel else 11
        assert m.generator.initial_seed() == want


def test_a_draw_without_a_generator_raises():
    drop = ShardAwareDropout(0.1)
    with pytest.raises(ValueError, match="no generator"):
        drop(torch.ones(4))
    assert torch.equal(drop.eval()(torch.ones(4)), torch.ones(4))


def test_hidden_dropout_under_sp_differs_across_tp_ranks():
    """Under sequence parallelism the tp ranks hold different slices of
    the sequence, so JAX folds the tp rank into the hidden dropout's key
    (``apex_tpu/transformer/layer.py`` ``_hidden_dropout_axes``). On a
    world of 2 gloo ranks at tp = 2: the hidden-dropout masks differ
    across the ranks and repeat from the same seed on each; the
    attention dropout keeps drawing its model-parallel generator's own
    mask (the tp rank is in that generator's seed, so no second fold).
    The JAX and torch generators are different streams, so no mask is
    compared with JAX's."""
    from apex_tpu_torch.transformer.testing.distributed_test_base import (
        spawn,
    )
    from apex_tpu_torch.transformer.testing.parallel_workers import (
        sp_dropout_worker,
    )

    outs = spawn(sp_dropout_worker, 2, timeout=120.0)
    assert [o["tp_rank"] for o in outs] == [0, 1]
    masks = [o["hidden"] != 0 for o in outs]
    assert not np.array_equal(masks[0], masks[1]), \
        "tp ranks drew one hidden-dropout mask under sequence parallelism"
    for o in outs:
        np.testing.assert_array_equal(o["hidden"], o["hidden_again"])
        np.testing.assert_array_equal(o["attention"], o["attention_again"])
        np.testing.assert_array_equal(o["attention"], o["attention_direct"])
        assert set(np.unique(o["hidden"])) <= {0.0, 2.0}
    assert not np.array_equal(outs[0]["attention"], outs[1]["attention"])
