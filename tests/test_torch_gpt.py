"""apex_tpu_torch's GPT against the JAX package's GPTModel and generate.

A small GPT (2 layers, hidden 128, 4 heads, vocab 256) is initialised by
the JAX package from a seed; ``gpt_params_from_jax`` carries its weights
into the port, so both compute with the same numbers. Inputs come from a
seeded numpy RNG. Tolerances: 1e-4 on fp32 logits (two layers of fp32
matmuls summed in another order), 5e-2 on bf16 logits (activations are
rounded to bf16 at the same points but accumulated in another order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import GPTModel as JaxGPT
from apex_tpu.models import generate as jax_generate
from apex_tpu.models.generate import _filter_logits as jax_filter_logits
from apex_tpu.transformer import TransformerConfig as JaxConfig
from apex_tpu_torch.models import GPTModel, generate, gpt_params_from_jax
from apex_tpu_torch.models.generate import _filter_logits, sample_next_token
from apex_tpu_torch.transformer import TransformerConfig

LOGITS_TOL = 1e-4
BF16_LOGITS_TOL = 5e-2
SMALL = dict(num_layers=2, hidden_size=128, num_attention_heads=4,
             vocab_size=256, max_position_embeddings=64,
             hidden_dropout=0.0, attention_dropout=0.0)


def _pair(compute="fp32", **extra):
    """(jitted jax apply, jax model, jax variables, port model) with the
    same weights (jit: one compile is far cheaper than eager dispatch)."""
    jd, td = ((jnp.float32, torch.float32) if compute == "fp32"
              else (jnp.bfloat16, torch.bfloat16))
    jmodel = JaxGPT(config=JaxConfig(compute_dtype=jd, **SMALL, **extra))
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                     jnp.zeros((1, 8), jnp.int32))
    apply = jax.jit(jmodel.apply,
                    static_argnames=("cache_len", "decode_step", "mutable"))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    model = GPTModel(TransformerConfig(compute_dtype=td, **SMALL, **extra),
                     device="cpu")
    model.load_state_dict(gpt_params_from_jax(params), strict=True)
    return apply, jmodel, variables, model


@pytest.fixture(scope="module")
def fp32_pair():
    return _pair()


def _tokens(b, s, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (b, s)).astype(np.int32)


@pytest.mark.parametrize(
    "extra", [{}, {"num_query_groups": 2},
              {"share_embeddings_and_output_weights": False}],
    ids=["mha", "gqa", "untied"])
def test_logits_match_jax(extra, fp32_pair):
    apply, _, variables, model = _pair(**extra) if extra else fp32_pair
    tokens = _tokens(2, 24)
    ref = apply(variables, jnp.asarray(tokens))
    with torch.no_grad():
        out = model(torch.from_numpy(tokens).long())
    assert out.dtype == torch.float32 and out.shape == (2, 24, 256)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               atol=LOGITS_TOL, rtol=LOGITS_TOL)


def test_bf16_logits_match_jax():
    apply, _, variables, model = _pair("bf16")
    tokens = _tokens(1, 16, seed=1)
    ref = apply(variables, jnp.asarray(tokens))
    with torch.no_grad():
        out = model(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               atol=BF16_LOGITS_TOL, rtol=BF16_LOGITS_TOL)


def test_prefill_and_decode_step_match_jax(fp32_pair):
    apply, _, variables, model = fp32_pair
    tokens = _tokens(2, 10, seed=2)
    total, nxt = 16, _tokens(2, 1, seed=3)
    ref_pre, state = apply(variables, jnp.asarray(tokens),
                           cache_len=total, mutable=("cache",))
    ref_step, _ = apply(
        {**variables, "cache": state["cache"]}, jnp.asarray(nxt),
        position_ids=jnp.full((1, 1), 10, jnp.int32), cache_len=total,
        decode_step=True, mutable=("cache",))
    cache = model.new_cache(2, total)
    with torch.no_grad():
        pre = model(torch.from_numpy(tokens).long(), cache=cache)
        step = model(torch.from_numpy(nxt).long(), cache=cache,
                     decode_step=True)
    assert cache.index.tolist() == [11, 11]
    np.testing.assert_allclose(pre.numpy(), np.asarray(ref_pre),
                               atol=LOGITS_TOL, rtol=LOGITS_TOL)
    np.testing.assert_allclose(step.numpy(), np.asarray(ref_step),
                               atol=LOGITS_TOL, rtol=LOGITS_TOL)


@pytest.mark.parametrize("use_cache", [True, False])
def test_greedy_generate_matches_jax(use_cache, fp32_pair):
    _, jmodel, variables, model = fp32_pair
    prompt = _tokens(2, 7, seed=4)
    ref = jax.jit(functools.partial(jax_generate, jmodel, max_new_tokens=9,
                                    use_cache=use_cache))(
        variables, jnp.asarray(prompt))
    out = generate(model, prompt, max_new_tokens=9, use_cache=use_cache,
                   device="cpu")
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_sampled_generate_is_seeded_and_bounded(fp32_pair):
    *_, model = fp32_pair
    prompt = _tokens(1, 5, seed=5)

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return generate(model, prompt, 6, temperature=0.8, generator=gen,
                        top_k=20, top_p=0.9, device="cpu")

    a, b = run(1), run(1)
    assert torch.equal(a, b)
    assert a.shape == (1, 11) and int(a.max()) < 256
    with pytest.raises(ValueError, match="generator"):
        generate(model, prompt, 2, temperature=1.0, device="cpu")
    with pytest.raises(ValueError, match="max_position_embeddings"):
        generate(model, prompt, 60, device="cpu")


@pytest.mark.parametrize("top_k,top_p", [(5, None), (None, 0.7), (3, 0.5),
                                         (300, 1.0)])
def test_filter_logits_matches_jax(top_k, top_p):
    logits = np.random.RandomState(6).randn(3, 256).astype(np.float32)
    ref = jax_filter_logits(jnp.asarray(logits), top_k, top_p)
    out = _filter_logits(torch.from_numpy(logits), top_k, top_p)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_sample_next_token_greedy_rows_take_argmax():
    logits = torch.from_numpy(
        np.random.RandomState(7).randn(4, 256).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    tok = sample_next_token(logits, [0.0, 1.0, 0.0, 0.5], gen)
    assert tok.shape == (4,)
    assert tok[0] == logits[0].argmax() and tok[2] == logits[2].argmax()


def test_unported_features_raise():
    # rope is ported (tests/test_torch_llama.py); recompute is not
    with pytest.raises(NotImplementedError, match="recompute"):
        GPTModel(TransformerConfig(recompute_granularity="full", **SMALL),
                 device="cpu")
    with pytest.raises(NotImplementedError, match="MoE"):
        GPTModel(TransformerConfig(num_moe_experts=2, **SMALL), device="cpu")
