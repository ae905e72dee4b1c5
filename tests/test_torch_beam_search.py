"""apex_tpu_torch's beam_search against the JAX package's.

A tiny GPT (2 layers, hidden 32, 4 heads, vocab 64, fp32) is initialised
by the JAX package from a seed and carried into the port by
``gpt_params_from_jax``; prompts come from a seeded numpy RNG. Tokens
must be equal and scores agree within 1e-5 (log-softmax sums of the same
fp32 logits in another order). Exact ties do occur (a random model
repeats tokens, and two hypotheses can sum to the same fp32 score): the
port breaks them toward the lower index, as ``jax.lax.top_k`` does, which
a test holds on tied inputs. The prompts are not chosen, only seeded.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import GPTModel as JaxGPT
from apex_tpu.models.generate import beam_search as jax_beam_search
from apex_tpu.transformer import TransformerConfig as JaxConfig
from apex_tpu_torch.models import (
    GPTModel,
    beam_search,
    generate,
    gpt_params_from_jax,
)
from apex_tpu_torch.models.generate import _top_k
from apex_tpu_torch.transformer import TransformerConfig

SCORE_TOL = 1e-5
TINY = dict(num_layers=2, hidden_size=32, num_attention_heads=4,
            vocab_size=64, max_position_embeddings=48, hidden_dropout=0.0,
            attention_dropout=0.0)


def _pair(**extra):
    jmodel = JaxGPT(config=JaxConfig(compute_dtype=jnp.float32, **TINY,
                                     **extra))
    variables = jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    model = GPTModel(TransformerConfig(compute_dtype=torch.float32, **TINY,
                                       **extra), device="cpu")
    model.load_state_dict(gpt_params_from_jax(params), strict=True)
    return jmodel, variables, model


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _prompts(b, s, seed):
    return np.random.RandomState(seed).randint(
        0, TINY["vocab_size"], (b, s)).astype(np.int32)


@pytest.mark.parametrize("b,s,new,beams,penalty", [
    (2, 6, 8, 4, 1.0),
    (1, 11, 5, 3, 0.6),
    (3, 4, 1, 2, 1.0),
])
def test_beams_equal_jax(pair, b, s, new, beams, penalty):
    jmodel, variables, model = pair
    prompt = _prompts(b, s, seed=b * 100 + s)
    jt, js = jax_beam_search(jmodel, variables, jnp.asarray(prompt), new,
                             beams, length_penalty=penalty)
    tokens, scores = beam_search(model, prompt, new, beams,
                                 length_penalty=penalty, device="cpu")
    assert tokens.shape == (b, beams, s + new) and tokens.dtype == torch.long
    assert scores.shape == (b, beams) and scores.dtype == torch.float32
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jt))
    np.testing.assert_allclose(scores.numpy(), np.asarray(js),
                               atol=SCORE_TOL, rtol=SCORE_TOL)
    # best-first, prompts kept
    assert bool((scores[:, :-1] >= scores[:, 1:]).all())
    assert bool((tokens[:, :, :s] == torch.from_numpy(prompt)[:, None]
                 .long()).all())


def test_rope_beams_equal_jax():
    jmodel, variables, model = _pair(position_embedding_type="rope")
    prompt = _prompts(2, 7, seed=7)
    jt, js = jax_beam_search(jmodel, variables, jnp.asarray(prompt), 6, 3)
    tokens, scores = beam_search(model, prompt, 6, 3, device="cpu")
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jt))
    np.testing.assert_allclose(scores.numpy(), np.asarray(js),
                               atol=SCORE_TOL, rtol=SCORE_TOL)


def test_one_beam_is_greedy_generate(pair):
    _, _, model = pair
    prompt = _prompts(3, 5, seed=11)
    tokens, _ = beam_search(model, prompt, 9, 1, device="cpu")
    greedy = generate(model, prompt, 9, device="cpu")
    assert torch.equal(tokens[:, 0], greedy)


def test_zero_new_tokens_and_bad_beams(pair):
    jmodel, variables, model = pair
    prompt = _prompts(2, 5, seed=3)
    tokens, scores = beam_search(model, prompt, 0, 3, device="cpu")
    jt, js = jax_beam_search(jmodel, variables, jnp.asarray(prompt), 0, 3)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jt))
    assert torch.equal(scores, torch.zeros((2, 3)))
    with pytest.raises(ValueError, match="num_beams"):
        beam_search(model, prompt, 4, 0, device="cpu")
    with pytest.raises(ValueError, match="max_position_embeddings"):
        beam_search(model, prompt, 60, 2, device="cpu")


def test_ties_go_to_the_lower_index_as_in_jax():
    rs = np.random.RandomState(4)
    x = rs.randint(0, 6, (3, 40)).astype(np.float32)  # many exact ties
    x[1] = 2.5
    for k in (1, 4, 9):
        values, indices = _top_k(torch.from_numpy(x), k)
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(indices.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(values.numpy(), np.asarray(jv))
    assert _top_k(torch.from_numpy(x), 3)[1][1].tolist() == [0, 1, 2]
