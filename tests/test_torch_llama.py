"""apex_tpu_torch's Llama family against the JAX package's.

A small Llama (2 layers, hidden 128, 4 heads over 2 KV groups, SwiGLU
160, vocab 512, RMSNorm, rotate-half RoPE, untied fp32 head) is
initialised by the JAX package from a seed; ``gpt_params_from_jax``
carries its weights into the port, so both compute with the same
numbers. Inputs come from a seeded numpy RNG. The JAX side runs its
RMSNorm and flash attention with ``impl="pallas"`` semantics on the CPU
(its default dispatch there), the port runs the kernels' plain
versions on CPU tensors.

Tolerances: fp32 logits 1e-4 (two layers of fp32 matmuls summed in
another order, cos and sin from two libms); the loss 1e-5 relative;
gradients 2e-6 absolute + 1e-4 relative, as for GPT-2; greedy tokens
exactly. The transformers checks run only where ``transformers`` is
installed and hold the port to HF's fp32 logits at 1e-4.
"""

import functools
import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import GPTModel as JaxGPT
from apex_tpu.models import generate as jax_generate
from apex_tpu.models import gpt_loss_fn as jax_gpt_loss_fn
from apex_tpu.transformer import TransformerConfig as JaxConfig
from apex_tpu.transformer.layer import (
    rotary_embedding_for as jax_rotary_embedding_for,
)
from apex_tpu_torch.examples.llama import finetune_llama
from apex_tpu_torch.models import (
    GPTModel,
    config_from_hf_llama,
    generate,
    gpt_loss_fn,
    gpt_params_from_jax,
    llama_from_hf,
    params_from_hf_llama,
    params_to_hf_llama,
    tinyllama_1_1b_config,
)
from apex_tpu_torch.serving import ServingConfig, ServingEngine
from apex_tpu_torch.transformer import TransformerConfig
from apex_tpu_torch.transformer.layer import ParallelTransformerLayer

# the module, which the package's function of the same name shadows
dfa_module = importlib.import_module(
    "apex_tpu_torch.optimizers.distributed_fused_adam")
LOGITS_TOL = 1e-4
VOCAB = 512
LLAMA = dict(num_layers=2, hidden_size=128, num_attention_heads=4,
             num_query_groups=2, ffn_hidden_size=160, vocab_size=VOCAB,
             max_position_embeddings=64, layernorm_epsilon=1e-5,
             hidden_dropout=0.0, attention_dropout=0.0,
             normalization="rmsnorm", activation="swiglu",
             add_bias_linear=False, position_embedding_type="rope",
             rotary_base=10000.0, share_embeddings_and_output_weights=False,
             apply_query_key_layer_scaling=False)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair():
    """(jitted jax apply, jax model, jax variables, port model) with the
    same fp32 weights."""
    jmodel = JaxGPT(config=JaxConfig(compute_dtype=jnp.float32, **LLAMA))
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                     jnp.zeros((1, 8), jnp.int32))
    apply = jax.jit(jmodel.apply,
                    static_argnames=("cache_len", "decode_step", "mutable"))
    model = GPTModel(TransformerConfig(compute_dtype=torch.float32, **LLAMA),
                     device="cpu")
    model.load_state_dict(gpt_params_from_jax(_np(variables["params"])),
                          strict=True)
    return apply, jmodel, variables, model


def _tokens(b, s, seed=0):
    return np.random.RandomState(seed).randint(0, VOCAB, (b, s)).astype(
        np.int32)


def test_jax_llama_tree_carries_over_by_name(pair):
    """``gpt_params_from_jax`` joins the Llama tree's paths: a separate
    ``query`` and a per-group ``key_value``, the untied ``output_layer``
    and scale-only norms, all loaded strictly."""
    *_, variables, model = pair
    sd = gpt_params_from_jax(_np(variables["params"]))
    assert "output_layer.kernel" in sd
    assert sd["transformer.layer_0.self_attention.query.kernel"].shape == \
        (128, 128)
    assert sd["transformer.layer_1.self_attention.key_value.kernel"].shape \
        == (128, 2 * 2 * 32)
    assert sd["transformer.layer_0.mlp.dense_h_to_4h.kernel"].shape == \
        (128, 2 * 160)
    norms = [k for k in sd if "layernorm" in k]
    assert norms and all(k.endswith(".scale") for k in norms)
    assert set(sd) == set(model.state_dict())


def test_llama_logits_match_jax(pair):
    apply, _, variables, model = pair
    tokens = _tokens(2, 40)
    ref = apply(variables, jnp.asarray(tokens))
    with torch.no_grad():
        out = model(torch.from_numpy(tokens).long())
    assert out.dtype == torch.float32 and out.shape == (2, 40, VOCAB)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               atol=LOGITS_TOL, rtol=LOGITS_TOL)


def test_llama_bf16_logits_match_jax():
    jmodel = JaxGPT(config=JaxConfig(compute_dtype=jnp.bfloat16, **LLAMA))
    tokens = _tokens(1, 24, seed=1)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(1),
                                     jnp.asarray(tokens))
    ref = jax.jit(jmodel.apply)(variables, jnp.asarray(tokens))
    model = GPTModel(TransformerConfig(compute_dtype=torch.bfloat16, **LLAMA),
                     device="cpu")
    model.load_state_dict(gpt_params_from_jax(_np(variables["params"])),
                          strict=True)
    with torch.no_grad():
        out = model(torch.from_numpy(tokens).long())
    # bf16 activations rounded at the same points, summed in another order
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-2,
                               rtol=5e-2)


def test_llama_loss_and_every_gradient_match_jax(pair):
    _, jmodel, variables, model = pair
    rs = np.random.RandomState(3)
    tokens = rs.randint(0, VOCAB, (2, 32)).astype(np.int32)
    labels = rs.randint(0, VOCAB, (2, 32)).astype(np.int32)

    def loss_fn(p):
        return jax_gpt_loss_fn(jmodel.apply({"params": p}, jnp.asarray(tokens),
                                            labels=jnp.asarray(labels)))

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(
        variables["params"])
    model.zero_grad(set_to_none=True)
    loss = gpt_loss_fn(model(torch.from_numpy(tokens).long(),
                             labels=torch.from_numpy(labels).long()))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    ref = gpt_params_from_jax(_np(ref_grads))
    named = dict(model.named_parameters())
    # 2 layers of 7 tensors, the word table, the final norm and the head
    assert set(named) == set(ref) and len(named) == 2 * 7 + 3
    for name, p in named.items():
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(),
                                   atol=2e-6, rtol=1e-4, err_msg=name)
    model.zero_grad(set_to_none=True)


def test_decode_rows_at_different_positions_match_jax(pair):
    """Two rows of one cache at positions 6 and 10: each decode step's
    logits equal JAX's single-sequence decode of that row's prefix (a
    rope table broadcast across rows would mix their positions)."""
    apply, _, variables, model = pair
    prompt = _tokens(2, 10, seed=2)
    lengths = [6, 10]
    steps = _tokens(2, 3, seed=3)
    cache = model.new_cache(2, 32)
    with torch.no_grad():
        model(torch.from_numpy(prompt).long(), cache=cache)
        # row 0's entries past 6 are stale but masked: the causal prefill
        # wrote the same K/V for positions < 6 as a 6-token prompt would
        cache.index[:] = torch.tensor(lengths)
        got = [model(torch.from_numpy(steps[:, i:i + 1]).long(), cache=cache,
                     decode_step=True)[:, 0].numpy() for i in range(3)]
    assert cache.index.tolist() == [9, 13]
    for row, L in enumerate(lengths):
        _, state = apply(variables, jnp.asarray(prompt[row:row + 1, :L]),
                         cache_len=32, mutable=("cache",))
        for i in range(3):
            ref, state = apply(
                {**variables, "cache": state["cache"]},
                jnp.asarray(steps[row:row + 1, i:i + 1]),
                position_ids=jnp.full((1, 1), L + i, jnp.int32),
                cache_len=32, decode_step=True, mutable=("cache",))
            np.testing.assert_allclose(got[i][row], np.asarray(ref)[0, 0],
                                       atol=LOGITS_TOL, rtol=LOGITS_TOL)


def test_engine_greedy_tokens_match_jax_generate(pair):
    """The engine's lanes at different positions (ragged prompts, more
    requests than lanes, prompts across block edges) give JAX
    ``generate``'s greedy tokens on each prompt alone."""
    _, jmodel, variables, model = pair
    rs = np.random.RandomState(5)
    prompts = [rs.randint(0, VOCAB, size=n) for n in (5, 17, 30)]
    eng = ServingEngine(model, ServingConfig(lanes=2, block_size=8,
                                             num_blocks=24, max_seq_len=64),
                        device="cpu")
    reqs = [eng.submit(p, 8) for p in prompts]
    while not eng.idle:
        eng.tick()
    gen = jax.jit(functools.partial(jax_generate, jmodel, max_new_tokens=8))
    for r, p in zip(reqs, prompts):
        assert r.state == "completed"
        ref = np.asarray(gen(variables, jnp.asarray(p[None], jnp.int32)))
        assert r.tokens_out == ref[0, len(p):].tolist()


def test_rope_model_keeps_the_position_bound(pair):
    *_, model = pair
    with pytest.raises(ValueError, match="max_position_embeddings"):
        ServingEngine(model, ServingConfig(lanes=1, block_size=8,
                                           num_blocks=16, max_seq_len=128),
                      device="cpu")
    with pytest.raises(ValueError, match="max_position_embeddings"):
        generate(model, _tokens(1, 60), max_new_tokens=5, device="cpu")


def test_rope_table_is_built_once_at_the_position_bound(pair):
    """The cos/sin table holds ``max_position_embeddings`` rows of the
    JAX cache-length table's angles; a rope config with no bound is
    refused, since a position past the table has no row."""
    *_, model = pair
    jf, _ = jax_rotary_embedding_for(
        JaxConfig(compute_dtype=jnp.float32, **LLAMA), 64)
    jf = np.asarray(jf)[:, 0, 0, :]
    assert model.rope_cos.shape == model.rope_sin.shape == (64, 32)
    np.testing.assert_allclose(model.rope_cos.numpy(), np.cos(jf), atol=1e-6)
    np.testing.assert_allclose(model.rope_sin.numpy(), np.sin(jf), atol=1e-6)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        GPTModel(TransformerConfig(**dict(LLAMA, max_position_embeddings=0)),
                 device="cpu")


def test_tinyllama_config_has_the_published_shape():
    """1,100,048,384 parameters in 157 tensors, counted on the meta
    device (no memory): 22 layers of 7 tensors, the word table, the
    final norm and the untied head."""
    cfg = tinyllama_1_1b_config()
    hf = types.SimpleNamespace(
        vocab_size=32000, hidden_size=2048, intermediate_size=5632,
        num_hidden_layers=22, num_attention_heads=32, num_key_value_heads=4,
        max_position_embeddings=2048, rms_norm_eps=1e-5, rope_theta=10000.0,
        tie_word_embeddings=False)
    assert config_from_hf_llama(
        hf, compute_dtype=torch.bfloat16) == cfg
    layer = ParallelTransformerLayer(cfg, device="meta")
    per_layer = [p.numel() for p in layer.parameters()]
    h, v = cfg.hidden_size, cfg.vocab_size
    total = 22 * sum(per_layer) + v * h + h + h * v
    assert (22 * len(per_layer) + 3, total) == (157, 1_100_048_384)
    assert cfg.kv_channels == 64 and cfg.num_query_groups == 4


# -- transformers import -----------------------------------------------------

def _hf_llama(heads=4, kv_heads=2, seed=0):
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.LlamaConfig(
        vocab_size=VOCAB, hidden_size=128, intermediate_size=160,
        num_hidden_layers=2, num_attention_heads=heads,
        num_key_value_heads=kv_heads, max_position_embeddings=64,
        rms_norm_eps=1e-5, rope_theta=10000.0, tie_word_embeddings=False,
        attn_implementation="eager")
    torch.manual_seed(seed)
    return transformers.LlamaForCausalLM(hf_cfg).eval()


@pytest.mark.parametrize("heads,kv_heads", [(4, 2), (4, 4)],
                         ids=["gqa", "mha"])
def test_llama_from_hf_matches_transformers(heads, kv_heads):
    hf = _hf_llama(heads, kv_heads)
    tokens = _tokens(2, 24, seed=6)
    with torch.no_grad():
        ref = hf(torch.from_numpy(tokens).long()).logits
        model = llama_from_hf(hf, device="cpu")
        out = model(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=LOGITS_TOL,
                               rtol=LOGITS_TOL)


def test_llama_from_hf_matches_jax_import():
    from apex_tpu.models.hf_import import llama_from_hf as jax_llama_from_hf

    hf = _hf_llama(seed=1)
    tokens = _tokens(1, 20, seed=7)
    jmodel, jvars = jax_llama_from_hf(hf)
    ref = jax.jit(jmodel.apply)(jvars, jnp.asarray(tokens))
    model = llama_from_hf(hf, device="cpu")
    # the same tensors by name as the JAX import's tree
    want = gpt_params_from_jax(_np(jvars["params"]))
    got = params_from_hf_llama(hf.state_dict(), hf.config)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), k)
    with torch.no_grad():
        out = model(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=LOGITS_TOL,
                               rtol=LOGITS_TOL)


@pytest.mark.parametrize("heads,kv_heads", [(4, 2), (4, 4)],
                         ids=["gqa", "mha"])
def test_params_to_hf_llama_round_trip(heads, kv_heads):
    src = _hf_llama(heads, kv_heads, seed=2)
    model = llama_from_hf(src, device="cpu")
    dst = _hf_llama(heads, kv_heads, seed=3)
    params_to_hf_llama(model, dst)
    for k, v in src.state_dict().items():
        torch.testing.assert_close(dst.state_dict()[k], v, atol=0, rtol=0,
                                   msg=k)


# -- the fine-tuning example ---------------------------------------------------

def test_finetune_example_loss_falls_and_clips_through_sumsq(monkeypatch):
    """The example's loop on the CPU at the demo size: the loss falls,
    and every step's clip factor comes from ``sumsq_flat``."""
    calls = []
    real = dfa_module.sumsq_flat

    def counted(x):
        calls.append(x.numel())
        return real(x)

    monkeypatch.setattr(dfa_module, "sumsq_flat", counted)
    records = finetune_llama.main(["--device", "cpu", "--steps", "6",
                                   "--batch", "2", "--seq-len", "32"])
    losses = [r["loss"] for r in records]
    assert len(calls) == 6
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    # random init starts near ln(vocab)
    assert abs(losses[0] - np.log(256)) < 0.5


def test_finetune_step_reports_every_gradient():
    model = GPTModel(finetune_llama.demo_config(16), device="cpu", seed=0)
    run = finetune_llama.LlamaFinetune(model, batch=2, seq_len=16)
    loss, bad = run.step(check_grads=True)
    assert np.isfinite(loss) and bad == []
    assert all(p.grad is None for p in model.parameters())
    assert int(run.state.step) == 1


# -- the fine-tuning trajectory against the JAX example's ---------------------
# The JAX example's step (examples/llama/finetune_llama.py: the mean token
# loss, jax.value_and_grad, then distributed_fused_adam at a data-parallel
# world of one with average_grads and max_grad_norm, and
# optax.apply_updates) and the port's LlamaFinetune.step, from the same
# seeded weights on the same fixed batch, with the example's lr 1e-3 and
# clip 1.0. Both run in fp32; the per-step losses are held to
# TRAJECTORY_RTOL relative: the first is the same forward summed in
# another order (1e-5 in test_llama_loss_and_every_gradient_match_jax), and
# each update moves every weight by about lr, through Adam's normalisation
# of gradients that differ in their last bits (the losses agree to about
# 1e-7 and 6e-7 here).

TRAJECTORY_RTOL = 1e-5
TRAJECTORY_STEPS = 8


def _jax_finetune_losses(cfg, params, tokens, labels, steps, lr, clip):
    import optax
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from apex_tpu.compat import shard_map
    from apex_tpu.optimizers import distributed_fused_adam as jax_dfa

    jmodel = JaxGPT(config=cfg)
    mesh = Mesh(np.array(jax.devices()[:1]), ("dp",))
    opt = jax_dfa(lr=lr, axis_name="dp", axis_size=1, average_grads=True,
                  max_grad_norm=clip)
    toks, labs = jnp.asarray(tokens), jnp.asarray(labels)

    def loss_fn(p):
        return jnp.mean(jmodel.apply(p, toks, labels=labs))

    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    sharded = functools.partial(shard_map, mesh=mesh, out_specs=P(),
                                check_vma=False)
    init = jax.jit(sharded(opt.init, in_specs=(P(),)))

    @jax.jit
    @functools.partial(sharded, in_specs=(P(), P(), P()))
    def update(grads, state, p):
        upd, state = opt.update(grads, state, p)
        return optax.apply_updates(p, upd), state

    state, losses = init(params), []
    for _ in range(steps):
        loss, grads = grad_fn(params)
        params, state = update(grads, state, params)
        losses.append(float(loss))
    return losses


# the JAX demo's LlamaConfig, and a wider one (4 layers of 256, 8 heads
# over 2 KV heads, a longer batch)
TRAJECTORY_CASES = {
    "demo": (dict(vocab_size=256, hidden_size=64, intermediate_size=160,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, rms_norm_eps=1e-6), 2, 32),
    "wide": (dict(vocab_size=2000, hidden_size=256, intermediate_size=688,
                  num_hidden_layers=4, num_attention_heads=8,
                  num_key_value_heads=2, rms_norm_eps=1e-5), 4, 128),
}


@pytest.mark.parametrize("case", sorted(TRAJECTORY_CASES))
def test_finetune_trajectory_matches_the_jax_example(case):
    from apex_tpu.models.hf_import import (
        config_from_hf_llama as jax_config_from_hf_llama,
    )

    fields, batch, seq = TRAJECTORY_CASES[case]
    lr, clip = 1e-3, 1.0
    hf = types.SimpleNamespace(max_position_embeddings=seq,
                               rope_theta=10000.0, tie_word_embeddings=False,
                               **fields)
    cfg = config_from_hf_llama(hf)
    if case == "demo":
        assert cfg == finetune_llama.demo_config(seq)
    jcfg = jax_config_from_hf_llama(hf)
    variables = jax.jit(JaxGPT(config=jcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    model = GPTModel(cfg, device="cpu")
    model.load_state_dict(gpt_params_from_jax(_np(variables["params"])),
                          strict=True)
    run = finetune_llama.LlamaFinetune(model, batch, seq, lr=lr, clip=clip,
                                       seed=0)
    got = [run.step()[0] for _ in range(TRAJECTORY_STEPS)]
    want = _jax_finetune_losses(jcfg, variables, run.tokens.numpy(),
                                run.labels.numpy(), TRAJECTORY_STEPS, lr,
                                clip)
    np.testing.assert_allclose(got, want, rtol=TRAJECTORY_RTOL)
    # the objective memorises one batch: the loss falls at every step
    assert all(b < a for a, b in zip(want, want[1:]))
