"""apex_tpu_torch's BERT slice against the JAX package's.

A small BERT (2 layers, hidden 64, 4 heads, vocab 128) is initialised by
the JAX package from a seed; ``bert_params_from_jax`` carries its weights
into the port, so both compute with the same numbers. Inputs (batch 2,
seq 32: tokens, a padding mask of lengths 32 and 21, tokentype ids with
segment 1 from half of each length, labels) come from a seeded numpy RNG.
The JAX model's flash attention runs its Pallas kernel in interpret mode
(``attention_impl="pallas"``), as the JAX package's tests run it on the
CPU. Tolerances: fp32 logits, NSP logits, per-token losses and every
gradient 1e-5 (two layers of fp32 arithmetic summed in another order);
bf16 logits, NSP logits and losses 5e-2 (the Llama tests' bf16
tolerance: activations rounded to bf16 at the same points, accumulated
in another order); the standalone
BERT's losses over three steps 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from apex_tpu.models.bert import BertModel as JaxBert
from apex_tpu.optimizers import fused_adam as jax_fused_adam
from apex_tpu.parallel.pipeline import (
    forward_backward_no_pipelining as jax_fbnp,
)
from apex_tpu.transformer import TransformerConfig as JaxConfig
from apex_tpu.transformer.enums import AttnMaskType as JaxMaskType
from apex_tpu.transformer.layer import ParallelTransformer as JaxStack
from apex_tpu.transformer.testing.arguments import (
    parse_args as jax_parse_args,
)
from apex_tpu_torch.models import (
    BertModel,
    bert_extended_attention_mask,
    bert_params_from_jax,
    gpt_params_from_jax,
    megatron_bert_345m_config,
)
from apex_tpu_torch.parallel.pipeline import forward_backward_no_pipelining
from apex_tpu_torch.transformer import (
    AttnMaskType,
    ParallelTransformer,
    TransformerConfig,
)
from apex_tpu_torch.transformer.testing import (
    global_vars,
    parse_args,
    standalone_bert,
)

TOL = 1e-5
BF16_TOL = 5e-2
B, S, V = 2, 32, 128
SMALL = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
             vocab_size=V, max_position_embeddings=S)


def _dtypes(compute):
    return ((jnp.float32, torch.float32) if compute == "fp32"
            else (jnp.bfloat16, torch.bfloat16))


def _configs(compute="fp32", **extra):
    jd, td = _dtypes(compute)
    return (JaxConfig(compute_dtype=jd, attention_impl="pallas", **SMALL,
                      **extra),
            TransformerConfig(compute_dtype=td, **SMALL, **extra))


def _pair(compute="fp32", add_binary_head=True, **extra):
    """(jax model, jax params, port model in eval mode) with the same
    weights."""
    jcfg, tcfg = _configs(compute, **extra)
    jmodel = JaxBert(config=jcfg, add_binary_head=add_binary_head)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                     jnp.zeros((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    model = BertModel(tcfg, add_binary_head=add_binary_head, device="cpu")
    model.load_state_dict(bert_params_from_jax(params), strict=True)
    return jmodel, variables["params"], model.eval()


@pytest.fixture(scope="module")
def fp32_pair():
    return _pair()


def _inputs(seed=0):
    """tokens, attention_mask (1 = keep), tokentype_ids, labels; numpy."""
    rs = np.random.RandomState(seed)
    tokens = rs.randint(0, V, (B, S)).astype(np.int32)
    lens = np.array([S, 21])
    pos = np.arange(S)[None, :]
    mask = (pos < lens[:, None]).astype(np.int32)
    types = ((pos >= lens[:, None] // 2) & (mask == 1)).astype(np.int32)
    labels = rs.randint(0, V, (B, S)).astype(np.int32)
    return tokens, mask, types, labels


def _t(x):
    return torch.from_numpy(np.asarray(x)).long()


CASES = [(m, t) for m in (False, True) for t in (False, True)]
IDS = ["plain", "tokentypes", "mask", "mask+tokentypes"]


def _args(with_mask, with_types, seed=0):
    tokens, mask, types, labels = _inputs(seed)
    return (tokens, mask if with_mask else None, types if with_types else None,
            labels)


@pytest.mark.parametrize("with_mask,with_types", CASES, ids=IDS)
def test_logits_match_jax(with_mask, with_types, fp32_pair):
    jmodel, params, model = fp32_pair
    tokens, mask, types, _ = _args(with_mask, with_types)
    ref, ref_nsp = jax.jit(jmodel.apply)(
        {"params": params}, jnp.asarray(tokens),
        None if mask is None else jnp.asarray(mask),
        None if types is None else jnp.asarray(types))
    with torch.no_grad():
        out, nsp = model(_t(tokens), None if mask is None else _t(mask),
                         None if types is None else _t(types))
    assert out.dtype == torch.float32 and out.shape == (B, S, V)
    assert nsp.dtype == torch.float32 and nsp.shape == (B, 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(nsp.numpy(), np.asarray(ref_nsp), atol=TOL,
                               rtol=TOL)


def _flat(tree):
    return bert_params_from_jax(jax.tree_util.tree_map(np.asarray, tree))


@pytest.mark.parametrize("with_mask,with_types", CASES, ids=IDS)
def test_losses_and_every_gradient_match_jax(with_mask, with_types,
                                             fp32_pair):
    """Per-token LM losses, and the gradient of every parameter of the
    mean kept-token loss plus the NSP logits' sum (so the pooler and the
    binary head get one too)."""
    jmodel, params, model = fp32_pair
    tokens, mask, types, labels = _args(with_mask, with_types, seed=1)
    keep = np.ones((B, S), np.float32) if mask is None else mask
    keep = keep.astype(np.float32)

    def jloss(p):
        losses, nsp = jmodel.apply(
            {"params": p}, jnp.asarray(tokens),
            None if mask is None else jnp.asarray(mask),
            None if types is None else jnp.asarray(types),
            lm_labels=jnp.asarray(labels))
        total = jnp.sum(losses * keep) / keep.sum() + 0.1 * jnp.sum(nsp)
        return total, losses

    (ref_total, ref_losses), ref_grads = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(params)
    model.zero_grad()
    losses, nsp = model(_t(tokens), None if mask is None else _t(mask),
                        None if types is None else _t(types),
                        lm_labels=_t(labels))
    total = (losses * torch.from_numpy(keep)).sum() / keep.sum() \
        + 0.1 * nsp.sum()
    total.backward()
    np.testing.assert_allclose(losses.detach().numpy(),
                               np.asarray(ref_losses), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(total.item(), float(ref_total), rtol=TOL)
    want = _flat(ref_grads)
    named = dict(model.named_parameters())
    assert set(named) == set(want) and len(named) == 37
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=TOL, rtol=TOL, err_msg=name)


@pytest.mark.parametrize("with_mask", [False, True], ids=["plain", "mask"])
def test_bf16_logits_and_losses_match_jax(with_mask):
    jmodel, params, model = _pair("bf16")
    tokens, mask, types, labels = _args(with_mask, True, seed=2)
    jm = None if mask is None else jnp.asarray(mask)
    apply = jax.jit(jmodel.apply)
    ref, ref_nsp = apply({"params": params}, jnp.asarray(tokens), jm,
                         jnp.asarray(types))
    ref_losses, _ = apply({"params": params}, jnp.asarray(tokens), jm,
                          jnp.asarray(types), jnp.asarray(labels))
    tm = None if mask is None else _t(mask)
    with torch.no_grad():
        out, nsp = model(_t(tokens), tm, _t(types))
        losses, _ = model(_t(tokens), tm, _t(types), lm_labels=_t(labels))
    assert out.dtype == nsp.dtype == losses.dtype == torch.float32
    for got, want in ((out, ref), (nsp, ref_nsp), (losses, ref_losses)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.parametrize("flags", [dict(post_process=False),
                                   dict(add_binary_head=False)],
                         ids=["no-post-process", "no-binary-head"])
def test_stage_flags_match_jax(flags):
    """``post_process=False`` gives the stack's hidden states (no final
    LayerNorm, no heads); no binary head gives None for its logits."""
    jcfg, tcfg = _configs()
    jmodel = JaxBert(config=jcfg, **flags)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(1),
                                     jnp.zeros((1, 8), jnp.int32))
    model = BertModel(tcfg, device="cpu", **flags).eval()
    model.load_state_dict(_flat(variables["params"]), strict=True)
    tokens, mask, types, _ = _inputs(3)
    ref = jmodel.apply(variables, jnp.asarray(tokens), jnp.asarray(mask),
                       jnp.asarray(types))
    with torch.no_grad():
        out = model(_t(tokens), _t(mask), _t(types))
    if flags.get("post_process") is False:
        assert out.shape == (S, B, 64)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL,
                                   rtol=TOL)
    else:
        assert out[1] is None and ref[1] is None
        np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]),
                                   atol=TOL, rtol=TOL)


def test_padding_mask_blocks_attention(fp32_pair):
    """Changing the padded tokens leaves the kept positions' logits as
    they were (JAX's test_padding_mask_blocks_attention)."""
    *_, model = fp32_pair
    tokens, mask, types, _ = _inputs(4)
    mask[:] = 0
    mask[:, :16] = 1
    tokens2 = tokens.copy()
    tokens2[:, 16:] = (tokens2[:, 16:] + 7) % V
    with torch.no_grad():
        a, _ = model(_t(tokens), _t(mask), _t(types))
        b, _ = model(_t(tokens2), _t(mask), _t(types))
    np.testing.assert_allclose(a[:, :16].numpy(), b[:, :16].numpy(),
                               atol=TOL, rtol=TOL)


def test_extended_attention_mask():
    mask = torch.tensor([[1, 1, 0]])
    ext = bert_extended_attention_mask(mask)
    assert ext.shape == (1, 1, 3, 3) and ext.dtype == torch.bool
    want = torch.tensor([[False, False, True], [False, False, True],
                         [True, True, True]])
    assert torch.equal(ext[0, 0], want)


def _stack_pair(causal, **extra):
    """(jax stack, its variables, port stack) with the same weights, fp32;
    the JAX stack attends through the Pallas kernel in interpret mode
    where it takes the flash path."""
    jcfg, tcfg = _configs(**extra)
    jm = JaxMaskType.causal if causal else JaxMaskType.padding
    tm = AttnMaskType.causal if causal else AttnMaskType.padding
    jstack = JaxStack(config=jcfg, attn_mask_type=jm)
    h = jnp.zeros((S, B, 64), jnp.float32)
    variables = jax.jit(jstack.init)(jax.random.PRNGKey(2), h)
    stack = ParallelTransformer(tcfg, attn_mask_type=tm, device="cpu").eval()
    stack.load_state_dict(gpt_params_from_jax(
        jax.tree_util.tree_map(np.asarray, variables["params"])), strict=True)
    return jstack, variables, stack


def _dense_mask(seed):
    """(b, 1, s, s) bool True = masked: a random pattern with every
    query keeping its own key."""
    rs = np.random.RandomState(seed)
    m = rs.rand(B, 1, S, S) < 0.3
    m[:, :, np.arange(S), np.arange(S)] = False
    return m


@pytest.mark.parametrize("extra,causal", [
    ({}, False), ({}, True), ({"num_query_groups": 2}, False),
    ({"num_query_groups": 2, "attention_window": 8}, True),
    ({"apply_query_key_layer_scaling": True}, False)],
    ids=["mha", "mha-causal", "gqa", "gqa-window-causal", "layer-scaling"])
def test_core_attention_matches_jax(extra, causal):
    """A dense attention_mask takes CoreAttention on both sides: MHA and
    GQA (K/V repeated per query head), a causal mask with the padding one
    folded in, a sliding window's lower edge folded into the mask. The
    output and the input's gradient."""
    jstack, variables, stack = _stack_pair(causal, **extra)
    rs = np.random.RandomState(5)
    h = rs.randn(S, B, 64).astype(np.float32)
    mask = _dense_mask(6)
    ct = rs.randn(S, B, 64).astype(np.float32)

    def f(x):
        return jnp.sum(jstack.apply(variables, x,
                                    attention_mask=jnp.asarray(mask)) * ct)

    ref_out = jstack.apply(variables, jnp.asarray(h),
                           attention_mask=jnp.asarray(mask))
    ref_dh = jax.grad(f)(jnp.asarray(h))
    x = torch.from_numpy(h).requires_grad_(True)
    out = stack(x, attention_mask=torch.from_numpy(mask))
    (out * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_dh), atol=TOL,
                               rtol=TOL)


def test_key_padding_through_flash_equals_the_dense_mask_path():
    """The (b, s) key-padding row through the flash path equals the same
    mask expressed densely through CoreAttention, at every position, on
    the port's own modules (JAX's
    test_kpm_fast_path_matches_dense_mask_path)."""
    *_, stack = _stack_pair(False)
    h = torch.from_numpy(np.random.RandomState(7).randn(S, B, 64)
                         .astype(np.float32))
    kpm = torch.zeros(B, S, dtype=torch.bool)
    kpm[0, 11:] = True
    with torch.no_grad():
        fast = stack(h, kpm)
        dense = stack(h, attention_mask=kpm[:, None, None, :])
    np.testing.assert_allclose(fast.numpy(), dense.numpy(), atol=2e-5)


def test_forward_backward_no_pipelining_matches_jax(fp32_pair):
    """Two micro-batches: the mean loss, each micro-batch's loss and the
    averaged gradients, against the JAX schedule; grad_sync_fn runs once."""
    jmodel, params, model = fp32_pair
    rs = np.random.RandomState(8)
    toks = rs.randint(0, V, (2, B, S)).astype(np.int32)
    labs = rs.randint(0, V, (2, B, S)).astype(np.int32)

    def jfwd(p, batch):
        t, l = batch
        losses, _ = jmodel.apply({"params": p}, t, lm_labels=l)
        return jnp.mean(losses)

    ref_loss, ref_losses, ref_grads = jax.jit(
        lambda p, b: jax_fbnp(jfwd, p, b))(
        params, (jnp.asarray(toks), jnp.asarray(labs)))
    synced = []

    def sync(g):
        synced.append(len(g))
        return g

    def fwd(_, batch):
        t, l = batch
        return model(t, lm_labels=l)[0].mean()

    loss, losses, grads = forward_backward_no_pipelining(
        fwd, dict(model.named_parameters()), (_t(toks), _t(labs)),
        grad_sync_fn=sync)
    assert synced == [37] and losses.shape == (2,)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=TOL)
    np.testing.assert_allclose(losses.numpy(), np.asarray(ref_losses),
                               rtol=TOL)
    want = _flat(ref_grads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=TOL,
                                   rtol=TOL, err_msg=name)
    # the binary head is outside the LM loss: zeros on both sides
    assert not grads["binary_head.kernel"].any()


BERT_ARGV = ("--num-layers 2 --hidden-size 64 --num-attention-heads 4 "
             "--seq-length 32 --max-position-embeddings 32 "
             "--micro-batch-size 2 --global-batch-size 4 --train-iters 3 "
             "--lr 1e-3").split()


def test_three_standalone_bert_steps_match_jax():
    """Three steps of the standalone BERT's step function against JAX's
    composition (``model.apply``, ``forward_backward_no_pipelining``,
    ``fused_adam``, ``optax.apply_updates``) on the same numpy batches and
    weights: the losses to 1e-5 relative, then every parameter to 1e-5."""
    args = parse_args(args=BERT_ARGV)
    args.padded_vocab_size = V
    run = standalone_bert.BertPretraining(args, device="cpu")
    cfg = run.config
    assert cfg.hidden_dropout == 0.0 and cfg.vocab_size == V
    jmodel = JaxBert(config=JaxConfig(
        compute_dtype=jnp.float32, attention_impl="pallas", hidden_dropout=0.0,
        attention_dropout=0.0, **SMALL))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(3),
                                  jnp.zeros((1, 8), jnp.int32))["params"]
    run.model.load_state_dict(_flat(params), strict=True)
    opt = jax_fused_adam(lr=1e-3, betas=(args.adam_beta1, args.adam_beta2),
                         eps=args.adam_eps, weight_decay=args.weight_decay)
    opt_state = opt.init(params)

    def fwd(p, batch):
        t, l = batch
        losses, _ = jmodel.apply({"params": p}, t, lm_labels=l)
        return jnp.mean(losses)

    @jax.jit
    def jstep(p, s, batch):
        loss, _, grads = jax_fbnp(fwd, p, batch)
        updates, s = opt.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss

    rs = np.random.RandomState(9)
    got, want = [], []
    for _ in range(3):
        toks = rs.randint(0, V, (2, 2, S)).astype(np.int32)
        labs = rs.randint(0, V, (2, 2, S)).astype(np.int32)
        params, opt_state, loss = jstep(
            params, opt_state, (jnp.asarray(toks), jnp.asarray(labs)))
        want.append(float(loss))
        loss, run.opt_state, _ = standalone_bert.bert_train_step(
            run.model, run.opt, run.opt_state, _t(toks), _t(labs))
        got.append(loss.item())
    np.testing.assert_allclose(got, want, rtol=TOL)
    # the optimizer's updates too: every parameter after the three steps.
    # The key bias's gradient is 0 in exact arithmetic (it adds one
    # constant to all of a query's scores), so each side holds rounding
    # noise there, which Adam's normalised step turns into up to lr a
    # step: those elements are held to 3 steps of 2 lr, the rest to 1e-5.
    after = _flat(params)
    for name, p in run.model.named_parameters():
        got, want = p.detach().numpy(), after[name].numpy()
        if name.endswith("query_key_value.bias"):
            key = np.zeros_like(got, bool).reshape(
                SMALL["num_attention_heads"], 3, -1)
            key[:, 1] = True
            key = key.reshape(-1)
            np.testing.assert_array_less(np.abs(got - want)[key], 6e-3)
            got, want = got[~key], want[~key]
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL,
                                   err_msg=name)


def test_run_bert_on_the_cpu():
    args = parse_args(args=BERT_ARGV)
    lines = []
    global_vars.set_args(args)
    try:
        losses = standalone_bert.run_bert(log=lines.append, device="cpu")
    finally:
        global_vars.set_args(None)
    assert len(losses) == 3 and np.isfinite(losses).all()
    # the default vocabulary is --make-vocab-size-divisible-by's 128
    assert abs(losses[0] - np.log(128)) < 1.0
    assert lines[0].startswith("iteration    0 | lm loss ")


def test_parse_args_matches_jax_on_the_ported_flags():
    """Every field the port's parse gives equals the JAX package's on the
    same launch line (the dtype by name), but the world: JAX's is its
    device count, the port's one process."""
    argv = BERT_ARGV + ["--bf16", "--bert-no-binary-head", "--seed", "7",
                        "--weight-decay", "0.1", "--adam-eps", "1e-6"]
    ours, theirs = parse_args(args=argv), jax_parse_args(args=argv)
    for key, value in vars(ours).items():
        if key in ("world_size", "data_parallel_size"):
            continue
        if key == "params_dtype":
            assert str(value)[6:] == jnp.dtype(theirs.params_dtype).name
        else:
            assert value == getattr(theirs, key), key


@pytest.mark.parametrize("flag", ["--recompute-activations", "--kv-channels",
                                  "--fp32-residual-connection", "--clip-grad"])
def test_parse_args_refuses_flags_it_would_not_honour(flag):
    argv = BERT_ARGV + [flag] + ([] if "activations" in flag
                                or "residual" in flag else ["8"])
    with pytest.raises(SystemExit):
        parse_args(args=argv)
    parse_args(args=argv, ignore_unknown_args=True)


@pytest.mark.parametrize("flag", ["--tensor-model-parallel-size",
                                  "--pipeline-model-parallel-size"])
def test_run_bert_refuses_model_parallelism(flag):
    """Pipelined BERT raises JAX's refusal; tensor parallelism is ported
    (tests/test_torch_bert_tp.py holds it to JAX) and trains here in a
    world of 2 gloo ranks: finite losses, equal on both ranks, the first
    near ln(128)."""
    if flag == "--pipeline-model-parallel-size":
        args = parse_args(args=BERT_ARGV + [flag, "2"])
        with pytest.raises(NotImplementedError, match="dp x tp"):
            standalone_bert.run_bert(args, log=lambda _: None, device="cpu")
        return
    from apex_tpu_torch.transformer.testing.distributed_test_base import (
        jobs_worker,
        spawn,
    )

    ranks = spawn(jobs_worker, 2, args=([
        ("apex_tpu_torch.transformer.testing.tp_workers:run_bert_worker",
         (BERT_ARGV + [flag, "2"],))],), timeout=180.0)
    losses = [r[0]["losses"] for r in ranks]
    assert ranks[0][0]["tp"] == 2 and losses[0] == losses[1]
    assert len(losses[0]) == 3 and np.isfinite(losses[0]).all()
    assert abs(losses[0][0] - np.log(128)) < 1.0


def test_tokentype_refusals():
    _, tcfg = _configs()
    tokens = torch.zeros(1, 8, dtype=torch.long)
    no_table = BertModel(tcfg, num_tokentypes=0, device="cpu").eval()
    with pytest.raises(ValueError, match="num_tokentypes == 0"):
        no_table(tokens, tokentype_ids=tokens)
    no_table(tokens)  # no table, no ids
    # a table without ids: BertModel defaults them to segment 0, the
    # embedding alone refuses
    table = BertModel(tcfg, device="cpu").eval()
    table(tokens)
    with pytest.raises(ValueError, match="no tokentype_ids"):
        table.embedding(tokens)


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _configs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BertModel(tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        standalone_bert.run_bert(parse_args(args=BERT_ARGV))


def test_megatron_bert_345m_shapes():
    cfg = megatron_bert_345m_config(num_layers=1)
    assert (cfg.hidden_size, cfg.num_attention_heads, cfg.kv_channels,
            cfg.ffn_hidden_size, cfg.vocab_size,
            cfg.max_position_embeddings) == (1024, 16, 64, 4096, 30592, 512)
    assert cfg.hidden_dropout == cfg.attention_dropout == 0.1
    model = BertModel(cfg, device="cpu")
    per_layer = 12 * 1024 * 1024 + 13 * 1024
    n = sum(p.numel() for p in model.parameters())
    # the full depth: 336,267,266 parameters in 301 tensors
    assert n + 23 * per_layer == 336_267_266
    assert len(list(model.parameters())) + 23 * 12 == 301
