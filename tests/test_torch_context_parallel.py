"""apex_tpu_torch's context parallelism against the JAX package: ring and
Ulysses attention, the zigzag layout, ``cp_decode_attention``, GPT with
its sequence split over cp (and over cp x tp), KV-cache decode over cp,
the dropout masks over cp, and the ported ``train_ring_cp`` example.

The port runs in one spawned world of 4 gloo ranks on the CPU; the JAX
functions run under ``shard_map`` on the 8-device CPU mesh (device r of
the first cp x tp is port rank r). At cp = 2 the world's two dp replicas
run the same inputs. Each JAX reference is computed once for the module;
inputs come from a seeded numpy RNG, GPT weights from JAX's
initializers. The cases mirror ``tests/test_context_parallel.py``:

- ring attention at cp 2 and 4, causal and not; zigzag (with a window
  of 12, and with GQA and key padding); windows of 3, 12 and 100; GQA
  (2 and 1 KV heads) x key padding x (non-causal, causal, window 12),
  whose last chunk is padded in every row (a skipped chunk);
  ``block_size`` 2, 4 and 8; Ulysses at cp 4, causal and not, with a
  window of 8, and at cp 2 with GQA and key padding: the output at rtol
  2e-4, atol 2e-5, and dq, dk, dv of ``sum(o * ct)`` at atol 1e-4 (as
  the JAX tests hold them against single-device attention), each rank's
  chunk against the JAX function's on the same device;
- the refusals of indivisible heads (ring, and Ulysses' head count
  below cp): the JAX message;
- ``zigzag_shard``/``zigzag_unshard`` bit-equal to JAX's, and the round
  trip;
- ``cp_decode_attention`` at cp 2 and 4, GQA, one shard fully padded:
  rtol 2e-4, atol 2e-5;
- GPT (2 layers, hidden 32, 4 heads, vocab 64, seq 32, fp32) at cp = 4,
  rope and learned positions through the ring, rope through Ulysses:
  per-token losses against JAX's single-device model at rtol 2e-4, atol
  2e-5 (JAX's ``TestGPTWithCP``);
- CP decode (JAX's ``TestCPDecode``): a 16-token sequence, the first 8
  prefilled over cp = 4, 8 teacher-forced decode steps: the logits
  against JAX's single-device uncached forward at rtol 2e-4, atol 2e-4;
  a decode step whose rows sit at different positions is refused;
- cp 2 x tp 2, GQA through the ring, sequence parallelism off and on:
  the per-token losses against JAX's tp-only run on the same mesh (what
  JAX's ``TestCPComposition`` holds its cp run to) and against JAX's cp
  x tp run, rtol 2e-4, atol 2e-5;
- dropout over cp: the masks differ across the 4 ranks while their
  shared generator stays in step; without cp the generator comes back
  unchanged; in eval the module is the identity;
- ``train_ring_cp`` at the JAX example's defaults (cp 4, 10 steps) from
  the JAX example's initial weights: every step's loss within 1e-5
  relative of the JAX example's step (its ``train_step``, repeated here
  at full precision; the example's own printed losses agree to the 4
  decimals it prints);
- the card phase's runner (``cp_card_worker``, which ``chip_smoke.py``
  runs on the card) at a tiny TinyLlama-shaped config on the CPU: ring
  and Ulysses training steps give finite losses, the same parameters on
  every rank and the same losses in both modes (1e-5); one step at cp = 4
  against cp = 1 from the same weights gives the per-token losses (rtol
  2e-4, atol 2e-5) and every gradient (1e-4 relative in norm); decode
  over cp gives the cp = 1 logits (rtol 2e-4, atol 2e-4).
"""

import contextlib
import functools
import importlib
import importlib.util
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from apex_tpu.compat import shard_map
from apex_tpu.models import GPTModel as JaxGPT
from apex_tpu.optimizers import fused_adam as jax_fused_adam
from apex_tpu.parallel import parallel_state as jps
from apex_tpu.parallel.ddp import all_reduce_gradients as jax_all_reduce
from apex_tpu.transformer import TransformerConfig as JaxConfig
from apex_tpu_torch.models import gpt_params_from_jax, gpt_tp_params_from_jax
from apex_tpu_torch.parallel.ring_attention import (
    zigzag_shard,
    zigzag_unshard,
)
from apex_tpu_torch.transformer.testing.cp_workers import jobs_worker
from apex_tpu_torch.transformer.testing.distributed_test_base import spawn

# the module: the package's ``ring_attention`` attribute is the function
jra = importlib.import_module("apex_tpu.parallel.ring_attention")

WORLD = 4
B, H, D, SEQ = 2, 4, 8, 32
SEQ_SPEC = P(None, None, "cp", None)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mesh(cp, tp=1):
    return jps.initialize_model_parallel(
        tensor_model_parallel_size=tp, context_parallel_size=cp,
        devices=jax.devices()[:cp * tp])


def _kpm():
    """The JAX tests' mask: the last chunk at cp = 4 (keys 24-31) padded
    in every row, and row 0 from key 20."""
    kpm = np.zeros((B, SEQ), bool)
    kpm[:, 24:] = True
    kpm[0, 20:] = True
    return kpm


# -- attention: cases and the JAX side --------------------------------------

def _attention_cases(rs):
    def arr(*shape):
        return rs.randn(*shape).astype(np.float32)

    q, ct = arr(B, H, SEQ, D), arr(B, H, SEQ, D)
    kv = {h: (arr(B, h, SEQ, D), arr(B, h, SEQ, D)) for h in (4, 2, 1)}
    cases = []

    def add(name, fn, cp, h_kv=4, kpm=None, zigzag=False, **kw):
        k, v = kv[h_kv]
        cases.append(dict(name=name, fn=fn, cp=cp, q=q, k=k, v=v, ct=ct,
                          kpm=kpm, zigzag=zigzag,
                          kwargs=dict(kw, zigzag=True) if zigzag else kw))

    for cp in (2, 4):
        for causal in (False, True):
            add(f"ring cp{cp} causal={causal}", "ring", cp, causal=causal)
    add("ring zigzag", "ring", 4, zigzag=True, causal=True, block_size=8)
    add("ring zigzag window 12", "ring", 4, zigzag=True, causal=True,
        window=12, block_size=8)
    add("ring zigzag gqa kpm", "ring", 4, h_kv=2, kpm=_kpm(), zigzag=True,
        causal=True, block_size=8)
    for w in (3, 12, 100):
        add(f"ring window {w}", "ring", 4, causal=True, window=w)
    for h_kv in (2, 1):
        for causal, w in ((False, None), (True, None), (True, 12)):
            add(f"ring gqa{h_kv} kpm causal={causal} window={w}", "ring", 4,
                h_kv=h_kv, kpm=_kpm(), causal=causal, window=w,
                block_size=8)
    for bs in (2, 4, 8):
        add(f"ring block_size {bs}", "ring", 4, causal=True, block_size=bs)
    for causal in (False, True):
        add(f"ulysses cp4 causal={causal}", "ulysses", 4, causal=causal)
    add("ulysses window 8", "ulysses", 4, causal=True, window=8)
    add("ulysses cp2 gqa kpm", "ulysses", 2, h_kv=2,
        kpm=np.zeros((B, SEQ), bool) | (np.arange(SEQ) >= 20)[None]
        * (np.arange(B) == 0)[:, None], causal=True)
    # refusals
    cases.append(dict(name="ring refuses kv heads 3", fn="ring", cp=4,
                      q=q, k=arr(B, 3, SEQ, D), v=arr(B, 3, SEQ, D), ct=ct,
                      kpm=None, zigzag=False, kwargs={}))
    cases.append(dict(name="ulysses refuses heads 2 at cp 4", fn="ulysses",
                      cp=4, q=arr(B, 2, SEQ, D), k=arr(B, 2, SEQ, D),
                      v=arr(B, 2, SEQ, D), ct=arr(B, 2, SEQ, D), kpm=None,
                      zigzag=False, kwargs={}))
    for cp in (2, 4):
        pad = rs.rand(B, 16) < 0.3
        pad[:, :16 // cp] = True  # rank 0's shard holds no valid key
        pad[:, -1] = False
        cases.append(dict(name=f"cp_decode cp{cp}", fn="decode", cp=cp,
                          q=arr(B, H, 1, D), k=arr(B, 2, 16, D),
                          v=arr(B, 2, 16, D), padded=pad, kwargs={}))
    return cases


def _jax_attention(c):
    """The JAX function's output (and gradients of sum(o * ct)) on the
    global arrays, or its error message."""
    mesh = _mesh(c["cp"])
    try:
        if c["fn"] == "decode":
            f = shard_map(
                lambda q, k, v, pad: jra.cp_decode_attention(
                    q, k, v, pad, axis_name="cp"),
                mesh=mesh, in_specs=(P(), SEQ_SPEC, SEQ_SPEC, P(None, "cp")),
                out_specs=P(), check_vma=False)
            return {"o": np.asarray(jax.jit(f)(c["q"], c["k"], c["v"],
                                               c["padded"]))}
        fn = jra.ring_attention if c["fn"] == "ring" else \
            jra.ulysses_attention
        has_kpm = c["kpm"] is not None

        def run(q, k, v, ct, kpm):
            def attend(q, k, v):
                return fn(q, k, v, axis_name="cp",
                          key_padding_mask=kpm if has_kpm else None,
                          **c["kwargs"])

            o, pull = jax.vjp(attend, q, k, v)
            return (o, *pull(ct))

        f = shard_map(run, mesh=mesh,
                      in_specs=(SEQ_SPEC,) * 4 + (P(None, "cp"),),
                      out_specs=(SEQ_SPEC,) * 4, check_vma=False)
        arrays = [c[n] for n in ("q", "k", "v", "ct")]
        kpm = c["kpm"] if has_kpm else np.zeros((B, SEQ), bool)
        if c["zigzag"]:
            arrays = [np.asarray(jra.zigzag_shard(a, c["cp"]))
                      for a in arrays]
            kpm = np.asarray(jra.zigzag_shard(kpm, c["cp"], axis=-1))
        try:
            out = jax.jit(f)(*arrays, kpm)
        except (ValueError, AssertionError) as e:
            return {"error": str(e)}
        out = [np.asarray(a) for a in out]
        if c["zigzag"]:
            out = [np.asarray(jra.zigzag_unshard(a, c["cp"])) for a in out]
        return dict(zip(("o", "dq", "dk", "dv"), out))
    finally:
        jps.destroy_model_parallel()


def _port_attention(c):
    """The zigzag cases run on zigzag-sharded inputs (the port's own
    ``zigzag_shard``); returns the case as the worker takes it."""
    if not c.get("zigzag"):
        return c
    out = dict(c)
    for n in ("q", "k", "v", "ct"):
        out[n] = zigzag_shard(torch.from_numpy(c[n]), c["cp"]).numpy()
    if c["kpm"] is not None:
        out["kpm"] = zigzag_shard(torch.from_numpy(c["kpm"]), c["cp"],
                                  axis=-1).numpy()
    return out


def _assemble(ports, job, name, field, cp):
    """The global array of ``field`` from the cp ranks of dp replica 0."""
    by_rank = {ports[r][job][name]["cp_rank"]: ports[r][job][name][field]
               for r in range(cp)}
    return np.concatenate([by_rank[i] for i in range(cp)], axis=2)


# -- GPT: the JAX side --------------------------------------------------------

def _gpt_cfg(mode=None, **kw):
    base = dict(num_layers=2, hidden_size=32, num_attention_heads=4,
                vocab_size=64, max_position_embeddings=SEQ,
                hidden_dropout=0.0, attention_dropout=0.0,
                context_parallel_mode=mode)
    base.update(kw)
    return base


def _port_cfg(fields):
    return dict(fields, compute_dtype=torch.float32)


def _np_params(tree):
    return {k: v.numpy() for k, v in gpt_params_from_jax(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


def _gpt_single(rs):
    """GPT at cp = 4 (ring rope and learned, Ulysses rope): cases and
    JAX's single-device losses."""
    tokens = rs.randint(0, 64, (B, SEQ)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    cases, refs = [], {}
    for mode, pos in (("ring", "rope"), ("ring", "learned"),
                      ("ulysses", "rope")):
        fields = _gpt_cfg(position_embedding_type=pos)
        model = JaxGPT(config=JaxConfig(compute_dtype=jnp.float32, **fields))
        params = model.init(jax.random.PRNGKey(1), tokens)
        name = f"gpt cp4 {mode} {pos}"
        refs[name] = np.asarray(model.apply(params, tokens, labels=labels))
        cases.append(dict(name=name, cp=4, tokens=tokens, labels=labels,
                          params=_np_params(params["params"]),
                          config=_port_cfg(dict(
                              fields, context_parallel_mode=mode))))
    return cases, refs


def _gpt_decode(rs):
    """JAX's TestCPDecode: the single-device uncached logits."""
    total = 16
    fields = _gpt_cfg(position_embedding_type="rope",
                      max_position_embeddings=total)
    tokens = rs.randint(0, 64, (B, total)).astype(np.int32)
    model = JaxGPT(config=JaxConfig(compute_dtype=jnp.float32, **fields))
    params = model.init(jax.random.PRNGKey(1), tokens)
    full = np.asarray(model.apply(params, tokens))
    args = (4, _port_cfg(dict(fields, context_parallel_mode="ring")),
            _np_params(params["params"]), tokens, 8)
    return args, full


def _gpt_cp_tp(rs):
    """cp 2 x tp 2 (GQA, SP off and on): JAX's init on the mesh, its
    tp-only losses and its cp x tp losses."""
    tokens = rs.randint(0, 64, (4, SEQ)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    cases, refs = [], {}
    for sp in (False, True):
        fields = _gpt_cfg(num_query_groups=2, sequence_parallel=sp)
        mesh = _mesh(cp=2, tp=2)
        try:
            cp_model = JaxGPT(config=JaxConfig(
                compute_dtype=jnp.float32,
                **dict(fields, context_parallel_mode="ring")))
            tp_model = JaxGPT(config=JaxConfig(compute_dtype=jnp.float32,
                                               **fields))
            init = shard_map(
                lambda t: cp_model.init(jax.random.PRNGKey(1), t),
                mesh=mesh, in_specs=P(), out_specs=P(), check_vma=False)
            params = jax.jit(init)(tokens[:1, :SEQ // 2])
            run_cp = shard_map(
                lambda p, t, lab: cp_model.apply(p, t, labels=lab),
                mesh=mesh, in_specs=(P(), P(None, "cp"), P(None, "cp")),
                out_specs=P(None, "cp"), check_vma=False)
            run_tp = shard_map(
                lambda p, t, lab: tp_model.apply(p, t, labels=lab),
                mesh=mesh, in_specs=(P(), P(), P()), out_specs=P(),
                check_vma=False)
            name = f"gpt cp2 tp2 sp={sp}"
            refs[name] = (np.asarray(jax.jit(run_tp)(params, tokens, labels)),
                          np.asarray(jax.jit(run_cp)(params, tokens,
                                                     labels)))
            by_rank = [{k: v.numpy() for k, v in gpt_tp_params_from_jax(
                params["params"], r).items()} for r in range(WORLD)]
        finally:
            jps.destroy_model_parallel()
        cases.append(dict(name=name, cp=2, tp=2, tokens=tokens,
                          labels=labels, params=by_rank,
                          config=_port_cfg(dict(
                              fields, context_parallel_mode="ring"))))
    return cases, refs


# -- train_ring_cp: the JAX side ---------------------------------------------

# the card phase's jobs at a tiny size (chip_smoke.py's llama_cp_phase)
CARD_CONFIG = dict(num_layers=2, hidden_size=64, num_attention_heads=8,
                   num_query_groups=4, ffn_hidden_size=96, vocab_size=128,
                   max_position_embeddings=64, hidden_dropout=0.0,
                   attention_dropout=0.0, normalization="rmsnorm",
                   activation="swiglu", add_bias_linear=False,
                   position_embedding_type="rope",
                   share_embeddings_and_output_weights=False,
                   compute_dtype=torch.float32)
CARD_BATCH = dict(batch=2, seq_len=64, vocab=128, doc_len_min=32, seed=0)
CARD_JOBS = (
    [dict(kind="train", cp=4, steps=2, batch=CARD_BATCH,
          config=dict(CARD_CONFIG, context_parallel_mode=m))
     for m in ("ring", "ulysses")]
    + [dict(kind="vs_single", cp=4, batch=CARD_BATCH,
            config=dict(CARD_CONFIG, context_parallel_mode=m))
       for m in ("ring", "ulysses")]
    + [dict(kind="decode", cp=4, batch=CARD_BATCH, prompt=32, total=40,
            config=dict(CARD_CONFIG, context_parallel_mode="ring"))])

EXAMPLE = dict(cp=4, vocab=256, seq_len=256, layers=2, hidden=64, heads=8,
               kv_heads=2, batch=4, doc_len_min=128, lr=1e-3, steps=10,
               seed=0)


def _jax_train_ring_cp():
    """The JAX example's ``train_step`` (examples/long_context/
    train_ring_cp.py, its code repeated here so that the losses come out
    at full precision): its initial parameters and 10 losses; then the
    example's ``main`` itself, whose printed losses (4 decimals) the
    full-precision ones must round to."""
    a = EXAMPLE
    mesh = jps.initialize_model_parallel(
        context_parallel_size=a["cp"], devices=jax.devices()[:a["cp"]])
    try:
        cfg = JaxConfig(
            num_layers=a["layers"], hidden_size=a["hidden"],
            num_attention_heads=a["heads"], num_query_groups=a["kv_heads"],
            vocab_size=a["vocab"], max_position_embeddings=a["seq_len"],
            hidden_dropout=0.0, attention_dropout=0.0,
            compute_dtype=jnp.float32, context_parallel_mode="ring")
        model = JaxGPT(config=cfg)
        opt = jax_fused_adam(lr=a["lr"])
        rng = np.random.RandomState(a["seed"])
        base = np.cumsum(rng.randint(1, 5, size=(a["batch"], a["seq_len"])),
                         axis=1) % a["vocab"]
        doc_len = rng.randint(a["doc_len_min"], a["seq_len"] + 1,
                              size=(a["batch"],))
        kpm_np = np.arange(a["seq_len"])[None, :] >= doc_len[:, None]
        tokens = jnp.asarray(base, jnp.int32)
        labels = jnp.roll(tokens, -1, axis=1)
        kpm = jnp.asarray(kpm_np)
        loss_mask = (~kpm).astype(jnp.float32)
        seq_sharded = P(None, "cp")

        @jax.jit
        @functools.partial(
            shard_map, mesh=mesh,
            in_specs=(P(), P(), seq_sharded, seq_sharded, seq_sharded,
                      seq_sharded),
            out_specs=(P(), P(), P()), check_vma=False)
        def train_step(params, opt_state, tokens, labels, kpm, loss_mask):
            n = jax.lax.psum(jnp.sum(loss_mask), "cp")

            def loss_fn(p):
                losses = model.apply(p, tokens, labels=labels,
                                     key_padding_mask=kpm,
                                     loss_mask=loss_mask)
                return jnp.sum(losses) / jnp.maximum(n, 1.0)

            loss_local, grads = jax.value_and_grad(loss_fn)(params)
            grads = jax_all_reduce(grads, "cp", gradient_average=False)
            loss = jax.lax.psum(loss_local, "cp")
            updates, opt_state = opt.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), opt_state, loss

        @jax.jit
        @functools.partial(shard_map, mesh=mesh, in_specs=(seq_sharded,),
                           out_specs=P(), check_vma=False)
        def init_params(tokens):
            return model.init(jax.random.PRNGKey(a["seed"]), tokens)

        params = init_params(tokens)
        initial = _np_params(params["params"])
        opt_state = jax.jit(opt.init)(params)
        losses = []
        for _ in range(a["steps"]):
            params, opt_state, loss = train_step(params, opt_state, tokens,
                                                 labels, kpm, loss_mask)
            losses.append(float(loss))
    finally:
        jps.destroy_model_parallel()
    spec = importlib.util.spec_from_file_location(
        "jax_train_ring_cp",
        os.path.join(REPO, "examples", "long_context", "train_ring_cp.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    out = io.StringIO()
    argv = ["train_ring_cp.py", "--steps", str(a["steps"]), "--cp",
            str(a["cp"])]
    with contextlib.redirect_stdout(out), \
            pytest.MonkeyPatch.context() as mp:
        mp.setattr("sys.argv", argv)
        example.main()
    jps.destroy_model_parallel()
    printed = [float(line.split()[3]) for line in out.getvalue().splitlines()
               if line.startswith("step ")]
    return initial, losses, printed


# -- the module's one world ---------------------------------------------------

@pytest.fixture(scope="module")
def both():
    rs = np.random.RandomState(0)
    att = _attention_cases(rs)
    refs = {"attention": {c["name"]: _jax_attention(c) for c in att}}
    gpt, refs["gpt"] = _gpt_single(rs)
    decode_args, refs["decode"] = _gpt_decode(rs)
    cp_tp, refs["cp_tp"] = _gpt_cp_tp(rs)
    initial, losses, printed = _jax_train_ring_cp()
    refs["train"] = (losses, printed)
    argv = ["--device", "cpu"] + [
        x for k in ("cp", "steps", "seed") for x in
        (f"--{k}", str(EXAMPLE[k]))]
    ports = spawn(jobs_worker, WORLD, args=([
        ("attention_worker", ([_port_attention(c) for c in att],)),
        ("gpt_cp_worker", (gpt + cp_tp,)),
        ("cp_decode_worker", decode_args),
        ("dropout_worker", (4,)),
        ("train_ring_cp_worker", (argv, initial)),
        ("cp_card_worker", (CARD_JOBS, "cpu"))],), timeout=300.0)
    return att, refs, ports


ATTENTION = [c["name"] for c in _attention_cases(np.random.RandomState(0))]


@pytest.mark.parametrize("name", ATTENTION)
def test_attention_matches_jax(both, name):
    att, refs, ports = both
    case = next(c for c in att if c["name"] == name)
    want = refs["attention"][name]
    if "error" in want:
        for r in range(WORLD):
            assert ports[r][0][name] == {"cp_rank": ports[r][0][name][
                "cp_rank"], "error": want["error"]}
        return
    cp = case["cp"]
    if case["fn"] == "decode":
        for r in range(WORLD):
            np.testing.assert_allclose(ports[r][0][name]["o"], want["o"],
                                       rtol=2e-4, atol=2e-5)
        return
    got = {f: _assemble(ports, 0, name, f, cp)
           for f in ("o", "dq", "dk", "dv")}
    if case.get("zigzag"):
        got = {f: zigzag_unshard(torch.from_numpy(a), cp).numpy()
               for f, a in got.items()}
    np.testing.assert_allclose(got["o"], want["o"], rtol=2e-4, atol=2e-5)
    for f in ("dq", "dk", "dv"):
        np.testing.assert_allclose(got[f], want[f], atol=1e-4, err_msg=f)


def test_zigzag_shard_and_unshard_match_jax():
    x = np.random.RandomState(3).randn(B, H, SEQ, D).astype(np.float32)
    t = torch.from_numpy(x)
    for cp in (2, 4, 8):
        z = zigzag_shard(t, cp)
        np.testing.assert_array_equal(z.numpy(),
                                      np.asarray(jra.zigzag_shard(x, cp)))
        np.testing.assert_array_equal(zigzag_unshard(z, cp).numpy(), x)
        m = torch.from_numpy(_kpm())
        np.testing.assert_array_equal(
            zigzag_shard(m, cp, axis=-1).numpy(),
            np.asarray(jra.zigzag_shard(_kpm(), cp, axis=-1)))
    with pytest.raises(ValueError, match="not divisible by 2"):
        zigzag_shard(torch.zeros(1, 1, 12, 1), 4)


def _gpt_losses(ports, name, cp, tp=1):
    """The global (b, s) losses from the tp rank 0 of each cp rank."""
    by_cp = {}
    for r in range(WORLD):
        out = ports[r][1][name]
        if out["tp_rank"] == 0 and r < cp * tp:
            by_cp[out["cp_rank"]] = out["losses"]
    return np.concatenate([by_cp[i] for i in range(cp)], axis=1)


@pytest.mark.parametrize("name", ["gpt cp4 ring rope", "gpt cp4 ring learned",
                                  "gpt cp4 ulysses rope"])
def test_gpt_at_cp4_matches_jax_single_device(both, name):
    _, refs, ports = both
    np.testing.assert_allclose(_gpt_losses(ports, name, 4), refs["gpt"][name],
                               rtol=2e-4, atol=2e-5)


def test_cp_decode_matches_jax_single_device(both):
    _, refs, ports = both
    full = refs["decode"]
    for r in range(WORLD):
        got = ports[r][2]["decoded"]
        assert got.shape == (B, 8, 64)
        np.testing.assert_allclose(got, full[:, 8:], rtol=2e-4, atol=2e-4,
                                   err_msg=f"rank {r}")
        # JAX's cache index is one number: rows apart are refused
        assert "one position for every row" in ports[r][2]["refusal"]


@pytest.mark.parametrize("sp", [False, True])
def test_gpt_cp2_tp2_matches_jax(both, sp):
    _, refs, ports = both
    name = f"gpt cp2 tp2 sp={sp}"
    tp_only, jax_cp = refs["cp_tp"][name]
    got = _gpt_losses(ports, name, 2, 2)
    np.testing.assert_allclose(got, tp_only, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got, jax_cp, rtol=2e-4, atol=2e-5)
    for r in range(WORLD):  # both tp ranks of a cp rank hold its losses
        partner = r ^ 1
        np.testing.assert_allclose(ports[r][1][name]["losses"],
                                   ports[partner][1][name]["losses"],
                                   rtol=1e-6, atol=1e-7)


def test_dropout_masks_differ_across_cp_ranks(both):
    _, _, ports = both
    masks = [ports[r][3][4]["y"] != 0 for r in range(WORLD)]
    assert not all(np.array_equal(masks[0], m) for m in masks[1:]), \
        "cp ranks drew identical dropout masks"
    for r in range(WORLD):
        out = ports[r][3]
        assert out[4]["same"] is False and out[1]["same"] is True
        assert out[4]["next_draw"] == ports[0][3][4]["next_draw"]
        np.testing.assert_array_equal(out[4]["y"][masks[r]], 2.0)


def test_dropout_folds_the_cp_rank_once_a_module(both):
    _, _, ports = both
    for r in range(WORLD):
        out = ports[r][3][4]
        # successive calls draw new masks from the folded generator, and
        # the shared generator moved by one fold for both calls
        assert not np.array_equal(out["y"], out["y2"])
        assert out["next_draw"] == out["one_fold"]
        assert ports[r][3][1]["next_draw"] != ports[r][3][1]["one_fold"]


def test_dropout_is_the_identity_without_axes_or_in_eval(both):
    _, _, ports = both
    for r in range(WORLD):
        out = ports[r][3]
        # without cp every rank draws the one mask
        np.testing.assert_array_equal(out[1]["y"], ports[0][3][1]["y"])
        for size in (4, 1):
            np.testing.assert_array_equal(out[size]["eval"],
                                          np.ones((4, 64), np.float32))


def test_train_ring_cp_follows_the_jax_example(both):
    _, refs, ports = both
    losses, printed = refs["train"]
    assert len(losses) == len(printed) == EXAMPLE["steps"]
    np.testing.assert_allclose(np.round(losses, 4), printed, atol=1e-4)
    for r in range(WORLD):
        got = ports[r][4]["losses"]
        np.testing.assert_allclose(got, losses, rtol=1e-5,
                                   err_msg=f"rank {r}")
    lines = ports[0][4]["lines"]
    assert lines[0].startswith("ring-CP GPT: cp=4  seq 256 (64/rank)")
    assert sum(line.startswith("step ") for line in lines) == 10
    assert lines[-1] == "done"


def test_card_phase_runner_runs_on_the_cpu(both):
    _, _, ports = both
    runs = [ports[r][5] for r in range(WORLD)]
    ring, ulysses, vs_ring, vs_ulysses, decode = runs[0]
    for i in (0, 1):
        losses = [rec["loss"] for rec in runs[0][i]["records"]]
        assert len(losses) == 3 and np.isfinite(losses).all()
        for step in range(3):
            assert len({runs[r][i]["records"][step]["digest"]
                        for r in range(WORLD)}) == 1
    np.testing.assert_allclose([rec["loss"] for rec in ulysses["records"]],
                               [rec["loss"] for rec in ring["records"]],
                               rtol=1e-5)
    for vs in (vs_ring, vs_ulysses):
        assert vs["loss_ok"] and vs["worst_grad_rel"] < 1e-4
        np.testing.assert_allclose(vs["cp_mean_loss"], vs["single_mean_loss"],
                                   rtol=1e-5)
    np.testing.assert_allclose(decode["decoded"],
                               decode["reference"][:, 32:], rtol=2e-4,
                               atol=2e-4)
